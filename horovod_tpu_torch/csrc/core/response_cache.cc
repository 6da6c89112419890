#include "response_cache.h"

#include <algorithm>

namespace hvdcore {

namespace {
bool SameParams(const Request& a, const Request& b) {
  return a.type == b.type && a.op == b.op && a.dtype == b.dtype &&
         a.root_rank == b.root_rank && a.prescale == b.prescale &&
         a.postscale == b.postscale && a.shape == b.shape &&
         a.splits == b.splits;
}
}  // namespace

ResponseCache::CacheState ResponseCache::Lookup(const Request& req) const {
  auto it = by_name_.find(req.name);
  if (it == by_name_.end()) return CacheState::kMiss;
  const Entry& e = entries_[it->second];
  return SameParams(e.req, req) ? CacheState::kHit : CacheState::kInvalid;
}

size_t ResponseCache::Put(const Request& req, const Response& resp) {
  auto it = by_name_.find(req.name);
  if (it != by_name_.end()) {
    size_t slot = it->second;
    entries_[slot].req = req;
    entries_[slot].resp = resp;
    entries_[slot].seq = next_seq_++;
    Touch(slot);
    return slot;
  }
  size_t slot;
  if (entries_.size() < capacity_) {
    slot = entries_.size();
    entries_.push_back(Entry{req, resp, next_seq_++});
  } else {
    // Evict least-recently-used. Deterministic across ranks because every
    // rank performs the identical Put/Touch sequence (responses are
    // coordinator-broadcast; touches happen only on cross-rank-agreed hits).
    slot = lru_.front();
    lru_.pop_front();
    by_name_.erase(entries_[slot].resp.names.empty()
                       ? entries_[slot].req.name
                       : entries_[slot].req.name);
    entries_[slot] = Entry{req, resp, next_seq_++};
  }
  by_name_[req.name] = slot;
  lru_.push_back(slot);
  return slot;
}

void ResponseCache::Erase(const std::string& name) {
  auto it = by_name_.find(name);
  if (it == by_name_.end()) return;
  size_t slot = it->second;
  by_name_.erase(it);
  lru_.remove(slot);
  // Leave the slot allocated but unnamed; it is reused only via LRU reuse
  // of capacity slots. Mark unusable by clearing the name.
  entries_[slot].req.name.clear();
  entries_[slot].resp = Response{};
  // Push to front so the dead slot is first to be recycled.
  lru_.push_front(slot);
}

bool ResponseCache::BitFor(const std::string& name, size_t* bit) const {
  auto it = by_name_.find(name);
  if (it == by_name_.end()) return false;
  *bit = it->second;
  return true;
}

const Response& ResponseCache::Get(size_t bit) const {
  return entries_[bit].resp;
}

const Request& ResponseCache::CachedRequest(size_t bit) const {
  return entries_[bit].req;
}

void ResponseCache::Touch(size_t bit) {
  lru_.remove(bit);
  lru_.push_back(bit);
}

std::vector<size_t> ResponseCache::BitsInInsertionOrder() const {
  std::vector<size_t> bits;
  bits.reserve(entries_.size());
  for (size_t i = 0; i < entries_.size(); ++i)
    if (!entries_[i].req.name.empty()) bits.push_back(i);
  std::sort(bits.begin(), bits.end(), [this](size_t a, size_t b) {
    return entries_[a].seq < entries_[b].seq;
  });
  return bits;
}

}  // namespace hvdcore
