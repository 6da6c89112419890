#include "controller.h"

#include <algorithm>
#include <chrono>
#include <cstring>
#include <sstream>

#include "timeline.h"

namespace hvdcore {
namespace {

double NowSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Cache-coordination exchange payload: flags + process-set consensus
// counters + two bit vectors.
struct CacheWire {
  uint64_t flags = 0;  // bit0 = has_uncached, bit1 = shutdown_requested
  uint32_t staged_adds = 0;      // pending process-set creations (min-fold)
  uint32_t staged_removals = 0;  // pending process-set removals (min-fold)
  std::vector<uint64_t> hits;
  std::vector<uint64_t> invalid;
};

constexpr uint64_t kFlagUncached = 1ull;
constexpr uint64_t kFlagShutdown = 2ull;

void EncodeCacheWire(const CacheWire& w, std::vector<uint8_t>* out) {
  out->clear();
  uint32_t nwords = static_cast<uint32_t>(w.hits.size());
  out->resize(sizeof(uint64_t) + 3 * sizeof(uint32_t) +
              2 * nwords * sizeof(uint64_t));
  uint8_t* p = out->data();
  std::memcpy(p, &w.flags, sizeof(uint64_t));
  p += sizeof(uint64_t);
  std::memcpy(p, &w.staged_adds, sizeof(uint32_t));
  p += sizeof(uint32_t);
  std::memcpy(p, &w.staged_removals, sizeof(uint32_t));
  p += sizeof(uint32_t);
  std::memcpy(p, &nwords, sizeof(uint32_t));
  p += sizeof(uint32_t);
  std::memcpy(p, w.hits.data(), nwords * sizeof(uint64_t));
  p += nwords * sizeof(uint64_t);
  std::memcpy(p, w.invalid.data(), nwords * sizeof(uint64_t));
}

bool DecodeCacheWire(const std::vector<uint8_t>& in, CacheWire* w) {
  if (in.size() < sizeof(uint64_t) + 3 * sizeof(uint32_t)) return false;
  const uint8_t* p = in.data();
  std::memcpy(&w->flags, p, sizeof(uint64_t));
  p += sizeof(uint64_t);
  std::memcpy(&w->staged_adds, p, sizeof(uint32_t));
  p += sizeof(uint32_t);
  std::memcpy(&w->staged_removals, p, sizeof(uint32_t));
  p += sizeof(uint32_t);
  uint32_t nwords = 0;
  std::memcpy(&nwords, p, sizeof(uint32_t));
  p += sizeof(uint32_t);
  if (in.size() != sizeof(uint64_t) + 3 * sizeof(uint32_t) +
                       2ull * nwords * sizeof(uint64_t))
    return false;
  w->hits.resize(nwords);
  std::memcpy(w->hits.data(), p, nwords * sizeof(uint64_t));
  p += nwords * sizeof(uint64_t);
  w->invalid.resize(nwords);
  std::memcpy(w->invalid.data(), p, nwords * sizeof(uint64_t));
  return true;
}

std::string RanksToString(const std::vector<int>& ranks) {
  std::ostringstream os;
  for (size_t i = 0; i < ranks.size(); ++i)
    os << (i ? ", " : "") << ranks[i];
  return os.str();
}

int64_t NumElements(const std::vector<int64_t>& shape) {
  int64_t n = 1;
  for (int64_t d : shape) n *= d;
  return n;
}

bool Cacheable(const Response& r) {
  return r.error.empty() &&
         (r.type == ReqType::kAllreduce || r.type == ReqType::kAllgather ||
          r.type == ReqType::kBroadcast || r.type == ReqType::kAlltoall ||
          r.type == ReqType::kReducescatter);
}

}  // namespace

Controller::Controller(Transport* transport, const ControllerOptions& opts,
                       Timeline* timeline)
    : transport_(transport),
      opts_(opts),
      timeline_(timeline),
      cache_(opts.cache_capacity) {}

Status Controller::CoordinateCache(const std::vector<size_t>& hit_bits,
                                   const std::vector<size_t>& invalid_bits,
                                   bool has_uncached, bool request_shutdown,
                                   const PsConsensus& staged,
                                   std::vector<size_t>* agreed_bits,
                                   bool* any_uncached, bool* all_shutdown,
                                   PsConsensus* agreed_ps) {
  const size_t nwords = (opts_.cache_capacity + 63) / 64;
  CacheWire mine;
  mine.hits.assign(nwords, 0);
  mine.invalid.assign(nwords, 0);
  for (size_t b : hit_bits) mine.hits[b / 64] |= 1ull << (b % 64);
  for (size_t b : invalid_bits) mine.invalid[b / 64] |= 1ull << (b % 64);
  if (has_uncached) mine.flags |= kFlagUncached;
  if (request_shutdown) mine.flags |= kFlagShutdown;
  mine.staged_adds = staged.adds;
  mine.staged_removals = staged.removals;

  CacheWire global = mine;
  const int size = transport_->size();
  if (size > 1) {
    std::vector<uint8_t> buf;
    if (is_coordinator()) {
      // Fold every worker's vector: AND hits, OR invalid, OR uncached,
      // AND shutdown (reference: CrossRankBitwiseAnd/Or,
      // mpi_controller.cc:117-127).
      for (int r = 1; r < size; ++r) {
        Status st = transport_->Recv(r, &buf);
        if (!st.ok()) return st;
        CacheWire theirs;
        if (!DecodeCacheWire(buf, &theirs) ||
            theirs.hits.size() != nwords)
          return Status::Error(StatusCode::kUnknownError,
                               "bad cache-coordination message");
        for (size_t i = 0; i < nwords; ++i) {
          global.hits[i] &= theirs.hits[i];
          global.invalid[i] |= theirs.invalid[i];
        }
        uint64_t uncached =
            (global.flags | theirs.flags) & kFlagUncached;
        uint64_t shut = (global.flags & theirs.flags) & kFlagShutdown;
        global.flags = uncached | shut;
        global.staged_adds = std::min(global.staged_adds, theirs.staged_adds);
        global.staged_removals =
            std::min(global.staged_removals, theirs.staged_removals);
      }
      std::vector<uint8_t> enc;
      EncodeCacheWire(global, &enc);
      for (int r = 1; r < size; ++r) {
        Status st = transport_->Send(r, enc.data(), enc.size());
        if (!st.ok()) return st;
      }
    } else {
      std::vector<uint8_t> enc;
      EncodeCacheWire(mine, &enc);
      Status st = transport_->Send(0, enc.data(), enc.size());
      if (!st.ok()) return st;
      st = transport_->Recv(0, &buf);
      if (!st.ok()) return st;
      if (!DecodeCacheWire(buf, &global) || global.hits.size() != nwords)
        return Status::Error(StatusCode::kUnknownError,
                             "bad cache-coordination reply");
    }
  }

  bool any_invalid = false;
  agreed_bits->clear();
  for (size_t w = 0; w < nwords; ++w) {
    uint64_t agreed = global.hits[w] & ~global.invalid[w];
    if (global.invalid[w]) any_invalid = true;
    for (int b = 0; b < 64; ++b)
      if (agreed & (1ull << b)) agreed_bits->push_back(w * 64 + b);
    // Cross-rank-invalidated entries are erased on EVERY rank so bit
    // layouts stay identical (reference: cache invalidation coordination).
    uint64_t inv = global.invalid[w];
    for (int b = 0; b < 64; ++b)
      if (inv & (1ull << b)) {
        size_t bit = w * 64 + b;
        if (bit < cache_.NumEntries())
          cache_.Erase(cache_.CachedRequest(bit).name);
      }
  }
  *any_uncached = (global.flags & kFlagUncached) != 0 || any_invalid;
  *all_shutdown = (global.flags & kFlagShutdown) != 0;
  if (agreed_ps) {
    agreed_ps->adds = global.staged_adds;
    agreed_ps->removals = global.staged_removals;
  }
  return Status::OK();
}

void Controller::AddRequestToTable(const Request& req, int from_rank) {
  if (req.type == ReqType::kJoin) {
    joined_ranks_.insert(from_rank);
    return;
  }
  auto& entry = message_table_[req.name];
  const double now = NowSeconds();
  if (entry.ranks.empty()) entry.first_seen = now;
  entry.last_update = now;
  if (entry.ranks.insert(from_rank).second)
    entry.requests.push_back(req);
}

bool Controller::TableEntryReady(const std::string& name) const {
  auto it = message_table_.find(name);
  if (it == message_table_.end()) return false;
  // Ready when every rank has either submitted the tensor or joined
  // (reference: IncrementTensorCount counts joined ranks as ready,
  // controller.cc:977).
  std::set<int> covered = it->second.ranks;
  covered.insert(joined_ranks_.begin(), joined_ranks_.end());
  return static_cast<int>(covered.size()) == transport_->size();
}

Response Controller::ConstructResponse(const std::string& name) {
  // Validation mirroring the reference's cross-rank consistency checks
  // (reference: controller.cc:495-778) — errors name offending ranks.
  TableEntry entry = std::move(message_table_[name]);
  message_table_.erase(name);
  std::sort(entry.requests.begin(), entry.requests.end(),
            [](const Request& a, const Request& b) { return a.rank < b.rank; });
  const Request& first = entry.requests.front();

  Response resp;
  resp.type = first.type;
  resp.op = first.op;
  resp.dtype = first.dtype;
  resp.names.push_back(name);
  resp.prescale = first.prescale;
  resp.postscale = first.postscale;
  if (!joined_ranks_.empty())
    resp.last_joined_rank = *joined_ranks_.rbegin();

  auto fail = [&](const std::string& why) {
    resp.error = "Tensor " + name + ": " + why;
    return resp;
  };

  std::vector<int> bad;
  for (const Request& r : entry.requests)
    if (r.type != first.type) bad.push_back(r.rank);
  if (!bad.empty())
    return fail("mismatched collective types; rank " +
                std::to_string(first.rank) + " vs ranks " + RanksToString(bad));
  bad.clear();
  for (const Request& r : entry.requests)
    if (r.dtype != first.dtype) bad.push_back(r.rank);
  if (!bad.empty())
    return fail(std::string("mismatched data types; expected ") +
                DataTypeName(first.dtype) + ", differing ranks " +
                RanksToString(bad));

  switch (first.type) {
    case ReqType::kAllreduce:
    case ReqType::kReducescatter: {
      if (first.type == ReqType::kReducescatter && !joined_ranks_.empty())
        return fail("reducescatter cannot run while ranks have joined");
      if (first.type == ReqType::kReducescatter &&
          first.op == RedOp::kAdasum)
        return fail("Adasum is not defined for reducescatter");
      for (const Request& r : entry.requests) {
        if (r.shape != first.shape) bad.push_back(r.rank);
        if (r.op != first.op || r.prescale != first.prescale ||
            r.postscale != first.postscale)
          bad.push_back(r.rank);
      }
      if (!bad.empty())
        return fail("mismatched shapes or reduction parameters on ranks " +
                    RanksToString(bad));
      resp.sizes.push_back(NumElements(first.shape));
      break;
    }
    case ReqType::kBroadcast: {
      for (const Request& r : entry.requests) {
        if (r.root_rank != first.root_rank) bad.push_back(r.rank);
        if (r.shape != first.shape) bad.push_back(r.rank);
      }
      if (!bad.empty())
        return fail("mismatched root rank or shapes on ranks " +
                    RanksToString(bad));
      if (first.root_rank < 0 || first.root_rank >= transport_->size())
        return fail("root rank " + std::to_string(first.root_rank) +
                    " out of range");
      // sizes = [element count, root index] so ranks without a local entry
      // (joined) can still participate in the broadcast tree.
      resp.sizes.push_back(NumElements(first.shape));
      resp.sizes.push_back(first.root_rank);
      break;
    }
    case ReqType::kAllgather: {
      // Shapes must agree on all dims but the first (reference: allgather
      // displacement logic, collective_operations.h:129-179). sizes[r] =
      // rank r's first-dim extent; joined ranks contribute 0 rows.
      for (const Request& r : entry.requests) {
        if (r.shape.size() != first.shape.size() ||
            !std::equal(r.shape.begin() + 1, r.shape.end(),
                        first.shape.begin() + 1))
          bad.push_back(r.rank);
      }
      if (!bad.empty())
        return fail("mismatched trailing dimensions on ranks " +
                    RanksToString(bad));
      resp.sizes.assign(transport_->size(), 0);
      for (const Request& r : entry.requests)
        resp.sizes[r.rank] = r.shape.empty() ? 1 : r.shape[0];
      // Trailing extra entry: row element count, so ranks without a local
      // entry can size their ring buffers.
      {
        int64_t row_elems = 1;
        for (size_t d = 1; d < first.shape.size(); ++d)
          row_elems *= first.shape[d];
        resp.sizes.push_back(row_elems);
      }
      break;
    }
    case ReqType::kAlltoall: {
      // sizes = row-count matrix [src][dst] (reference: alltoall recv-split
      // negotiation, AlltoallOp::PrepareOutputAndParams,
      // collective_operations.h:195-273).
      const int size = transport_->size();
      resp.sizes.assign(static_cast<size_t>(size) * size, 0);
      for (const Request& r : entry.requests) {
        if (static_cast<int>(r.splits.size()) != size) {
          bad.push_back(r.rank);
          continue;
        }
        int64_t total = 0;
        for (int32_t s : r.splits) total += s;
        int64_t rows = r.shape.empty() ? 0 : r.shape[0];
        if (total != rows) bad.push_back(r.rank);
        for (int d = 0; d < size; ++d)
          resp.sizes[static_cast<size_t>(r.rank) * size + d] = r.splits[d];
      }
      if (!bad.empty())
        return fail("invalid alltoall splits on ranks " + RanksToString(bad));
      if (!joined_ranks_.empty())
        return fail("alltoall cannot run while ranks have joined");
      break;
    }
    case ReqType::kBarrier:
      break;
    case ReqType::kJoin:
      break;
  }
  return resp;
}

void Controller::CheckForStalledTensors() {
  // Coordinator-side stall inspection (reference:
  // horovod/common/stall_inspector.cc:26 CheckForStalledTensors; warn after
  // 60s listing which ranks are missing which tensors).
  const double now = NowSeconds();
  if (now - last_stall_check_ < 5.0) return;
  last_stall_check_ = now;
  for (auto& kv : message_table_) {
    double age = now - kv.second.first_seen;
    // The shutdown threshold stands on its own: a user may set it below
    // the (default 60s) warning threshold. Quiescence guard: a healthy
    // rank whose cache-hit submissions are still escalating refreshes
    // last_update when its request lands, deferring the fatal verdict —
    // without it a transiently-slow but alive rank could be declared
    // missing in the escalation window.
    if (opts_.stall_shutdown_s > 0 && age >= opts_.stall_shutdown_s &&
        now - kv.second.last_update >= EffectiveStallThreshold())
      stalled_fatal_.insert(kv.first);
    if (age < opts_.stall_warning_s) continue;
    LogMsg(LogLevel::kWarn, transport_->rank(),
           "Tensor '" + kv.first + "' stalled for " +
               std::to_string(static_cast<int>(age)) +
               "s; waiting on ranks [" +
               RanksToString(MissingRanks(kv.second)) + "]");
  }
}

double Controller::EffectiveStallThreshold() const {
  // Escalation and the fatal quiescence window MUST use the same value:
  // the quiescence guard assumes a healthy rank escalates within it.
  double t = opts_.stall_warning_s;
  if (opts_.stall_shutdown_s > 0) t = std::min(t, opts_.stall_shutdown_s);
  return t;
}

std::vector<int> Controller::MissingRanks(const TableEntry& entry) const {
  std::vector<int> missing;
  for (int r = 0; r < transport_->size(); ++r)
    if (!entry.ranks.count(r) && !joined_ranks_.count(r))
      missing.push_back(r);
  return missing;
}

ResponseList Controller::FuseResponses(std::vector<Response> responses) {
  // Greedy fusion with lookahead over the deterministic response order
  // (reference: FuseResponses, controller.cc:808-948): allreduce responses
  // sharing (dtype, op, scale factors) merge until the byte threshold.
  ResponseList out;
  std::vector<bool> used(responses.size(), false);
  for (size_t i = 0; i < responses.size(); ++i) {
    if (used[i]) continue;
    Response& r = responses[i];
    used[i] = true;
    // kAdasum never fuses: the dot-product coefficients are per-tensor
    // (a concatenated buffer would couple unrelated layers' scale
    // adaptation and make results depend on fusion timing).
    if (r.type == ReqType::kAllreduce && r.error.empty() &&
        r.op != RedOp::kAdasum) {
      int64_t bytes = 0;
      for (int64_t n : r.sizes) bytes += n * DataTypeSize(r.dtype);
      for (size_t j = i + 1; j < responses.size(); ++j) {
        if (used[j]) continue;
        const Response& c = responses[j];
        if (c.type != ReqType::kAllreduce || !c.error.empty() ||
            c.dtype != r.dtype || c.op != r.op ||
            c.prescale != r.prescale || c.postscale != r.postscale ||
            c.last_joined_rank != r.last_joined_rank)
          continue;
        int64_t cbytes = 0;
        for (int64_t n : c.sizes) cbytes += n * DataTypeSize(c.dtype);
        if (bytes + cbytes > opts_.fusion_threshold) continue;
        bytes += cbytes;
        r.names.insert(r.names.end(), c.names.begin(), c.names.end());
        r.sizes.insert(r.sizes.end(), c.sizes.begin(), c.sizes.end());
        used[j] = true;
      }
    }
    out.responses.push_back(std::move(r));
  }
  return out;
}

Status Controller::ComputeResponseList(std::vector<Request> pending,
                                       bool request_shutdown,
                                       const PsConsensus& staged,
                                       CycleResult* out) {
  // Classify local pending requests against the response cache.
  std::vector<size_t> hit_bits, invalid_bits;
  std::vector<Request> uncached;
  std::map<size_t, Request> hit_candidates;
  for (Request& req : pending) {
    if (req.type == ReqType::kBarrier || req.type == ReqType::kJoin) {
      if (req.type == ReqType::kJoin) local_joined_ = true;
      uncached.push_back(std::move(req));
      continue;
    }
    switch (cache_.Lookup(req)) {
      case ResponseCache::CacheState::kHit: {
        // A hit that keeps failing cross-rank agreement (some rank has
        // stopped submitting) is invisible to the stall inspector: it
        // loops through the requeue path and never reaches the
        // coordinator's message table. Past the warning threshold,
        // escalate it to the slow path so stall warning/shutdown apply
        // to cached steady-state tensors too.
        const double now_hit = NowSeconds();
        auto emplaced = hit_pending_since_.try_emplace(req.name, now_hit);
        if (now_hit - emplaced.first->second >= EffectiveStallThreshold()) {
          hit_pending_since_.erase(emplaced.first);
          uncached.push_back(std::move(req));
          break;
        }
        size_t bit = 0;
        cache_.BitFor(req.name, &bit);
        hit_bits.push_back(bit);
        hit_candidates[bit] = std::move(req);
        break;
      }
      case ResponseCache::CacheState::kInvalid: {
        size_t bit = 0;
        cache_.BitFor(req.name, &bit);
        invalid_bits.push_back(bit);
        hit_pending_since_.erase(req.name);
        uncached.push_back(std::move(req));
        break;
      }
      case ResponseCache::CacheState::kMiss:
        hit_pending_since_.erase(req.name);
        uncached.push_back(std::move(req));
        break;
    }
  }

  if (local_joined_) {
    // A joined rank submits nothing; report every cache bit as a hit so the
    // training ranks' AND-agreement still succeeds. Cached non-allreduce
    // responses carry per-rank sizes that are stale once this rank joins —
    // invalidate them ONCE at the join transition so they renegotiate
    // join-aware; anything re-cached after that is already join-aware, and
    // re-invalidating every cycle would force slow-path negotiation for the
    // whole joined period.
    hit_bits.clear();
    for (size_t bit : cache_.BitsInInsertionOrder()) {  // live slots only
      if (joined_cache_flushed_ ||
          cache_.Get(bit).type == ReqType::kAllreduce)
        hit_bits.push_back(bit);
      else
        invalid_bits.push_back(bit);
    }
    joined_cache_flushed_ = true;
  }

  if (timeline_)
    for (const auto& kv : hit_candidates)
      timeline_->NegotiateStart(kv.second.name);
  for (const Request& r : uncached)
    if (timeline_ && r.type != ReqType::kBarrier && r.type != ReqType::kJoin)
      timeline_->NegotiateStart(r.name);

  std::vector<size_t> agreed_bits;
  bool any_uncached = false, all_shutdown = false;
  // Pending stall-shutdown errors must reach every rank; forcing the slow
  // path gives the coordinator a response broadcast to carry them.
  bool has_uncached_local =
      !uncached.empty() || (is_coordinator() && !stalled_fatal_.empty());
  Status st = CoordinateCache(hit_bits, invalid_bits, has_uncached_local,
                              request_shutdown, staged, &agreed_bits,
                              &any_uncached, &all_shutdown, &out->agreed_ps);
  if (!st.ok()) return st;

  // Agreed hits resolve straight from cache; unagreed hits requeue locally
  // for a later cycle (some rank has not submitted the tensor yet).
  std::set<size_t> agreed(agreed_bits.begin(), agreed_bits.end());
  std::vector<Response> ready_responses;
  std::vector<size_t> my_agreed;  // agreed bits this rank actually requested
  for (auto& kv : hit_candidates) {
    if (agreed.count(kv.first)) {
      my_agreed.push_back(kv.first);
      hit_pending_since_.erase(kv.second.name);
    } else if (cache_.Lookup(kv.second) ==
               ResponseCache::CacheState::kMiss) {
      // Invalidated cross-rank during coordination: renegotiate.
      hit_pending_since_.erase(kv.second.name);
      uncached.push_back(std::move(kv.second));
    } else {
      out->requeue.push_back(std::move(kv.second));
    }
  }
  // Deterministic cross-rank execution order for the fast path: cache
  // insertion order (reference: controller.cc:240-247 — identical bit order
  // on all ranks is a correctness requirement).
  std::sort(my_agreed.begin(), my_agreed.end());
  std::vector<size_t> order = cache_.BitsInInsertionOrder();
  for (size_t bit : order) {
    if (!agreed.count(bit)) continue;
    cache_.Touch(bit);
    // A joined rank executes every agreed cached response entry-less (ring
    // collectives need all ranks); others execute only what they requested.
    if (local_joined_ ||
        std::binary_search(my_agreed.begin(), my_agreed.end(), bit))
      ready_responses.push_back(cache_.Get(bit));
  }

  // Slow path: full negotiation through the coordinator.
  if (any_uncached) {
    // Remember what this rank submitted: negotiated responses are cached
    // under the *submitted* request (shape, root, scales) so the next
    // identical submit is a cache hit.
    std::map<std::string, Request> submitted;
    for (const Request& r : uncached)
      if (r.type != ReqType::kBarrier && r.type != ReqType::kJoin)
        submitted[r.name] = r;
    ResponseList negotiated;
    if (is_coordinator()) {
      for (const Request& r : uncached) AddRequestToTable(r, transport_->rank());
      std::vector<uint8_t> buf;
      for (int r = 1; r < transport_->size(); ++r) {
        Status s = transport_->Recv(r, &buf);
        if (!s.ok()) return s;
        RequestList rl;
        if (!Deserialize(buf.data(), buf.size(), &rl))
          return Status::Error(StatusCode::kUnknownError,
                               "bad request list from rank " +
                                   std::to_string(r));
        for (const Request& req : rl.requests) AddRequestToTable(req, r);
      }
      // Construct responses for every tensor now ready on all ranks, in
      // deterministic (name-sorted) order.
      std::vector<std::string> ready;
      for (const auto& kv : message_table_)
        if (TableEntryReady(kv.first)) ready.push_back(kv.first);
      std::sort(ready.begin(), ready.end());
      bool barrier_ready = false;
      for (const std::string& name : ready) {
        if (message_table_[name].requests.front().type == ReqType::kBarrier) {
          message_table_.erase(name);
          Response b;
          b.type = ReqType::kBarrier;
          b.names.push_back(name);
          negotiated.responses.push_back(std::move(b));
          barrier_ready = true;
          continue;
        }
        negotiated.responses.push_back(ConstructResponse(name));
      }
      (void)barrier_ready;
      // Stall shutdown: fail tensors past the threshold with an error
      // response naming the missing ranks.
      for (auto it = stalled_fatal_.begin(); it != stalled_fatal_.end();) {
        auto te = message_table_.find(*it);
        if (te == message_table_.end()) {  // became ready in the meantime
          it = stalled_fatal_.erase(it);
          continue;
        }
        Response err;
        err.type = te->second.requests.front().type;
        err.names.push_back(*it);
        // "STALLED:" is a stable machine-readable marker (the Python layer
        // classifies the exception type by it; wording after it is free).
        err.error = "STALLED: tensor '" + *it +
                    "' stalled beyond the stall-shutdown threshold; "
                    "missing ranks [" +
                    RanksToString(MissingRanks(te->second)) + "]";
        negotiated.responses.push_back(std::move(err));
        message_table_.erase(te);
        it = stalled_fatal_.erase(it);
      }
      // All ranks joined => emit the join-done response and reset.
      if (!joined_ranks_.empty() &&
          static_cast<int>(joined_ranks_.size()) == transport_->size()) {
        Response j;
        j.type = ReqType::kJoin;
        j.names.push_back("__join__");
        j.last_joined_rank = *joined_ranks_.rbegin();
        negotiated.responses.push_back(std::move(j));
        joined_ranks_.clear();
      }
      std::vector<uint8_t> enc;
      Serialize(negotiated, &enc);
      for (int r = 1; r < transport_->size(); ++r) {
        Status s = transport_->Send(r, enc.data(), enc.size());
        if (!s.ok()) return s;
      }
    } else {
      RequestList rl;
      rl.requests = uncached;
      rl.shutdown = request_shutdown;
      std::vector<uint8_t> enc;
      Serialize(rl, &enc);
      Status s = transport_->Send(0, enc.data(), enc.size());
      if (!s.ok()) return s;
      std::vector<uint8_t> buf;
      s = transport_->Recv(0, &buf);
      if (!s.ok()) return s;
      if (!Deserialize(buf.data(), buf.size(), &negotiated))
        return Status::Error(StatusCode::kUnknownError,
                             "bad response list from coordinator");
    }
    // Every rank caches the negotiated responses in identical order so
    // cache-bit layouts agree next cycle.
    for (const Response& r : negotiated.responses) {
      if (r.type == ReqType::kJoin) {
        local_joined_ = false;  // all joined
        joined_cache_flushed_ = false;
      }
      if (!Cacheable(r) || r.names.size() != 1) {
        ready_responses.push_back(r);
        continue;
      }
      {
        auto sub = submitted.find(r.names[0]);
        Request key;
        if (sub != submitted.end()) {
          key = sub->second;  // this rank's exact submission
        } else {
          // This rank never submitted the tensor (it joined). The cache
          // MUST still be updated — insertion order is a pure function of
          // the broadcast response list so bit layouts stay identical on
          // every rank. Store a reconstructed key; a later real submit
          // mismatches it and renegotiates (coordinated invalidation),
          // which is correct, just not fast-pathed.
          key.name = r.names[0];
          key.type = r.type;
          key.op = r.op;
          key.dtype = r.dtype;
          key.prescale = r.prescale;
          key.postscale = r.postscale;
          if (r.type == ReqType::kAllreduce ||
              r.type == ReqType::kBroadcast ||
              r.type == ReqType::kReducescatter) {
            key.shape.assign(1, 0);
            for (int64_t n : r.sizes) key.shape[0] += n;
          }
        }
        cache_.Put(key, r);
      }
      ready_responses.push_back(r);
    }
  }

  if (timeline_)
    for (const Response& r : ready_responses)
      for (const std::string& n : r.names) timeline_->NegotiateEnd(n);

  if (is_coordinator()) CheckForStalledTensors();

  out->to_execute = FuseResponses(std::move(ready_responses));
  out->shutdown = all_shutdown;
  return Status::OK();
}

}  // namespace hvdcore
