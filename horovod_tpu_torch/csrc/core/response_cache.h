// LRU response cache with cross-rank bitvector coordination.
//
// Steady-state training enqueues the same named tensors with the same
// parameters every step; the reference short-circuits the full coordinator
// negotiation with an LRU of previously-negotiated responses plus two
// bitwise-AND allreduces over a bit vector (reference:
// horovod/common/response_cache.h:45-169, used controller.cc:88-251).
// This is the same design: a hit list every rank agrees on is executed in
// deterministic cache order with zero coordinator round-trips.
#ifndef HVDCORE_RESPONSE_CACHE_H_
#define HVDCORE_RESPONSE_CACHE_H_

#include <cstdint>
#include <list>
#include <map>
#include <string>
#include <vector>

#include "message.h"

namespace hvdcore {

class ResponseCache {
 public:
  enum class CacheState { kMiss, kHit, kInvalid };

  explicit ResponseCache(size_t capacity) : capacity_(capacity) {}

  // Does `req` match a cached response bit-for-bit (same type/op/dtype/
  // shape/root/scales)? kInvalid = name cached with different params, which
  // forces eviction + renegotiation (reference: response_cache.cc cache
  // invalidation on parameter change).
  CacheState Lookup(const Request& req) const;

  size_t Put(const Request& req, const Response& resp);
  void Erase(const std::string& name);

  // Bit position of a cached name (stable across ranks because insertion
  // order is driven by identical coordinator responses on every rank).
  bool BitFor(const std::string& name, size_t* bit) const;
  const Response& Get(size_t bit) const;
  const Request& CachedRequest(size_t bit) const;
  void Touch(size_t bit);  // LRU bump
  size_t NumEntries() const { return entries_.size(); }
  size_t capacity() const { return capacity_; }

  // All cache bits in most-recently-used-last order — the deterministic
  // execution order for hit lists (reference: controller.cc:240-247 requires
  // identical ordering on all ranks).
  std::vector<size_t> BitsInInsertionOrder() const;

 private:
  struct Entry {
    Request req;
    Response resp;
    uint64_t seq;  // insertion sequence for deterministic ordering
  };
  size_t capacity_;
  uint64_t next_seq_ = 0;
  std::vector<Entry> entries_;             // slot index == bit position
  std::list<size_t> lru_;                  // front = least recent
  std::map<std::string, size_t> by_name_;  // name -> slot
};

}  // namespace hvdcore

#endif  // HVDCORE_RESPONSE_CACHE_H_
