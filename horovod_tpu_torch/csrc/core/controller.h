// Coordinator/worker negotiation controller.
//
// Native rethink of the reference controller (reference:
// horovod/common/controller.cc:73 ComputeResponseList, :495 ConstructResponse,
// :808 FuseResponses, :977 IncrementTensorCount; protocol documented at
// controller.h:77-108). Per cycle:
//
//   1. Cache coordination (always): every rank exchanges a bit vector of
//      response-cache hits plus flags; agreed hits (bitwise AND) execute
//      straight from the cache with no coordinator round-trip — the
//      steady-state fast path (reference: response_cache.h:131-168).
//   2. Slow path (only when any rank holds uncached requests): workers send
//      their RequestList to rank 0; the coordinator counts per-name
//      readiness across ranks, validates shape/dtype/op agreement naming
//      offending ranks in errors, constructs responses, and broadcasts the
//      ResponseList.
//   3. Both rank-agreed cache hits and fresh responses are fused into
//      buckets up to the fusion threshold (identical, deterministic order
//      on every rank) and returned for execution.
#ifndef HVDCORE_CONTROLLER_H_
#define HVDCORE_CONTROLLER_H_

#include <cstdint>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <vector>

#include "message.h"
#include "response_cache.h"
#include "transport.h"

namespace hvdcore {

class Timeline;

struct ControllerOptions {
  size_t cache_capacity = 1024;     // HOROVOD_CACHE_CAPACITY analog
  int64_t fusion_threshold = 128 << 20;  // bytes (reference: operations.cc:491)
  double stall_warning_s = 60.0;    // reference: stall_inspector.h
  double stall_shutdown_s = 0.0;    // 0 = never force-error stalled tensors
};

// Pending process-set changes folded through the phase-A exchange with MIN:
// a staged set/removal activates only once every rank has staged it — the
// analog of the reference's synchronized process-set initialization in the
// background loop (reference: horovod/common/operations.cc:725-741).
struct PsConsensus {
  uint32_t adds = 0;
  uint32_t removals = 0;
};

// Outcome of one negotiation cycle.
struct CycleResult {
  ResponseList to_execute;          // fused, identical order on all ranks
  std::vector<Request> requeue;     // cache hits not yet agreed by all ranks
  bool shutdown = false;            // every rank requested shutdown
  PsConsensus agreed_ps;            // process-set changes agreed this cycle
};

class Controller {
 public:
  Controller(Transport* transport, const ControllerOptions& opts,
             Timeline* timeline);

  // Runs one full negotiation cycle. `pending` = requests popped from the
  // local tensor queue this cycle; `request_shutdown` = this rank wants out;
  // `staged` = this rank's pending process-set adds/removals (global set
  // controller only; pass {} elsewhere).
  Status ComputeResponseList(std::vector<Request> pending,
                             bool request_shutdown, const PsConsensus& staged,
                             CycleResult* out);

  int rank() const { return transport_->rank(); }
  int size() const { return transport_->size(); }
  int joined_size() const { return static_cast<int>(joined_ranks_.size()); }

  // Runtime autotune knob (reference: SynchronizeParameters applies the
  // parameter manager's winners, controller.cc:39-53). Callers must set
  // the same value on every rank at the same cycle boundary.
  void set_fusion_threshold(int64_t bytes) { opts_.fusion_threshold = bytes; }

 private:
  bool is_coordinator() const { return transport_->rank() == 0; }

  // Cache coordination: returns agreed-hit bits; fills `any_uncached` /
  // `all_shutdown` / `agreed_ps`; erases cross-rank-invalidated entries.
  Status CoordinateCache(const std::vector<size_t>& hit_bits,
                         const std::vector<size_t>& invalid_bits,
                         bool has_uncached, bool request_shutdown,
                         const PsConsensus& staged,
                         std::vector<size_t>* agreed_bits, bool* any_uncached,
                         bool* all_shutdown, PsConsensus* agreed_ps);

  // Slow path pieces (coordinator side).
  void AddRequestToTable(const Request& req, int from_rank);
  bool TableEntryReady(const std::string& name) const;
  Response ConstructResponse(const std::string& name);
  void CheckForStalledTensors();

  ResponseList FuseResponses(std::vector<Response> responses);

  struct TableEntry;
  std::vector<int> MissingRanks(const TableEntry& entry) const;
  double EffectiveStallThreshold() const;

  Transport* transport_;
  ControllerOptions opts_;
  Timeline* timeline_;
  ResponseCache cache_;

  // Coordinator state persisting across cycles (workers may submit the same
  // tensor on different cycles): name -> per-rank requests.
  struct TableEntry {
    std::vector<Request> requests;
    std::set<int> ranks;
    double first_seen;   // monotonic seconds, for the stall inspector
    double last_update;  // refreshed per insert; fatal needs quiescence
  };
  std::map<std::string, TableEntry> message_table_;
  // Names past the stall-shutdown threshold: the next slow-path round
  // broadcasts an error response for them (reference: the stall
  // inspector's optional shutdown, stall_inspector.h:78-83 — failing the
  // stalled tensor with a rank-naming error beats killing the job).
  std::set<std::string> stalled_fatal_;
  // First time a cache-hit failed cross-rank agreement, per name (stall
  // escalation for cached steady-state tensors).
  std::map<std::string, double> hit_pending_since_;
  std::set<int> joined_ranks_;
  // True between this rank submitting a Join and the all-joined response.
  // A joined rank submits nothing, so it must (a) report every cache bit as
  // a hit so the bitwise-AND agreement can still succeed for the training
  // ranks (reference: joined ranks record all cache bits,
  // horovod/common/controller.cc:129-133), and (b) execute agreed cached
  // responses entry-less so ring collectives do not hang on it.
  bool local_joined_ = false;
  // Whether the one-time join-transition cache invalidation already ran
  // (stale non-allreduce sizes renegotiate once, then cache hits resume).
  bool joined_cache_flushed_ = false;
  double last_stall_check_ = 0.0;
};

}  // namespace hvdcore

#endif  // HVDCORE_CONTROLLER_H_
