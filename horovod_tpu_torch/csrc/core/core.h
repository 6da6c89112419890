// Core runtime context: tensor queues, per-process-set controllers,
// fusion-buffer execution, async handles.
//
// Native rethink of the reference's HorovodGlobalState + background loop
// (reference: horovod/common/operations.cc:385 BackgroundThreadLoop, :706
// RunLoopOnce, :257 PerformOperation; process-set table:
// horovod/common/process_set.h:89-171). Differences by design:
//  - The cycle is *driven from outside* (the Python coordinator thread calls
//    RunCycle) instead of owning a thread: on TPU the heavy data plane is
//    compiled XLA programs dispatched from Python, so the native core slots
//    under the same driver thread rather than competing with it.
//  - Each process set is a channel over one multiplexed transport; a set's
//    controller, response cache, queue, and fusion buffer are private to the
//    channel, mirroring the reference's per-set controller+queue.
#ifndef HVDCORE_CORE_H_
#define HVDCORE_CORE_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include "collectives.h"
#include "controller.h"
#include "message.h"
#include "timeline.h"
#include "transport.h"

namespace hvdcore {

// Channel-multiplexed wrapper over one base transport: every message gets a
// u32 channel header; out-of-channel frames are parked in per-(channel,peer)
// inboxes. Lets N process sets share one socket mesh (the reference gives
// each process set its own communicator; one mesh + channels is the
// TCP-native equivalent).
class MuxTransport {
 public:
  explicit MuxTransport(std::unique_ptr<Transport> base)
      : base_(std::move(base)) {}
  int rank() const { return base_->rank(); }
  int size() const { return base_->size(); }
  Status Send(uint32_t ch, int to, const void* data, size_t len);
  Status Recv(uint32_t ch, int from, std::vector<uint8_t>* out);
  Status SendRecv(uint32_t ch, int to, const void* sdata, size_t slen,
                  int from, std::vector<uint8_t>* out);
  void Close() { base_->Close(); }

 private:
  Status TakeFromInbox(uint32_t ch, int from, std::vector<uint8_t>* out,
                       bool* found);
  std::unique_ptr<Transport> base_;
  std::map<std::pair<uint32_t, int>, std::vector<std::vector<uint8_t>>> inbox_;
};

// Adapts (channel, member-rank-list) to the Transport interface consumed by
// the controller and the ring collectives.
class ChannelView : public Transport {
 public:
  ChannelView(MuxTransport* mux, uint32_t ch, std::vector<int> members,
              int my_index)
      : mux_(mux), ch_(ch), members_(std::move(members)), my_index_(my_index) {}
  int rank() const override { return my_index_; }
  int size() const override { return static_cast<int>(members_.size()); }
  Status Send(int to, const void* data, size_t len) override {
    return mux_->Send(ch_, members_[to], data, len);
  }
  Status Recv(int from, std::vector<uint8_t>* out) override {
    return mux_->Recv(ch_, members_[from], out);
  }
  Status SendRecv(int to, const void* sdata, size_t slen, int from,
                  std::vector<uint8_t>* out) override {
    return mux_->SendRecv(ch_, members_[to], sdata, slen, members_[from], out);
  }
  void Close() override {}

 private:
  MuxTransport* mux_;
  uint32_t ch_;
  std::vector<int> members_;
  int my_index_;
};

enum class HandleState : int { kInProgress = 0, kDone = 1, kError = 2 };

struct Entry {
  Request req;
  std::vector<uint8_t> input;    // copied at enqueue (owner-safe)
  std::vector<uint8_t> output;
  std::vector<int64_t> out_shape;
  std::vector<int32_t> recv_splits;  // alltoall only
  HandleState state = HandleState::kInProgress;
  std::string error;
};

struct CoreOptions {
  ControllerOptions controller;
  std::string timeline_path;  // empty = disabled
  // Delegate data-op execution to the embedding runtime: negotiation and
  // fusion ordering stay native, but agreed allreduce/allgather/broadcast/
  // reducescatter responses queue for external execution (the XLA/ICI data
  // plane) instead of running the TCP ring collectives. The analog of the
  // reference's NCCL-executes/controller-negotiates split
  // (reference: horovod/common/ops/nccl_operations.cc:80-119 — the NCCL
  // data plane bootstraps and orders through the MPI/Gloo controller).
  bool delegate_data_ops = false;
};

class Core {
 public:
  // transport_kind: "tcp" (peers = "host:port,...") or "local"
  // (peers = job name for the in-process hub).
  static Status Create(int rank, int size, const std::string& transport_kind,
                       const std::string& peers, const CoreOptions& opts,
                       std::unique_ptr<Core>* out);

  // Must be called collectively in the same order on every member rank.
  // Returns the new process-set id (>0; 0 is the global set).
  int AddProcessSet(const std::vector<int>& ranks);
  bool RemoveProcessSet(int ps_id);

  // Thread-safe enqueue; returns handle >= 0 or negative error code
  // (-1 duplicate name, -2 bad args, -3 shutting down, -4 not a member).
  int64_t Enqueue(int ps_id, const Request& req, const void* data,
                  size_t nbytes);

  // One negotiation+execution cycle over every process set this rank
  // belongs to. Returns completed-handle count, or -1 after shutdown.
  int RunCycle();

  // Apply an autotuned fusion threshold to every process-set controller.
  void SetFusionThreshold(int64_t bytes);

  // Host topology for hierarchical collectives: host_of[r] = host index
  // of global rank r; threshold = minimum buffer bytes before the
  // two-level path engages (0 disables). Settable at runtime (autotune).
  void SetTopology(const std::vector<int>& host_of, int64_t threshold);

  void RequestShutdown() { shutdown_requested_.store(true); }
  bool ShutdownComplete() const { return shutdown_complete_.load(); }

  HandleState Poll(int64_t handle, std::string* error);
  Status Wait(int64_t handle, double timeout_s);
  const Entry* Get(int64_t handle);
  void Release(int64_t handle);

  // --- delegated execution (external data plane; delegate_data_ops) ---
  struct Delegated {
    int ps_id = 0;
    Response resp;                 // the negotiated (possibly fused) bucket
    std::vector<int64_t> handles;  // parallel to resp.names; -1 entry-less
  };
  // Pop the next delegated response token (FIFO) or 0 when none pending.
  int64_t NextDelegated();
  // Valid until FinishDelegated(token).
  const Delegated* GetDelegated(int64_t token);
  void FinishDelegated(int64_t token);
  // Write the externally computed result into the entry and complete its
  // handle; empty/NULL error means success. False if the handle is gone.
  bool CompleteDelegatedEntry(int64_t handle, const void* data,
                              size_t nbytes, const int64_t* shape, int ndim,
                              const char* error);

  int rank() const { return mux_->rank(); }
  int size() const { return mux_->size(); }
  uint64_t cycles() const { return cycles_; }
  uint64_t bytes_processed() const { return bytes_processed_; }
  Timeline* timeline() { return timeline_.get(); }

 private:
  Core(std::unique_ptr<Transport> base, const CoreOptions& opts);

  struct PsState {
    uint32_t channel;
    std::vector<int> members;           // global ranks, sorted
    int my_index;                       // -1 if not a member
    bool active = false;  // cycled only after cross-rank activation
    std::unique_ptr<ChannelView> view;
    std::unique_ptr<Controller> controller;
    std::vector<std::pair<Request, int64_t>> queue;  // pending (req, handle)
    std::map<std::string, int64_t> inflight;         // name -> handle
    std::vector<uint8_t> fusion_buffer;              // persistent
  };

  void ExecuteResponse(PsState& ps, const Response& resp, int* completed);
  void DelegateResponse(int ps_id, PsState& ps, const Response& resp);
  void CompleteHandle(int64_t handle, HandleState state,
                      const std::string& error);
  // Hierarchical-collective gate: process-set-local host indices when the
  // two-level path should engage for a buffer of `nbytes` (empty vector =
  // stay flat). Snapshots topology under mu_ (SetTopology is
  // runtime-settable).
  std::vector<int> HierViewHosts(const PsState& ps, int64_t nbytes);

  CoreOptions opts_;
  std::unique_ptr<MuxTransport> mux_;
  std::unique_ptr<Timeline> timeline_;
  std::vector<int> host_of_;            // empty = flat topology
  int64_t hierarchical_threshold_ = 0;  // bytes; 0 = disabled

  std::mutex mu_;  // guards handles_ + queues + process-set table
  std::condition_variable cv_;
  std::map<int, std::unique_ptr<PsState>> process_sets_;
  // Creation/removal is staged locally and applied only once every rank has
  // staged the same change (MIN-consensus through the global set's phase-A
  // exchange; see controller.h PsConsensus). Both lists are consumed FIFO,
  // which is why every rank must stage changes in the same order.
  std::vector<int> staged_adds_;      // ps ids awaiting activation
  std::vector<int> staged_removals_;  // ps ids awaiting removal
  int next_ps_id_ = 1;
  uint32_t next_channel_ = 1;
  std::map<int64_t, std::unique_ptr<Entry>> handles_;
  // Entries pinned by an in-flight ExecuteResponse (raw Entry* held without
  // mu_ during network execution). Release() defers destruction of pinned
  // entries into zombies_, freed when the response finishes.
  std::set<int64_t> executing_handles_;
  std::vector<std::unique_ptr<Entry>> zombies_;
  int64_t next_handle_ = 0;
  std::map<int64_t, Delegated> delegated_;  // token -> record
  std::deque<int64_t> delegated_order_;     // unclaimed tokens, FIFO
  int64_t next_token_ = 1;
  std::atomic<bool> shutdown_requested_{false};
  std::atomic<bool> shutdown_complete_{false};
  uint64_t cycles_ = 0;
  uint64_t bytes_processed_ = 0;
};

}  // namespace hvdcore

#endif  // HVDCORE_CORE_H_
