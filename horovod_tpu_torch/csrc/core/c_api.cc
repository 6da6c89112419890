// C API exported to the Python binding via ctypes.
//
// The reference exposes a ctypes-visible C API from its shared library
// (reference: horovod/common/operations.cc:887-1353 horovod_* functions,
// loaded by horovod/common/basics.py:48). Same pattern here: opaque context
// handle + flat-argument entry points. All functions are thread-safe w.r.t.
// the single cycle-driver thread plus any number of enqueueing threads.
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "core.h"

using namespace hvdcore;

namespace {
// Error strings returned to Python must outlive the call; keep them in a
// per-context slot guarded by a mutex.
struct Ctx {
  std::unique_ptr<Core> core;
  std::mutex err_mu;
  std::string last_error;
};

void SetErr(Ctx* c, const std::string& e) {
  std::lock_guard<std::mutex> g(c->err_mu);
  c->last_error = e;
}
}  // namespace

extern "C" {

// Returns an opaque context or nullptr (check hvd_core_last_error via a
// temporary context-less slot is impossible; errors at create go to stderr).
void* hvd_core_create(int rank, int size, const char* transport,
                      const char* peers, int64_t fusion_threshold,
                      int64_t cache_capacity, double stall_warning_s,
                      const char* timeline_path, int delegate_data_ops,
                      double stall_shutdown_s) {
  CoreOptions opts;
  if (fusion_threshold > 0) opts.controller.fusion_threshold = fusion_threshold;
  if (cache_capacity > 0)
    opts.controller.cache_capacity = static_cast<size_t>(cache_capacity);
  if (stall_warning_s > 0) opts.controller.stall_warning_s = stall_warning_s;
  if (stall_shutdown_s > 0) opts.controller.stall_shutdown_s = stall_shutdown_s;
  if (timeline_path) opts.timeline_path = timeline_path;
  opts.delegate_data_ops = delegate_data_ops != 0;
  auto ctx = std::make_unique<Ctx>();
  Status st = Core::Create(rank, size, transport ? transport : "tcp",
                           peers ? peers : "", opts, &ctx->core);
  if (!st.ok()) {
    LogMsg(LogLevel::kError, rank, "core create failed: " + st.reason);
    return nullptr;
  }
  return ctx.release();
}

void hvd_core_destroy(void* h) { delete static_cast<Ctx*>(h); }

// Autotune: apply an agreed fusion threshold at a cycle boundary.
void hvd_core_set_fusion_threshold(void* h, int64_t bytes) {
  static_cast<Ctx*>(h)->core->SetFusionThreshold(bytes);
}

// Host topology for hierarchical collectives: host_of[r] = host index of
// global rank r; threshold = min buffer bytes for the two-level path
// (0 disables).
void hvd_core_set_topology(void* h, const int32_t* host_of, int n,
                           int64_t threshold) {
  std::vector<int> hosts(host_of, host_of + n);
  static_cast<Ctx*>(h)->core->SetTopology(hosts, threshold);
}

// Rendezvous bootstrap: reserve (bind+listen) an ephemeral port that a
// later hvd_core_create consumes, closing the publish-then-rebind race.
int hvd_reserve_listen_port() { return ReserveListenPort(); }

// --- delegated execution (external XLA data plane) ------------------------

int64_t hvd_core_next_delegated(void* h) {
  return static_cast<Ctx*>(h)->core->NextDelegated();
}

// Fills the fixed-size fields; returns 0 on success, -1 for a bad token.
// sizes layout depends on type (allreduce: per-tensor flat sizes;
// allgather: [rows per rank..., row_elems]; broadcast: [count, root]).
int hvd_core_delegated_info(void* h, int64_t token, int32_t* ps_id,
                            int32_t* type, int32_t* dtype, int32_t* red_op,
                            double* prescale, double* postscale,
                            int32_t* ntensors, int32_t* nsizes) {
  const Core::Delegated* d =
      static_cast<Ctx*>(h)->core->GetDelegated(token);
  if (!d) return -1;
  *ps_id = d->ps_id;
  *type = static_cast<int32_t>(d->resp.type);
  *dtype = static_cast<int32_t>(d->resp.dtype);
  *red_op = static_cast<int32_t>(d->resp.op);
  *prescale = d->resp.prescale;
  *postscale = d->resp.postscale;
  *ntensors = static_cast<int32_t>(d->resp.names.size());
  *nsizes = static_cast<int32_t>(d->resp.sizes.size());
  return 0;
}

// handles_out: ntensors entries (-1 = entry-less); sizes_out: nsizes.
int hvd_core_delegated_meta(void* h, int64_t token, int64_t* handles_out,
                            int64_t* sizes_out) {
  const Core::Delegated* d =
      static_cast<Ctx*>(h)->core->GetDelegated(token);
  if (!d) return -1;
  for (size_t i = 0; i < d->handles.size(); ++i)
    handles_out[i] = d->handles[i];
  for (size_t i = 0; i < d->resp.sizes.size(); ++i)
    sizes_out[i] = d->resp.sizes[i];
  return 0;
}

int hvd_core_delegated_complete(void* h, int64_t handle, const void* data,
                                int64_t nbytes, const int64_t* shape,
                                int32_t ndim, const char* error) {
  return static_cast<Ctx*>(h)->core->CompleteDelegatedEntry(
             handle, data, static_cast<size_t>(nbytes), shape, ndim, error)
             ? 0
             : -1;
}

void hvd_core_delegated_finish(void* h, int64_t token) {
  static_cast<Ctx*>(h)->core->FinishDelegated(token);
}

int hvd_core_rank(void* h) { return static_cast<Ctx*>(h)->core->rank(); }
int hvd_core_size(void* h) { return static_cast<Ctx*>(h)->core->size(); }

int hvd_core_add_process_set(void* h, const int* ranks, int n) {
  std::vector<int> v(ranks, ranks + n);
  return static_cast<Ctx*>(h)->core->AddProcessSet(v);
}

int hvd_core_remove_process_set(void* h, int ps_id) {
  return static_cast<Ctx*>(h)->core->RemoveProcessSet(ps_id) ? 0 : -1;
}

// req_type / red_op / dtype match the enums in common.h. splits may be null.
// Returns handle >= 0, or a negative error code (-1 duplicate name, -2 bad
// arguments, -3 shut down, -4 not a member of the process set).
int64_t hvd_core_enqueue(void* h, int ps_id, const char* name, int req_type,
                         int red_op, int dtype, const void* data,
                         const int64_t* shape, int ndim, int root_rank,
                         double prescale, double postscale,
                         const int32_t* splits, int nsplits) {
  Ctx* c = static_cast<Ctx*>(h);
  Request req;
  req.type = static_cast<ReqType>(req_type);
  req.op = static_cast<RedOp>(red_op);
  req.dtype = static_cast<DataType>(dtype);
  req.name = name ? name : "";
  req.root_rank = root_rank;
  req.prescale = prescale;
  req.postscale = postscale;
  if (shape && ndim > 0) req.shape.assign(shape, shape + ndim);
  if (splits && nsplits > 0) req.splits.assign(splits, splits + nsplits);
  size_t nbytes = 0;
  if (req.type != ReqType::kBarrier && req.type != ReqType::kJoin) {
    int64_t n = 1;
    for (int64_t d : req.shape) n *= d;
    nbytes = static_cast<size_t>(n) * DataTypeSize(req.dtype);
  }
  return c->core->Enqueue(ps_id, req, data, nbytes);
}

// Returns completed count this cycle; -1 once shut down; -2 on transport
// failure (all in-flight handles are failed).
int hvd_core_run_cycle(void* h) {
  return static_cast<Ctx*>(h)->core->RunCycle();
}

void hvd_core_request_shutdown(void* h) {
  static_cast<Ctx*>(h)->core->RequestShutdown();
}

int hvd_core_shutdown_complete(void* h) {
  return static_cast<Ctx*>(h)->core->ShutdownComplete() ? 1 : 0;
}

// 0 = in progress, 1 = done, 2 = error (see hvd_core_handle_error).
int hvd_core_poll(void* h, int64_t handle) {
  std::string err;
  return static_cast<int>(static_cast<Ctx*>(h)->core->Poll(handle, &err));
}

int hvd_core_wait(void* h, int64_t handle, double timeout_s) {
  Ctx* c = static_cast<Ctx*>(h);
  Status st = c->core->Wait(handle, timeout_s);
  if (!st.ok()) {
    SetErr(c, st.reason);
    return -1;
  }
  return 0;
}

const char* hvd_core_handle_error(void* h, int64_t handle) {
  Ctx* c = static_cast<Ctx*>(h);
  std::string err;
  c->core->Poll(handle, &err);
  SetErr(c, err);
  std::lock_guard<std::mutex> g(c->err_mu);
  return c->last_error.c_str();
}

// Output access: ndim/shape/bytes. Copy the payload out before Release.
int hvd_core_output_ndim(void* h, int64_t handle) {
  const Entry* e = static_cast<Ctx*>(h)->core->Get(handle);
  return e ? static_cast<int>(e->out_shape.size()) : -1;
}

int hvd_core_output_shape(void* h, int64_t handle, int64_t* shape_out) {
  const Entry* e = static_cast<Ctx*>(h)->core->Get(handle);
  if (!e) return -1;
  for (size_t i = 0; i < e->out_shape.size(); ++i)
    shape_out[i] = e->out_shape[i];
  return static_cast<int>(e->out_shape.size());
}

int64_t hvd_core_output_nbytes(void* h, int64_t handle) {
  const Entry* e = static_cast<Ctx*>(h)->core->Get(handle);
  return e ? static_cast<int64_t>(e->output.size()) : -1;
}

int hvd_core_output_copy(void* h, int64_t handle, void* dst,
                         int64_t dst_bytes) {
  const Entry* e = static_cast<Ctx*>(h)->core->Get(handle);
  if (!e || dst_bytes < static_cast<int64_t>(e->output.size())) return -1;
  std::memcpy(dst, e->output.data(), e->output.size());
  return 0;
}

int hvd_core_recv_splits(void* h, int64_t handle, int32_t* out, int n) {
  const Entry* e = static_cast<Ctx*>(h)->core->Get(handle);
  if (!e || static_cast<int>(e->recv_splits.size()) > n) return -1;
  for (size_t i = 0; i < e->recv_splits.size(); ++i) out[i] = e->recv_splits[i];
  return static_cast<int>(e->recv_splits.size());
}

void hvd_core_release(void* h, int64_t handle) {
  static_cast<Ctx*>(h)->core->Release(handle);
}

uint64_t hvd_core_cycles(void* h) {
  return static_cast<Ctx*>(h)->core->cycles();
}

uint64_t hvd_core_bytes_processed(void* h) {
  return static_cast<Ctx*>(h)->core->bytes_processed();
}

}  // extern "C"
