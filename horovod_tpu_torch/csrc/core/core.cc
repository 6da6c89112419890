#include "core.h"

#include <map>

#include <algorithm>
#include <chrono>
#include <cstring>

namespace hvdcore {

// --- MuxTransport ----------------------------------------------------------

Status MuxTransport::Send(uint32_t ch, int to, const void* data, size_t len) {
  std::vector<uint8_t> framed(sizeof(uint32_t) + len);
  std::memcpy(framed.data(), &ch, sizeof(uint32_t));
  std::memcpy(framed.data() + sizeof(uint32_t), data, len);
  return base_->Send(to, framed.data(), framed.size());
}

Status MuxTransport::TakeFromInbox(uint32_t ch, int from,
                                   std::vector<uint8_t>* out, bool* found) {
  auto it = inbox_.find({ch, from});
  if (it != inbox_.end() && !it->second.empty()) {
    *out = std::move(it->second.front());
    it->second.erase(it->second.begin());
    *found = true;
  } else {
    *found = false;
  }
  return Status::OK();
}

namespace {
Status StripChannel(std::vector<uint8_t>* frame, uint32_t* ch) {
  if (frame->size() < sizeof(uint32_t))
    return Status::Error(StatusCode::kUnknownError, "short mux frame");
  std::memcpy(ch, frame->data(), sizeof(uint32_t));
  frame->erase(frame->begin(), frame->begin() + sizeof(uint32_t));
  return Status::OK();
}
}  // namespace

Status MuxTransport::Recv(uint32_t ch, int from, std::vector<uint8_t>* out) {
  bool found = false;
  TakeFromInbox(ch, from, out, &found);
  while (!found) {
    std::vector<uint8_t> frame;
    Status st = base_->Recv(from, &frame);
    if (!st.ok()) return st;
    uint32_t got = 0;
    st = StripChannel(&frame, &got);
    if (!st.ok()) return st;
    if (got == ch) {
      *out = std::move(frame);
      found = true;
    } else {
      inbox_[{got, from}].push_back(std::move(frame));
    }
  }
  return Status::OK();
}

Status MuxTransport::SendRecv(uint32_t ch, int to, const void* sdata,
                              size_t slen, int from,
                              std::vector<uint8_t>* out) {
  std::vector<uint8_t> framed(sizeof(uint32_t) + slen);
  std::memcpy(framed.data(), &ch, sizeof(uint32_t));
  std::memcpy(framed.data() + sizeof(uint32_t), sdata, slen);

  bool found = false;
  TakeFromInbox(ch, from, out, &found);
  if (found) return base_->Send(to, framed.data(), framed.size());

  std::vector<uint8_t> frame;
  Status st = base_->SendRecv(to, framed.data(), framed.size(), from, &frame);
  if (!st.ok()) return st;
  while (true) {
    uint32_t got = 0;
    st = StripChannel(&frame, &got);
    if (!st.ok()) return st;
    if (got == ch) {
      *out = std::move(frame);
      return Status::OK();
    }
    inbox_[{got, from}].push_back(std::move(frame));
    st = base_->Recv(from, &frame);
    if (!st.ok()) return st;
  }
}

// --- Core ------------------------------------------------------------------

Core::Core(std::unique_ptr<Transport> base, const CoreOptions& opts)
    : opts_(opts), mux_(new MuxTransport(std::move(base))) {
  if (!opts_.timeline_path.empty())
    timeline_.reset(new Timeline(opts_.timeline_path, mux_->rank()));
}

Status Core::Create(int rank, int size, const std::string& transport_kind,
                    const std::string& peers, const CoreOptions& opts,
                    std::unique_ptr<Core>* out) {
  std::unique_ptr<Transport> base;
  if (transport_kind == "local") {
    base = LocalTransport::Create(peers, rank, size);
  } else if (transport_kind == "tcp") {
    std::vector<std::string> addrs;
    size_t pos = 0;
    while (pos <= peers.size()) {
      size_t comma = peers.find(',', pos);
      if (comma == std::string::npos) comma = peers.size();
      if (comma > pos) addrs.push_back(peers.substr(pos, comma - pos));
      pos = comma + 1;
    }
    if (static_cast<int>(addrs.size()) != size)
      return Status::Error(StatusCode::kInvalidArgument,
                           "peer list size != world size");
    std::unique_ptr<TcpTransport> tcp;
    Status st = TcpTransport::Create(rank, addrs, 60.0, &tcp);
    if (!st.ok()) return st;
    base = std::move(tcp);
  } else {
    return Status::Error(StatusCode::kInvalidArgument,
                         "unknown transport " + transport_kind);
  }
  std::unique_ptr<Core> core(new Core(std::move(base), opts));
  // Global process set (id 0) spans all ranks (reference: process set 0,
  // horovod/common/process_set.cc).
  std::vector<int> all(size);
  for (int i = 0; i < size; ++i) all[i] = i;
  {
    std::lock_guard<std::mutex> g(core->mu_);
    auto ps = std::make_unique<PsState>();
    ps->channel = 0;
    ps->members = all;
    ps->my_index = rank;
    ps->active = true;
    ps->view.reset(
        new ChannelView(core->mux_.get(), 0, ps->members, ps->my_index));
    ps->controller.reset(new Controller(ps->view.get(), opts.controller,
                                        core->timeline_.get()));
    core->process_sets_[0] = std::move(ps);
  }
  *out = std::move(core);
  return Status::OK();
}

int Core::AddProcessSet(const std::vector<int>& ranks) {
  std::vector<int> members = ranks;
  std::sort(members.begin(), members.end());
  members.erase(std::unique(members.begin(), members.end()), members.end());
  std::lock_guard<std::mutex> g(mu_);
  int ps_id = next_ps_id_++;
  auto ps = std::make_unique<PsState>();
  ps->channel = next_channel_++;
  ps->members = members;
  auto it = std::find(members.begin(), members.end(), mux_->rank());
  ps->my_index = it == members.end()
                     ? -1
                     : static_cast<int>(it - members.begin());
  if (ps->my_index >= 0) {
    ps->view.reset(new ChannelView(mux_.get(), ps->channel, ps->members,
                                   ps->my_index));
    ps->controller.reset(
        new Controller(ps->view.get(), opts_.controller, timeline_.get()));
  }
  process_sets_[ps_id] = std::move(ps);
  staged_adds_.push_back(ps_id);  // activates once all ranks staged it
  return ps_id;
}

bool Core::RemoveProcessSet(int ps_id) {
  std::lock_guard<std::mutex> g(mu_);
  if (ps_id == 0) return false;
  auto it = process_sets_.find(ps_id);
  if (it == process_sets_.end()) return false;
  staged_removals_.push_back(ps_id);  // applied once all ranks staged it
  return true;
}

int64_t Core::Enqueue(int ps_id, const Request& req, const void* data,
                      size_t nbytes) {
  std::lock_guard<std::mutex> g(mu_);
  if (shutdown_complete_.load()) return -3;
  auto it = process_sets_.find(ps_id);
  if (it == process_sets_.end() || it->second->my_index < 0) return -4;
  PsState& ps = *it->second;
  if (ps.inflight.count(req.name)) return -1;  // DUPLICATE_NAME_ERROR analog
  int64_t expect = 1;
  for (int64_t d : req.shape) expect *= d;
  if (req.type != ReqType::kBarrier && req.type != ReqType::kJoin &&
      nbytes != static_cast<size_t>(expect) * DataTypeSize(req.dtype))
    return -2;
  // A request the embedding runtime will execute (the list DelegateResponse
  // delegates) comes without its bytes: the runtime keeps its own tensor,
  // which may live on a GPU, and the core never reads it. Every other
  // request needs its input here.
  const bool delegated =
      opts_.delegate_data_ops && req.op != RedOp::kAdasum &&
      (req.type == ReqType::kAllreduce || req.type == ReqType::kAllgather ||
       req.type == ReqType::kBroadcast ||
       req.type == ReqType::kReducescatter);
  if (data == nullptr && nbytes && !delegated) return -2;

  int64_t handle = next_handle_++;
  auto entry = std::make_unique<Entry>();
  entry->req = req;
  entry->req.rank = ps.my_index;
  if (nbytes && data) {
    entry->input.resize(nbytes);
    std::memcpy(entry->input.data(), data, nbytes);
  }
  handles_[handle] = std::move(entry);
  ps.inflight[req.name] = handle;
  ps.queue.emplace_back(handles_[handle]->req, handle);
  return handle;
}

void Core::SetFusionThreshold(int64_t bytes) {
  std::lock_guard<std::mutex> g(mu_);
  opts_.controller.fusion_threshold = bytes;  // future process sets
  for (auto& kv : process_sets_)
    if (kv.second->controller)
      kv.second->controller->set_fusion_threshold(bytes);
}

void Core::SetTopology(const std::vector<int>& host_of, int64_t threshold) {
  std::lock_guard<std::mutex> g(mu_);
  host_of_ = host_of;
  hierarchical_threshold_ = threshold;
}

std::vector<int> Core::HierViewHosts(const PsState& ps, int64_t nbytes) {
  std::vector<int> topo;
  {
    std::lock_guard<std::mutex> g(mu_);
    // Scalar checks first: the common small-tensor path must not pay an
    // O(world) vector copy just to discover the gate is closed.
    if (hierarchical_threshold_ <= 0 || nbytes < hierarchical_threshold_ ||
        host_of_.empty())
      return {};
    topo = host_of_;
  }
  std::vector<int> view_hosts;
  view_hosts.reserve(ps.members.size());
  for (int g : ps.members) {
    if (g < 0 || g >= static_cast<int>(topo.size())) return {};
    view_hosts.push_back(topo[g]);
  }
  // Only worth engaging (and only honest to timeline as HIERARCHICAL_*)
  // when the view spans >1 host AND some host holds >1 rank.
  std::map<int, int> counts;
  for (int h : view_hosts) ++counts[h];
  if (counts.size() < 2 || counts.size() == view_hosts.size()) return {};
  return view_hosts;
}

void Core::CompleteHandle(int64_t handle, HandleState state,
                          const std::string& error) {
  auto it = handles_.find(handle);
  if (it == handles_.end()) return;
  it->second->state = state;
  it->second->error = error;
  cv_.notify_all();
}

int Core::RunCycle() {
  if (shutdown_complete_.load()) return -1;
  int completed = 0;
  bool want_shutdown = shutdown_requested_.load();
  bool all_shutdown = false;

  // One process set's negotiation + execution. Returns false on transport
  // failure (everything in flight is failed; the elastic layer turns this
  // into restore+reinit, reference: horovod/common/elastic.py:151).
  auto cycle_ps = [&](int ps_id, PsState* ps, const PsConsensus& staged,
                      PsConsensus* agreed) -> bool {
    std::vector<std::pair<Request, int64_t>> pending;
    {
      std::lock_guard<std::mutex> g(mu_);
      pending.swap(ps->queue);
    }
    std::vector<Request> reqs;
    reqs.reserve(pending.size());
    for (auto& p : pending) reqs.push_back(p.first);

    CycleResult result;
    // Only the global set carries shutdown + process-set consensus (the
    // reference ties both to the global state, operations.cc RunLoopOnce).
    Status st = ps->controller->ComputeResponseList(
        std::move(reqs), ps_id == 0 && want_shutdown, staged, &result);
    if (!st.ok()) {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& kv : ps->inflight)
        CompleteHandle(kv.second, HandleState::kError, st.reason);
      ps->inflight.clear();
      shutdown_complete_.store(true);
      return false;
    }
    // Requeue cache hits some rank has not caught up to yet.
    if (!result.requeue.empty()) {
      std::lock_guard<std::mutex> g(mu_);
      std::map<std::string, int64_t> handles_by_name;
      for (auto& p : pending) handles_by_name[p.first.name] = p.second;
      for (Request& r : result.requeue)
        ps->queue.emplace_back(r, handles_by_name[r.name]);
    }
    for (const Response& resp : result.to_execute.responses) {
      // Data ops can be delegated to the external (XLA) data plane; error
      // responses, alltoall (uneven splits need the TCP plane), barrier,
      // and join always run natively.
      bool delegatable =
          opts_.delegate_data_ops && resp.error.empty() &&
          resp.op != RedOp::kAdasum &&  // VHDD stays on the host plane
          (resp.type == ReqType::kAllreduce ||
           resp.type == ReqType::kAllgather ||
           resp.type == ReqType::kBroadcast ||
           resp.type == ReqType::kReducescatter);
      if (delegatable)
        DelegateResponse(ps_id, *ps, resp);
      else
        ExecuteResponse(*ps, resp, &completed);
    }
    if (ps_id == 0 && result.shutdown) all_shutdown = true;
    if (agreed) *agreed = result.agreed_ps;
    ++cycles_;
    return true;
  };

  // Phase 1: global set — always active, carries the consensus counters.
  PsConsensus staged, agreed;
  {
    std::lock_guard<std::mutex> g(mu_);
    staged.adds = static_cast<uint32_t>(staged_adds_.size());
    staged.removals = static_cast<uint32_t>(staged_removals_.size());
  }
  if (!cycle_ps(0, process_sets_.at(0).get(), staged, &agreed)) return -2;

  // Apply agreed process-set changes: every rank activates/removes the same
  // FIFO prefix this cycle, so channel schedules stay aligned.
  std::vector<int> active_ids;
  {
    std::lock_guard<std::mutex> g(mu_);
    for (uint32_t i = 0; i < agreed.adds && !staged_adds_.empty(); ++i) {
      int id = staged_adds_.front();
      staged_adds_.erase(staged_adds_.begin());
      auto it = process_sets_.find(id);
      if (it != process_sets_.end()) it->second->active = true;
    }
    for (uint32_t i = 0; i < agreed.removals && !staged_removals_.empty();
         ++i) {
      int id = staged_removals_.front();
      staged_removals_.erase(staged_removals_.begin());
      auto it = process_sets_.find(id);
      if (it == process_sets_.end()) continue;
      for (auto& kv : it->second->inflight)
        CompleteHandle(kv.second, HandleState::kError, "process set removed");
      process_sets_.erase(it);
    }
    for (auto& kv : process_sets_)
      if (kv.first != 0 && kv.second->active && kv.second->my_index >= 0)
        active_ids.push_back(kv.first);
  }

  // Phase 2: the other active sets, in id order on every rank.
  for (int ps_id : active_ids) {
    PsState* ps;
    {
      std::lock_guard<std::mutex> g(mu_);
      auto it = process_sets_.find(ps_id);
      if (it == process_sets_.end()) continue;
      ps = it->second.get();
    }
    if (!cycle_ps(ps_id, ps, PsConsensus{}, nullptr)) return -2;
  }
  if (all_shutdown) shutdown_complete_.store(true);
  return completed;
}

void Core::ExecuteResponse(PsState& ps, const Response& resp, int* completed) {
  Transport* view = ps.view.get();
  const size_t esize = DataTypeSize(resp.dtype);

  // Resolve the entries this rank owns for the response's names.
  std::vector<Entry*> entries(resp.names.size(), nullptr);
  std::vector<int64_t> handles(resp.names.size(), -1);
  {
    std::lock_guard<std::mutex> g(mu_);
    for (size_t i = 0; i < resp.names.size(); ++i) {
      auto it = ps.inflight.find(resp.names[i]);
      if (it == ps.inflight.end()) continue;
      auto hit = handles_.find(it->second);
      if (hit == handles_.end()) {
        // Handle was Released while still negotiating (caller gave up);
        // drop the stale in-flight name and participate entry-less, like a
        // joined rank.
        ps.inflight.erase(it);
        continue;
      }
      handles[i] = it->second;
      entries[i] = hit->second.get();
      executing_handles_.insert(it->second);
    }
  }
  auto finish = [&](size_t i, HandleState state, const std::string& err) {
    if (handles[i] < 0) return;
    std::lock_guard<std::mutex> g(mu_);
    // Only drop the inflight mapping if it still points at the handle we
    // resolved — a Release + same-name resubmit mid-flight installs a new
    // handle that must keep its mapping.
    auto it = ps.inflight.find(resp.names[i]);
    if (it != ps.inflight.end() && it->second == handles[i])
      ps.inflight.erase(it);
    CompleteHandle(handles[i], state, err);
    ++*completed;
  };
  auto fail_all = [&](const std::string& err) {
    for (size_t i = 0; i < resp.names.size(); ++i)
      finish(i, HandleState::kError, err);
  };
  auto unpin = [&] {
    std::lock_guard<std::mutex> g(mu_);
    for (int64_t h : handles)
      if (h >= 0) executing_handles_.erase(h);
    if (executing_handles_.empty()) zombies_.clear();
  };

  if (!resp.error.empty()) {
    fail_all(resp.error);
    unpin();
    return;
  }
  if (timeline_ && !resp.names.empty())
    timeline_->OpStart(resp.names[0], "EXEC");

  Status st = Status::OK();
  switch (resp.type) {
    case ReqType::kAllreduce: {
      int64_t total = 0;
      for (int64_t n : resp.sizes) total += n;
      uint8_t* buf = nullptr;
      bool fused = resp.names.size() > 1 || entries[0] == nullptr;
      if (fused) {
        if (timeline_)
          timeline_->ActivityStart(resp.names[0], "MEMCPY_IN_FUSION_BUFFER");
        ps.fusion_buffer.resize(static_cast<size_t>(total) * esize);
        size_t off = 0;
        for (size_t i = 0; i < resp.names.size(); ++i) {
          size_t n = static_cast<size_t>(resp.sizes[i]) * esize;
          if (entries[i]) {
            std::memcpy(ps.fusion_buffer.data() + off,
                        entries[i]->input.data(), n);
            // Prescale applies to contributed data only; the identity
            // slots below must stay exact (0.5 * 1.0 would corrupt prod).
            if (resp.prescale != 1.0)
              ScaleBuffer(ps.fusion_buffer.data() + off, resp.sizes[i],
                          resp.dtype, resp.prescale);
          } else {
            // Joined/entry-less rank: contribute the op's identity element
            // (zeros would corrupt min/max/prod results).
            FillReduceIdentity(ps.fusion_buffer.data() + off, resp.sizes[i],
                               resp.dtype, resp.op);
          }
          off += n;
        }
        buf = ps.fusion_buffer.data();
        if (timeline_) timeline_->ActivityEnd(resp.names[0]);
      } else {
        buf = entries[0]->input.data();
      }
      if (!fused && resp.prescale != 1.0)
        ScaleBuffer(buf, total, resp.dtype, resp.prescale);
      // Two-level path: engaged for large buffers on a known multi-host
      // topology (SetTopology; see HierViewHosts).
      std::vector<int> view_hosts;
      if (resp.op != RedOp::kAdasum)
        view_hosts =
            HierViewHosts(ps, static_cast<int64_t>(total * esize));
      const bool hier = !view_hosts.empty();
      if (timeline_)
        timeline_->ActivityStart(resp.names[0],
                                 resp.op == RedOp::kAdasum
                                     ? "VHDD_ADASUM"
                                     : (hier ? "HIERARCHICAL_ALLREDUCE"
                                             : "RING_ALLREDUCE"));
      if (resp.op == RedOp::kAdasum) {
        st = VhddAdasum(view, buf, total, resp.dtype);
      } else if (hier) {
        st = HierarchicalAllreduce(view, buf, total, resp.dtype, resp.op,
                                   view_hosts);
        // Heterogeneous local sizes are detected inside; fall back flat.
        if (!st.ok() && st.code == StatusCode::kInvalidArgument)
          st = RingAllreduce(view, buf, total, resp.dtype, resp.op);
      } else {
        st = RingAllreduce(view, buf, total, resp.dtype, resp.op);
      }
      if (timeline_) timeline_->ActivityEnd(resp.names[0]);
      if (st.ok() && resp.postscale != 1.0)
        ScaleBuffer(buf, total, resp.dtype, resp.postscale);
      if (st.ok()) {
        size_t off = 0;
        for (size_t i = 0; i < resp.names.size(); ++i) {
          size_t n = static_cast<size_t>(resp.sizes[i]) * esize;
          if (entries[i]) {
            if (fused) {
              entries[i]->output.assign(buf + off, buf + off + n);
            } else {
              entries[i]->output = std::move(entries[i]->input);
            }
            entries[i]->out_shape = entries[i]->req.shape;
            finish(i, HandleState::kDone, "");
          }
          off += n;
        }
        bytes_processed_ += static_cast<uint64_t>(total) * esize;
      }
      break;
    }
    case ReqType::kAllgather: {
      // sizes = [rows per rank..., row_elems]
      const int n = view->size();
      if (static_cast<int>(resp.sizes.size()) != n + 1) {
        st = Status::Error(StatusCode::kUnknownError, "bad allgather sizes");
        break;
      }
      int64_t row_elems = resp.sizes[n];
      std::vector<int64_t> counts(n);
      int64_t total = 0, total_rows = 0;
      for (int i = 0; i < n; ++i) {
        counts[i] = resp.sizes[i] * row_elems;
        total += counts[i];
        total_rows += resp.sizes[i];
      }
      Entry* e = entries[0];
      std::vector<uint8_t> out(static_cast<size_t>(total) * esize);
      std::vector<uint8_t> scratch;
      const void* sendbuf = e ? e->input.data() : nullptr;
      if (!e && counts[view->rank()] > 0) {
        // Negotiation listed this rank with rows but the entry is gone
        // (released mid-flight): contribute zeros so peers don't hang.
        scratch.assign(static_cast<size_t>(counts[view->rank()]) * esize, 0);
        sendbuf = scratch.data();
      }
      // Two-level path mirrors the allreduce gate (see HierViewHosts).
      std::vector<int> view_hosts =
          HierViewHosts(ps, static_cast<int64_t>(total * esize));
      if (!view_hosts.empty()) {
        if (timeline_)
          timeline_->ActivityStart(resp.names[0],
                                   "HIERARCHICAL_ALLGATHER");
        st = HierarchicalAllgatherv(view, sendbuf, out.data(), counts,
                                    resp.dtype, view_hosts);
        if (timeline_) timeline_->ActivityEnd(resp.names[0]);
      } else {
        st = RingAllgatherv(view, sendbuf, out.data(), counts,
                            resp.dtype);
      }
      if (st.ok() && e) {
        e->output = std::move(out);
        e->out_shape = e->req.shape;
        if (!e->out_shape.empty()) e->out_shape[0] = total_rows;
        bytes_processed_ += static_cast<uint64_t>(total) * esize;
        finish(0, HandleState::kDone, "");
      }
      break;
    }
    case ReqType::kBroadcast: {
      int64_t count = resp.sizes.empty() ? 0 : resp.sizes[0];
      int root = resp.sizes.size() > 1 ? static_cast<int>(resp.sizes[1]) : 0;
      Entry* e = entries[0];
      std::vector<uint8_t> scratch;
      uint8_t* buf;
      if (e) {
        buf = e->input.data();
      } else {
        scratch.resize(static_cast<size_t>(count) * esize);
        buf = scratch.data();
      }
      st = TreeBroadcast(view, buf, count, resp.dtype, root);
      if (st.ok() && e) {
        e->output = std::move(e->input);
        e->out_shape = e->req.shape;
        bytes_processed_ += static_cast<uint64_t>(count) * esize;
        finish(0, HandleState::kDone, "");
      }
      break;
    }
    case ReqType::kAlltoall: {
      const int n = view->size();
      const int me = view->rank();
      Entry* e = entries[0];
      if (!e || static_cast<int>(resp.sizes.size()) != n * n) {
        st = Status::Error(StatusCode::kUnknownError, "bad alltoall state");
        break;
      }
      int64_t row_elems = 1;
      for (size_t d = 1; d < e->req.shape.size(); ++d)
        row_elems *= e->req.shape[d];
      std::vector<int64_t> send_splits(n), recv_splits(n);
      int64_t recv_total = 0, recv_rows = 0;
      for (int d = 0; d < n; ++d) {
        send_splits[d] = resp.sizes[static_cast<size_t>(me) * n + d] * row_elems;
        recv_splits[d] = resp.sizes[static_cast<size_t>(d) * n + me] * row_elems;
        recv_total += recv_splits[d];
        recv_rows += resp.sizes[static_cast<size_t>(d) * n + me];
      }
      e->output.resize(static_cast<size_t>(recv_total) * esize);
      st = PairwiseAlltoallv(view, e->input.data(), e->output.data(),
                             send_splits, recv_splits, resp.dtype);
      if (st.ok()) {
        e->out_shape = e->req.shape;
        if (!e->out_shape.empty()) e->out_shape[0] = recv_rows;
        e->recv_splits.resize(n);
        for (int d = 0; d < n; ++d)
          e->recv_splits[d] =
              static_cast<int32_t>(resp.sizes[static_cast<size_t>(d) * n + me]);
        bytes_processed_ += static_cast<uint64_t>(recv_total) * esize;
        finish(0, HandleState::kDone, "");
      }
      break;
    }
    case ReqType::kReducescatter: {
      const int n = view->size();
      const int me = view->rank();
      Entry* e = entries[0];
      if (!e) {
        st = Status::Error(StatusCode::kUnknownError,
                           "reducescatter with no local entry");
        break;
      }
      int64_t rows = e->req.shape.empty() ? 1 : e->req.shape[0];
      int64_t row_elems = 1;
      for (size_t d = 1; d < e->req.shape.size(); ++d)
        row_elems *= e->req.shape[d];
      // First dim split evenly, remainder to lower ranks (reference:
      // reducescatter output sizing in collective_operations.cc).
      std::vector<int64_t> recv_counts(n);
      int64_t base = rows / n, rem = rows % n;
      for (int i = 0; i < n; ++i)
        recv_counts[i] = (base + (i < rem ? 1 : 0)) * row_elems;
      int64_t my_rows = base + (me < rem ? 1 : 0);
      e->output.resize(static_cast<size_t>(recv_counts[me]) * esize);
      st = RingReducescatter(view, e->input.data(), e->output.data(),
                             recv_counts, resp.dtype, resp.op);
      if (st.ok()) {
        if (resp.postscale != 1.0)
          ScaleBuffer(e->output.data(), recv_counts[me], resp.dtype,
                      resp.postscale);
        e->out_shape = e->req.shape;
        if (!e->out_shape.empty()) e->out_shape[0] = my_rows;
        bytes_processed_ +=
            static_cast<uint64_t>(recv_counts[me]) * esize;
        finish(0, HandleState::kDone, "");
      }
      break;
    }
    case ReqType::kBarrier: {
      st = DisseminationBarrier(view);
      if (st.ok()) finish(0, HandleState::kDone, "");
      break;
    }
    case ReqType::kJoin: {
      Entry* e = entries[0];
      if (e) {
        e->output.resize(sizeof(int32_t));
        int32_t last = resp.last_joined_rank;
        std::memcpy(e->output.data(), &last, sizeof(int32_t));
        e->out_shape.clear();
        finish(0, HandleState::kDone, "");
      }
      break;
    }
  }
  if (!st.ok()) fail_all(st.reason);
  if (timeline_ && !resp.names.empty()) timeline_->OpEnd(resp.names[0]);
  unpin();
}

void Core::DelegateResponse(int ps_id, PsState& ps, const Response& resp) {
  Delegated d;
  d.ps_id = ps_id;
  d.resp = resp;
  d.handles.assign(resp.names.size(), -1);
  std::lock_guard<std::mutex> g(mu_);
  for (size_t i = 0; i < resp.names.size(); ++i) {
    auto it = ps.inflight.find(resp.names[i]);
    if (it == ps.inflight.end()) continue;
    if (handles_.find(it->second) == handles_.end()) {
      // Released while negotiating: participate entry-less.
      ps.inflight.erase(it);
      continue;
    }
    d.handles[i] = it->second;
    // The name frees once execution starts (reference: the entry is popped
    // from the tensor queue at PerformOperation); completion later is by
    // handle, not name.
    ps.inflight.erase(it);
  }
  // Queue even with zero local entries: a joined rank is still a member of
  // the external collective and must contribute identity data.
  int64_t token = next_token_++;
  delegated_order_.push_back(token);
  delegated_.emplace(token, std::move(d));
}

int64_t Core::NextDelegated() {
  std::lock_guard<std::mutex> g(mu_);
  if (delegated_order_.empty()) return 0;
  int64_t token = delegated_order_.front();
  delegated_order_.pop_front();
  return token;
}

const Core::Delegated* Core::GetDelegated(int64_t token) {
  std::lock_guard<std::mutex> g(mu_);
  auto it = delegated_.find(token);
  return it == delegated_.end() ? nullptr : &it->second;
}

void Core::FinishDelegated(int64_t token) {
  std::lock_guard<std::mutex> g(mu_);
  delegated_.erase(token);
}

bool Core::CompleteDelegatedEntry(int64_t handle, const void* data,
                                  size_t nbytes, const int64_t* shape,
                                  int ndim, const char* error) {
  std::lock_guard<std::mutex> g(mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return false;  // released while delegated
  Entry* e = it->second.get();
  if (error && error[0]) {
    e->state = HandleState::kError;
    e->error = error;
  } else {
    e->output.assign(static_cast<const uint8_t*>(data),
                     static_cast<const uint8_t*>(data) + nbytes);
    e->out_shape.assign(shape, shape + ndim);
    e->input.clear();
    e->input.shrink_to_fit();
    e->state = HandleState::kDone;
    bytes_processed_ += nbytes;
  }
  cv_.notify_all();
  return true;
}

HandleState Core::Poll(int64_t handle, std::string* error) {
  std::lock_guard<std::mutex> g(mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) {
    if (error) *error = "unknown handle";
    return HandleState::kError;
  }
  if (error) *error = it->second->error;
  return it->second->state;
}

Status Core::Wait(int64_t handle, double timeout_s) {
  std::unique_lock<std::mutex> g(mu_);
  auto done = [&] {
    auto it = handles_.find(handle);
    return it == handles_.end() ||
           it->second->state != HandleState::kInProgress;
  };
  if (!cv_.wait_for(g, std::chrono::duration<double>(timeout_s), done))
    return Status::Error(StatusCode::kUnknownError, "wait timed out");
  return Status::OK();
}

const Entry* Core::Get(int64_t handle) {
  std::lock_guard<std::mutex> g(mu_);
  auto it = handles_.find(handle);
  return it == handles_.end() ? nullptr : it->second.get();
}

void Core::Release(int64_t handle) {
  std::lock_guard<std::mutex> g(mu_);
  // Drop any in-flight name still pointing at this handle so a later
  // response does not resolve to a dead entry.
  for (auto& kv : process_sets_) {
    auto& inflight = kv.second->inflight;
    for (auto it = inflight.begin(); it != inflight.end();) {
      if (it->second == handle)
        it = inflight.erase(it);
      else
        ++it;
    }
  }
  auto h = handles_.find(handle);
  if (h != handles_.end()) {
    // The cycle thread may hold a raw Entry* for this handle mid-collective
    // (mu_ is dropped during network execution) — defer destruction until
    // the response finishes instead of freeing under its feet.
    if (executing_handles_.count(handle)) zombies_.push_back(std::move(h->second));
    handles_.erase(h);
  }
}

}  // namespace hvdcore
