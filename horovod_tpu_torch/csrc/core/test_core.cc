// Native-core unit test: N in-process threads act as N ranks over the
// LocalTransport hub (see transport.h). Covers the negotiation protocol,
// cache fast path, fusion, every collective, validation errors, process
// sets, and join. Exits non-zero on failure.
//
// (The reference only exercises its controller under real launchers in
// test/parallel/; in-process ranks make the same protocol testable from one
// binary.)
#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include "core.h"

using namespace hvdcore;

namespace {

std::atomic<int> failures{0};

#define CHECK(cond, msg)                                         \
  do {                                                           \
    if (!(cond)) {                                               \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, msg); \
      failures.fetch_add(1);                                     \
    }                                                            \
  } while (0)

void RunUntilDone(Core* core, int64_t handle) {
  std::string err;
  while (core->Poll(handle, &err) == HandleState::kInProgress) {
    int rc = core->RunCycle();
    if (rc < 0) break;
  }
}

Request MakeReq(ReqType type, const std::string& name, DataType dtype,
                std::vector<int64_t> shape, RedOp op = RedOp::kSum,
                int root = -1, double pre = 1.0, double post = 1.0,
                std::vector<int32_t> splits = {}) {
  Request r;
  r.type = type;
  r.name = name;
  r.dtype = dtype;
  r.shape = std::move(shape);
  r.op = op;
  r.root_rank = root;
  r.prescale = pre;
  r.postscale = post;
  r.splits = std::move(splits);
  return r;
}

void RankMain(int rank, int size, const std::string& job) {
  CoreOptions opts;
  opts.controller.fusion_threshold = 1 << 20;
  std::unique_ptr<Core> core;
  Status st = Core::Create(rank, size, "local", job, opts, &core);
  CHECK(st.ok(), st.reason.c_str());
  if (!st.ok()) return;

  // --- allreduce sum, three steady-state steps (exercises cache path) ----
  for (int step = 0; step < 3; ++step) {
    std::vector<float> data(37);
    for (size_t i = 0; i < data.size(); ++i)
      data[i] = static_cast<float>(rank + 1) * (i + 1);
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kAllreduce, "t.allreduce", DataType::kFloat32,
                   {37}),
        data.data(), data.size() * 4);
    CHECK(h >= 0, "enqueue allreduce");
    RunUntilDone(core.get(), h);
    std::string err;
    CHECK(core->Poll(h, &err) == HandleState::kDone, err.c_str());
    const Entry* e = core->Get(h);
    float expect_factor = size * (size + 1) / 2.0f;
    const float* out = reinterpret_cast<const float*>(e->output.data());
    bool good = true;
    for (size_t i = 0; i < data.size(); ++i)
      if (std::fabs(out[i] - expect_factor * (i + 1)) > 1e-3) good = false;
    CHECK(good, "allreduce values");
    core->Release(h);
  }

  // --- fused grouped allreduce: two tensors in one cycle -----------------
  {
    std::vector<double> a(16, rank + 1.0), b(8, 2.0 * rank);
    int64_t ha = core->Enqueue(
        0, MakeReq(ReqType::kAllreduce, "fuse.a", DataType::kFloat64, {16}),
        a.data(), a.size() * 8);
    int64_t hb = core->Enqueue(
        0, MakeReq(ReqType::kAllreduce, "fuse.b", DataType::kFloat64, {8}),
        b.data(), b.size() * 8);
    CHECK(ha >= 0 && hb >= 0, "enqueue fused");
    RunUntilDone(core.get(), ha);
    RunUntilDone(core.get(), hb);
    const Entry* ea = core->Get(ha);
    const Entry* eb = core->Get(hb);
    double sum_ranks = size * (size + 1) / 2.0;      // sum of (rank+1)
    double sum_2ranks = size * (size - 1.0);          // sum of 2*rank
    CHECK(std::fabs(reinterpret_cast<const double*>(ea->output.data())[0] -
                    sum_ranks) < 1e-9,
          "fused a");
    CHECK(std::fabs(reinterpret_cast<const double*>(eb->output.data())[7] -
                    sum_2ranks) < 1e-9,
          "fused b");
    core->Release(ha);
    core->Release(hb);
  }

  // --- allreduce min/max --------------------------------------------------
  {
    std::vector<int32_t> v(5, rank * 10);
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kAllreduce, "t.max", DataType::kInt32, {5},
                   RedOp::kMax),
        v.data(), v.size() * 4);
    RunUntilDone(core.get(), h);
    const Entry* e = core->Get(h);
    CHECK(reinterpret_cast<const int32_t*>(e->output.data())[0] ==
              (size - 1) * 10,
          "max value");
    core->Release(h);
  }

  // --- ragged allgather ---------------------------------------------------
  {
    int64_t rows = rank + 1;
    std::vector<float> v(rows * 2);
    for (int64_t i = 0; i < rows * 2; ++i) v[i] = rank * 100.0f + i;
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kAllgather, "t.allgather", DataType::kFloat32,
                   {rows, 2}),
        v.data(), v.size() * 4);
    CHECK(h >= 0, "enqueue allgather");
    RunUntilDone(core.get(), h);
    std::string err;
    CHECK(core->Poll(h, &err) == HandleState::kDone, err.c_str());
    const Entry* e = core->Get(h);
    int64_t total_rows = 0;
    for (int r = 0; r < size; ++r) total_rows += r + 1;
    CHECK(e->out_shape.size() == 2 && e->out_shape[0] == total_rows,
          "allgather shape");
    const float* out = reinterpret_cast<const float*>(e->output.data());
    // Block for rank r begins after sum_{q<r}(q+1) rows.
    int64_t off_rows = 0;
    bool good = true;
    for (int r = 0; r < size; ++r) {
      for (int64_t i = 0; i < (r + 1) * 2; ++i)
        if (std::fabs(out[off_rows * 2 + i] - (r * 100.0f + i)) > 1e-3)
          good = false;
      off_rows += r + 1;
    }
    CHECK(good, "allgather values");
    core->Release(h);
  }

  // --- broadcast from root 1 ---------------------------------------------
  {
    std::vector<int64_t> v(9, rank == 1 ? 4242 : -1);
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kBroadcast, "t.bcast", DataType::kInt64, {9},
                   RedOp::kSum, /*root=*/1),
        v.data(), v.size() * 8);
    RunUntilDone(core.get(), h);
    const Entry* e = core->Get(h);
    CHECK(reinterpret_cast<const int64_t*>(e->output.data())[8] == 4242,
          "broadcast value");
    core->Release(h);
  }

  // --- alltoall with uneven splits ----------------------------------------
  {
    // Rank r sends (d+1) rows to destination d; row payload = r*1000+d.
    std::vector<int32_t> splits(size);
    int64_t rows = 0;
    for (int d = 0; d < size; ++d) {
      splits[d] = d + 1;
      rows += d + 1;
    }
    std::vector<float> v(rows * 3);
    int64_t row = 0;
    for (int d = 0; d < size; ++d)
      for (int k = 0; k < d + 1; ++k, ++row)
        for (int c = 0; c < 3; ++c) v[row * 3 + c] = rank * 1000.0f + d;
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kAlltoall, "t.alltoall", DataType::kFloat32,
                   {rows, 3}, RedOp::kSum, -1, 1.0, 1.0, splits),
        v.data(), v.size() * 4);
    CHECK(h >= 0, "enqueue alltoall");
    RunUntilDone(core.get(), h);
    std::string err;
    CHECK(core->Poll(h, &err) == HandleState::kDone, err.c_str());
    const Entry* e = core->Get(h);
    // Every source sends us (rank+1) rows stamped src*1000+rank.
    CHECK(e->out_shape[0] == static_cast<int64_t>(size) * (rank + 1),
          "alltoall rows");
    const float* out = reinterpret_cast<const float*>(e->output.data());
    bool good = true;
    for (int src = 0; src < size; ++src)
      for (int k = 0; k < rank + 1; ++k) {
        int64_t r2 = static_cast<int64_t>(src) * (rank + 1) + k;
        if (std::fabs(out[r2 * 3] - (src * 1000.0f + rank)) > 1e-3)
          good = false;
      }
    CHECK(good, "alltoall values");
    CHECK(e->recv_splits.size() == static_cast<size_t>(size) &&
              e->recv_splits[0] == rank + 1,
          "alltoall recv splits");
    core->Release(h);
  }

  // --- reducescatter ------------------------------------------------------
  {
    int64_t rows = 2 * size + 1;  // uneven split
    std::vector<float> v(rows * 2, 1.0f + rank);
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kReducescatter, "t.rs", DataType::kFloat32,
                   {rows, 2}),
        v.data(), v.size() * 4);
    RunUntilDone(core.get(), h);
    std::string err;
    CHECK(core->Poll(h, &err) == HandleState::kDone, err.c_str());
    const Entry* e = core->Get(h);
    int64_t expect_rows = rows / size + (rank < rows % size ? 1 : 0);
    CHECK(e->out_shape[0] == expect_rows, "reducescatter shape");
    float expect = size * (size + 1) / 2.0f;
    CHECK(std::fabs(reinterpret_cast<const float*>(e->output.data())[0] -
                    expect) < 1e-3,
          "reducescatter value");
    core->Release(h);
  }

  // --- barrier ------------------------------------------------------------
  {
    int64_t h = core->Enqueue(
        0, MakeReq(ReqType::kBarrier, "t.barrier", DataType::kUint8, {}),
        nullptr, 0);
    RunUntilDone(core.get(), h);
    std::string err;
    CHECK(core->Poll(h, &err) == HandleState::kDone, "barrier");
    core->Release(h);
  }

  // --- validation error: mismatched dtype ---------------------------------
  {
    std::vector<uint8_t> v(8 * 4, 0);
    Request req = rank == 0
                      ? MakeReq(ReqType::kAllreduce, "t.bad", DataType::kInt32,
                                {8})
                      : MakeReq(ReqType::kAllreduce, "t.bad",
                                DataType::kFloat32, {8});
    int64_t h = core->Enqueue(0, req, v.data(), 8 * 4);
    RunUntilDone(core.get(), h);
    std::string err;
    CHECK(core->Poll(h, &err) == HandleState::kError, "mismatch should fail");
    CHECK(err.find("data types") != std::string::npos, err.c_str());
    core->Release(h);
  }

  // --- process set {0, size-1} -------------------------------------------
  {
    std::vector<int> members = {0, size - 1};
    int ps = core->AddProcessSet(members);
    CHECK(ps > 0, "add process set");
    bool member = rank == 0 || rank == size - 1;
    if (member) {
      std::vector<float> v(4, static_cast<float>(rank));
      int64_t h = core->Enqueue(
          ps, MakeReq(ReqType::kAllreduce, "ps.t", DataType::kFloat32, {4}),
          v.data(), 16);
      CHECK(h >= 0, "enqueue on subset");
      RunUntilDone(core.get(), h);
      const Entry* e = core->Get(h);
      CHECK(std::fabs(reinterpret_cast<const float*>(e->output.data())[0] -
                      (0.0f + size - 1)) < 1e-4,
            "subset allreduce");
      core->Release(h);
    } else {
      int64_t h = core->Enqueue(
          ps, MakeReq(ReqType::kAllreduce, "ps.t", DataType::kFloat32, {4}),
          nullptr, 16);
      CHECK(h == -4, "non-member enqueue rejected");
    }
    CHECK(core->RemoveProcessSet(ps), "remove process set");
  }

  // --- join ---------------------------------------------------------------
  {
    // Odd ranks join immediately; even ranks allreduce one more tensor
    // (joined ranks contribute zeros), then join.
    if (rank % 2 == 1) {
      int64_t hj = core->Enqueue(
          0, MakeReq(ReqType::kJoin, "__join__", DataType::kUint8, {}),
          nullptr, 0);
      RunUntilDone(core.get(), hj);
      std::string err;
      CHECK(core->Poll(hj, &err) == HandleState::kDone, "join done");
      core->Release(hj);
    } else {
      std::vector<float> v(6, 1.0f);
      int64_t h = core->Enqueue(
          0, MakeReq(ReqType::kAllreduce, "t.joined", DataType::kFloat32,
                     {6}),
          v.data(), 24);
      RunUntilDone(core.get(), h);
      std::string err;
      CHECK(core->Poll(h, &err) == HandleState::kDone, err.c_str());
      const Entry* e = core->Get(h);
      int evens = (size + 1) / 2;
      CHECK(std::fabs(reinterpret_cast<const float*>(e->output.data())[0] -
                      static_cast<float>(evens)) < 1e-4,
            "join-padded allreduce");
      core->Release(h);
      int64_t hj = core->Enqueue(
          0, MakeReq(ReqType::kJoin, "__join__", DataType::kUint8, {}),
          nullptr, 0);
      RunUntilDone(core.get(), hj);
      core->Release(hj);
    }
  }

  // --- coordinated shutdown ----------------------------------------------
  core->RequestShutdown();
  while (!core->ShutdownComplete()) {
    if (core->RunCycle() < 0) break;
  }
  CHECK(core->ShutdownComplete(), "shutdown consensus");
}

// Delegated mode: a delegatable request is enqueued without its bytes (the
// embedding runtime keeps the tensor, possibly on a GPU) and completed by
// the runtime with no output; the byte count is still checked, and every
// request the core executes itself still needs its input.
void DelegatedRankMain(int rank, int size, const std::string& job) {
  CoreOptions opts;
  opts.controller.fusion_threshold = 1 << 20;
  opts.delegate_data_ops = true;
  std::unique_ptr<Core> core;
  Status st = Core::Create(rank, size, "local", job, opts, &core);
  CHECK(st.ok(), st.reason.c_str());
  if (!st.ok()) return;

  // Two allreduces fused into one delegated response, and an allgather.
  int64_t ha = core->Enqueue(
      0, MakeReq(ReqType::kAllreduce, "d.a", DataType::kFloat32, {4, 8}),
      nullptr, 4 * 8 * 4);
  int64_t hb = core->Enqueue(
      0, MakeReq(ReqType::kAllreduce, "d.b", DataType::kFloat32, {5}),
      nullptr, 5 * 4);
  int64_t hg = core->Enqueue(
      0, MakeReq(ReqType::kAllgather, "d.g", DataType::kInt64,
                 {rank + 1, 3}),
      nullptr, (rank + 1) * 3 * 8);
  CHECK(ha >= 0 && hb >= 0 && hg >= 0, "null-input delegated enqueue");
  CHECK(core->Get(ha) && core->Get(ha)->input.empty(),
        "delegated entry stores no input");
  // Wrong byte count, and requests the core executes itself, are refused
  // without their input.
  CHECK(core->Enqueue(0, MakeReq(ReqType::kAllreduce, "d.bad",
                                 DataType::kFloat32, {5}),
                      nullptr, 16) == -2,
        "delegated byte count still checked");
  CHECK(core->Enqueue(0, MakeReq(ReqType::kAlltoall, "d.a2a",
                                 DataType::kFloat32, {2}, RedOp::kSum, -1,
                                 1.0, 1.0, std::vector<int32_t>(size, 0)),
                      nullptr, 8) == -2,
        "alltoall needs its input");
  CHECK(core->Enqueue(0, MakeReq(ReqType::kAllreduce, "d.adasum",
                                 DataType::kFloat32, {5}, RedOp::kAdasum),
                      nullptr, 20) == -2,
        "adasum needs its input");

  int seen = 0;
  bool fused = false, gathered = false;
  std::string err;
  while (core->Poll(ha, &err) == HandleState::kInProgress ||
         core->Poll(hb, &err) == HandleState::kInProgress ||
         core->Poll(hg, &err) == HandleState::kInProgress) {
    if (core->RunCycle() < 0) break;
    for (int64_t tok = core->NextDelegated(); tok != 0;
         tok = core->NextDelegated()) {
      const Core::Delegated* d = core->GetDelegated(tok);
      CHECK(d != nullptr, "delegated token");
      if (d->resp.type == ReqType::kAllreduce) {
        fused = d->resp.names.size() == 2 && d->resp.sizes.size() == 2 &&
                d->resp.sizes[0] == 32 && d->resp.sizes[1] == 5;
      } else if (d->resp.type == ReqType::kAllgather) {
        gathered = static_cast<int>(d->resp.sizes.size()) == size + 1 &&
                   d->resp.sizes[rank] == rank + 1 &&
                   d->resp.sizes[size] == 3;
      }
      for (int64_t h : d->handles) {
        CHECK(h >= 0, "delegated handle");
        CHECK(core->CompleteDelegatedEntry(h, nullptr, 0, nullptr, 0, ""),
              "complete with no output");
        ++seen;
      }
      core->FinishDelegated(tok);
    }
  }
  CHECK(fused, "two null-input allreduces fused into one response");
  CHECK(gathered, "allgather response carries every rank's rows");
  CHECK(seen == 3, "every delegated handle handed out once");
  for (int64_t h : {ha, hb, hg}) {
    CHECK(core->Poll(h, &err) == HandleState::kDone, err.c_str());
    core->Release(h);
  }

  core->RequestShutdown();
  while (!core->ShutdownComplete()) {
    if (core->RunCycle() < 0) break;
  }
  CHECK(core->ShutdownComplete(), "delegated shutdown consensus");
}

}  // namespace

int main() {
  for (int size : {2, 4}) {
    std::string job = "test_core_job_" + std::to_string(size);
    std::vector<std::thread> threads;
    for (int r = 0; r < size; ++r)
      threads.emplace_back(RankMain, r, size, job);
    for (auto& t : threads) t.join();
    std::printf("size=%d: %s\n", size,
                failures.load() == 0 ? "OK" : "FAILURES");
  }
  {
    const int size = 2;
    std::vector<std::thread> threads;
    for (int r = 0; r < size; ++r)
      threads.emplace_back(DelegatedRankMain, r, size,
                           std::string("test_core_delegated"));
    for (auto& t : threads) t.join();
    std::printf("delegated null input: %s\n",
                failures.load() == 0 ? "OK" : "FAILURES");
  }
  if (failures.load()) {
    std::printf("test_core: %d failure(s)\n", failures.load());
    return 1;
  }
  std::printf("test_core: all passed\n");
  return 0;
}
