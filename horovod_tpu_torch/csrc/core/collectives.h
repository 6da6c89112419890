// CPU data-plane collectives over a point-to-point Transport.
//
// This is the native core's gloo-analog op set (reference:
// horovod/common/ops/gloo_operations.cc, mpi_operations.cc). Algorithms are
// the classic bandwidth-optimal ones: ring allreduce (reduce-scatter +
// allgather), ring allgatherv, binomial-tree broadcast, pairwise alltoallv,
// dissemination barrier. On TPU the data plane is XLA/ICI (Python side);
// these run the same negotiated schedule for CPU-only SPMD jobs and tests.
#ifndef HVDCORE_COLLECTIVES_H_
#define HVDCORE_COLLECTIVES_H_

#include <cstdint>
#include <vector>

#include "common.h"
#include "transport.h"

namespace hvdcore {

// In-place allreduce over `count` elements of `dtype` at `buf`.
Status RingAllreduce(Transport* t, void* buf, int64_t count, DataType dtype,
                     RedOp op);

// Rank-subset adapter: expose members of a parent transport as a dense
// 0..k-1 transport (the SubsetTransport of the hierarchical algorithms;
// the mux-channel twin for process sets is core.h ChannelView).
class SubsetTransport : public Transport {
 public:
  // members: parent ranks in subset order; my_index: this rank's slot.
  SubsetTransport(Transport* base, std::vector<int> members, int my_index)
      : base_(base), members_(std::move(members)), my_index_(my_index) {}
  int rank() const override { return my_index_; }
  int size() const override { return static_cast<int>(members_.size()); }
  Status Send(int to, const void* data, size_t len) override {
    return base_->Send(members_[to], data, len);
  }
  Status Recv(int from, std::vector<uint8_t>* out) override {
    return base_->Recv(members_[from], out);
  }
  Status SendRecv(int to, const void* sdata, size_t slen, int from,
                  std::vector<uint8_t>* out) override {
    return base_->SendRecv(members_[to], sdata, slen, members_[from], out);
  }
  void Close() override {}

 private:
  Transport* base_;
  std::vector<int> members_;
  int my_index_;
};

// Two-level allreduce for multi-host topologies (reference:
// horovod/common/ops/nccl_operations.cc:267 NCCLHierarchicalAllreduce /
// mpi_operations.cc:331 shared-mem hierarchical allgather): intra-host
// reduce-scatter to spread the load, cross-host ring allreduce among the
// per-host shards, intra-host allgather. host_of[r] = host index of
// transport rank r. Cross-host traffic drops from N ring peers to
// num_hosts, which is the win once per-host rank counts grow.
Status HierarchicalAllreduce(Transport* t, void* buf, int64_t count,
                             DataType dtype, RedOp op,
                             const std::vector<int>& host_of);

// Two-level allgatherv (reference: mpi_operations.cc:331 shared-mem
// hierarchical allgather): gather to the host leader, ring-allgather
// per-host bundles among leaders only, leader scatters blocks to rank
// offsets and broadcasts locally. Cross-host connections drop from
// all-pairs to leaders-only; works for ANY host grouping (no equal
// ranks-per-host requirement — bundles are variable-size).
Status HierarchicalAllgatherv(Transport* t, const void* sendbuf,
                              void* recvbuf,
                              const std::vector<int64_t>& counts,
                              DataType dtype,
                              const std::vector<int>& host_of);

// Gather variable-size blocks: rank r contributes counts[r] elements from
// sendbuf; recvbuf (sum(counts) elements) receives blocks ordered by rank.
Status RingAllgatherv(Transport* t, const void* sendbuf, void* recvbuf,
                      const std::vector<int64_t>& counts, DataType dtype);

// In-place Adasum allreduce via vector-halving distance-doubling
// (reference spec: adasum/adasum.h:194-343 FusedAllreduce + the pairwise
// rule a <- (1 - dot/2|a|^2) a + (1 - dot/2|b|^2) b at :397-407).
// Float dtypes only; transport size must be a power of two.
Status VhddAdasum(Transport* t, void* buf, int64_t count, DataType dtype);

// Binomial-tree broadcast of `count` elements from `root`.
Status TreeBroadcast(Transport* t, void* buf, int64_t count, DataType dtype,
                     int root);

// Pairwise exchange: send_splits[r] elements go to rank r (in rank order in
// sendbuf); recv_splits[r] elements arrive from rank r (in rank order in
// recvbuf). Splits are element counts of `dtype`.
Status PairwiseAlltoallv(Transport* t, const void* sendbuf, void* recvbuf,
                         const std::vector<int64_t>& send_splits,
                         const std::vector<int64_t>& recv_splits,
                         DataType dtype);

// Reduce then scatter: input `count` = sum(recv_counts) elements in sendbuf;
// this rank's reduced block (recv_counts[rank] elements, offset = prefix sum)
// lands in recvbuf.
Status RingReducescatter(Transport* t, const void* sendbuf, void* recvbuf,
                         const std::vector<int64_t>& recv_counts,
                         DataType dtype, RedOp op);

Status DisseminationBarrier(Transport* t);

// Elementwise accumulate src into dst (used by fusion + tests).
void ReduceInto(void* dst, const void* src, int64_t count, DataType dtype,
                RedOp op);

// Scale buffer elementwise by `factor` (pre/postscale application,
// reference: ScaleBufferCPUImpl, horovod/common/ops/collective_operations.h:91).
void ScaleBuffer(void* buf, int64_t count, DataType dtype, double factor);

// Fill `count` elements with the identity of `op` (0 for sum, +max for min,
// lowest for max, 1 for prod) — the contribution of a joined/entry-less rank
// to a fused reduction (the reference restricts Join to sum, where zero is
// the identity; using the true identity extends it to min/max/prod).
void FillReduceIdentity(void* buf, int64_t count, DataType dtype, RedOp op);

}  // namespace hvdcore

#endif  // HVDCORE_COLLECTIVES_H_
