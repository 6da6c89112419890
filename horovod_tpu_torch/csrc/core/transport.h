// Point-to-point transports for the control plane and the CPU data plane.
//
// The reference's equivalents are the Gloo TCP context (reference:
// horovod/common/gloo/gloo_context.cc) for CPU jobs and MPI. On TPU-VMs
// there is no MPI; the native core talks plain TCP over DCN for host-side
// coordination, while tensor bytes on TPU ride XLA/ICI (Python side). This
// TCP layer doubles as the CPU-fallback data plane (the gloo analog).
//
// Two implementations:
//  - TcpTransport: full socket mesh between N processes.
//  - LocalTransport: in-process queues keyed by a job id, letting N threads
//    act as N ranks for unit tests (the reference tests its controller only
//    under real launchers; in-process ranks make the native core testable
//    from a single pytest process).
#ifndef HVDCORE_TRANSPORT_H_
#define HVDCORE_TRANSPORT_H_

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "common.h"

namespace hvdcore {

class Transport {
 public:
  virtual ~Transport() = default;
  virtual int rank() const = 0;
  virtual int size() const = 0;

  // Blocking framed send/recv. Messages from a given peer arrive in order.
  virtual Status Send(int to, const void* data, size_t len) = 0;
  virtual Status Recv(int from, std::vector<uint8_t>* out) = 0;
  // Simultaneous exchange (ring steps would deadlock two blocking Sends
  // whose socket buffers fill; this primitive multiplexes with poll()).
  virtual Status SendRecv(int to, const void* sdata, size_t slen, int from,
                          std::vector<uint8_t>* out) = 0;
  virtual void Close() = 0;
};

// Rendezvous bootstrap support: bind + listen an ephemeral port NOW and
// keep the socket open so the address a worker publishes to the KV store
// cannot be stolen before TcpTransport::Create runs (a close-then-rebind
// dance would be a TOCTOU race). Create() consumes the reserved fd when
// peers[rank] names a reserved port. Returns -1 on failure.
int ReserveListenPort();

// --- LocalTransport --------------------------------------------------------

class LocalHub;  // shared mailbox registry for one in-process "job"

class LocalTransport : public Transport {
 public:
  // All ranks of `job` within this process share one hub.
  static std::unique_ptr<LocalTransport> Create(const std::string& job,
                                                int rank, int size);
  ~LocalTransport() override;

  int rank() const override { return rank_; }
  int size() const override { return size_; }
  Status Send(int to, const void* data, size_t len) override;
  Status Recv(int from, std::vector<uint8_t>* out) override;
  Status SendRecv(int to, const void* sdata, size_t slen, int from,
                  std::vector<uint8_t>* out) override;
  void Close() override;

 private:
  LocalTransport(std::shared_ptr<LocalHub> hub, int rank, int size);
  std::shared_ptr<LocalHub> hub_;
  int rank_, size_;
};

// --- TcpTransport ----------------------------------------------------------

class TcpTransport : public Transport {
 public:
  // peers[i] = "host:port" where rank i listens. Establishes the full mesh:
  // listens on peers[rank], connects to lower ranks, accepts higher ranks.
  static Status Create(int rank, const std::vector<std::string>& peers,
                       double timeout_s, std::unique_ptr<TcpTransport>* out);
  ~TcpTransport() override;

  int rank() const override { return rank_; }
  int size() const override { return static_cast<int>(fds_.size()); }
  Status Send(int to, const void* data, size_t len) override;
  Status Recv(int from, std::vector<uint8_t>* out) override;
  Status SendRecv(int to, const void* sdata, size_t slen, int from,
                  std::vector<uint8_t>* out) override;
  void Close() override;

 private:
  TcpTransport(int rank, std::vector<int> fds) : rank_(rank), fds_(std::move(fds)) {}
  int rank_;
  std::vector<int> fds_;  // fds_[peer] = connected socket, -1 for self
};

}  // namespace hvdcore

#endif  // HVDCORE_TRANSPORT_H_
