#include "transport.h"

#include <arpa/inet.h>
#include <cerrno>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <thread>

namespace hvdcore {

LogLevel GlobalLogLevel() {
  static LogLevel level = [] {
    const char* env = std::getenv("HVDTPU_LOG_LEVEL");
    if (!env) env = std::getenv("HOROVOD_LOG_LEVEL");
    if (!env) return LogLevel::kWarn;
    std::string s(env);
    if (s == "trace") return LogLevel::kTrace;
    if (s == "debug") return LogLevel::kDebug;
    if (s == "info") return LogLevel::kInfo;
    if (s == "warning" || s == "warn") return LogLevel::kWarn;
    if (s == "error") return LogLevel::kError;
    return LogLevel::kNone;
  }();
  return level;
}

void LogMsg(LogLevel level, int rank, const std::string& msg) {
  if (level < GlobalLogLevel()) return;
  static const char* names[] = {"TRACE", "DEBUG", "INFO", "WARN", "ERROR", ""};
  std::fprintf(stderr, "[hvdcore %s rank %d] %s\n",
               names[static_cast<int>(level)], rank, msg.c_str());
}

// --- LocalTransport --------------------------------------------------------

// Mailboxes for one in-process job: box[from * size + to] holds messages in
// flight from `from` to `to`.
class LocalHub {
 public:
  explicit LocalHub(int size) : size_(size), boxes_(size * size) {}

  void Push(int from, int to, const void* data, size_t len) {
    auto& box = boxes_[from * size_ + to];
    {
      std::lock_guard<std::mutex> g(mu_);
      box.emplace_back(static_cast<const uint8_t*>(data),
                       static_cast<const uint8_t*>(data) + len);
    }
    cv_.notify_all();
  }

  Status Pop(int from, int to, std::vector<uint8_t>* out) {
    auto& box = boxes_[from * size_ + to];
    std::unique_lock<std::mutex> g(mu_);
    if (!cv_.wait_for(g, std::chrono::seconds(300),
                      [&] { return !box.empty() || closed_; })) {
      return Status::Error(StatusCode::kUnknownError, "local recv timeout");
    }
    if (box.empty() && closed_)
      return Status::Error(StatusCode::kAborted, "transport closed");
    *out = std::move(box.front());
    box.pop_front();
    return Status::OK();
  }

  void CloseAll() {
    { std::lock_guard<std::mutex> g(mu_); closed_ = true; }
    cv_.notify_all();
  }

  static std::shared_ptr<LocalHub> Get(const std::string& job, int size) {
    static std::mutex reg_mu;
    static std::map<std::string, std::weak_ptr<LocalHub>> registry;
    std::lock_guard<std::mutex> g(reg_mu);
    auto it = registry.find(job);
    if (it != registry.end()) {
      if (auto hub = it->second.lock()) return hub;
    }
    auto hub = std::make_shared<LocalHub>(size);
    registry[job] = hub;
    return hub;
  }

 private:
  int size_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::vector<std::deque<std::vector<uint8_t>>> boxes_;
  bool closed_ = false;
};

std::unique_ptr<LocalTransport> LocalTransport::Create(const std::string& job,
                                                       int rank, int size) {
  return std::unique_ptr<LocalTransport>(
      new LocalTransport(LocalHub::Get(job, size), rank, size));
}

LocalTransport::LocalTransport(std::shared_ptr<LocalHub> hub, int rank,
                               int size)
    : hub_(std::move(hub)), rank_(rank), size_(size) {}

LocalTransport::~LocalTransport() = default;

Status LocalTransport::Send(int to, const void* data, size_t len) {
  hub_->Push(rank_, to, data, len);
  return Status::OK();
}

Status LocalTransport::Recv(int from, std::vector<uint8_t>* out) {
  return hub_->Pop(from, rank_, out);
}

Status LocalTransport::SendRecv(int to, const void* sdata, size_t slen,
                                int from, std::vector<uint8_t>* out) {
  hub_->Push(rank_, to, sdata, slen);
  return hub_->Pop(from, rank_, out);
}

void LocalTransport::Close() { hub_->CloseAll(); }

// --- TcpTransport ----------------------------------------------------------

namespace {

Status ParseHostPort(const std::string& hp, std::string* host, int* port) {
  size_t colon = hp.rfind(':');
  if (colon == std::string::npos)
    return Status::Error(StatusCode::kInvalidArgument, "bad address " + hp);
  *host = hp.substr(0, colon);
  *port = std::atoi(hp.c_str() + colon + 1);
  return Status::OK();
}

void SetSockOpts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Write exactly len bytes (blocking fd).
Status WriteAll(int fd, const void* data, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return Status::Error(StatusCode::kUnknownError,
                           std::string("send: ") + std::strerror(errno));
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return Status::OK();
}

Status ReadAll(int fd, void* data, size_t len) {
  uint8_t* p = static_cast<uint8_t*>(data);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      return Status::Error(StatusCode::kUnknownError,
                           std::string("recv: ") + std::strerror(errno));
    }
    if (n == 0)
      return Status::Error(StatusCode::kAborted, "peer closed connection");
    p += n;
    len -= static_cast<size_t>(n);
  }
  return Status::OK();
}

}  // namespace

// Ports reserved by ReserveListenPort(), keyed by port number. The fd stays
// bound+listening from reservation until TcpTransport::Create consumes it.
namespace {
std::mutex g_reserved_mu;
std::map<int, int> g_reserved_listeners;  // port -> listening fd
}  // namespace

int ReserveListenPort() {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = 0;  // ephemeral
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return -1;
  }
  socklen_t len = sizeof(addr);
  if (::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) < 0) {
    ::close(fd);
    return -1;
  }
  int port = ntohs(addr.sin_port);
  std::lock_guard<std::mutex> lock(g_reserved_mu);
  auto it = g_reserved_listeners.find(port);
  if (it != g_reserved_listeners.end()) ::close(it->second);
  g_reserved_listeners[port] = fd;
  return port;
}

namespace {
int TakeReservedListenFd(int port) {
  std::lock_guard<std::mutex> lock(g_reserved_mu);
  auto it = g_reserved_listeners.find(port);
  if (it == g_reserved_listeners.end()) return -1;
  int fd = it->second;
  g_reserved_listeners.erase(it);
  return fd;
}
}  // namespace

Status TcpTransport::Create(int rank, const std::vector<std::string>& peers,
                            double timeout_s,
                            std::unique_ptr<TcpTransport>* out) {
  const int size = static_cast<int>(peers.size());
  std::vector<int> fds(size, -1);

  std::string host;
  int port = 0;
  Status st = ParseHostPort(peers[rank], &host, &port);
  if (!st.ok()) return st;

  // Listen socket for this rank: prefer a socket reserved at rendezvous
  // time (already bound + listening, no steal window); otherwise bind to
  // all interfaces at our assigned port.
  int listen_fd = TakeReservedListenFd(port);
  if (listen_fd < 0) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0)
      return Status::Error(StatusCode::kUnknownError, "socket() failed");
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) < 0) {
      ::close(listen_fd);
      return Status::Error(
          StatusCode::kUnknownError,
          "bind " + peers[rank] + ": " + std::strerror(errno));
    }
    if (::listen(listen_fd, size) < 0) {
      ::close(listen_fd);
      return Status::Error(StatusCode::kUnknownError, "listen failed");
    }
  }

  // Connector thread: dial every lower rank (with retries — peers may not
  // be listening yet). Handshake = our rank as u32.
  Status connect_status = Status::OK();
  std::thread connector([&] {
    for (int peer = 0; peer < rank; ++peer) {
      std::string phost;
      int pport = 0;
      Status s = ParseHostPort(peers[peer], &phost, &pport);
      if (!s.ok()) { connect_status = s; return; }
      addrinfo hints{}, *res = nullptr;
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      if (getaddrinfo(phost.c_str(), nullptr, &hints, &res) != 0 || !res) {
        connect_status = Status::Error(StatusCode::kUnknownError,
                                       "getaddrinfo " + phost);
        return;
      }
      sockaddr_in peer_addr = *reinterpret_cast<sockaddr_in*>(res->ai_addr);
      peer_addr.sin_port = htons(static_cast<uint16_t>(pport));
      freeaddrinfo(res);

      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::duration<double>(timeout_s);
      int fd = -1;
      while (true) {
        fd = ::socket(AF_INET, SOCK_STREAM, 0);
        if (::connect(fd, reinterpret_cast<sockaddr*>(&peer_addr),
                      sizeof(peer_addr)) == 0)
          break;
        ::close(fd);
        fd = -1;
        if (std::chrono::steady_clock::now() > deadline) {
          connect_status = Status::Error(
              StatusCode::kUnknownError,
              "connect to rank " + std::to_string(peer) + " (" + peers[peer] +
                  ") timed out");
          return;
        }
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
      }
      SetSockOpts(fd);
      uint32_t my_rank = static_cast<uint32_t>(rank);
      Status w = WriteAll(fd, &my_rank, sizeof(my_rank));
      if (!w.ok()) { connect_status = w; ::close(fd); return; }
      fds[peer] = fd;
    }
  });

  // Accept every higher rank.
  Status accept_status = Status::OK();
  for (int need = size - 1 - rank; need > 0; --need) {
    pollfd pfd{listen_fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(timeout_s * 1000));
    if (pr <= 0) {
      accept_status = Status::Error(StatusCode::kUnknownError,
                                    "timed out waiting for peer connections");
      break;
    }
    int fd = ::accept(listen_fd, nullptr, nullptr);
    if (fd < 0) {
      accept_status = Status::Error(StatusCode::kUnknownError, "accept failed");
      break;
    }
    SetSockOpts(fd);
    uint32_t peer_rank = 0;
    Status r = ReadAll(fd, &peer_rank, sizeof(peer_rank));
    if (!r.ok() || peer_rank >= static_cast<uint32_t>(size)) {
      ::close(fd);
      accept_status = Status::Error(StatusCode::kUnknownError,
                                    "bad handshake from peer");
      break;
    }
    fds[peer_rank] = fd;
  }

  connector.join();
  ::close(listen_fd);
  if (!connect_status.ok() || !accept_status.ok()) {
    for (int fd : fds)
      if (fd >= 0) ::close(fd);
    return connect_status.ok() ? accept_status : connect_status;
  }
  out->reset(new TcpTransport(rank, std::move(fds)));
  return Status::OK();
}

TcpTransport::~TcpTransport() { Close(); }

void TcpTransport::Close() {
  for (int& fd : fds_) {
    if (fd >= 0) {
      ::close(fd);
      fd = -1;
    }
  }
}

Status TcpTransport::Send(int to, const void* data, size_t len) {
  if (to == rank_)
    return Status::Error(StatusCode::kInvalidArgument, "send to self");
  uint64_t frame = len;
  Status st = WriteAll(fds_[to], &frame, sizeof(frame));
  if (!st.ok()) return st;
  return WriteAll(fds_[to], data, len);
}

Status TcpTransport::Recv(int from, std::vector<uint8_t>* out) {
  uint64_t frame = 0;
  Status st = ReadAll(fds_[from], &frame, sizeof(frame));
  if (!st.ok()) return st;
  out->resize(frame);
  return frame ? ReadAll(fds_[from], out->data(), frame) : Status::OK();
}

// Full-duplex exchange: drive both directions with poll() so neither side
// blocks on a full socket buffer (classic ring-allreduce requirement).
Status TcpTransport::SendRecv(int to, const void* sdata, size_t slen, int from,
                              std::vector<uint8_t>* out) {
  if (to == rank_ && from == rank_) {
    out->assign(static_cast<const uint8_t*>(sdata),
                static_cast<const uint8_t*>(sdata) + slen);
    return Status::OK();
  }
  // Compose framed send buffer.
  std::vector<uint8_t> sbuf(sizeof(uint64_t) + slen);
  uint64_t frame = slen;
  std::memcpy(sbuf.data(), &frame, sizeof(frame));
  std::memcpy(sbuf.data() + sizeof(frame), sdata, slen);

  size_t sent = 0;
  size_t rcvd = 0;
  bool have_frame = false;
  uint64_t rframe = 0;
  std::vector<uint8_t> hdr(sizeof(uint64_t));

  int sfd = fds_[to];
  int rfd = fds_[from];
  while (sent < sbuf.size() || !have_frame || rcvd < rframe) {
    pollfd pfds[2];
    int n = 0;
    int send_idx = -1, recv_idx = -1;
    if (sent < sbuf.size()) {
      pfds[n] = {sfd, POLLOUT, 0};
      send_idx = n++;
    }
    if (!have_frame || rcvd < rframe) {
      pfds[n] = {rfd, POLLIN, 0};
      recv_idx = n++;
    }
    int pr = ::poll(pfds, n, 300000);
    if (pr < 0) {
      if (errno == EINTR) continue;
      return Status::Error(StatusCode::kUnknownError, "poll failed");
    }
    if (pr == 0)
      return Status::Error(StatusCode::kUnknownError, "sendrecv timeout");
    if (send_idx >= 0 && (pfds[send_idx].revents & (POLLOUT | POLLERR))) {
      // MSG_DONTWAIT: a blocking send() would sleep until the peer drains
      // its receive buffer — with every rank in the ring sending at once
      // that deadlocks as soon as the payload exceeds sndbuf+rcvbuf. A
      // partial nonblocking write keeps the recv direction serviced.
      ssize_t w = ::send(sfd, sbuf.data() + sent, sbuf.size() - sent,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EINTR && errno != EAGAIN)
        return Status::Error(StatusCode::kUnknownError,
                             std::string("send: ") + std::strerror(errno));
      if (w > 0) sent += static_cast<size_t>(w);
    }
    if (recv_idx >= 0 && (pfds[recv_idx].revents & (POLLIN | POLLHUP))) {
      if (!have_frame) {
        ssize_t r = ::recv(rfd, hdr.data() + rcvd, hdr.size() - rcvd, 0);
        if (r == 0)
          return Status::Error(StatusCode::kAborted, "peer closed");
        if (r < 0 && errno != EINTR && errno != EAGAIN)
          return Status::Error(StatusCode::kUnknownError, "recv failed");
        if (r > 0) {
          rcvd += static_cast<size_t>(r);
          if (rcvd == hdr.size()) {
            std::memcpy(&rframe, hdr.data(), sizeof(rframe));
            out->resize(rframe);
            have_frame = true;
            rcvd = 0;
          }
        }
      } else if (rcvd < rframe) {
        ssize_t r = ::recv(rfd, out->data() + rcvd, rframe - rcvd, 0);
        if (r == 0)
          return Status::Error(StatusCode::kAborted, "peer closed");
        if (r < 0 && errno != EINTR && errno != EAGAIN)
          return Status::Error(StatusCode::kUnknownError, "recv failed");
        if (r > 0) rcvd += static_cast<size_t>(r);
      }
    }
  }
  return Status::OK();
}

}  // namespace hvdcore
