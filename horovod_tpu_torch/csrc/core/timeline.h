// Chrome-trace timeline writer.
//
// Reference: horovod/common/timeline.h — a writer thread drains an SPSC
// queue of events and emits chrome://tracing JSON; tensors move through
// NEGOTIATING -> TOP_LEVEL -> ACTIVITY states. Here the queue is a
// mutex-guarded deque drained by a dedicated writer thread (contention is
// negligible at negotiation rates), and the same three-phase structure is
// emitted: NEGOTIATE_<OP>, the top-level op span, and per-op activities
// (e.g. RING_ALLREDUCE, MEMCPY_IN_FUSION_BUFFER).
#ifndef HVDCORE_TIMELINE_H_
#define HVDCORE_TIMELINE_H_

#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace hvdcore {

class Timeline {
 public:
  // pid: rank, so multi-process traces merge into one view.
  Timeline(const std::string& path, int pid);
  ~Timeline();

  bool ok() const { return file_ != nullptr; }

  void NegotiateStart(const std::string& tensor);
  void NegotiateEnd(const std::string& tensor);
  void OpStart(const std::string& tensor, const std::string& op);
  void OpEnd(const std::string& tensor);
  void ActivityStart(const std::string& tensor, const std::string& activity);
  void ActivityEnd(const std::string& tensor);
  // One-shot marker (cycle boundaries, autotune decisions).
  void Marker(const std::string& name);

 private:
  struct Event {
    char phase;  // 'B' begin, 'E' end, 'i' instant
    std::string tid;   // per-tensor lane
    std::string name;  // event label (empty for 'E')
    int64_t us;
  };
  void Push(char phase, const std::string& tid, const std::string& name);
  void WriterLoop();

  std::FILE* file_ = nullptr;
  int pid_;
  bool first_ = true;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Event> queue_;
  bool stop_ = false;
  std::thread writer_;
};

}  // namespace hvdcore

#endif  // HVDCORE_TIMELINE_H_
