#include "timeline.h"

#include <chrono>

namespace hvdcore {

namespace {
int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Minimal JSON string escaping for tensor names.
std::string Escape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    if (c == '"' || c == '\\') out.push_back('\\');
    if (static_cast<unsigned char>(c) >= 0x20) out.push_back(c);
  }
  return out;
}
}  // namespace

Timeline::Timeline(const std::string& path, int pid) : pid_(pid) {
  file_ = std::fopen(path.c_str(), "w");
  if (!file_) return;
  std::fputs("[\n", file_);
  writer_ = std::thread(&Timeline::WriterLoop, this);
}

Timeline::~Timeline() {
  if (!file_) return;
  {
    std::lock_guard<std::mutex> g(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  writer_.join();
  std::fputs("\n]\n", file_);
  std::fclose(file_);
}

void Timeline::Push(char phase, const std::string& tid,
                    const std::string& name) {
  if (!file_) return;
  {
    std::lock_guard<std::mutex> g(mu_);
    queue_.push_back(Event{phase, tid, name, NowUs()});
  }
  cv_.notify_one();
}

void Timeline::WriterLoop() {
  std::unique_lock<std::mutex> g(mu_);
  while (true) {
    cv_.wait(g, [&] { return stop_ || !queue_.empty(); });
    while (!queue_.empty()) {
      Event e = std::move(queue_.front());
      queue_.pop_front();
      g.unlock();
      if (!first_) std::fputs(",\n", file_);
      first_ = false;
      if (e.phase == 'i') {
        std::fprintf(file_,
                     "{\"ph\":\"i\",\"name\":\"%s\",\"pid\":%d,\"ts\":%lld,"
                     "\"s\":\"p\"}",
                     Escape(e.name).c_str(), pid_,
                     static_cast<long long>(e.us));
      } else {
        // Chrome-trace tids are numeric: lane = stable hash of tensor name.
        unsigned long tid =
            std::hash<std::string>{}(e.tid) % 1000000ul;
        if (e.phase == 'B') {
          std::fprintf(file_,
                       "{\"ph\":\"B\",\"name\":\"%s\",\"pid\":%d,"
                       "\"tid\":%lu,\"ts\":%lld}",
                       Escape(e.name).c_str(), pid_, tid,
                       static_cast<long long>(e.us));
        } else {
          std::fprintf(file_,
                       "{\"ph\":\"E\",\"pid\":%d,\"tid\":%lu,\"ts\":%lld}",
                       pid_, tid, static_cast<long long>(e.us));
        }
      }
      g.lock();
    }
    if (stop_ && queue_.empty()) break;
  }
  std::fflush(file_);
}

void Timeline::NegotiateStart(const std::string& tensor) {
  Push('B', tensor, "NEGOTIATE");
}
void Timeline::NegotiateEnd(const std::string& tensor) { Push('E', tensor, ""); }
void Timeline::OpStart(const std::string& tensor, const std::string& op) {
  Push('B', tensor, op);
}
void Timeline::OpEnd(const std::string& tensor) { Push('E', tensor, ""); }
void Timeline::ActivityStart(const std::string& tensor,
                             const std::string& activity) {
  Push('B', tensor, activity);
}
void Timeline::ActivityEnd(const std::string& tensor) {
  Push('E', tensor, "");
}
void Timeline::Marker(const std::string& name) { Push('i', "", name); }

}  // namespace hvdcore
