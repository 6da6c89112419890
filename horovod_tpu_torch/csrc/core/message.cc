#include "message.h"

#include <cstring>

namespace hvdcore {
namespace {

// Little-endian append/read helpers. All hosts we target are LE; a static
// assert guards the assumption rather than paying for byte swaps.
template <typename T>
void Put(std::vector<uint8_t>* out, T v) {
  static_assert(std::is_trivially_copyable<T>::value, "POD only");
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out->insert(out->end(), p, p + sizeof(T));
}

void PutStr(std::vector<uint8_t>* out, const std::string& s) {
  Put<uint32_t>(out, static_cast<uint32_t>(s.size()));
  out->insert(out->end(), s.begin(), s.end());
}

template <typename T>
void PutVec(std::vector<uint8_t>* out, const std::vector<T>& v) {
  Put<uint32_t>(out, static_cast<uint32_t>(v.size()));
  for (const T& x : v) Put<T>(out, x);
}

class Reader {
 public:
  Reader(const uint8_t* data, size_t len) : data_(data), len_(len) {}
  bool ok() const { return ok_; }

  template <typename T>
  T Get() {
    T v{};
    if (pos_ + sizeof(T) > len_) { ok_ = false; return v; }
    std::memcpy(&v, data_ + pos_, sizeof(T));
    pos_ += sizeof(T);
    return v;
  }

  std::string GetStr() {
    uint32_t n = Get<uint32_t>();
    if (!ok_ || pos_ + n > len_) { ok_ = false; return ""; }
    std::string s(reinterpret_cast<const char*>(data_ + pos_), n);
    pos_ += n;
    return s;
  }

  template <typename T>
  std::vector<T> GetVec() {
    uint32_t n = Get<uint32_t>();
    std::vector<T> v;
    if (!ok_ || pos_ + static_cast<size_t>(n) * sizeof(T) > len_) {
      ok_ = false;
      return v;
    }
    v.reserve(n);
    for (uint32_t i = 0; i < n; ++i) v.push_back(Get<T>());
    return v;
  }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t pos_ = 0;
  bool ok_ = true;
};

constexpr uint32_t kReqMagic = 0x48565251;   // "HVRQ"
constexpr uint32_t kRespMagic = 0x48565250;  // "HVRP"

}  // namespace

void Serialize(const RequestList& in, std::vector<uint8_t>* out) {
  out->clear();
  Put<uint32_t>(out, kReqMagic);
  Put<uint8_t>(out, in.shutdown ? 1 : 0);
  Put<uint32_t>(out, static_cast<uint32_t>(in.requests.size()));
  for (const Request& r : in.requests) {
    Put<int32_t>(out, r.rank);
    Put<uint8_t>(out, static_cast<uint8_t>(r.type));
    Put<uint8_t>(out, static_cast<uint8_t>(r.op));
    Put<uint8_t>(out, static_cast<uint8_t>(r.dtype));
    PutStr(out, r.name);
    Put<int32_t>(out, r.root_rank);
    Put<int32_t>(out, r.group_id);
    Put<double>(out, r.prescale);
    Put<double>(out, r.postscale);
    PutVec<int64_t>(out, r.shape);
    PutVec<int32_t>(out, r.splits);
  }
}

bool Deserialize(const uint8_t* data, size_t len, RequestList* out) {
  Reader rd(data, len);
  if (rd.Get<uint32_t>() != kReqMagic) return false;
  out->shutdown = rd.Get<uint8_t>() != 0;
  uint32_t n = rd.Get<uint32_t>();
  out->requests.clear();
  out->requests.reserve(n);
  for (uint32_t i = 0; i < n && rd.ok(); ++i) {
    Request r;
    r.rank = rd.Get<int32_t>();
    r.type = static_cast<ReqType>(rd.Get<uint8_t>());
    r.op = static_cast<RedOp>(rd.Get<uint8_t>());
    r.dtype = static_cast<DataType>(rd.Get<uint8_t>());
    r.name = rd.GetStr();
    r.root_rank = rd.Get<int32_t>();
    r.group_id = rd.Get<int32_t>();
    r.prescale = rd.Get<double>();
    r.postscale = rd.Get<double>();
    r.shape = rd.GetVec<int64_t>();
    r.splits = rd.GetVec<int32_t>();
    out->requests.push_back(std::move(r));
  }
  return rd.ok();
}

void Serialize(const ResponseList& in, std::vector<uint8_t>* out) {
  out->clear();
  Put<uint32_t>(out, kRespMagic);
  Put<uint8_t>(out, in.shutdown ? 1 : 0);
  Put<uint32_t>(out, static_cast<uint32_t>(in.responses.size()));
  for (const Response& r : in.responses) {
    Put<uint8_t>(out, static_cast<uint8_t>(r.type));
    Put<uint8_t>(out, static_cast<uint8_t>(r.op));
    Put<uint8_t>(out, static_cast<uint8_t>(r.dtype));
    Put<uint32_t>(out, static_cast<uint32_t>(r.names.size()));
    for (const std::string& s : r.names) PutStr(out, s);
    PutStr(out, r.error);
    Put<double>(out, r.prescale);
    Put<double>(out, r.postscale);
    PutVec<int64_t>(out, r.sizes);
    Put<int32_t>(out, r.last_joined_rank);
  }
}

bool Deserialize(const uint8_t* data, size_t len, ResponseList* out) {
  Reader rd(data, len);
  if (rd.Get<uint32_t>() != kRespMagic) return false;
  out->shutdown = rd.Get<uint8_t>() != 0;
  uint32_t n = rd.Get<uint32_t>();
  out->responses.clear();
  out->responses.reserve(n);
  for (uint32_t i = 0; i < n && rd.ok(); ++i) {
    Response r;
    r.type = static_cast<ReqType>(rd.Get<uint8_t>());
    r.op = static_cast<RedOp>(rd.Get<uint8_t>());
    r.dtype = static_cast<DataType>(rd.Get<uint8_t>());
    uint32_t nn = rd.Get<uint32_t>();
    for (uint32_t j = 0; j < nn && rd.ok(); ++j) r.names.push_back(rd.GetStr());
    r.error = rd.GetStr();
    r.prescale = rd.Get<double>();
    r.postscale = rd.Get<double>();
    r.sizes = rd.GetVec<int64_t>();
    r.last_joined_rank = rd.Get<int32_t>();
    out->responses.push_back(std::move(r));
  }
  return rd.ok();
}

}  // namespace hvdcore
