#include "collectives.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <map>

namespace hvdcore {
namespace {

// --- half-precision conversion (IEEE fp16 and bfloat16) --------------------

float HalfToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400) == 0) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3FF;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp + 127 - 15) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t FloatToHalf(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFF;
  // NaN must stay NaN (not clamp to Inf) so numerical errors upstream of an
  // fp16 reduction are not silently masked.
  if (((bits >> 23) & 0xFF) == 0xFF && mant != 0)
    return static_cast<uint16_t>(sign | 0x7E00);
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half_mant = mant >> shift;
    // round-to-nearest-even
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_mant & 1))) ++half_mant;
    return static_cast<uint16_t>(sign | half_mant);
  }
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00);
  uint32_t half_mant = mant >> 13;
  uint32_t rem = mant & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (half_mant & 1))) {
    ++half_mant;
    if (half_mant == 0x400) {
      half_mant = 0;
      ++exp;
      if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00);
    }
  }
  return static_cast<uint16_t>(sign | (static_cast<uint32_t>(exp) << 10) |
                               half_mant);
}

float BF16ToFloat(uint16_t b) {
  uint32_t bits = static_cast<uint32_t>(b) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t FloatToBF16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // NaN must stay NaN: round-to-nearest-even below can carry a NaN mantissa
  // into the exponent (0x7FFFFFFF -> -0.0, sNaN -> Inf), silently masking
  // upstream numerical errors — same guard as FloatToHalf above.
  if ((bits & 0x7F800000u) == 0x7F800000u && (bits & 0x7FFFFFu) != 0)
    return static_cast<uint16_t>(((bits >> 16) & 0x8000u) | 0x7FC0u);
  // round-to-nearest-even on the truncated 16 bits
  uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

template <typename T>
void ReduceTyped(T* dst, const T* src, int64_t n, RedOp op) {
  switch (op) {
    case RedOp::kSum:
      for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<T>(dst[i] + src[i]);
      break;
    case RedOp::kMin:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::min(dst[i], src[i]);
      break;
    case RedOp::kMax:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::max(dst[i], src[i]);
      break;
    case RedOp::kProd:
      for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<T>(dst[i] * src[i]);
      break;
    default:
      break;  // kAdasum never reaches elementwise reduction (VhddAdasum)
  }
}

template <uint16_t (*ToBits)(float), float (*FromBits)(uint16_t)>
void ReduceHalfLike(uint16_t* dst, const uint16_t* src, int64_t n, RedOp op) {
  for (int64_t i = 0; i < n; ++i) {
    float a = FromBits(dst[i]);
    float b = FromBits(src[i]);
    float r;
    switch (op) {
      case RedOp::kSum: r = a + b; break;
      case RedOp::kMin: r = std::min(a, b); break;
      case RedOp::kMax: r = std::max(a, b); break;
      case RedOp::kProd: r = a * b; break;
      default: r = a; break;
    }
    dst[i] = ToBits(r);
  }
}

void ReduceBool(uint8_t* dst, const uint8_t* src, int64_t n, RedOp op) {
  // Sum/Max => logical OR, Min/Prod => logical AND (reference maps bool
  // allreduce onto MPI LOR/LAND semantics).
  if (op == RedOp::kSum || op == RedOp::kMax) {
    for (int64_t i = 0; i < n; ++i) dst[i] = dst[i] || src[i];
  } else {
    for (int64_t i = 0; i < n; ++i) dst[i] = dst[i] && src[i];
  }
}

}  // namespace

void ReduceInto(void* dst, const void* src, int64_t count, DataType dtype,
                RedOp op) {
  switch (dtype) {
    case DataType::kUint8:
      ReduceTyped(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src),
                  count, op);
      break;
    case DataType::kInt8:
      ReduceTyped(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src),
                  count, op);
      break;
    case DataType::kInt32:
      ReduceTyped(static_cast<int32_t*>(dst), static_cast<const int32_t*>(src),
                  count, op);
      break;
    case DataType::kInt64:
      ReduceTyped(static_cast<int64_t*>(dst), static_cast<const int64_t*>(src),
                  count, op);
      break;
    case DataType::kFloat32:
      ReduceTyped(static_cast<float*>(dst), static_cast<const float*>(src),
                  count, op);
      break;
    case DataType::kFloat64:
      ReduceTyped(static_cast<double*>(dst), static_cast<const double*>(src),
                  count, op);
      break;
    case DataType::kFloat16:
      ReduceHalfLike<FloatToHalf, HalfToFloat>(
          static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src),
          count, op);
      break;
    case DataType::kBFloat16:
      ReduceHalfLike<FloatToBF16, BF16ToFloat>(
          static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src),
          count, op);
      break;
    case DataType::kBool:
      ReduceBool(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src),
                 count, op);
      break;
  }
}

void ScaleBuffer(void* buf, int64_t count, DataType dtype, double factor) {
  if (factor == 1.0) return;
  switch (dtype) {
    case DataType::kFloat32: {
      float* p = static_cast<float*>(buf);
      float f = static_cast<float>(factor);
      for (int64_t i = 0; i < count; ++i) p[i] *= f;
      break;
    }
    case DataType::kFloat64: {
      double* p = static_cast<double*>(buf);
      for (int64_t i = 0; i < count; ++i) p[i] *= factor;
      break;
    }
    case DataType::kFloat16: {
      uint16_t* p = static_cast<uint16_t*>(buf);
      float f = static_cast<float>(factor);
      for (int64_t i = 0; i < count; ++i)
        p[i] = FloatToHalf(HalfToFloat(p[i]) * f);
      break;
    }
    case DataType::kBFloat16: {
      uint16_t* p = static_cast<uint16_t*>(buf);
      float f = static_cast<float>(factor);
      for (int64_t i = 0; i < count; ++i)
        p[i] = FloatToBF16(BF16ToFloat(p[i]) * f);
      break;
    }
    case DataType::kInt32: {
      int32_t* p = static_cast<int32_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = static_cast<int32_t>(std::llround(p[i] * factor));
      break;
    }
    case DataType::kInt64: {
      int64_t* p = static_cast<int64_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = static_cast<int64_t>(std::llround(p[i] * factor));
      break;
    }
    default:
      break;  // uint8/int8/bool: scaling not meaningful
  }
}

namespace {

template <typename T>
void FillTyped(void* buf, int64_t count, T value) {
  T* p = static_cast<T*>(buf);
  for (int64_t i = 0; i < count; ++i) p[i] = value;
}

}  // namespace

void FillReduceIdentity(void* buf, int64_t count, DataType dtype, RedOp op) {
  if (op == RedOp::kSum || op == RedOp::kAdasum) {
    std::memset(buf, 0, static_cast<size_t>(count) * DataTypeSize(dtype));
    return;
  }
  float fval = op == RedOp::kProd
                   ? 1.0f
                   : (op == RedOp::kMin ? std::numeric_limits<float>::infinity()
                                        : -std::numeric_limits<float>::infinity());
  switch (dtype) {
    case DataType::kFloat32:
      FillTyped<float>(buf, count, fval);
      break;
    case DataType::kFloat64:
      FillTyped<double>(buf, count, static_cast<double>(fval));
      break;
    case DataType::kFloat16:
      FillTyped<uint16_t>(buf, count, FloatToHalf(fval));
      break;
    case DataType::kBFloat16:
      FillTyped<uint16_t>(buf, count, FloatToBF16(fval));
      break;
    case DataType::kInt32:
      FillTyped<int32_t>(buf, count,
                         op == RedOp::kProd ? 1
                         : op == RedOp::kMin
                             ? std::numeric_limits<int32_t>::max()
                             : std::numeric_limits<int32_t>::lowest());
      break;
    case DataType::kInt64:
      FillTyped<int64_t>(buf, count,
                         op == RedOp::kProd ? 1
                         : op == RedOp::kMin
                             ? std::numeric_limits<int64_t>::max()
                             : std::numeric_limits<int64_t>::lowest());
      break;
    case DataType::kUint8:
      FillTyped<uint8_t>(buf, count,
                         op == RedOp::kProd ? 1
                         : op == RedOp::kMin
                             ? std::numeric_limits<uint8_t>::max()
                             : std::numeric_limits<uint8_t>::lowest());
      break;
    case DataType::kInt8:
      FillTyped<int8_t>(buf, count,
                        op == RedOp::kProd ? 1
                        : op == RedOp::kMin ? std::numeric_limits<int8_t>::max()
                                            : std::numeric_limits<int8_t>::lowest());
      break;
    case DataType::kBool:
      // min/prod identity = 1 (true), max identity = 0 (false)
      FillTyped<uint8_t>(buf, count, op == RedOp::kMax ? 0 : 1);
      break;
  }
}

namespace {

// Chunk boundaries for the ring: chunk i covers [offsets[i], offsets[i+1]).
std::vector<int64_t> EvenOffsets(int64_t count, int size) {
  std::vector<int64_t> offsets(size + 1, 0);
  int64_t base = count / size, rem = count % size;
  for (int i = 0; i < size; ++i)
    offsets[i + 1] = offsets[i] + base + (i < rem ? 1 : 0);
  return offsets;
}

std::vector<int64_t> PrefixOffsets(const std::vector<int64_t>& counts) {
  std::vector<int64_t> offsets(counts.size() + 1, 0);
  for (size_t i = 0; i < counts.size(); ++i)
    offsets[i + 1] = offsets[i] + counts[i];
  return offsets;
}

// Ring reduce-scatter on buf with chunk layout `offsets`. After this, chunk
// (rank+1) % size in buf holds the fully reduced values.
Status RingReduceScatterPhase(Transport* t, uint8_t* buf,
                              const std::vector<int64_t>& offsets,
                              DataType dtype, RedOp op) {
  const int size = t->size();
  const int rank = t->rank();
  const size_t esize = DataTypeSize(dtype);
  const int right = (rank + 1) % size;
  const int left = (rank - 1 + size) % size;
  std::vector<uint8_t> incoming;
  for (int s = 0; s < size - 1; ++s) {
    int send_chunk = (rank - s + size) % size;
    int recv_chunk = (rank - s - 1 + size) % size;
    uint8_t* send_ptr = buf + offsets[send_chunk] * esize;
    int64_t send_n = offsets[send_chunk + 1] - offsets[send_chunk];
    Status st = t->SendRecv(right, send_ptr, send_n * esize, left, &incoming);
    if (!st.ok()) return st;
    int64_t recv_n = offsets[recv_chunk + 1] - offsets[recv_chunk];
    if (incoming.size() != static_cast<size_t>(recv_n) * esize)
      return Status::Error(StatusCode::kUnknownError, "ring size mismatch");
    ReduceInto(buf + offsets[recv_chunk] * esize, incoming.data(), recv_n,
               dtype, op);
  }
  return Status::OK();
}

}  // namespace

Status RingAllreduce(Transport* t, void* vbuf, int64_t count, DataType dtype,
                     RedOp op) {
  const int size = t->size();
  if (size == 1 || count == 0) return Status::OK();
  uint8_t* buf = static_cast<uint8_t*>(vbuf);
  const size_t esize = DataTypeSize(dtype);
  auto offsets = EvenOffsets(count, size);
  const int rank = t->rank();
  const int right = (rank + 1) % size;
  const int left = (rank - 1 + size) % size;

  Status st = RingReduceScatterPhase(t, buf, offsets, dtype, op);
  if (!st.ok()) return st;

  // Allgather phase: circulate reduced chunks. After reduce-scatter, this
  // rank owns fully-reduced chunk (rank+1) % size.
  std::vector<uint8_t> incoming;
  for (int s = 0; s < size - 1; ++s) {
    int send_chunk = (rank + 1 - s + size) % size;
    int recv_chunk = (rank - s + size) % size;
    uint8_t* send_ptr = buf + offsets[send_chunk] * esize;
    int64_t send_n = offsets[send_chunk + 1] - offsets[send_chunk];
    st = t->SendRecv(right, send_ptr, send_n * esize, left, &incoming);
    if (!st.ok()) return st;
    int64_t recv_n = offsets[recv_chunk + 1] - offsets[recv_chunk];
    if (incoming.size() != static_cast<size_t>(recv_n) * esize)
      return Status::Error(StatusCode::kUnknownError, "ring size mismatch");
    std::memcpy(buf + offsets[recv_chunk] * esize, incoming.data(),
                incoming.size());
  }
  return Status::OK();
}

Status RingAllgatherv(Transport* t, const void* sendbuf, void* recvbuf,
                      const std::vector<int64_t>& counts, DataType dtype) {
  const int size = t->size();
  const int rank = t->rank();
  const size_t esize = DataTypeSize(dtype);
  auto offsets = PrefixOffsets(counts);
  uint8_t* out = static_cast<uint8_t*>(recvbuf);
  if (counts[rank] > 0)
    std::memcpy(out + offsets[rank] * esize, sendbuf, counts[rank] * esize);
  if (size == 1) return Status::OK();
  const int right = (rank + 1) % size;
  const int left = (rank - 1 + size) % size;
  std::vector<uint8_t> incoming;
  for (int s = 0; s < size - 1; ++s) {
    int send_block = (rank - s + size) % size;
    int recv_block = (rank - s - 1 + size) % size;
    Status st = t->SendRecv(right, out + offsets[send_block] * esize,
                            counts[send_block] * esize, left, &incoming);
    if (!st.ok()) return st;
    if (incoming.size() != static_cast<size_t>(counts[recv_block]) * esize)
      return Status::Error(StatusCode::kUnknownError, "allgather size mismatch");
    std::memcpy(out + offsets[recv_block] * esize, incoming.data(),
                incoming.size());
  }
  return Status::OK();
}

Status TreeBroadcast(Transport* t, void* vbuf, int64_t count, DataType dtype,
                     int root) {
  const int size = t->size();
  if (size == 1) return Status::OK();
  const int rank = t->rank();
  const size_t nbytes = static_cast<size_t>(count) * DataTypeSize(dtype);
  const int vrank = (rank - root + size) % size;

  // Receive once from the parent, then forward to children: standard
  // binomial tree on virtual ranks.
  int mask = 1;
  while (mask < size && (vrank & mask) == 0) mask <<= 1;
  if (vrank != 0) {
    int parent = ((vrank & ~mask) + root) % size;
    std::vector<uint8_t> data;
    Status st = t->Recv(parent, &data);
    if (!st.ok()) return st;
    if (data.size() != nbytes)
      return Status::Error(StatusCode::kUnknownError, "broadcast size mismatch");
    std::memcpy(vbuf, data.data(), nbytes);
  }
  // Children: vrank + m for m in descending powers of two below mask.
  for (int m = mask >> 1; m >= 1; m >>= 1) {
    int child_v = vrank + m;
    if (child_v < size) {
      Status st = t->Send((child_v + root) % size, vbuf, nbytes);
      if (!st.ok()) return st;
    }
  }
  return Status::OK();
}

Status PairwiseAlltoallv(Transport* t, const void* sendbuf, void* recvbuf,
                         const std::vector<int64_t>& send_splits,
                         const std::vector<int64_t>& recv_splits,
                         DataType dtype) {
  const int size = t->size();
  const int rank = t->rank();
  const size_t esize = DataTypeSize(dtype);
  auto soff = PrefixOffsets(send_splits);
  auto roff = PrefixOffsets(recv_splits);
  const uint8_t* in = static_cast<const uint8_t*>(sendbuf);
  uint8_t* out = static_cast<uint8_t*>(recvbuf);
  std::memcpy(out + roff[rank] * esize, in + soff[rank] * esize,
              send_splits[rank] * esize);
  std::vector<uint8_t> incoming;
  for (int d = 1; d < size; ++d) {
    int to = (rank + d) % size;
    int from = (rank - d + size) % size;
    Status st = t->SendRecv(to, in + soff[to] * esize,
                            send_splits[to] * esize, from, &incoming);
    if (!st.ok()) return st;
    if (incoming.size() != static_cast<size_t>(recv_splits[from]) * esize)
      return Status::Error(StatusCode::kUnknownError, "alltoall size mismatch");
    std::memcpy(out + roff[from] * esize, incoming.data(), incoming.size());
  }
  return Status::OK();
}

Status RingReducescatter(Transport* t, const void* sendbuf, void* recvbuf,
                         const std::vector<int64_t>& recv_counts,
                         DataType dtype, RedOp op) {
  const int size = t->size();
  const int rank = t->rank();
  const size_t esize = DataTypeSize(dtype);
  auto offsets = PrefixOffsets(recv_counts);
  const int64_t total = offsets[size];
  // Work on a scratch copy: the reduce-scatter phase mutates the full buffer.
  std::vector<uint8_t> scratch(static_cast<size_t>(total) * esize);
  std::memcpy(scratch.data(), sendbuf, scratch.size());
  if (size > 1) {
    Status st = RingReduceScatterPhase(t, scratch.data(), offsets, dtype, op);
    if (!st.ok()) return st;
  }
  // RingReduceScatterPhase leaves chunk (rank+1)%size fully reduced at this
  // rank... but reducescatter semantics say this rank gets chunk `rank`.
  // One extra neighbor exchange aligns them — unless size == 1.
  if (size == 1) {
    std::memcpy(recvbuf, scratch.data() + offsets[rank] * esize,
                recv_counts[rank] * esize);
    return Status::OK();
  }
  const int right = (rank + 1) % size;
  const int left = (rank - 1 + size) % size;
  int owned = (rank + 1) % size;  // chunk index this rank holds reduced
  std::vector<uint8_t> incoming;
  Status st = t->SendRecv(right, scratch.data() + offsets[owned] * esize,
                          recv_counts[owned] * esize, left, &incoming);
  if (!st.ok()) return st;
  if (incoming.size() != static_cast<size_t>(recv_counts[rank]) * esize)
    return Status::Error(StatusCode::kUnknownError, "reducescatter mismatch");
  std::memcpy(recvbuf, incoming.data(), incoming.size());
  return Status::OK();
}

// --- Adasum (VHDD) ---------------------------------------------------------
// Vector-halving distance-doubling adaptive summation (reference:
// adasum/adasum.h:194-343). The whole reduction runs in double precision:
// the convergence-preserving property rests on the dot-product
// coefficients, and fp16/bf16 partial dots would defeat it.

namespace {

Status ToDoubleVec(const void* buf, int64_t count, DataType dtype,
                   std::vector<double>* out) {
  out->resize(static_cast<size_t>(count));
  switch (dtype) {
    case DataType::kFloat32: {
      const float* p = static_cast<const float*>(buf);
      for (int64_t i = 0; i < count; ++i) (*out)[i] = p[i];
      return Status::OK();
    }
    case DataType::kFloat64:
      std::memcpy(out->data(), buf, static_cast<size_t>(count) * 8);
      return Status::OK();
    case DataType::kFloat16: {
      const uint16_t* p = static_cast<const uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i) (*out)[i] = HalfToFloat(p[i]);
      return Status::OK();
    }
    case DataType::kBFloat16: {
      const uint16_t* p = static_cast<const uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i) (*out)[i] = BF16ToFloat(p[i]);
      return Status::OK();
    }
    default:
      return Status::Error(StatusCode::kInvalidArgument,
                           "Adasum requires a floating-point dtype");
  }
}

void FromDoubleVec(const std::vector<double>& in, void* buf, DataType dtype) {
  const int64_t count = static_cast<int64_t>(in.size());
  switch (dtype) {
    case DataType::kFloat32: {
      float* p = static_cast<float*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = static_cast<float>(in[i]);
      break;
    }
    case DataType::kFloat64:
      std::memcpy(buf, in.data(), static_cast<size_t>(count) * 8);
      break;
    case DataType::kFloat16: {
      uint16_t* p = static_cast<uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = FloatToHalf(static_cast<float>(in[i]));
      break;
    }
    case DataType::kBFloat16: {
      uint16_t* p = static_cast<uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = FloatToBF16(static_cast<float>(in[i]));
      break;
    }
    default:
      break;  // unreachable: ToDoubleVec validated the dtype
  }
}

struct AdasumLevel {
  int partner;
  int64_t kept_start, kept_count;   // span kept after halving
  int64_t sent_start, sent_count;   // span handed to the partner
};

}  // namespace

Status VhddAdasum(Transport* t, void* vbuf, int64_t count, DataType dtype) {
  const int size = t->size();
  const int rank = t->rank();
  if (size == 1) return Status::OK();
  if ((size & (size - 1)) != 0)
    return Status::Error(
        StatusCode::kInvalidArgument,
        "Adasum requires a power-of-two rank count (reference restriction, "
        "horovod/tensorflow/__init__.py:138-154); got " +
            std::to_string(size));
  if (dtype != DataType::kFloat32 && dtype != DataType::kFloat64 &&
      dtype != DataType::kFloat16 && dtype != DataType::kBFloat16)
    return Status::Error(StatusCode::kInvalidArgument,
                         "Adasum requires a floating-point dtype");

  // Spans travel in the tensor's NATIVE dtype (the reference exchanges
  // native buffers too — fp64 on the wire would double/quadruple
  // traffic); only the dot accumulators and the combine run in double.
  const size_t esize = DataTypeSize(dtype);
  uint8_t* buf = static_cast<uint8_t*>(vbuf);

  std::vector<AdasumLevel> levels;
  std::vector<uint8_t> incoming;
  std::vector<double> mine_d, theirs_d;
  int64_t start = 0, seg = count;
  Status st;

  // Forward: halve the vector, double the distance.
  for (int d = 1; d < size; d <<= 1) {
    const int partner = rank ^ d;
    const bool low = rank < partner;  // low keeps the left half
    const int64_t left = seg - seg / 2;
    const int64_t right = seg / 2;
    AdasumLevel lv;
    lv.partner = partner;
    if (low) {
      lv.kept_start = start;
      lv.kept_count = left;
      lv.sent_start = start + left;
      lv.sent_count = right;
    } else {
      lv.kept_start = start + left;
      lv.kept_count = right;
      lv.sent_start = start;
      lv.sent_count = left;
    }
    st = t->SendRecv(partner, buf + lv.sent_start * esize,
                     static_cast<size_t>(lv.sent_count) * esize, partner,
                     &incoming);
    if (!st.ok()) return st;
    if (incoming.size() != static_cast<size_t>(lv.kept_count) * esize)
      return Status::Error(StatusCode::kUnknownError, "adasum size mismatch");

    st = ToDoubleVec(buf + lv.kept_start * esize, lv.kept_count, dtype,
                     &mine_d);
    if (!st.ok()) return st;
    st = ToDoubleVec(incoming.data(), lv.kept_count, dtype, &theirs_d);
    if (!st.ok()) return st;

    // Partial dot products over the kept span; `a` is always the lower
    // sub-block's logical vector so every rank applies the same formula.
    const bool i_hold_a = (rank & d) == 0;
    double aa = 0, bb = 0, ab = 0;
    for (int64_t i = 0; i < lv.kept_count; ++i) {
      const double m = mine_d[i], th = theirs_d[i];
      ab += m * th;
      if (i_hold_a) {
        aa += m * m;
        bb += th * th;
      } else {
        aa += th * th;
        bb += m * m;
      }
    }
    // Sum the three scalars over the 2d ranks holding pieces of (a, b):
    // recursive doubling with strides 1..d (reference: the distributed
    // dot-product reduction inside FusedAllreduce).
    double dots[3] = {aa, bb, ab};
    for (int s = 1; s <= d; s <<= 1) {
      const int p2 = rank ^ s;
      st = t->SendRecv(p2, dots, sizeof(dots), p2, &incoming);
      if (!st.ok()) return st;
      if (incoming.size() != sizeof(dots))
        return Status::Error(StatusCode::kUnknownError,
                             "adasum dot exchange mismatch");
      const double* other = reinterpret_cast<const double*>(incoming.data());
      dots[0] += other[0];
      dots[1] += other[1];
      dots[2] += other[2];
    }
    aa = dots[0];
    bb = dots[1];
    ab = dots[2];

    // a <- (1 - dot/2|a|^2) a + (1 - dot/2|b|^2) b; a zero-norm operand is
    // the Adasum identity (joined ranks contribute zeros), coefficient 1
    // on the other side (reference: adasum.h:397-407 with norm guards).
    const double acoef = aa > 0.0 ? 1.0 - ab / (2.0 * aa) : 1.0;
    const double bcoef = bb > 0.0 ? 1.0 - ab / (2.0 * bb) : 1.0;
    for (int64_t i = 0; i < lv.kept_count; ++i) {
      const double m = mine_d[i], th = theirs_d[i];
      mine_d[i] = i_hold_a ? acoef * m + bcoef * th
                           : acoef * th + bcoef * m;
    }
    FromDoubleVec(mine_d, buf + lv.kept_start * esize, dtype);

    levels.push_back(lv);
    start = lv.kept_start;
    seg = lv.kept_count;
  }

  // Reverse: distance-halving allgather reconstructs the full vector.
  for (auto it = levels.rbegin(); it != levels.rend(); ++it) {
    st = t->SendRecv(it->partner, buf + it->kept_start * esize,
                     static_cast<size_t>(it->kept_count) * esize,
                     it->partner, &incoming);
    if (!st.ok()) return st;
    if (incoming.size() != static_cast<size_t>(it->sent_count) * esize)
      return Status::Error(StatusCode::kUnknownError,
                           "adasum reconstruct mismatch");
    std::memcpy(buf + it->sent_start * esize, incoming.data(),
                incoming.size());
  }
  return Status::OK();
}

Status DisseminationBarrier(Transport* t) {
  const int size = t->size();
  const int rank = t->rank();
  uint8_t token = 1;
  std::vector<uint8_t> incoming;
  for (int mask = 1; mask < size; mask <<= 1) {
    int to = (rank + mask) % size;
    int from = (rank - mask + size) % size;
    Status st = t->SendRecv(to, &token, 1, from, &incoming);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

namespace {
// Group ranks by host in ONE pass (this runs per collective on the
// cycle thread — keep it O(size)). Rank order within a host defines
// the local order; hosts are numbered by first appearance, identically
// on every rank. Returns the groups + the index of `rank`'s group.
int GroupByHost(const std::vector<int>& host_of, int rank,
                std::vector<std::vector<int>>* by_host) {
  std::map<int, int> host_slot;  // host id -> dense host index
  const int size = static_cast<int>(host_of.size());
  for (int r = 0; r < size; ++r) {
    auto it = host_slot.find(host_of[r]);
    if (it == host_slot.end()) {
      it = host_slot.emplace(host_of[r],
                             static_cast<int>(by_host->size())).first;
      by_host->emplace_back();
    }
    (*by_host)[it->second].push_back(r);
  }
  return host_slot[host_of[rank]];
}
}  // namespace

Status HierarchicalAllreduce(Transport* t, void* vbuf, int64_t count,
                             DataType dtype, RedOp op,
                             const std::vector<int>& host_of) {
  const int size = t->size();
  const int rank = t->rank();
  if (static_cast<int>(host_of.size()) != size)
    return Status::Error(StatusCode::kInvalidArgument,
                         "host_of size != transport size");
  if (size == 1 || count == 0) return Status::OK();

  std::vector<std::vector<int>> by_host;
  const std::vector<int>& my_local =
      by_host[GroupByHost(host_of, rank, &by_host)];
  const int k = static_cast<int>(my_local.size());
  const int num_hosts = static_cast<int>(by_host.size());
  if (k == 1 || num_hosts == 1)
    return RingAllreduce(t, vbuf, count, dtype, op);
  // Chunk boundaries must agree across hosts: require homogeneous local
  // sizes (the reference's hierarchical paths assume the same).
  for (const auto& group : by_host) {
    if (static_cast<int>(group.size()) != k)
      return Status::Error(StatusCode::kInvalidArgument,
                           "hierarchical allreduce needs equal ranks per "
                           "host");
  }

  int li = 0;
  while (my_local[li] != rank) ++li;
  // Cross-host group: the rank holding local index li on every host
  // (first-appearance host order keeps it identical on every rank).
  std::vector<int> cross;
  cross.reserve(num_hosts);
  for (const auto& group : by_host) cross.push_back(group[li]);
  int ci = 0;
  while (cross[ci] != rank) ++ci;

  const size_t esize = DataTypeSize(dtype);
  auto offsets = EvenOffsets(count, k);
  std::vector<int64_t> counts(k);
  for (int i = 0; i < k; ++i) counts[i] = offsets[i + 1] - offsets[i];
  uint8_t* buf = static_cast<uint8_t*>(vbuf);

  // 1. Intra-host reduce-scatter: local rank li ends up owning the
  //    locally-reduced chunk li.
  SubsetTransport local(t, my_local, li);
  std::vector<uint8_t> shard(static_cast<size_t>(counts[li]) * esize);
  Status st = RingReducescatter(&local, buf, shard.data(), counts, dtype,
                                op);
  if (!st.ok()) return st;

  // 2. Cross-host ring allreduce of chunk li among the hosts' li-ranks —
  //    the only phase that touches the cross-host network, moving
  //    count/k elements instead of count.
  SubsetTransport xhost(t, cross, ci);
  st = RingAllreduce(&xhost, shard.data(), counts[li], dtype, op);
  if (!st.ok()) return st;

  // 3. Intra-host allgather of the fully-reduced chunks.
  return RingAllgatherv(&local, shard.data(), buf, counts, dtype);
}

Status HierarchicalAllgatherv(Transport* t, const void* sendbuf,
                              void* recvbuf,
                              const std::vector<int64_t>& counts,
                              DataType dtype,
                              const std::vector<int>& host_of) {
  const int size = t->size();
  const int rank = t->rank();
  if (static_cast<int>(host_of.size()) != size ||
      static_cast<int>(counts.size()) != size)
    return Status::Error(StatusCode::kInvalidArgument,
                         "host_of/counts size != transport size");
  if (size == 1) {
    if (counts[0] > 0)
      std::memcpy(recvbuf, sendbuf, counts[0] * DataTypeSize(dtype));
    return Status::OK();
  }

  std::vector<std::vector<int>> by_host;
  const std::vector<int>& my_local =
      by_host[GroupByHost(host_of, rank, &by_host)];
  const int num_hosts = static_cast<int>(by_host.size());
  const int k = static_cast<int>(my_local.size());
  if (num_hosts == 1 || k == size)
    return RingAllgatherv(t, sendbuf, recvbuf, counts, dtype);

  const size_t esize = DataTypeSize(dtype);
  auto offsets = PrefixOffsets(counts);  // rank-order output offsets
  uint8_t* out = static_cast<uint8_t*>(recvbuf);
  int li = 0;
  while (my_local[li] != rank) ++li;
  const int leader = my_local[0];

  // 1. Gather to the host leader (local members in local order).
  if (li != 0) {
    Status st = t->Send(leader, sendbuf, counts[rank] * esize);
    if (!st.ok()) return st;
  } else {
    // Leader builds this host's bundle: members' blocks back to back.
    std::vector<uint8_t> bundle;
    int64_t bundle_elems = 0;
    for (int r : my_local) bundle_elems += counts[r];
    bundle.reserve(static_cast<size_t>(bundle_elems) * esize);
    std::vector<uint8_t> incoming;
    for (int r : my_local) {
      if (r == rank) {
        const uint8_t* p = static_cast<const uint8_t*>(sendbuf);
        bundle.insert(bundle.end(), p, p + counts[r] * esize);
      } else {
        Status st = t->Recv(r, &incoming);
        if (!st.ok()) return st;
        if (incoming.size() != static_cast<size_t>(counts[r]) * esize)
          return Status::Error(StatusCode::kUnknownError,
                               "hier allgather bundle size mismatch");
        bundle.insert(bundle.end(), incoming.begin(), incoming.end());
      }
    }

    // 2. Ring allgatherv of bundles among leaders (cross-host plane).
    std::vector<int> leaders;
    std::vector<int64_t> bundle_counts;
    int ci = -1;
    for (const auto& group : by_host) {
      if (group[0] == rank) ci = static_cast<int>(leaders.size());
      leaders.push_back(group[0]);
      int64_t c = 0;
      for (int r : group) c += counts[r];
      bundle_counts.push_back(c);
    }
    SubsetTransport xhost(t, leaders, ci);
    auto boff = PrefixOffsets(bundle_counts);
    std::vector<uint8_t> all(static_cast<size_t>(boff[num_hosts]) * esize);
    Status st = RingAllgatherv(&xhost, bundle.data(), all.data(),
                               bundle_counts, dtype);
    if (!st.ok()) return st;

    // 3a. Scatter bundle blocks into rank-order output offsets.
    for (int h = 0; h < num_hosts; ++h) {
      size_t pos = static_cast<size_t>(boff[h]) * esize;
      for (int r : by_host[h]) {
        std::memcpy(out + offsets[r] * esize, all.data() + pos,
                    counts[r] * esize);
        pos += counts[r] * esize;
      }
    }
  }

  // 3b. Leader broadcasts the assembled output to local members.
  SubsetTransport local(t, my_local, li);
  return TreeBroadcast(&local, out, offsets[size], dtype, 0);
}

}  // namespace hvdcore
