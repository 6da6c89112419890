// Core types shared across the native runtime.
//
// TPU-native rethink of the reference's common layer (reference:
// horovod/common/common.h). The native core owns the *host-side* machinery —
// negotiation, fusion planning, CPU data plane, timeline — while the TPU data
// plane lives in compiled XLA programs on the Python side.
#ifndef HVDCORE_COMMON_H_
#define HVDCORE_COMMON_H_

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace hvdcore {

// Matches numpy dtype kinds the Python binding marshals
// (reference dtype enum: horovod/common/common.h DataType / message.h).
enum class DataType : uint8_t {
  kUint8 = 0,
  kInt8 = 1,
  kInt32 = 2,
  kInt64 = 3,
  kFloat16 = 4,
  kFloat32 = 5,
  kFloat64 = 6,
  kBool = 7,
  kBFloat16 = 8,
};

inline size_t DataTypeSize(DataType t) {
  switch (t) {
    case DataType::kUint8:
    case DataType::kInt8:
    case DataType::kBool:
      return 1;
    case DataType::kFloat16:
    case DataType::kBFloat16:
      return 2;
    case DataType::kInt32:
    case DataType::kFloat32:
      return 4;
    case DataType::kInt64:
    case DataType::kFloat64:
      return 8;
  }
  return 1;
}

inline const char* DataTypeName(DataType t) {
  switch (t) {
    case DataType::kUint8: return "uint8";
    case DataType::kInt8: return "int8";
    case DataType::kInt32: return "int32";
    case DataType::kInt64: return "int64";
    case DataType::kFloat16: return "float16";
    case DataType::kFloat32: return "float32";
    case DataType::kFloat64: return "float64";
    case DataType::kBool: return "bool";
    case DataType::kBFloat16: return "bfloat16";
  }
  return "?";
}

// Collective kinds (reference Request::RequestType, horovod/common/message.h).
enum class ReqType : uint8_t {
  kAllreduce = 0,
  kAllgather = 1,
  kBroadcast = 2,
  kAlltoall = 3,
  kReducescatter = 4,
  kBarrier = 5,
  kJoin = 6,
};

// Reduction ops (reference ReduceOp: Average is Sum + postscale on the
// Python side, reference: horovod/common/operations.cc:1408-1424).
enum class RedOp : uint8_t {
  kSum = 0,
  kMin = 1,
  kMax = 2,
  kProd = 3,
  kAdasum = 4,  // VHDD adaptive summation (collectives.cc VhddAdasum)
};

enum class StatusCode : uint8_t {
  kOk = 0,
  kUnknownError = 1,
  kPreconditionError = 2,
  kAborted = 3,
  kInvalidArgument = 4,
  kInProgress = 5,
};

struct Status {
  StatusCode code = StatusCode::kOk;
  std::string reason;
  static Status OK() { return Status{}; }
  static Status Error(StatusCode c, std::string r) { return Status{c, std::move(r)}; }
  bool ok() const { return code == StatusCode::kOk; }
};

// Simple leveled logging to stderr with rank prefix (reference:
// horovod/common/logging.h LOG(level, rank)).
enum class LogLevel : int { kTrace = 0, kDebug = 1, kInfo = 2, kWarn = 3, kError = 4, kNone = 5 };
LogLevel GlobalLogLevel();
void LogMsg(LogLevel level, int rank, const std::string& msg);

}  // namespace hvdcore

#endif  // HVDCORE_COMMON_H_
