// Wire format for coordinator negotiation.
//
// The reference serializes Request/Response lists with flatbuffers
// (reference: horovod/common/wire/message.fbs, message.cc). We use a compact
// hand-rolled little-endian binary format instead: the messages are small,
// fixed in structure, and a zero-dependency encoder keeps the native core
// self-contained.
#ifndef HVDCORE_MESSAGE_H_
#define HVDCORE_MESSAGE_H_

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdcore {

// One named-tensor request from one rank (reference: Request table,
// horovod/common/wire/message.fbs:44-67).
struct Request {
  int32_t rank = 0;
  ReqType type = ReqType::kAllreduce;
  RedOp op = RedOp::kSum;
  DataType dtype = DataType::kFloat32;
  std::string name;
  int32_t root_rank = -1;
  int32_t group_id = -1;  // grouped-allreduce atomic fusion (group_table.cc)
  double prescale = 1.0;
  double postscale = 1.0;
  std::vector<int64_t> shape;
  std::vector<int32_t> splits;  // alltoall send splits
};

// Coordinator's fused verdict (reference: Response table, message.fbs:78+).
struct Response {
  ReqType type = ReqType::kAllreduce;
  RedOp op = RedOp::kSum;
  DataType dtype = DataType::kFloat32;
  std::vector<std::string> names;    // >1 => fused bucket
  std::string error;                 // non-empty => error response
  double prescale = 1.0;
  double postscale = 1.0;
  // Allgather/alltoall: first-dim sizes per rank, flattened per tensor
  // (reference: Response::tensor_sizes).
  std::vector<int64_t> sizes;
  int32_t last_joined_rank = -1;
};

struct RequestList {
  std::vector<Request> requests;
  bool shutdown = false;
};

struct ResponseList {
  std::vector<Response> responses;
  bool shutdown = false;
};

void Serialize(const RequestList& in, std::vector<uint8_t>* out);
bool Deserialize(const uint8_t* data, size_t len, RequestList* out);
void Serialize(const ResponseList& in, std::vector<uint8_t>* out);
bool Deserialize(const uint8_t* data, size_t len, ResponseList* out);

}  // namespace hvdcore

#endif  // HVDCORE_MESSAGE_H_
