// Building blocks of the Hopper (sm_90a) flash-attention kernels: tiles
// copied asynchronously into the 128-byte swizzled shared-memory layout that
// wgmma reads, wgmma descriptors for that layout in its K-major and MN-major
// views, the wgmma products (A from shared memory or from registers, fp32
// accumulators in registers), and the staging of a tile's dropout keep
// pattern.
//
// Why cp.async and not TMA: the tiles are 64 rows of one (bh) slice, a
// straight 2-D box that 128 threads copy in 4 (D 64) or 8 (D 128) 16-byte
// steps each, with the swizzle computed in a shift and an xor.  TMA would
// need a tensor map per operand per call, encoded on the host
// (cuTensorMapEncodeTiled, from libcuda), on paths whose step is
// already bound by the host's enqueue time; and the dropout keep tile, which
// rides in the same stage, is staged by the threads either way.  The copies
// of stage j+1 are in flight while stage j is in the products
// (cp.async.commit_group / wait_group 1).
//
// Shared-memory tile layout ("swizzled tile"): a ROWS x D tile of 16-bit
// values is stored as D/64 column blocks, each ROWS rows of 128 bytes; the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8).  With each block
// 1024-byte aligned, this is the layout of wgmma's 128-byte swizzle
// (LayoutType B128): address bits [4,7) xor bits [7,10).  The same tile is
//  * K-major (the reduction runs along D): 8-row groups 1024 bytes apart
//    (SBO), each k16 step 32 bytes further along the row, the next column
//    block after 4 steps;
//  * MN-major (the reduction runs along the rows, N along D): k16 steps of
//    16 rows (2048 bytes), 8-row groups 1024 bytes apart (SBO), the next
//    64-wide N block one column block further (LBO = ROWS * 128 bytes).
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace hvd_flash {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;                // one warpgroup
constexpr int kBM = 64;                      // rows (and keys) of every tile
constexpr int kKeepLd = 80;                  // bytes per row of a keep tile
constexpr int kKeepBytes = kBM * kKeepLd;    // one staged 64 x 64 keep tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed copies visible to wgmma, which reads shared
// memory through the async proxy; a __syncthreads() follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma writes (accumulators) or reads
// (A fragments) at this point of the program: placed after wgmma_wait, it
// keeps the compiler from reading an accumulator, or reusing an A register,
// before the product has finished.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma matrix descriptor of a 128-byte swizzled operand at shared address
// ADDR: leading and stride byte offsets in bytes (encoded in 16-byte units),
// layout type 1 (B128) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major view of rows [row0, row0 + N) of a swizzled tile, k16 step KK of
// the D axis.  ROW0 is a multiple of 8.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0,
                                                int kk) {
  return desc_sw128(tile + (kk / 4) * (ROWS * 128) + row0 * 128 + (kk % 4) * 32,
                    16, 1024);
}

// MN-major view (N along D) of the k16 step over rows [row0, row0 + 16).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int row0) {
  return desc_sw128(tile + row0 * 128, ROWS * 128, 1024);
}

// Asynchronous copy of ROWS rows of a row-major (*, D) matrix of 16-bit
// values into a swizzled tile, by the block's 128 threads.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const void* src,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kChunks % kThreads == 0, "whole steps per thread");
  const char* s = static_cast<const char*>(src);
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks;
    const int ch = i % kChunks;
    const uint32_t off = (ch / 8) * (ROWS * 128) + r * 128 +
                         (((ch % 8) ^ (r % 8)) << 4);
    cp_async16(dst + off, s + static_cast<size_t>(r) * (D * 2) + ch * 16);
  }
}

// Keep tile (qb, kb) of head bh: a 64 x 64 byte tile, rows (queries)
// kKeepLd bytes apart, one 0/1 byte per element.
// Mask mode: an asynchronous copy of the keep-mask's tile.
__device__ __forceinline__ void load_keep_mask(uint32_t dst, const Dropout& dr,
                                               int bh, int s_q, int s_k, int qb,
                                               int kb, int tid) {
#pragma unroll
  for (int it = 0; it < kBM * 4 / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / 4;
    const int ch = i % 4;
    cp_async16(dst + r * kKeepLd + ch * 16,
               dr.mask + (static_cast<size_t>(bh) * s_q + qb * kBM + r) * s_k +
                   kb * kBM + ch * 16);
  }
}

// Philox mode: drawn, one generator call per 4 keys, each element once
// (counter (col / 4, row) in global coordinates of the head, key (seed, bh),
// as philox_keep_mask).
__device__ __forceinline__ void draw_keep_philox(unsigned char* dst,
                                                 const Dropout& dr, int bh,
                                                 int qb, int kb, int tid) {
  constexpr int kGroups = kBM / 4;
#pragma unroll 2
  for (int it = 0; it < kBM * kGroups / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kGroups;
    const int g = i % kGroups;
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(kb * kGroups + g),
                   static_cast<uint32_t>(qb * kBM + r), 0u, 0u),
        make_uint2(dr.seed, static_cast<uint32_t>(bh)));
    const uint32_t t = dr.threshold;
    *reinterpret_cast<uint32_t*>(dst + r * kKeepLd + g * 4) =
        static_cast<uint32_t>(w.x < t) | (static_cast<uint32_t>(w.y < t) << 8) |
        (static_cast<uint32_t>(w.z < t) << 16) |
        (static_cast<uint32_t>(w.w < t) << 24);
  }
}

// Two fp32 values rounded to the input type and packed into one register:
// the lower k index in the low half, as the A fragment of wgmma holds them.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma.mma_async m64nNk16, fp32 accumulators.  _ss: A and B from shared
// memory, both K-major; scale_d 0 overwrites the accumulator.  _rs: A from
// registers, B MN-major (transposed), accumulating.
//
// The accumulator of an m64nN product, in thread t of the warpgroup
// (warp w = t / 32, lane l = t % 32): register i holds row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
// Registers 8 kk .. 8 kk + 7, packed in pairs, are exactly the A fragment
// of k16 step kk of a product whose K runs along those columns.

__device__ __forceinline__ void wgmma_ss_m64n32_bf16(float (&d)[16], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n64_bf16(float (&d)[32], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128_bf16(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n32_f16(float (&d)[16], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n64_f16(float (&d)[32], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64_f16(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128_f16(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 32 || N == 64, "m64n32 or m64n64");
  if constexpr (N == 32) {
    if constexpr (kBf16) wgmma_ss_m64n32_bf16(d, da, db, scale_d);
    else wgmma_ss_m64n32_f16(d, da, db, scale_d);
  } else {
    if constexpr (kBf16) wgmma_ss_m64n64_bf16(d, da, db, scale_d);
    else wgmma_ss_m64n64_f16(d, da, db, scale_d);
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 64 || N == 128, "m64n64 or m64n128");
  if constexpr (N == 64) {
    if constexpr (kBf16) wgmma_rs_m64n64_bf16(d, a, db);
    else wgmma_rs_m64n64_f16(d, a, db);
  } else {
    if constexpr (kBf16) wgmma_rs_m64n128_bf16(d, a, db);
    else wgmma_rs_m64n128_f16(d, a, db);
  }
}

// Rounds pairs of accumulator registers into the A fragments of the k16
// steps along the accumulator's columns.
template <typename T, int N>
__device__ __forceinline__ void to_a_fragments(const float (&acc)[N],
                                               uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack2<T>(acc[2 * i], acc[2 * i + 1]);
}

// The four registers of k16 step KK.
template <int N>
__device__ __forceinline__ void a_step(const uint32_t (&frag)[N], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = frag[4 * kk + i];
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

}  // namespace sm90
}  // namespace hvd_flash
