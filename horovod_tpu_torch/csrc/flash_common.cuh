// What every flash-attention translation unit shares: the masking rules of
// the TPU kernels (global-coordinate causal mask, key padding, tile skip),
// the dropout arguments and the Philox4x32-10 generator, and the entry points
// of the Hopper kernels (flash_fwd_sm90.cu, flash_dkv_sm90.cu,
// flash_dq_sm90.cu) that flash_attention.cu dispatches to.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF

struct Lens {
  int q_off;
  int k_off;
  int kv_len;
};

// Attention-dropout modes, shared with the Python wrapper.
enum Mode { kNoDropout = 0, kMaskDropout = 1, kPhiloxDropout = 2 };

struct Dropout {
  const uint8_t* mask;  // (BH, S_q, S_k) 0/1 keep-mask, mask mode
  float scale;          // 1 / (1 - rate)
  uint32_t threshold;   // Philox mode keeps an element when its word < this
  uint32_t seed;        // Philox mode key word 0 (word 1 is bh)
};

// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// _block_skip: the tile contributes nothing (all keys padding, or the whole
// tile above the causal diagonal).  For a fixed q tile the skipped k tiles
// are a suffix; for a fixed k tile the skipped q tiles are a prefix.
__device__ __forceinline__ bool block_skip(bool causal, Lens L, int qb, int kb,
                                           int bm) {
  bool skip = kb * bm >= L.kv_len;
  if (causal) skip = skip || (L.q_off + qb * bm + bm - 1 < L.k_off + kb * bm);
  return skip;
}

// _tile_interior: no element of the tile is masked.
__device__ __forceinline__ bool tile_interior(bool causal, Lens L, int qb,
                                              int kb, int bm) {
  bool inside = (kb + 1) * bm <= L.kv_len;
  if (causal) inside = inside && (L.k_off + kb * bm + bm - 1 <= L.q_off + qb * bm);
  return inside;
}

__device__ __forceinline__ bool visible(bool causal, Lens L, int row, int col) {
  return col < L.kv_len && (!causal || L.q_off + row >= L.k_off + col);
}

// Lets KERNEL launch with SMEM bytes of dynamic shared memory (above 48 KB
// only after this call).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// What a kernel instance uses, for the attribute entry point:
// registers per thread, static and dynamic shared memory bytes, local
// (spill) bytes per thread.
struct KernelAttrs {
  int regs, static_smem, dynamic_smem, local_bytes;
};

template <typename Kernel>
cudaError_t kernel_attrs(Kernel kernel, size_t dynamic_smem, KernelAttrs* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  *out = KernelAttrs{a.numRegs, static_cast<int>(a.sharedSizeBytes),
                     static_cast<int>(dynamic_smem),
                     static_cast<int>(a.localSizeBytes)};
  return cudaSuccess;
}

// The Hopper kernels for 16-bit inputs (T = __nv_bfloat16 or __half,
// D = 64 or 128, MODE an enum Mode), defined and instantiated in
// flash_fwd_sm90.cu, flash_dkv_sm90.cu and flash_dq_sm90.cu.
template <typename T, int D, int MODE>
cudaError_t fwd_sm90(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int s_q, int s_k, Lens L, bool causal,
                     float scale, Dropout dr, cudaStream_t stream);

template <typename T, int D, int MODE>
cudaError_t fwd_sm90_attrs(KernelAttrs* out);

template <typename T, int D, int MODE>
cudaError_t bwd_dkv_sm90(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh,
                         int s_q, int s_k, Lens L, bool causal, float scale,
                         Dropout dr, cudaStream_t stream);

template <typename T, int D, int MODE>
cudaError_t bwd_dkv_sm90_attrs(KernelAttrs* out);

template <typename T, int D, int MODE>
cudaError_t bwd_dq_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int s_q, int s_k, Lens L,
                        bool causal, float scale, Dropout dr,
                        cudaStream_t stream);

template <typename T, int D, int MODE>
cudaError_t bwd_dq_sm90_attrs(KernelAttrs* out);

}  // namespace hvd_flash
