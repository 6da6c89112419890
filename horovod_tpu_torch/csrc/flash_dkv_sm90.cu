// Flash-attention backward, dK and dV, for Hopper (sm_90a), bf16 and fp16.
//
// Replaces the Pallas TPU kernel _bwd_dkv_kernel of
// horovod_tpu/ops/flash_attention.py (_bwd_call, pallas_call :524), in its
// three modes (no dropout, explicit keep-mask, seeded).  flash_attention.cu
// dispatches the 16-bit calls here; float32 stays on its CUDA-core kernel.
//
// What bounds it on the H100: at BERT's shape (BH 128, S 512, D 64,
// non-causal) four products over every (query, key) pair, 17.2 GFLOP,
// ~17 us of tensor-core time against ~10 us of HBM traffic: operations.
//
// Design.  One warpgroup owns 64 keys (one block per (bh, k tile); causal
// grids put the key tiles that see the most queries first) and walks the
// visible 64-query tiles, in sub-tiles of NQ queries (64 at D 64; 32 at
// D 128, where dK and dV alone hold 128 fp32 registers per thread).  It
// computes the transposed products, so that every per-key quantity stays in
// the accumulator layout:
//  * S^T = K Q^T and dP^T = V dO^T: wgmma m64nNQk16, A (K, V) and B (Q, dO)
//    K-major from the swizzled tiles in shared memory;
//  * P^T = exp2(S^T sm_scale log2 e - LSE log2 e) and
//    dS^T = P^T (dP^T keep / (1 - rate) - delta) sm_scale in registers, LSE
//    and delta indexed by column from the stage's row vectors;
//  * dV += P^T dO and dK += dS^T Q: wgmma m64nDk16 with A = P^T (dropped) and
//    dS^T rounded in place from the accumulators (their layout is the A
//    fragment layout) and B = dO, Q: the same swizzled tiles, now read
//    MN-major (transpose flag); dK and dV stay in registers to the end;
//  * Q, dO, LSE, delta (and the mask tile) of q tile j+1 are copied
//    asynchronously into the second stage while tile j is in the products;
//    in Philox mode the keep pattern of tile j+1 is drawn into its stage,
//    each element once, while the dV and dK products of tile j run.  Each
//    thread holds 2 keys x 16 queries of a tile and one generator call gives
//    4 keys of one query, so the pattern goes through that small shared tile
//    rather than being drawn four times over.
// Registers: __launch_bounds__ names a minimum of one block per SM.  Left
// to itself ptxas holds the Philox mode to ~190 registers, which fits no
// more blocks (two) than the ~230 it takes when allowed, and the larger
// allocation runs the seeded kernel ~15% faster on the H100.
// Numerics as the TPU kernel: dV takes P * keep / (1 - rate) rounded to the
// input type; dP is scaled by keep / (1 - rate) before dS, which multiplies
// the undropped, unrounded P; masked elements give p = 0.

#include "flash_sm90.cuh"

namespace hvd_flash {
namespace {

using namespace sm90;

template <int D, int MODE>
struct DkvLayout {
  static constexpr int kTile = kBM * D * 2;
  static constexpr int k = 0;
  static constexpr int v = k + kTile;
  static constexpr int q = v + kTile;          // 2 stages
  static constexpr int dout = q + 2 * kTile;   // 2 stages
  static constexpr int lse = dout + 2 * kTile; // 2 stages of 64 fp32
  static constexpr int delta = lse + 2 * kBM * 4;
  static constexpr int keep = delta + 2 * kBM * 4;  // 2 stages, dropout modes
  static constexpr int bytes =
      keep + (MODE == kNoDropout ? 0 : 2 * kKeepBytes) + 1024;  // + alignment
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s_q, int s_k, Lens L, bool causal,
                     float sm_scale, Dropout dr) {
  using Lay = DkvLayout<D, MODE>;
  constexpr int NQ = D == 64 ? 64 : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's keys r0, r0 + 8
  const int bh = blockIdx.x;
  const int kb = blockIdx.y;
  const size_t k_row0 = static_cast<size_t>(bh) * s_k + kb * kBM;
  const size_t q_row0 = static_cast<size_t>(bh) * s_q;
  const int n_q = s_q / kBM;
  int qb0 = 0;  // the visible q tiles are [qb0, n_q)
  while (qb0 < n_q && block_skip(causal, L, qb0, kb, kBM)) ++qb0;

  auto load_stage = [&](int st, int qb) {
    const size_t row = q_row0 + qb * kBM;
    load_tile<D, kBM>(base + Lay::q + st * Lay::kTile, q + row * D, tid);
    load_tile<D, kBM>(base + Lay::dout + st * Lay::kTile, dout + row * D, tid);
    if (tid < 32) {  // 16 chunks of LSE, 16 of delta
      const int ch = tid % 16;
      const float* src = (tid < 16 ? lse : delta) + row + ch * 4;
      cp_async16(base + (tid < 16 ? Lay::lse : Lay::delta) + st * kBM * 4 +
                     ch * 16,
                 src);
    }
    if constexpr (MODE == kMaskDropout)
      load_keep_mask(base + Lay::keep + st * kKeepBytes, dr, bh, s_q, s_k, qb,
                     kb, tid);
  };

  if (qb0 < n_q) {
    load_tile<D, kBM>(base + Lay::k, k + k_row0 * D, tid);
    load_tile<D, kBM>(base + Lay::v, v + k_row0 * D, tid);
    load_stage(0, qb0);
  }
  cp_async_commit();
  if constexpr (MODE == kPhiloxDropout)
    if (qb0 < n_q) draw_keep_philox(base_ptr + Lay::keep, dr, bh, qb0, kb, tid);

  const float c = sm_scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int qb = qb0; qb < n_q; ++qb) {
    const int st = (qb - qb0) & 1;
    if (qb + 1 < n_q) load_stage(st ^ 1, qb + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st (and K, V) have landed
    fence_proxy_async();
    __syncthreads();

    const bool interior = tile_interior(causal, L, qb, kb, kBM);
    const uint32_t q_t = base + Lay::q + st * Lay::kTile;
    const uint32_t do_t = base + Lay::dout + st * Lay::kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(base_ptr + Lay::lse + st * kBM * 4);
    const float* delta_s =
        reinterpret_cast<const float*>(base_ptr + Lay::delta + st * kBM * 4);
    const unsigned char* keep = base_ptr + Lay::keep + st * kKeepBytes;

#pragma unroll
    for (int sub = 0; sub < kBM / NQ; ++sub) {
      float s[NQ / 2], dp[NQ / 2];
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) {
        s[i] = 0.f;
        dp[i] = 0.f;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, NQ>(s, desc_kmajor<kBM>(base + Lay::k, 0, kk),
                        desc_kmajor<kBM>(q_t, sub * NQ, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, NQ>(dp, desc_kmajor<kBM>(base + Lay::v, 0, kk),
                        desc_kmajor<kBM>(do_t, sub * NQ, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // Element (key r0 + 8 h, query sub * NQ + 8 j + 2 quad + e) of the
      // transposed tile sits in register 4 j + 2 h + e.
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) {
        const int kl = r0 + 8 * ((i >> 1) & 1);
        const int ql = sub * NQ + (i >> 2) * 8 + 2 * quad + (i & 1);
        float p = exp2f(fmaf(s[i], c, -lse_s[ql] * kLog2e));
        if (!interior && !visible(causal, L, qb * kBM + ql, kb * kBM + kl))
          p = 0.f;  // a select: LSE = -1e30 rows would give inf here
        float dpv = dp[i];
        float pv = p;
        if constexpr (MODE != kNoDropout) {
          const float kp = keep[ql * kKeepLd + kl] ? dr.scale : 0.f;
          pv = p * kp;
          dpv = dpv * kp;
        }
        s[i] = pv;
        dp[i] = p * (dpv - delta_s[ql]) * sm_scale;
      }
      uint32_t pa[NQ / 4], sa[NQ / 4];
      to_a_fragments<T, NQ / 2>(s, pa);
      to_a_fragments<T, NQ / 2>(dp, sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        uint32_t a[4];
        a_step(pa, kk, a);
        wgmma_rs<T, D>(dv_acc, a, desc_mnmajor<kBM>(do_t, sub * NQ + 16 * kk));
        a_step(sa, kk, a);
        wgmma_rs<T, D>(dk_acc, a, desc_mnmajor<kBM>(q_t, sub * NQ + 16 * kk));
      }
      wgmma_commit();
      if constexpr (MODE == kPhiloxDropout)
        if (sub == 0 && qb + 1 < n_q)
          draw_keep_philox(base_ptr + Lay::keep + (st ^ 1) * kKeepBytes, dr,
                           bh, qb + 1, kb, tid);
      wgmma_wait<0>();
      reg_fence(dv_acc);
      reg_fence(dk_acc);
      reg_fence(pa);
      reg_fence(sa);
    }
    __syncthreads();  // stage st is free for tile qb + 2
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no tile visible

  T* const dk_out = dk + k_row0 * D;
  T* const dv_out = dv + k_row0 * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = (i >> 2) * 8 + 2 * quad;
    *reinterpret_cast<uint32_t*>(dk_out + row * D + col) =
        pack2<T>(dk_acc[i], dk_acc[i + 1]);
    *reinterpret_cast<uint32_t*>(dv_out + row * D + col) =
        pack2<T>(dv_acc[i], dv_acc[i + 1]);
  }
}

}  // namespace

template <typename T, int D, int MODE>
cudaError_t bwd_dkv_sm90(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh,
                         int s_q, int s_k, Lens L, bool causal, float scale,
                         Dropout dr, cudaStream_t stream) {
  constexpr int kBytes = DkvLayout<D, MODE>::bytes;
  auto kernel = flash_bwd_dkv_kernel<T, D, MODE>;
  const cudaError_t err = prepare(kernel, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, s_k / kBM), kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), s_q, s_k, L, causal, scale,
      dr);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t bwd_dkv_sm90_attrs(KernelAttrs* out) {
  return kernel_attrs(flash_bwd_dkv_kernel<T, D, MODE>,
                      DkvLayout<D, MODE>::bytes, out);
}

#define HVD_DKV_SM90(T, D, MODE)                                               \
  template cudaError_t bwd_dkv_sm90<T, D, MODE>(                               \
      const void*, const void*, const void*, const void*, const float*,        \
      const float*, void*, void*, int, int, int, Lens, bool, float, Dropout,   \
      cudaStream_t);                                                           \
  template cudaError_t bwd_dkv_sm90_attrs<T, D, MODE>(KernelAttrs*);
#define HVD_DKV_SM90_MODES(T, D) \
  HVD_DKV_SM90(T, D, 0) HVD_DKV_SM90(T, D, 1) HVD_DKV_SM90(T, D, 2)
HVD_DKV_SM90_MODES(__nv_bfloat16, 64)
HVD_DKV_SM90_MODES(__nv_bfloat16, 128)
HVD_DKV_SM90_MODES(__half, 64)
HVD_DKV_SM90_MODES(__half, 128)

}  // namespace hvd_flash
