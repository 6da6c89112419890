// Flash-attention backward, dQ, for Hopper (sm_90a), bf16 and fp16.
//
// Replaces the Pallas TPU kernel _bwd_dq_kernel of
// horovod_tpu/ops/flash_attention.py (_bwd_call, pallas_call :561), in its
// three modes (no dropout, explicit keep-mask, seeded).  flash_attention.cu
// dispatches the 16-bit calls here; float32 stays on its CUDA-core kernel.
//
// What bounds it on the H100: at BERT's shape (BH 128, S 512, D 64,
// non-causal) three products over every (query, key) pair, 12.9 GFLOP,
// ~13 us of tensor-core time, against ~42 MB read and written once
// (Q, dO, dQ, K, V, LSE, delta), ~13 us at HBM rate: it sits at the ridge.
// At the TransformerLM's (BH 128, S 512, D 64, causal) half the pairs are
// visible, so the bytes bound it.  Each block reads K and V once per q tile
// (8x at S 512); those reads mostly hit the 50 MB L2.
//
// Design.  One warpgroup (128 threads) owns 64 query rows (one block per
// (bh, q tile); causal grids start the heaviest q tiles first) and walks
// the visible 64-key tiles, as the forward does:
//  * Q and dO are copied once into swizzled tiles; each thread holds the
//    LSE (in log2 units) and delta of its two rows in registers;
//  * S = Q K^T and dP = dO V^T are wgmma m64n64k16 from those tiles and the
//    stage's K and V tiles, all K-major, into 2 x 32 fp32 registers,
//    committed as two groups;
//  * P = exp2(S sm_scale log2 e - LSE log2 e) is computed in S's registers
//    while the dP product runs, then dS = P (dP keep / (1 - rate) - delta)
//    sm_scale in dP's;
//    dS is rounded in place into the A fragments of dQ += dS K (the
//    accumulator layout is the A-fragment layout), so it never touches
//    shared memory;
//  * dQ += dS K is wgmma m64nDk16 with B = the same K tile read MN-major
//    (transpose flag); dQ (D / 2 fp32 registers) stays in registers until
//    the one store at the end;
//  * K, V (and the mask tile) of tile j+1 are copied asynchronously into the
//    second of two stages while tile j is in the products; in Philox mode the
//    keep pattern of tile j+1 is drawn into its stage while the S and dP
//    products of tile j run, each element once, keyed as philox_keep_mask.
// dQ stays a kernel of its own that owns its output tile: no atomics, and
// the backward stays deterministic.
// Numerics as the TPU kernel: dP is scaled by keep / (1 - rate) before dS,
// which multiplies the undropped, unrounded P; masked elements give p = 0;
// dS is rounded to the input type for dS K.

#include "flash_sm90.cuh"

namespace hvd_flash {
namespace {

using namespace sm90;

// Shared memory (byte offsets from a 1024-byte aligned base).
template <int D, int MODE>
struct DqLayout {
  static constexpr int kTile = kBM * D * 2;    // a swizzled 64 x D tile
  static constexpr int q = 0;
  static constexpr int dout = q + kTile;
  static constexpr int k = dout + kTile;       // 2 stages
  static constexpr int v = k + 2 * kTile;      // 2 stages
  static constexpr int keep = v + 2 * kTile;   // 2 stages, dropout modes
  static constexpr int bytes =
      keep + (MODE == kNoDropout ? 0 : 2 * kKeepBytes) + 1024;  // + alignment
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s_q, int s_k, Lens L, bool causal, float sm_scale,
                    Dropout dr) {
  using Lay = DqLayout<D, MODE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const size_t q_row0 = static_cast<size_t>(bh) * s_q + qb * kBM;
  const size_t k_row0 = static_cast<size_t>(bh) * s_k;
  const int n_k = s_k / kBM;
  int n_kb = 0;  // the visible k tiles are [0, n_kb)
  while (n_kb < n_k && !block_skip(causal, L, qb, n_kb, kBM)) ++n_kb;

  auto load_stage = [&](int st, int kb) {
    load_tile<D, kBM>(base + Lay::k + st * Lay::kTile,
                      k + (k_row0 + kb * kBM) * D, tid);
    load_tile<D, kBM>(base + Lay::v + st * Lay::kTile,
                      v + (k_row0 + kb * kBM) * D, tid);
    if constexpr (MODE == kMaskDropout)
      load_keep_mask(base + Lay::keep + st * kKeepBytes, dr, bh, s_q, s_k, qb,
                     kb, tid);
  };

  load_tile<D, kBM>(base + Lay::q, q + q_row0 * D, tid);
  load_tile<D, kBM>(base + Lay::dout, dout + q_row0 * D, tid);
  if (n_kb > 0) load_stage(0, 0);
  cp_async_commit();
  if constexpr (MODE == kPhiloxDropout)
    if (n_kb > 0) draw_keep_philox(base_ptr + Lay::keep, dr, bh, qb, 0, tid);

  float lse2[2], dlt[2];  // LSE in log2 units, and delta, of rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = lse[q_row0 + r0 + 8 * h] * kLog2e;
    dlt[h] = delta[q_row0 + r0 + 8 * h];
  }
  const float c = sm_scale * kLog2e;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < n_kb) load_stage(st ^ 1, kb + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st (and Q, dO) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t k_t = base + Lay::k + st * Lay::kTile;
    const uint32_t v_t = base + Lay::v + st * Lay::kTile;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 64>(s, desc_kmajor<kBM>(base + Lay::q, 0, kk),
                      desc_kmajor<kBM>(k_t, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 64>(dp, desc_kmajor<kBM>(base + Lay::dout, 0, kk),
                      desc_kmajor<kBM>(v_t, 0, kk), kk);
    wgmma_commit();
    if constexpr (MODE == kPhiloxDropout)
      if (kb + 1 < n_kb)
        draw_keep_philox(base_ptr + Lay::keep + (st ^ 1) * kKeepBytes, dr, bh,
                         qb, kb + 1, tid);
    wgmma_wait<1>();  // S has landed; the dP product may still run
    reg_fence(s);

    // Element (row r0 + 8 h, key 8 j + 2 quad + e) of the tile sits in
    // register 4 j + 2 h + e of S and dP.  P overwrites S while the dP
    // product runs, then dS overwrites dP.
    const bool interior = tile_interior(causal, L, qb, kb, kBM);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], c, -lse2[h]));
      if (!interior &&
          !visible(causal, L, qb * kBM + r0 + 8 * h,
                   kb * kBM + (i >> 2) * 8 + 2 * quad + (i & 1)))
        p = 0.f;  // a select: LSE = -1e30 rows would give inf here
      s[i] = p;
    }
    wgmma_wait<0>();
    reg_fence(dp);
    const unsigned char* keep = base_ptr + Lay::keep + st * kKeepBytes;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      uint32_t kp = 0;
      if constexpr (MODE != kNoDropout)
        kp = *reinterpret_cast<const uint16_t*>(
            keep + (r0 + 8 * h) * kKeepLd + (i >> 2) * 8 + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dpv = dp[i + e];
        if constexpr (MODE != kNoDropout)
          dpv *= ((kp >> (8 * e)) & 0xffu) ? dr.scale : 0.f;
        dp[i + e] = s[i + e] * (dpv - dlt[h]) * sm_scale;
      }
    }
    uint32_t dsa[16];
    to_a_fragments<T, 32>(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      uint32_t a[4];
      a_step(dsa, kk, a);
      wgmma_rs<T, D>(dq_acc, a, desc_mnmajor<kBM>(k_t, 16 * kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_acc);
    reg_fence(dsa);
    __syncthreads();  // stage st is free for tile kb + 2
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no tile visible

  T* const dq_out = dq + q_row0 * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = (i >> 2) * 8 + 2 * quad;
    *reinterpret_cast<uint32_t*>(dq_out + row * D + col) =
        pack2<T>(dq_acc[i], dq_acc[i + 1]);
  }
}

}  // namespace

template <typename T, int D, int MODE>
cudaError_t bwd_dq_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int s_q, int s_k, Lens L,
                        bool causal, float scale, Dropout dr,
                        cudaStream_t stream) {
  constexpr int kBytes = DqLayout<D, MODE>::bytes;
  auto kernel = flash_bwd_dq_kernel<T, D, MODE>;
  const cudaError_t err = prepare(kernel, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, s_q / kBM), kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), s_q, s_k, L, causal, scale, dr);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t bwd_dq_sm90_attrs(KernelAttrs* out) {
  return kernel_attrs(flash_bwd_dq_kernel<T, D, MODE>,
                      DqLayout<D, MODE>::bytes, out);
}

#define HVD_DQ_SM90(T, D, MODE)                                                \
  template cudaError_t bwd_dq_sm90<T, D, MODE>(                                \
      const void*, const void*, const void*, const void*, const float*,        \
      const float*, void*, int, int, int, Lens, bool, float, Dropout,          \
      cudaStream_t);                                                           \
  template cudaError_t bwd_dq_sm90_attrs<T, D, MODE>(KernelAttrs*);
#define HVD_DQ_SM90_MODES(T, D) \
  HVD_DQ_SM90(T, D, 0) HVD_DQ_SM90(T, D, 1) HVD_DQ_SM90(T, D, 2)
HVD_DQ_SM90_MODES(__nv_bfloat16, 64)
HVD_DQ_SM90_MODES(__nv_bfloat16, 128)
HVD_DQ_SM90_MODES(__half, 64)
HVD_DQ_SM90_MODES(__half, 128)

}  // namespace hvd_flash
