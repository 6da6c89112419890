// Flash-attention forward for Hopper (sm_90a), bf16 and fp16 inputs.
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// horovod_tpu/ops/flash_attention.py (_fwd_call, pallas_call :295), in its
// three modes: no dropout, explicit keep-mask (_keep_scale :134) and seeded
// dropout (_seeded_keep_scale :141).  flash_attention.cu dispatches the
// 16-bit calls here; float32 stays on its CUDA-core kernel there.
//
// What bounds it on the H100: at BERT's shape (BH 128, S 512, D 64,
// non-causal) one call moves ~34 MB and does 8.6 GFLOP: ~10 us at HBM rate
// against ~9 us of tensor-core time, so both, and the exp2 of 33.5M scores
// beside them; the Philox mode adds 8.4M generator calls of integer work.
//
// Design.  One warpgroup (128 threads) owns 64 query rows (one block per
// (bh, q tile); causal grids start the heaviest q tiles first) and walks the
// visible 64-key tiles:
//  * S = Q K^T is wgmma m64n64k16 from the swizzled Q and K tiles in shared
//    memory into 32 fp32 registers per thread;
//  * the online softmax runs in those registers: each row lives in the 4
//    lanes of a quad, so its max and sum take two shuffles; scores are
//    pre-scaled by sm_scale * log2(e) and exponentiated with exp2f; O's
//    rescale is a register multiply;
//  * P (dropped, P * keep / (1 - rate)) is rounded to the input type in
//    place: the accumulator layout of S is the A-fragment layout of
//    O += P V, so P never leaves registers; V is the MN-major B operand
//    (transpose flag) of wgmma m64nDk16, O stays in registers;
//  * K, V (and the mask tile) of tile j+1 are copied asynchronously into the
//    second of two stages while tile j is in the products; in Philox mode the
//    keep pattern of tile j+1 is drawn into its stage while the S product of
//    tile j runs, each element once.
// Numerics as the TPU kernel: the normaliser sums the undropped P, P is
// rounded to the input type for P.V, masked scores give p = 0, rows that see
// no key give O = 0 and LSE = -1e30.

#include "flash_sm90.cuh"

namespace hvd_flash {
namespace {

using namespace sm90;

// Shared memory (byte offsets from a 1024-byte aligned base).
template <int D, int MODE>
struct FwdLayout {
  static constexpr int kTile = kBM * D * 2;     // a swizzled 64 x D tile
  static constexpr int q = 0;
  static constexpr int k = q + kTile;           // 2 stages
  static constexpr int v = k + 2 * kTile;       // 2 stages
  static constexpr int keep = v + 2 * kTile;    // 2 stages, dropout modes
  static constexpr int bytes =
      keep + (MODE == kNoDropout ? 0 : 2 * kKeepBytes) + 1024;  // + alignment
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s_q, int s_k, Lens L,
                 bool causal, float sm_scale, Dropout dr) {
  using Lay = FwdLayout<D, MODE>;
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
  if (n_kb > 0) load_stage(0, 0);
  cp_async_commit();
  if constexpr (MODE == kPhiloxDropout)
    if (n_kb > 0) draw_keep_philox(base_ptr + Lay::keep, dr, bh, qb, 0, tid);

  const float c = sm_scale * kLog2e;
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l_r[2] = {0.f, 0.f};          // running normaliser (undropped)

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < n_kb) load_stage(st ^ 1, kb + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 64>(s, desc_kmajor<kBM>(base + Lay::q, 0, kk),
                      desc_kmajor<kBM>(base + Lay::k + st * Lay::kTile, 0, kk),
                      kk);
    wgmma_commit();
    if constexpr (MODE == kPhiloxDropout)
      if (kb + 1 < n_kb)
        draw_keep_philox(base_ptr + Lay::keep + (st ^ 1) * kKeepBytes, dr, bh,
                         qb, kb + 1, tid);
    wgmma_wait<0>();
    reg_fence(s);

    // Online softmax on this thread's 2 rows x 16 columns.
    const bool interior = tile_interior(causal, L, qb, kb, kBM);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = s[i] * c;
      if (!interior) {
        const int col = kb * kBM + (i >> 2) * 8 + 2 * quad + (i & 1);
        if (!visible(causal, L, qb * kBM + r0 + 8 * h, col)) x = neg_inf();
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_r[h] - mx[h]);
      m_r[h] = mx[h];  // stays -1e30 (finite) while a row has seen no key
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = exp2f(s[i] - m_r[h]);  // masked: exp2(-inf) = 0
      sum[h] += p;
      s[i] = p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
    if constexpr (MODE != kNoDropout) {
      // P.V takes P * keep / (1 - rate); the normaliser kept the undropped P.
      const unsigned char* keep = base_ptr + Lay::keep + st * kKeepBytes;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = r0 + 8 * ((i >> 1) & 1);
        const int col = (i >> 2) * 8 + 2 * quad;
        const uint32_t kp =
            *reinterpret_cast<const uint16_t*>(keep + row * kKeepLd + col);
        s[i] *= (kp & 0xffu) ? dr.scale : 0.f;
        s[i + 1] *= (kp >> 8) ? dr.scale : 0.f;
      }
    }
    uint32_t pa[16];
    to_a_fragments<T, 32>(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      uint32_t a[4];
      a_step(pa, kk, a);
      wgmma_rs<T, D>(
          o_acc, a,
          desc_mnmajor<kBM>(base + Lay::v + st * Lay::kTile, 16 * kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o_acc);
    reg_fence(pa);
    __syncthreads();  // stage st is free for tile kb + 2
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no tile visible

  T* const o_out = o + q_row0 * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const float l = l_r[h] == 0.f ? 1.f : l_r[h];
    const int row = r0 + 8 * h;
    const int col = (i >> 2) * 8 + 2 * quad;
    *reinterpret_cast<uint32_t*>(o_out + row * D + col) =
        pack2<T>(o_acc[i] / l, o_acc[i + 1] / l);
  }
  if (quad == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lse[q_row0 + r0 + 8 * h] =
          l_r[h] == 0.f ? kNegInf : m_r[h] * kLn2 + logf(l_r[h]);
  }
}

}  // namespace

template <typename T, int D, int MODE>
cudaError_t fwd_sm90(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int s_q, int s_k, Lens L, bool causal,
                     float scale, Dropout dr, cudaStream_t stream) {
  constexpr int kBytes = FwdLayout<D, MODE>::bytes;
  auto kernel = flash_fwd_kernel<T, D, MODE>;
  const cudaError_t err = prepare(kernel, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, s_q / kBM), kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s_q, s_k, L, causal,
      scale, dr);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t fwd_sm90_attrs(KernelAttrs* out) {
  return kernel_attrs(flash_fwd_kernel<T, D, MODE>, FwdLayout<D, MODE>::bytes,
                      out);
}

#define HVD_FWD_SM90(T, D, MODE)                                               \
  template cudaError_t fwd_sm90<T, D, MODE>(                                   \
      const void*, const void*, const void*, void*, float*, int, int, int,     \
      Lens, bool, float, Dropout, cudaStream_t);                               \
  template cudaError_t fwd_sm90_attrs<T, D, MODE>(KernelAttrs*);
#define HVD_FWD_SM90_MODES(T, D) \
  HVD_FWD_SM90(T, D, 0) HVD_FWD_SM90(T, D, 1) HVD_FWD_SM90(T, D, 2)
HVD_FWD_SM90_MODES(__nv_bfloat16, 64)
HVD_FWD_SM90_MODES(__nv_bfloat16, 128)
HVD_FWD_SM90_MODES(__half, 64)
HVD_FWD_SM90_MODES(__half, 128)

}  // namespace hvd_flash
