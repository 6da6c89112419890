// Flash attention for Hopper (sm_90a): the C entry points that
// horovod_tpu_torch/ops/flash_attention.py loads with ctypes, and the
// float32 kernels.  Every bf16/fp16 call reaches a wgmma kernel:
// flash_fwd_sm90.cu, flash_dkv_sm90.cu and flash_dq_sm90.cu.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   forward <- _fwd_kernel      (_fwd_call, pallas_call :295)
//   dK, dV  <- _bwd_dkv_kernel  (_bwd_call, pallas_call :524)
//   dQ      <- _bwd_dq_kernel   (_bwd_call, pallas_call :561)
// Each kernel has three compile-time modes: no dropout, explicit-mask
// attention dropout (_keep_scale :134, _flash_dropout :622-645) and seeded
// attention dropout (_seeded_keep_scale :141, _flash_seeded :649-672).
//
// Layout: q/k/v/o/do are (BH, S, D) row-major with S a multiple of the tile
// (64 rows; the host pads) and D in {64, 128}; lse and delta are (BH, S)
// float32.  Scalars q_off, k_off, kv_len give the global-coordinate causal
// mask (q_off + row >= k_off + col) and the key-padding mask (col < kv_len),
// exactly as the TPU kernels read them from their scalar-prefetch operand.
//
// The float32 kernels of this file run on the CUDA cores (float32 has no
// tensor-core path here): one block of 2 warps per (bh, 32-row tile), the
// running max, normaliser and accumulators in shared memory, the sequential
// TPU grid axis as a loop inside the block, and tiles that are entirely
// masked skipped (_block_skip; _tile_interior tiles skip the mask).  dK/dV
// and dQ stay two kernels, as on the TPU: each output tile is owned by one
// block, so there are no atomics and the backward is deterministic.  Tiles
// sit in padded shared-memory rows (+8 elements).  They are bound by the
// CUDA cores' FMA rate.
//
// Attention dropout (torch semantics, as the TPU kernels apply it): the
// softmax normaliser l sums the undropped P, the P.V product takes
// P * keep / (1 - rate), dV takes the same dropped P, dP is multiplied by
// keep / (1 - rate) before dS, and delta is unchanged.  Here the keep pattern
// of a tile is written, as 0/1, into the shared buffer that the element loop
// then overwrites with P (or dS) element by element:
//  * mask mode reads the (BH, S_q, S_k) uint8 keep-mask tile from device
//    memory, 16 bytes per thread per step;
//  * Philox mode draws it from Philox4x32-10 keyed by (seed, bh) with the
//    counter (col / 4, row, 0, 0) in global element coordinates, one
//    generator call per 4 keys, so the pattern does not depend on the tile
//    size.  Skipped tiles draw nothing.  The TPU kernels key their on-chip
//    generator per tile; its bits cannot be reproduced here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

constexpr int kBM = 32;                // rows (and keys) of a float32 tile
constexpr int kThreads = kBM / 16 * 32;  // each warp owns 16 rows

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy ROWS rows of a row-major (*, D) matrix into a shared tile whose rows
// are D + 8 elements apart, 16 bytes per thread per step.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D + c);
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) dst[i] = src[i];
}

// The 0/1 keep pattern of tile (qb, kb) of head bh into a kBM x kBM shared
// tile whose rows are LD elements apart.
template <int MODE, int LD>
__device__ __forceinline__ void load_keep(float* dst, const Dropout& dr,
                                          int bh, int s_q, int s_k, int qb,
                                          int kb) {
  if constexpr (MODE == kMaskDropout) {
    constexpr int kPerRow = kBM / 16;
    for (int i = threadIdx.x; i < kBM * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * 16;
      const uint4 bytes = *reinterpret_cast<const uint4*>(
          dr.mask + (static_cast<size_t>(bh) * s_q + qb * kBM + r) * s_k +
          kb * kBM + c);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&bytes);
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[r * LD + c + j] = b[j] ? 1.f : 0.f;
    }
  } else if constexpr (MODE == kPhiloxDropout) {
    constexpr int kPerRow = kBM / 4;
    for (int i = threadIdx.x; i < kBM * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow;
      const int c4 = i % kPerRow;
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<uint32_t>(kb * kPerRow + c4),
                     static_cast<uint32_t>(qb * kBM + r), 0u, 0u),
          make_uint2(dr.seed, static_cast<uint32_t>(bh)));
      float* out = dst + r * LD + c4 * 4;
      out[0] = w.x < dr.threshold ? 1.f : 0.f;
      out[1] = w.y < dr.threshold ? 1.f : 0.f;
      out[2] = w.z < dr.threshold ? 1.f : 0.f;
      out[3] = w.w < dr.threshold ? 1.f : 0.f;
    }
  }
}

// One warp: C[16][N] (+)= A(16 x KD) * B(KD x N), all operands in shared
// memory, on the CUDA cores, one output element per lane at a time.
//   A(i, k) = A_T ? A[k * lda + i] : A[i * lda + k]
//   B(k, j) = B_T ? B[j * ldb + k] : B[k * ldb + j]
template <bool A_T, bool B_T, int KD, int N>
__device__ __forceinline__ void warp_gemm(const float* A, int lda,
                                          const float* B, int ldb, float* C,
                                          int ldc, bool accumulate) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N;
    const int j = idx % N;
    float acc = accumulate ? C[i * ldc + j] : 0.f;
    for (int k = 0; k < KD; ++k) {
      const float a = A_T ? A[k * lda + i] : A[i * lda + k];
      const float b = B_T ? B[j * ldb + k] : B[k * ldb + j];
      acc = fmaf(a, b, acc);
    }
    C[i * ldc + j] = acc;
  }
}

// Shared-memory layouts (byte offsets, each buffer 128-byte aligned).
template <int D>
struct Dims {
  static constexpr int LDT = D + 8;    // q/k/v/do tiles
  static constexpr int LDS = kBM + 4;  // score tiles
  static constexpr int LDP = kBM + 8;  // P / dS (first the keep pattern)
  static constexpr int LDO = D + 4;    // output accumulators
  static constexpr size_t kTile = kBM * LDT * sizeof(float);
  static constexpr size_t kScore = kBM * LDS * sizeof(float);
  static constexpr size_t kProb = kBM * LDP * sizeof(float);
  static constexpr size_t kAcc = kBM * LDO * sizeof(float);
  static constexpr size_t kRow = kBM * sizeof(float);
};

template <int D>
struct FwdSmem : Dims<D> {
  using B = Dims<D>;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + B::kTile);
  static constexpr size_t v = align128(k + B::kTile);
  static constexpr size_t s = align128(v + B::kTile);
  static constexpr size_t p = align128(s + B::kScore);
  static constexpr size_t o = align128(p + B::kProb);
  static constexpr size_t m = align128(o + B::kAcc);
  static constexpr size_t l = m + B::kRow;
  static constexpr size_t alpha = l + B::kRow;
  static constexpr size_t bytes = alpha + B::kRow;
};

template <int D>
struct BwdSmem : Dims<D> {
  using B = Dims<D>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = align128(q + B::kTile);
  static constexpr size_t k = align128(dout + B::kTile);
  static constexpr size_t v = align128(k + B::kTile);
  static constexpr size_t s = align128(v + B::kTile);
  static constexpr size_t dp = align128(s + B::kScore);
  static constexpr size_t pt = align128(dp + B::kScore);
  static constexpr size_t dst = align128(pt + B::kProb);
  static constexpr size_t acc1 = align128(dst + B::kProb);  // dK or dQ
  static constexpr size_t acc2 = align128(acc1 + B::kAcc);  // dV
  static constexpr size_t lse = align128(acc2 + B::kAcc);
  static constexpr size_t delta = lse + B::kRow;
  static constexpr size_t bytes = delta + B::kRow;
};

// dQ needs neither the P tile nor a second accumulator.
template <int D>
struct DqSmem : Dims<D> {
  using B = Dims<D>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = align128(q + B::kTile);
  static constexpr size_t k = align128(dout + B::kTile);
  static constexpr size_t v = align128(k + B::kTile);
  static constexpr size_t s = align128(v + B::kTile);
  static constexpr size_t dp = align128(s + B::kScore);
  static constexpr size_t dst = align128(dp + B::kScore);
  static constexpr size_t acc1 = align128(dst + B::kProb);
  static constexpr size_t lse = align128(acc1 + B::kAcc);
  static constexpr size_t delta = lse + B::kRow;
  static constexpr size_t bytes = delta + B::kRow;
};

// ---------------------------------------------------------------------------
// Forward, float32: one block per (bh, q tile); loops over k tiles with an
// online softmax.  Outputs O and LSE (-1e30 for rows that see no key, whose
// O is 0).  bf16/fp16: flash_fwd_sm90.cu.
// ---------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int s_q, int s_k, Lens L,
                      bool causal, float sm_scale, Dropout dr) {
  using Lay = FwdSmem<D>;
  constexpr int BM = kBM, LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP,
                LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q);
  float* Ks = reinterpret_cast<float*>(smem + Lay::k);
  float* Vs = reinterpret_cast<float*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  float* Ps = reinterpret_cast<float*>(smem + Lay::p);
  float* Os = reinterpret_cast<float*>(smem + Lay::o);
  float* m_s = reinterpret_cast<float*>(smem + Lay::m);
  float* l_s = reinterpret_cast<float*>(smem + Lay::l);
  float* a_s = reinterpret_cast<float*>(smem + Lay::alpha);

  const int bh = blockIdx.x;
  const int qb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_base = (static_cast<size_t>(bh) * s_q + qb * BM);

  load_tile<D, BM>(Qs, q + q_base * D);
  for (int i = threadIdx.x; i < BM * LDO; i += blockDim.x) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int n_k = s_k / BM;
  for (int kb = 0; kb < n_k; ++kb) {
    if (block_skip(causal, L, qb, kb, BM)) continue;
    const bool interior = tile_interior(causal, L, qb, kb, BM);
    __syncthreads();  // every warp is done with the previous K/V tile
    const size_t k_base = static_cast<size_t>(bh) * s_k + kb * BM;
    load_tile<D, BM>(Ks, k + k_base * D);
    load_tile<D, BM>(Vs, v + k_base * D);
    load_keep<MODE, LDP>(Ps, dr, bh, s_q, s_k, qb, kb);
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows.
    warp_gemm<false, true, D, BM>(Qs + warp * 16 * LDT, LDT, Ks, LDT,
                                  Ss + warp * 16 * LDS, LDS, false);
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int row = qb * BM + r;
      float sv[BM / 32];
      bool ok[BM / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < BM / 32; ++t) {
        const int c = lane + 32 * t;
        ok[t] = interior || visible(causal, L, row, kb * BM + c);
        sv[t] = ok[t] ? Ss[r * LDS + c] * sm_scale : kNegInf;
        mx = fmaxf(mx, sv[t]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BM / 32; ++t) {
        // A fully masked row keeps m_new = -1e30 and exp(0) = 1: zero it so
        // its normaliser stays 0.
        const float p = ok[t] ? expf(sv[t] - m_new) : 0.f;
        sum += p;
        // Dropout scales P in the P.V product only; l keeps the undropped
        // sum.  The slot holds this element's keep value until here.
        float& slot = Ps[r * LDP + lane + 32 * t];
        slot = MODE == kNoDropout ? p : p * (slot * dr.scale);
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
      __syncwarp();
    }

    for (int i = lane; i < 16 * D; i += 32) {
      const int r = warp * 16 + i / D;
      Os[r * LDO + i % D] *= a_s[r];
    }
    __syncwarp();
    // O += P V, fp32 accumulation.
    warp_gemm<false, false, BM, D>(Ps + warp * 16 * LDP, LDP, Vs, LDT,
                                   Os + warp * 16 * LDO, LDO, true);
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D;
    const float l = l_s[r];
    const float safe_l = l == 0.f ? 1.f : l;
    o[(q_base + r) * D + i % D] = Os[r * LDO + i % D] / safe_l;
  }
  if (lane < 16) {
    const int r = warp * 16 + lane;
    const float l = l_s[r];
    lse[q_base + r] = l == 0.f ? kNegInf : m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Backward, dK/dV, float32: one block per (bh, k tile); loops over q tiles.
// P is recomputed from LSE; dV += P^T dO, dP = dO V^T,
// dS = P * (dP - delta) * scale, dK += dS^T Q.  bf16/fp16: flash_dkv_sm90.cu.
// ---------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s_q, int s_k, Lens L, bool causal,
                          float sm_scale, Dropout dr) {
  using Lay = BwdSmem<D>;
  constexpr int BM = kBM, LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP,
                LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q);
  float* dOs = reinterpret_cast<float*>(smem + Lay::dout);
  float* Ks = reinterpret_cast<float*>(smem + Lay::k);
  float* Vs = reinterpret_cast<float*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp);
  float* Pt = reinterpret_cast<float*>(smem + Lay::pt);
  float* dSt = reinterpret_cast<float*>(smem + Lay::dst);
  float* dKs = reinterpret_cast<float*>(smem + Lay::acc1);
  float* dVs = reinterpret_cast<float*>(smem + Lay::acc2);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::delta);

  const int bh = blockIdx.x;
  const int kb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t k_base = static_cast<size_t>(bh) * s_k + kb * BM;

  load_tile<D, BM>(Ks, k + k_base * D);
  load_tile<D, BM>(Vs, v + k_base * D);
  for (int i = threadIdx.x; i < BM * LDO; i += blockDim.x) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  const int n_q = s_q / BM;
  for (int qb = 0; qb < n_q; ++qb) {
    if (block_skip(causal, L, qb, kb, BM)) continue;
    const bool interior = tile_interior(causal, L, qb, kb, BM);
    __syncthreads();  // previous q tile fully consumed (and K/V loaded)
    const size_t q_base = static_cast<size_t>(bh) * s_q + qb * BM;
    load_tile<D, BM>(Qs, q + q_base * D);
    load_tile<D, BM>(dOs, dout + q_base * D);
    load_vec<BM>(lse_s, lse + q_base);
    load_vec<BM>(delta_s, delta + q_base);
    load_keep<MODE, LDP>(Pt, dr, bh, s_q, s_k, qb, kb);
    __syncthreads();

    // Per query row (warp owns 16 rows): S = Q K^T, dP = dO V^T.
    warp_gemm<false, true, D, BM>(Qs + warp * 16 * LDT, LDT, Ks, LDT,
                                  Ss + warp * 16 * LDS, LDS, false);
    warp_gemm<false, true, D, BM>(dOs + warp * 16 * LDT, LDT, Vs, LDT,
                                  dPs + warp * 16 * LDS, LDS, false);
    __syncwarp();
    for (int i = lane; i < 16 * BM; i += 32) {
      const int r = warp * 16 + i / BM;
      const int c = i % BM;
      float p = expf(Ss[r * LDS + c] * sm_scale - lse_s[r]);
      if (!interior && !visible(causal, L, qb * BM + r, kb * BM + c)) p = 0.f;
      float pv = p;
      float dp = dPs[r * LDS + c];
      if constexpr (MODE != kNoDropout) {
        // dV takes the dropped P; dP is scaled by the same keep / (1 - rate)
        // before dS, which multiplies the undropped P.
        const float keep = Pt[r * LDP + c] * dr.scale;
        pv = p * keep;
        dp = dp * keep;
      }
      const float ds = p * (dp - delta_s[r]) * sm_scale;
      Pt[r * LDP + c] = pv;
      dSt[r * LDP + c] = ds;
    }
    __syncthreads();

    // Per key row (warp owns 16 rows): dV += P^T dO, dK += dS^T Q.
    warp_gemm<true, false, BM, D>(Pt + warp * 16, LDP, dOs, LDT,
                                  dVs + warp * 16 * LDO, LDO, true);
    warp_gemm<true, false, BM, D>(dSt + warp * 16, LDP, Qs, LDT,
                                  dKs + warp * 16 * LDO, LDO, true);
  }
  __syncthreads();  // covers the zero-fill when every q tile was skipped

  for (int i = threadIdx.x; i < BM * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i % D;
    dk[(k_base + r) * D + c] = dKs[r * LDO + c];
    dv[(k_base + r) * D + c] = dVs[r * LDO + c];
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ, float32: one block per (bh, q tile); loops over k tiles.
// dQ += dS K with the same recompute of P.  bf16/fp16: flash_dq_sm90.cu.
// ---------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int s_q, int s_k, Lens L,
                         bool causal, float sm_scale, Dropout dr) {
  using Lay = DqSmem<D>;
  constexpr int BM = kBM, LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP,
                LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q);
  float* dOs = reinterpret_cast<float*>(smem + Lay::dout);
  float* Ks = reinterpret_cast<float*>(smem + Lay::k);
  float* Vs = reinterpret_cast<float*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp);
  float* dSt = reinterpret_cast<float*>(smem + Lay::dst);
  float* dQs = reinterpret_cast<float*>(smem + Lay::acc1);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::delta);

  const int bh = blockIdx.x;
  const int qb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_base = static_cast<size_t>(bh) * s_q + qb * BM;

  load_tile<D, BM>(Qs, q + q_base * D);
  load_tile<D, BM>(dOs, dout + q_base * D);
  load_vec<BM>(lse_s, lse + q_base);
  load_vec<BM>(delta_s, delta + q_base);
  for (int i = threadIdx.x; i < BM * LDO; i += blockDim.x) dQs[i] = 0.f;
  __syncthreads();

  const int n_k = s_k / BM;
  for (int kb = 0; kb < n_k; ++kb) {
    if (block_skip(causal, L, qb, kb, BM)) continue;
    const bool interior = tile_interior(causal, L, qb, kb, BM);
    __syncthreads();  // every warp is done with the previous K/V tile
    const size_t k_base = static_cast<size_t>(bh) * s_k + kb * BM;
    load_tile<D, BM>(Ks, k + k_base * D);
    load_tile<D, BM>(Vs, v + k_base * D);
    load_keep<MODE, LDP>(dSt, dr, bh, s_q, s_k, qb, kb);
    __syncthreads();

    warp_gemm<false, true, D, BM>(Qs + warp * 16 * LDT, LDT, Ks, LDT,
                                  Ss + warp * 16 * LDS, LDS, false);
    warp_gemm<false, true, D, BM>(dOs + warp * 16 * LDT, LDT, Vs, LDT,
                                  dPs + warp * 16 * LDS, LDS, false);
    __syncwarp();
    for (int i = lane; i < 16 * BM; i += 32) {
      const int r = warp * 16 + i / BM;
      const int c = i % BM;
      float p = expf(Ss[r * LDS + c] * sm_scale - lse_s[r]);
      if (!interior && !visible(causal, L, qb * BM + r, kb * BM + c)) p = 0.f;
      float dp = dPs[r * LDS + c];
      if constexpr (MODE != kNoDropout)
        dp = dp * (dSt[r * LDP + c] * dr.scale);
      dSt[r * LDP + c] = p * (dp - delta_s[r]) * sm_scale;
    }
    __syncwarp();
    warp_gemm<false, false, BM, D>(dSt + warp * 16 * LDP, LDP, Ks, LDT,
                                   dQs + warp * 16 * LDO, LDO, true);
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D;
    dq[(q_base + r) * D + i % D] = dQs[r * LDO + i % D];
  }
}

// Each entry point below sends a 16-bit call (T = __nv_bfloat16 or __half)
// to its wgmma kernel and a float32 call to the kernel of this file.
template <typename T, int D, int MODE>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int s_q, int s_k, Lens L, bool causal,
                float scale, Dropout dr, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return fwd_sm90<T, D, MODE>(q, k, v, o, lse, bh, s_q, s_k, L, causal,
                                scale, dr, stream);
  } else {
    using Lay = FwdSmem<D>;
    auto kernel = flash_fwd_fp32_kernel<D, MODE>;
    cudaError_t err = prepare(kernel, Lay::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, s_q / kBM), kThreads, Lay::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, s_q, s_k,
        L, causal, scale, dr);
    return cudaGetLastError();
  }
}

template <typename T, int D, int MODE>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int bh, int s_q, int s_k, Lens L,
                    bool causal, float scale, Dropout dr, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return bwd_dkv_sm90<T, D, MODE>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    s_q, s_k, L, causal, scale, dr, stream);
  } else {
    using Lay = BwdSmem<D>;
    auto kernel = flash_bwd_dkv_fp32_kernel<D, MODE>;
    cudaError_t err = prepare(kernel, Lay::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, s_k / kBM), kThreads, Lay::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), s_q, s_k, L,
        causal, scale, dr);
    return cudaGetLastError();
  }
}

template <typename T, int D, int MODE>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int s_q, int s_k, Lens L, bool causal,
                   float scale, Dropout dr, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return bwd_dq_sm90<T, D, MODE>(q, k, v, dout, lse, delta, dq, bh, s_q,
                                   s_k, L, causal, scale, dr, stream);
  } else {
    using Lay = DqSmem<D>;
    auto kernel = flash_bwd_dq_fp32_kernel<D, MODE>;
    cudaError_t err = prepare(kernel, Lay::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, s_q / kBM), kThreads, Lay::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), s_q, s_k, L, causal, scale, dr);
    return cudaGetLastError();
  }
}

// Registers, shared memory and spill bytes of the instance a call with these
// template arguments launches.
template <typename T, int D, int MODE>
cudaError_t attrs_fwd(KernelAttrs* out) {
  if constexpr (!std::is_same<T, float>::value)
    return fwd_sm90_attrs<T, D, MODE>(out);
  else
    return kernel_attrs(flash_fwd_fp32_kernel<D, MODE>, FwdSmem<D>::bytes,
                        out);
}

template <typename T, int D, int MODE>
cudaError_t attrs_bwd_dkv(KernelAttrs* out) {
  if constexpr (!std::is_same<T, float>::value)
    return bwd_dkv_sm90_attrs<T, D, MODE>(out);
  else
    return kernel_attrs(flash_bwd_dkv_fp32_kernel<D, MODE>,
                        BwdSmem<D>::bytes, out);
}

template <typename T, int D, int MODE>
cudaError_t attrs_bwd_dq(KernelAttrs* out) {
  if constexpr (!std::is_same<T, float>::value)
    return bwd_dq_sm90_attrs<T, D, MODE>(out);
  else
    return kernel_attrs(flash_bwd_dq_fp32_kernel<D, MODE>, DqSmem<D>::bytes,
                        out);
}

// dtype codes shared with the Python wrapper.
enum DType { kFloat32 = 0, kFloat16 = 1, kBFloat16 = 2 };

#define HVD_DISPATCH_TYPE(DTYPE, HEAD_DIM, MODE, FN, ...)                      \
  do {                                                                         \
    if ((HEAD_DIM) == 64) {                                                    \
      if ((DTYPE) == kBFloat16)                                                \
        return FN<__nv_bfloat16, 64, MODE>(__VA_ARGS__);                       \
      if ((DTYPE) == kFloat16) return FN<__half, 64, MODE>(__VA_ARGS__);       \
      if ((DTYPE) == kFloat32) return FN<float, 64, MODE>(__VA_ARGS__);        \
    } else if ((HEAD_DIM) == 128) {                                            \
      if ((DTYPE) == kBFloat16)                                                \
        return FN<__nv_bfloat16, 128, MODE>(__VA_ARGS__);                      \
      if ((DTYPE) == kFloat16) return FN<__half, 128, MODE>(__VA_ARGS__);      \
      if ((DTYPE) == kFloat32) return FN<float, 128, MODE>(__VA_ARGS__);       \
    }                                                                          \
    return cudaErrorInvalidValue;                                              \
  } while (0)

#define HVD_DISPATCH(DTYPE, HEAD_DIM, MODE, FN, ...)                           \
  do {                                                                         \
    if ((MODE) == kNoDropout)                                                  \
      HVD_DISPATCH_TYPE(DTYPE, HEAD_DIM, kNoDropout, FN, __VA_ARGS__);         \
    if ((MODE) == kMaskDropout)                                                \
      HVD_DISPATCH_TYPE(DTYPE, HEAD_DIM, kMaskDropout, FN, __VA_ARGS__);       \
    if ((MODE) == kPhiloxDropout)                                              \
      HVD_DISPATCH_TYPE(DTYPE, HEAD_DIM, kPhiloxDropout, FN, __VA_ARGS__);     \
    return cudaErrorInvalidValue;                                              \
  } while (0)

cudaError_t attrs(int kernel, int dtype, int head_dim, int mode,
                  KernelAttrs* a) {
  if (kernel == 0) HVD_DISPATCH(dtype, head_dim, mode, attrs_fwd, a);
  if (kernel == 1) HVD_DISPATCH(dtype, head_dim, mode, attrs_bwd_dkv, a);
  if (kernel == 2) HVD_DISPATCH(dtype, head_dim, mode, attrs_bwd_dq, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* hvd_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry point takes the dropout mode (enum Mode), the keep-mask
// (mask mode; else null), 1 / (1 - rate), the Philox threshold and seed.

int hvd_flash_fwd(int dtype, int head_dim, int mode, const void* q,
                  const void* k, const void* v, void* o, float* lse,
                  const void* mask, int bh, int s_q, int s_k, int q_off,
                  int k_off, int kv_len, int causal, float scale,
                  float keep_scale, unsigned threshold, unsigned seed,
                  void* stream) {
  const Lens L{q_off, k_off, kv_len};
  const Dropout dr{static_cast<const uint8_t*>(mask), keep_scale, threshold,
                   seed};
  HVD_DISPATCH(dtype, head_dim, mode, fwd, q, k, v, o, lse, bh, s_q, s_k, L,
               causal != 0, scale, dr, static_cast<cudaStream_t>(stream));
}

int hvd_flash_bwd_dkv(int dtype, int head_dim, int mode, const void* q,
                      const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv,
                      const void* mask, int bh, int s_q, int s_k, int q_off,
                      int k_off, int kv_len, int causal, float scale,
                      float keep_scale, unsigned threshold, unsigned seed,
                      void* stream) {
  const Lens L{q_off, k_off, kv_len};
  const Dropout dr{static_cast<const uint8_t*>(mask), keep_scale, threshold,
                   seed};
  HVD_DISPATCH(dtype, head_dim, mode, bwd_dkv, q, k, v, dout, lse, delta, dk,
               dv, bh, s_q, s_k, L, causal != 0, scale, dr,
               static_cast<cudaStream_t>(stream));
}

// Attributes of one kernel instance (kernel 0 fwd, 1 bwd_dkv, 2 bwd_dq):
// out[0..3] = registers per thread, static shared bytes, dynamic shared
// bytes of its launch, local (spill) bytes per thread.
int hvd_flash_kernel_attrs(int kernel, int dtype, int head_dim, int mode,
                           int* out) {
  KernelAttrs a{};
  const cudaError_t err = attrs(kernel, dtype, head_dim, mode, &a);
  if (err == cudaSuccess) {
    out[0] = a.regs;
    out[1] = a.static_smem;
    out[2] = a.dynamic_smem;
    out[3] = a.local_bytes;
  }
  return err;
}

int hvd_flash_bwd_dq(int dtype, int head_dim, int mode, const void* q,
                     const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq,
                     const void* mask, int bh, int s_q, int s_k, int q_off,
                     int k_off, int kv_len, int causal, float scale,
                     float keep_scale, unsigned threshold, unsigned seed,
                     void* stream) {
  const Lens L{q_off, k_off, kv_len};
  const Dropout dr{static_cast<const uint8_t*>(mask), keep_scale, threshold,
                   seed};
  HVD_DISPATCH(dtype, head_dim, mode, bwd_dq, q, k, v, dout, lse, delta, dq,
               bh, s_q, s_k, L, causal != 0, scale, dr,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
