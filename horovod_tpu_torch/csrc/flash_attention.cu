// Flash attention for Hopper (sm_90a): forward, dK/dV backward and dQ
// backward, each a hand-written CUDA kernel behind a plain C interface that
// horovod_tpu_torch/ops/flash_attention.py loads with ctypes.  This file
// holds the entry points, the dQ kernel, and the float32 forward and dK/dV;
// the bf16/fp16 forward and dK/dV are the wgmma kernels of flash_fwd_sm90.cu
// and flash_dkv_sm90.cu, which every 16-bit call reaches.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (_fwd_call, pallas_call :295)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (_bwd_call, pallas_call :524)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (_bwd_call, pallas_call :561)
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
// The kernels of this file (dQ in every type; forward and dK/dV in
// float32) keep the first design: one block of 4 warps per (bh, tile),
// 16x16x16 wmma products out of shared memory for bf16/fp16 (float32 has no
// tensor-core path here and runs on the CUDA cores), the running max,
// normaliser and accumulators in shared memory, the sequential TPU grid axis
// as a loop inside the block, and tiles that are entirely masked skipped
// (_block_skip; _tile_interior tiles skip the mask).  dK/dV and dQ stay two
// kernels, as on the TPU: each output tile is owned by one block, so there
// are no atomics and the backward is deterministic.  Tiles are 64 x 64
// (32 x 32 for float32) in padded shared-memory rows (+8 elements).
// What bounds them on the H100: at the training shape (BH = 8*16, S = 512,
// D = 64, causal) dQ's ideal is near the ridge (~13 us of HBM traffic,
// ~6 us of tensor-core time), but this design is bound by the instruction
// rate of wmma products and accumulators out of shared memory, with one
// block of 4 warps per tile; float32 by the CUDA cores' FMA rate.
//
// Attention dropout (torch semantics, as the TPU kernels apply it): the
// softmax normaliser l sums the undropped P, the P.V product takes
// P * keep / (1 - rate), dV takes the same dropped P, dP is multiplied by
// keep / (1 - rate) before dS, and delta is unchanged.  Here the keep pattern
// of a tile is written, as 0/1 in the input type, into the shared buffer that
// the element loop then overwrites with P (or dS) element by element:
//  * mask mode reads the (BH, S_q, S_k) uint8 keep-mask tile from device
//    memory, 16 bytes per thread per step;
//  * Philox mode draws it from Philox4x32-10 keyed by (seed, bh) with the
//    counter (col / 4, row, 0, 0) in global element coordinates, one
//    generator call per 4 keys, so the pattern does not depend on the tile
//    size.  Skipped tiles draw nothing.  The TPU kernels key their on-chip
//    generator per tile; its bits cannot be reproduced here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

using namespace nvcuda;

namespace {

using namespace hvd_flash;

template <typename T>
struct Tile {
  static constexpr int kRows = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int kWarps = kRows / 16;  // each warp owns 16 rows
  static constexpr int kThreads = kWarps * 32;
};

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
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) dst[i] = src[i];
}

// The 0/1 keep pattern of tile (qb, kb) of head bh, as the input type, into
// a BM x BM shared tile whose rows are LD elements apart.
template <typename T, int MODE, int BM, int LD>
__device__ __forceinline__ void load_keep(T* dst, const Dropout& dr, int bh,
                                          int s_q, int s_k, int qb, int kb) {
  if constexpr (MODE == kMaskDropout) {
    constexpr int kPerRow = BM / 16;
    for (int i = threadIdx.x; i < BM * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * 16;
      const uint4 bytes = *reinterpret_cast<const uint4*>(
          dr.mask + (static_cast<size_t>(bh) * s_q + qb * BM + r) * s_k +
          kb * BM + c);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&bytes);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[r * LD + c + j] = from_f<T>(b[j] ? 1.f : 0.f);
    }
  } else if constexpr (MODE == kPhiloxDropout) {
    constexpr int kPerRow = BM / 4;
    for (int i = threadIdx.x; i < BM * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow;
      const int c4 = i % kPerRow;
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<uint32_t>(kb * kPerRow + c4),
                     static_cast<uint32_t>(qb * BM + r), 0u, 0u),
          make_uint2(dr.seed, static_cast<uint32_t>(bh)));
      T* out = dst + r * LD + c4 * 4;
      out[0] = from_f<T>(w.x < dr.threshold ? 1.f : 0.f);
      out[1] = from_f<T>(w.y < dr.threshold ? 1.f : 0.f);
      out[2] = from_f<T>(w.z < dr.threshold ? 1.f : 0.f);
      out[3] = from_f<T>(w.w < dr.threshold ? 1.f : 0.f);
    }
  }
}

// One warp: C[16][N] (+)= A(16 x KD) * B(KD x N), all operands in shared
// memory, fp32 accumulation.
//   A(i, k) = A_T ? A[k * lda + i] : A[i * lda + k]
//   B(k, j) = B_T ? B[j * ldb + k] : B[k * ldb + j]
// Half types run on the tensor cores (wmma 16x16x16); float runs on the CUDA
// cores, one output element per lane at a time.
template <typename T, bool A_T, bool B_T, int KD, int N>
__device__ __forceinline__ void warp_gemm(const T* A, int lda, const T* B,
                                          int ldb, float* C, int ldc,
                                          bool accumulate) {
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    using LA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      if (accumulate)
        wmma::load_matrix_sync(acc[j], C + j * 16, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[j], 0.f);
    }
#pragma unroll
    for (int k = 0; k < KD; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
      wmma::load_matrix_sync(a, A_T ? A + k * lda : A + k, lda);
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(b, B_T ? B + j * 16 * ldb + k : B + k * ldb + j * 16, ldb);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      wmma::store_matrix_sync(C + j * 16, acc[j], ldc, wmma::mem_row_major);
  }
}

// Shared-memory layouts (byte offsets, each buffer 128-byte aligned).
template <typename T, int D>
struct Dims {
  static constexpr int BM = Tile<T>::kRows;
  static constexpr int LDT = D + 8;   // q/k/v/do tiles
  static constexpr int LDS = BM + 4;  // fp32 score tiles
  static constexpr int LDP = BM + 8;  // P / dS in the input type
  static constexpr int LDO = D + 4;   // fp32 output accumulators
  static constexpr size_t kTile = BM * LDT * sizeof(T);
  static constexpr size_t kScore = BM * LDS * sizeof(float);
  static constexpr size_t kProb = BM * LDP * sizeof(T);
  static constexpr size_t kAcc = BM * LDO * sizeof(float);
  static constexpr size_t kRow = BM * sizeof(float);
};

template <typename T, int D>
struct FwdSmem : Dims<T, D> {
  using B = Dims<T, D>;
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

template <typename T, int D>
struct BwdSmem : Dims<T, D> {
  using B = Dims<T, D>;
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
template <typename T, int D>
struct DqSmem : Dims<T, D> {
  using B = Dims<T, D>;
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
// online softmax.  Outputs O (input type) and LSE (fp32, -1e30 for rows that
// see no key, whose O is 0).  bf16/fp16: flash_fwd_sm90.cu.
// ---------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(Tile<float>::kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int s_q, int s_k, Lens L,
                      bool causal, float sm_scale, Dropout dr) {
  using T = float;
  using Lay = FwdSmem<T, D>;
  constexpr int BM = Lay::BM, LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP,
                LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  T* Ps = reinterpret_cast<T*>(smem + Lay::p);
  float* Os = reinterpret_cast<float*>(smem + Lay::o);
  float* m_s = reinterpret_cast<float*>(smem + Lay::m);
  float* l_s = reinterpret_cast<float*>(smem + Lay::l);
  float* a_s = reinterpret_cast<float*>(smem + Lay::alpha);

  const int bh = blockIdx.x;
  const int qb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_base = (static_cast<size_t>(bh) * s_q + qb * BM);

  load_tile<T, D, BM>(Qs, q + q_base * D);
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
    load_tile<T, D, BM>(Ks, k + k_base * D);
    load_tile<T, D, BM>(Vs, v + k_base * D);
    load_keep<T, MODE, BM, LDP>(Ps, dr, bh, s_q, s_k, qb, kb);
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows.
    warp_gemm<T, false, true, D, BM>(Qs + warp * 16 * LDT, LDT, Ks, LDT,
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
        T& slot = Ps[r * LDP + lane + 32 * t];
        slot = from_f<T>(MODE == kNoDropout ? p
                                            : p * (to_f(slot) * dr.scale));
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
    // O += P V (P rounded to the input type, fp32 accumulation).
    warp_gemm<T, false, false, BM, D>(Ps + warp * 16 * LDP, LDP, Vs, LDT,
                                      Os + warp * 16 * LDO, LDO, true);
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D;
    const float l = l_s[r];
    const float safe_l = l == 0.f ? 1.f : l;
    o[(q_base + r) * D + i % D] = from_f<T>(Os[r * LDO + i % D] / safe_l);
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
__global__ void __launch_bounds__(Tile<float>::kThreads)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s_q, int s_k, Lens L, bool causal,
                          float sm_scale, Dropout dr) {
  using T = float;
  using Lay = BwdSmem<T, D>;
  constexpr int BM = Lay::BM, LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP,
                LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q);
  T* dOs = reinterpret_cast<T*>(smem + Lay::dout);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp);
  T* Pt = reinterpret_cast<T*>(smem + Lay::pt);
  T* dSt = reinterpret_cast<T*>(smem + Lay::dst);
  float* dKs = reinterpret_cast<float*>(smem + Lay::acc1);
  float* dVs = reinterpret_cast<float*>(smem + Lay::acc2);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::delta);

  const int bh = blockIdx.x;
  const int kb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t k_base = static_cast<size_t>(bh) * s_k + kb * BM;

  load_tile<T, D, BM>(Ks, k + k_base * D);
  load_tile<T, D, BM>(Vs, v + k_base * D);
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
    load_tile<T, D, BM>(Qs, q + q_base * D);
    load_tile<T, D, BM>(dOs, dout + q_base * D);
    load_vec<BM>(lse_s, lse + q_base);
    load_vec<BM>(delta_s, delta + q_base);
    load_keep<T, MODE, BM, LDP>(Pt, dr, bh, s_q, s_k, qb, kb);
    __syncthreads();

    // Per query row (warp owns 16 rows): S = Q K^T, dP = dO V^T.
    warp_gemm<T, false, true, D, BM>(Qs + warp * 16 * LDT, LDT, Ks, LDT,
                                     Ss + warp * 16 * LDS, LDS, false);
    warp_gemm<T, false, true, D, BM>(dOs + warp * 16 * LDT, LDT, Vs, LDT,
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
        const float keep = to_f(Pt[r * LDP + c]) * dr.scale;
        pv = p * keep;
        dp = dp * keep;
      }
      const float ds = p * (dp - delta_s[r]) * sm_scale;
      Pt[r * LDP + c] = from_f<T>(pv);
      dSt[r * LDP + c] = from_f<T>(ds);
    }
    __syncthreads();

    // Per key row (warp owns 16 rows): dV += P^T dO, dK += dS^T Q.
    warp_gemm<T, true, false, BM, D>(Pt + warp * 16, LDP, dOs, LDT,
                                     dVs + warp * 16 * LDO, LDO, true);
    warp_gemm<T, true, false, BM, D>(dSt + warp * 16, LDP, Qs, LDT,
                                     dKs + warp * 16 * LDO, LDO, true);
  }
  __syncthreads();  // covers the zero-fill when every q tile was skipped

  for (int i = threadIdx.x; i < BM * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i % D;
    dk[(k_base + r) * D + c] = from_f<T>(dKs[r * LDO + c]);
    dv[(k_base + r) * D + c] = from_f<T>(dVs[r * LDO + c]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ: one block per (bh, q tile); loops over k tiles.
// dQ += dS K with the same recompute of P.
// ---------------------------------------------------------------------------
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(Tile<T>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s_q, int s_k, Lens L, bool causal, float sm_scale,
                    Dropout dr) {
  using Lay = DqSmem<T, D>;
  constexpr int BM = Lay::BM, LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP,
                LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q);
  T* dOs = reinterpret_cast<T*>(smem + Lay::dout);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp);
  T* dSt = reinterpret_cast<T*>(smem + Lay::dst);
  float* dQs = reinterpret_cast<float*>(smem + Lay::acc1);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::delta);

  const int bh = blockIdx.x;
  const int qb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_base = static_cast<size_t>(bh) * s_q + qb * BM;

  load_tile<T, D, BM>(Qs, q + q_base * D);
  load_tile<T, D, BM>(dOs, dout + q_base * D);
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
    load_tile<T, D, BM>(Ks, k + k_base * D);
    load_tile<T, D, BM>(Vs, v + k_base * D);
    load_keep<T, MODE, BM, LDP>(dSt, dr, bh, s_q, s_k, qb, kb);
    __syncthreads();

    warp_gemm<T, false, true, D, BM>(Qs + warp * 16 * LDT, LDT, Ks, LDT,
                                     Ss + warp * 16 * LDS, LDS, false);
    warp_gemm<T, false, true, D, BM>(dOs + warp * 16 * LDT, LDT, Vs, LDT,
                                     dPs + warp * 16 * LDS, LDS, false);
    __syncwarp();
    for (int i = lane; i < 16 * BM; i += 32) {
      const int r = warp * 16 + i / BM;
      const int c = i % BM;
      float p = expf(Ss[r * LDS + c] * sm_scale - lse_s[r]);
      if (!interior && !visible(causal, L, qb * BM + r, kb * BM + c)) p = 0.f;
      float dp = dPs[r * LDS + c];
      if constexpr (MODE != kNoDropout)
        dp = dp * (to_f(dSt[r * LDP + c]) * dr.scale);
      dSt[r * LDP + c] = from_f<T>(p * (dp - delta_s[r]) * sm_scale);
    }
    __syncwarp();
    warp_gemm<T, false, false, BM, D>(dSt + warp * 16 * LDP, LDP, Ks, LDT,
                                      dQs + warp * 16 * LDO, LDO, true);
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D;
    dq[(q_base + r) * D + i % D] = from_f<T>(dQs[r * LDO + i % D]);
  }
}

template <typename T, int D, int MODE>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int s_q, int s_k, Lens L, bool causal,
                float scale, Dropout dr, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return fwd_sm90<T, D, MODE>(q, k, v, o, lse, bh, s_q, s_k, L, causal,
                                scale, dr, stream);
  } else {
    using Lay = FwdSmem<T, D>;
    auto kernel = flash_fwd_fp32_kernel<D, MODE>;
    cudaError_t err = prepare(kernel, Lay::bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, s_q / Lay::BM);
    kernel<<<grid, Tile<T>::kThreads, Lay::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, s_q, s_k, L,
        causal, scale, dr);
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
    using Lay = BwdSmem<T, D>;
    auto kernel = flash_bwd_dkv_fp32_kernel<D, MODE>;
    cudaError_t err = prepare(kernel, Lay::bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, s_k / Lay::BM);
    kernel<<<grid, Tile<T>::kThreads, Lay::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), s_q, s_k, L, causal, scale,
        dr);
    return cudaGetLastError();
  }
}

template <typename T, int D, int MODE>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int s_q, int s_k, Lens L, bool causal,
                   float scale, Dropout dr, cudaStream_t stream) {
  using Lay = DqSmem<T, D>;
  auto kernel = flash_bwd_dq_kernel<T, D, MODE>;
  cudaError_t err = prepare(kernel, Lay::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, s_q / Lay::BM);
  kernel<<<grid, Tile<T>::kThreads, Lay::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), s_q, s_k, L, causal, scale, dr);
  return cudaGetLastError();
}

// Registers, shared memory and spill bytes of the instance a call with these
// template arguments launches.
template <typename T, int D, int MODE>
cudaError_t attrs_fwd(KernelAttrs* out) {
  if constexpr (!std::is_same<T, float>::value)
    return fwd_sm90_attrs<T, D, MODE>(out);
  else
    return kernel_attrs(flash_fwd_fp32_kernel<D, MODE>,
                        FwdSmem<T, D>::bytes, out);
}

template <typename T, int D, int MODE>
cudaError_t attrs_bwd_dkv(KernelAttrs* out) {
  if constexpr (!std::is_same<T, float>::value)
    return bwd_dkv_sm90_attrs<T, D, MODE>(out);
  else
    return kernel_attrs(flash_bwd_dkv_fp32_kernel<D, MODE>,
                        BwdSmem<T, D>::bytes, out);
}

template <typename T, int D, int MODE>
cudaError_t attrs_bwd_dq(KernelAttrs* out) {
  return kernel_attrs(flash_bwd_dq_kernel<T, D, MODE>, DqSmem<T, D>::bytes,
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
