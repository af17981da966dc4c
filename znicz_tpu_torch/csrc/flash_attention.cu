// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces znicz_tpu/ops/pallas/attention.py:
//  - _call_fwd (the pallas_call at :132, kernel body _fwd_kernel)
//    -> znicz_flash_fwd;
//  - _flash_bwd (the pallas_call at :185, kernel body _bwd_kernel)
//    -> znicz_flash_bwd (two kernels: dk/dv, then dq).
// Semantics are the reference's, on folded per-head tensors (BH, T, DH):
//   s = (q . k^T) * sm_scale in f32; a causal key kpos > qpos scores -1e30;
//   forward:  o = (round_T(p) . v) / l with p = exp(s - m) and l = sum(p)
//             kept in f32, lse = m + log(l) (f32, one per query row);
//   backward: p = exp(s - lse); dv = round_T(p)^T . do;
//             ds = p * (do . v^T - delta) * sm_scale;
//             dq = round_T(ds) . k; dk = round_T(ds)^T . q.
// Every product accumulates in f32 and the outputs are cast back to the
// input type T.  delta = rowsum(do * o) (minus the lse cotangent) is an
// input, computed outside as the reference computes it outside its
// kernel.
//
// Bound: operations.  Per live (query, key) pair the forward does
// 4 * DH flops over 2 products and the backward 10 * DH over 5, against
// 2 * DH * sizeof(T) bytes of q/k/v rows that are each read once per
// tile; at T = 2048, DH = 64 in bf16 that is ~512 flops per byte,
// above the H100's ~295 ridge, so the least time is
// pairs * {4, 10} * DH / 989 TFLOP/s (bf16 tensor cores; f32 runs on
// the 67 TFLOP/s CUDA cores).  The two-pass backward below recomputes
// s and dp in its dq pass, 7 products a pair, so its own floor is 7/5
// of that bound.
//
// Design.  The TPU kernel keeps all of K and V for a head in VMEM and
// takes a whole-row softmax; its backward carries dk/dv across its
// sequential q grid axis in a revisited output block.  Neither carries
// over: a block has at most 227 KB of shared memory and GPU blocks run
// in no order.  So:
//  - bf16 (the training path): one block of two consumer warpgroups and
//    one producer warp.  The producer issues TMA copies
//    (cp.async.bulk.tensor) of 128-byte-swizzled tiles into a ring of
//    shared-memory slots, completed on mbarriers; the consumers wait on
//    a slot's "full" barrier, run wgmma on it and arrive on its "empty"
//    barrier.  Operands are described by a 3-D tensor map (bh, t, dh),
//    whose per-head bounds zero-fill the rows of a ragged last tile past
//    t (a 2-D (bh t, dh) map would read the next head's rows there).
//    The maps are encoded on the host with cuTensorMapEncodeTiled,
//    fetched through cudaGetDriverEntryPoint, so the build links no
//    driver library.  Each product is wgmma m64nNk16 (bf16 in, f32
//    accumulate): scores with both operands K-major from shared memory;
//    the products with p or ds take it from registers (the m64nN f32
//    accumulator layout is the k16 A fragment layout) rounded to bf16,
//    and the other operand through the transpose bit.  The mbarrier,
//    TMA and wgmma helpers are hopper.cuh's.
//  - Forward: a block per (128 q rows, head), causal q tiles heaviest
//    first; warpgroup w owns rows 64w..64w+63 and walks 128-key K/V
//    tiles (a 3-slot ring) with an online softmax in base 2 on the raw
//    scores (p = 2^(s c - m c), c = sm_scale log2 e: one FFMA a score),
//    writing o and lse = m sm_scale + ln 2 log2(l) at the end.  A causal
//    block stops at its diagonal tile; only that tile and a ragged last
//    tile are masked (keys past t read as zero rows, so they are masked
//    to -inf, not left at a score of 0).
//  - Backward, two passes without atomics, so a launch is deterministic:
//    dk/dv, a block per (128 keys, head), keeps K and V in shared memory
//    and both accumulators in registers, and walks (Q, dO) tiles of BQ
//    rows from the diagonal with their lse (in base 2, +inf past t, so
//    p = 0 there) and delta staged beside them by the producer warp,
//    in the transposed form s^T = k q^T, dp^T = v do^T, dv += p^T do,
//    dk += ds^T q; dq, a block per (128 q rows, head), keeps Q and dO
//    and walks BK-key K/V tiles to the diagonal.  Both rebuild p from
//    lse.  BQ is 64 at dh 64 and 32 at dh 128, where dk and dv alone are
//    2 x 64 f32 a thread; BK is 64.
//  - Registers and spills (ptxas, sm_90a): a block of nine warps puts
//    three on one of the SM's four register-file quarters, so 168 a
//    thread at most (setmaxnreg did not lift ptxas's allocation).
//    Forward 155 / 168 at dh 64 / 128 (wgmma serialised by ptxas at
//    128), dk/dv 168 / 168, dq 126 / 158; no spills but dk/dv at dh 128
//    (~308 bytes).  Forward 128 x 128 tiles in 3 slots; backward 2.
//  - f32: CUDA-core FMAs in full f32 (no TF32), 256 threads each owning
//    a 4 x 4 micro-tile of a 64 x 64 score tile, 64-row tiles loaded
//    synchronously, so f32 results stay within the reference's f32
//    bands.  Rows past T load as 0, keys past T score -1e30 (p = 0), and
//    rows past T are never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace znicz_hopper;

constexpr float kMaskValue = -1e30f;  // the reference's mask constant
constexpr int kTile = 64;             // q rows / key rows per tile

__device__ __forceinline__ bool dead(int qi, int key, int t, int causal) {
  return key >= t || (causal && key > qi);
}

// ---------------------------------------------------------------------------
// f32 path: CUDA cores, full f32
// ---------------------------------------------------------------------------

constexpr int kScalarThreads = 256;  // 16 x 16 threads, 4 x 4 each
constexpr int kST = kTile + 4;       // row stride of a transposed tile

// rows [r0, r0 + kTile) of a (t, DH) matrix into shared memory, row-major
// with row stride DH + 4 (16-byte aligned rows); rows at or past t are 0
template <int DH>
__device__ void load_rows(float* dst, const float* src, int r0, int t) {
  for (int i = threadIdx.x; i < kTile * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 4) + d] =
        r0 + r < t ? src[static_cast<size_t>(r0 + r) * DH + d] : 0.f;
  }
}

// the same rows transposed: dst[d][r] with row stride kST
template <int DH>
__device__ void load_rows_t(float* dst, const float* src, int r0, int t) {
  for (int i = threadIdx.x; i < kTile * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    dst[d * kST + r] =
        r0 + r < t ? src[static_cast<size_t>(r0 + r) * DH + d] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] += a * b.x;
  acc[1] += a * b.y;
  acc[2] += a * b.z;
  acc[3] += a * b.w;
}

// Thread (ty, tx) of 16 x 16 owns score rows ty*4 .. ty*4+3 and score
// columns tx*4 .. tx*4+3 of a 64 x 64 tile, and output columns
// c*64 + tx*4 .. +3 (c < DH/64) of its four rows.

template <int DH>
__global__ void __launch_bounds__(kScalarThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int t, int causal,
                  float sm_scale) {
  constexpr int NC = DH / 64, SD = DH + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [row][d]
  float* Kt = Qs + kTile * SD;                     // [d][key]
  float* Vs = Kt + DH * kST;                       // [key][d]
  float* Ps = Vs + kTile * SD;                     // [row][key]

  const int nq = (t + kTile - 1) / kTile;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * DH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<DH>(Qs, q + base, q0, t);
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_rows_t<DH>(Kt, k + base, kt * kTile, t);
    load_rows<DH>(Vs, v + base, kt * kTile, t);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 b = ld4(Kt + d * kST + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) fma4(s[i], Qs[(ty * 4 + i) * SD + d], b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * kTile + tx * 4 + j;
        s[i][j] = dead(qi, key, t, causal) ? kMaskValue : s[i][j] * sm_scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * kST + tx * 4 + j] = p;  // f32: rounding is a no-op
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b = ld4(Vs + key * SD + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(acc[i][c], Ps[(ty * 4 + i) * kST + key], b);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= t) continue;
    float* orow = o + base + static_cast<size_t>(qi) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[c * 64 + tx * 4 + e] = acc[i][c][e] / l[i];
    if (tx == 0)
      lse[static_cast<size_t>(blockIdx.y) * t + qi] = m[i] + logf(l[i]);
  }
}

// dk/dv: one block per (k tile, head); rows of the micro-tiles are keys,
// columns are queries (the transposed scores s^T = k . q^T).
template <int DH>
__global__ void __launch_bounds__(kScalarThreads)
    flash_bwd_dkdv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int t,
                       int causal, float sm_scale) {
  constexpr int NC = DH / 64, SD = DH + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [key][d]
  float* Vs = Ks + kTile * SD;                     // [key][d]
  float* Qs = Vs + kTile * SD;                     // [q][d]
  float* dOs = Qs + kTile * SD;                    // [q][d]
  float* Qt = dOs + kTile * SD;                    // [d][q]
  float* dOt = Qt + DH * kST;                      // [d][q]
  float* Bs = dOt + DH * kST;                      // [key][q]: p, then ds
  float* ls = Bs + kTile * kST;                    // lse of the q tile
  float* dl = ls + kTile;                          // delta of the q tile

  const int k0 = static_cast<int>(blockIdx.x) * kTile;
  const size_t rb = static_cast<size_t>(blockIdx.y) * t;
  const size_t base = rb * DH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<DH>(Ks, k + base, k0, t);
  load_rows<DH>(Vs, v + base, k0, t);
  float dka[4][NC][4] = {}, dva[4][NC][4] = {};

  const int nq = (t + kTile - 1) / kTile;
  for (int qt = causal ? static_cast<int>(blockIdx.x) : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_rows<DH>(Qs, q + base, q0, t);
    load_rows_t<DH>(Qt, q + base, q0, t);
    load_rows<DH>(dOs, dout + base, q0, t);
    load_rows_t<DH>(dOt, dout + base, q0, t);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool live = q0 + i < t;
      ls[i] = live ? lse[rb + q0 + i] : 0.f;
      dl[i] = live ? delta[rb + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 bq = ld4(Qt + d * kST + tx * 4);
      const float4 bo = ld4(dOt + d * kST + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(s[i], Ks[(ty * 4 + i) * SD + d], bq);
        fma4(dp[i], Vs[(ty * 4 + i) * SD + d], bo);
      }
    }
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx * 4 + j, qi = q0 + qc;
        const float p = dead(qi, key, t, causal) || qi >= t
                            ? 0.f
                            : expf(s[i][j] * sm_scale - ls[qc]);
        ds[i][j] = p * (dp[i][j] - dl[qc]) * sm_scale;
        Bs[(ty * 4 + i) * kST + qc] = p;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qc = 0; qc < kTile; ++qc) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b = ld4(dOs + qc * SD + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(dva[i][c], Bs[(ty * 4 + i) * kST + qc], b);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Bs[(ty * 4 + i) * kST + tx * 4 + j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int qc = 0; qc < kTile; ++qc) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b = ld4(Qs + qc * SD + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(dka[i][c], Bs[(ty * 4 + i) * kST + qc], b);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= t) continue;
    const size_t row = base + static_cast<size_t>(key) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[row + c * 64 + tx * 4 + e] = dka[i][c][e];
        dv[row + c * 64 + tx * 4 + e] = dva[i][c][e];
      }
  }
}

// dq: one block per (q tile, head), walking k tiles up to the diagonal
template <int DH>
__global__ void __launch_bounds__(kScalarThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int t, int causal, float sm_scale) {
  constexpr int NC = DH / 64, SD = DH + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [q][d]
  float* dOs = Qs + kTile * SD;                    // [q][d]
  float* Ks = dOs + kTile * SD;                    // [key][d]
  float* Kt = Ks + kTile * SD;                     // [d][key]
  float* Vt = Kt + DH * kST;                       // [d][key]
  float* Bs = Vt + DH * kST;                       // [q][key]: ds

  const int nq = (t + kTile - 1) / kTile;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const size_t rb = static_cast<size_t>(blockIdx.y) * t;
  const size_t base = rb * DH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<DH>(Qs, q + base, q0, t);
  load_rows<DH>(dOs, dout + base, q0, t);
  float lr[4], dr[4], acc[4][NC][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lr[i] = qi < t ? lse[rb + qi] : 0.f;
    dr[i] = qi < t ? delta[rb + qi] : 0.f;
  }

  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<DH>(Ks, k + base, k0, t);
    load_rows_t<DH>(Kt, k + base, k0, t);
    load_rows_t<DH>(Vt, v + base, k0, t);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 bk = ld4(Kt + d * kST + tx * 4);
      const float4 bv = ld4(Vt + d * kST + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(s[i], Qs[(ty * 4 + i) * SD + d], bk);
        fma4(dp[i], dOs[(ty * 4 + i) * SD + d], bv);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const float p = dead(qi, key, t, causal) || qi >= t
                            ? 0.f
                            : expf(s[i][j] * sm_scale - lr[i]);
        Bs[(ty * 4 + i) * kST + tx * 4 + j] =
            p * (dp[i][j] - dr[i]) * sm_scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b = ld4(Ks + key * SD + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(acc[i][c], Bs[(ty * 4 + i) * kST + key], b);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= t) continue;
    float* row = dq + base + static_cast<size_t>(qi) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) row[c * 64 + tx * 4 + e] = acc[i][c][e];
  }
}

// ---------------------------------------------------------------------------
// bf16 path: TMA rings on mbarriers, wgmma, one producer warp
// ---------------------------------------------------------------------------

constexpr int kGroups = 2;                        // consumer warpgroups
constexpr int kSpecThreads = kGroups * 128 + 32;  // + the producer warp
constexpr int kProducerWarp = kGroups * 4;
constexpr int kRowBytes = 128;  // 64 bf16 columns: the swizzle span
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// an R x DH tile: DH / 64 column halves, each R rows of 128 bytes
template <int DH, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
#pragma unroll
  for (int h = 0; h < DH / 64; ++h)
    tma_load(dst + h * R * kRowBytes, map, bar, h * 64, row, head);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_pair(uint16_t* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(lo, hi);
}

// D(64 x N) = A(64 x DH) . B(N x DH)^T, both K-major (dh contiguous):
// A is rows [ra, ra + 64) of an RA-row tile at `a`, B an N-row tile at
// `b`.  The k16 steps walk 32 bytes into a swizzle atom, then the next
// 64-column half.
template <int DH, int RA, int N>
__device__ __forceinline__ void gemm_nt(float (&d)[N / 2], uint32_t a, int ra,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t h = kk / 4, in = (kk % 4) * 32;
    wgmma_ss(d, sw128(a + h * RA * kRowBytes + ra * kRowBytes + in),
             sw128(b + h * N * kRowBytes + in), kk > 0);
  }
}

// an f32 accumulator of 64 x K rounded to bf16 as the A fragments of
// K / 16 k16 steps (its m16n8 C layout is the k16 A layout)
template <int K>
__device__ __forceinline__ void to_frags(uint32_t (&a)[K / 16][4],
                                         const float (&p)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_f32(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

// D(64 x DH) += P(64 x K) . B(K x DH): P as bf16 A fragments, B a K-row
// tile at `b` read MN-major (the transpose bit), one n64 product per
// 64-column half
template <int DH, int K>
__device__ __forceinline__ void gemm_pv(float (&d)[DH / 64][32],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int h = 0; h < DH / 64; ++h)
      wgmma_rs(d[h], a[kk],
               sw128(b + h * K * kRowBytes + kk * 16 * kRowBytes), 1);
}

// the same with P an f32 accumulator, rounded here
template <int DH, int K>
__device__ __forceinline__ void gemm_pv(float (&d)[DH / 64][32],
                                        const float (&p)[K / 2], uint32_t b) {
  uint32_t a[K / 16][4];
  to_frags<K>(a, p);
  gemm_pv<DH, K>(d, a, b);
}

// One tile of the forward's online softmax, in base 2 on the raw scores
// of rows r0 and r0 + 8 (accumulator entries e < 2 and e >= 2): where
// `masked`, keys at or past t and causal keys past the row score -inf;
// the running max m and sum l are updated, p replaces the scores, and
// the two factors that rescale the earlier accumulators are returned.
// The first tile holds a live key (key 0) for every row, so the max is
// finite from there on and the first tile's factor is 2^-inf = 0; a
// later tile with no live key for a row gives it p = 0 and factor 1.
template <int K>
__device__ __forceinline__ float2 online_softmax(float (&sc)[K / 2],
                                                 float (&m)[2], float (&l)[2],
                                                 bool masked, int k0, int r0,
                                                 int t, int causal, int tg,
                                                 float c) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tg + (e & 1);
        if (key >= t || (causal && key > r0 + 8 * (e >> 1)))
          sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], w));
    alpha[i] = exp2_approx((m[i] - mx[i]) * c);
    m[i] = mx[i];
    mx[i] *= c;
  }
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], c, -mx[e >> 1]));
      rs[e >> 1] += sc[4 * j + e];
    }
  // partial row sums: the quad's four lanes share alpha, so they sum
  // once at the end
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
  return make_float2(alpha[0], alpha[1]);
}

template <int DH>
__device__ __forceinline__ void rescale(float (&d)[DH / 64][32],
                                        float2 alpha) {
#pragma unroll
  for (int h = 0; h < DH / 64; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d[h][4 * j] *= alpha.x;
      d[h][4 * j + 1] *= alpha.x;
      d[h][4 * j + 2] *= alpha.y;
      d[h][4 * j + 3] *= alpha.y;
    }
}

// rows r0 (lane's g) and r0 + 8 of a (.., DH) accumulator to bf16 rows,
// each scaled by its factor; rows at or past t are not written
template <int DH>
__device__ __forceinline__ void store_rows(uint16_t* out,
                                           const float (&d)[DH / 64][32],
                                           int r0, int t, int tg, float f0,
                                           float f1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= t) continue;
    const float f = half ? f1 : f0;
    uint16_t* row = out + static_cast<size_t>(r) * DH + 2 * tg;
#pragma unroll
    for (int h = 0; h < DH / 64; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(row + h * 64 + 8 * j, d[h][4 * j + 2 * half] * f,
                   d[h][4 * j + 2 * half + 1] * f);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int H, int N>
__device__ __forceinline__ void zero(float (&d)[H][N]) {
#pragma unroll
  for (int h = 0; h < H; ++h) zero(d[h]);
}

// shared memory: a header (barriers, staged rows) at the start, then the
// tiles from the next 1024-byte boundary (the swizzle atom; TMA and
// wgmma both read the swizzle from the address bits)
__device__ __forceinline__ uint32_t tiles_base(uint32_t base, int header) {
  return (base + header + 1023) & ~1023u;
}

// Forward: one block per (128 query rows, head), heaviest causal q tile
// first.  Warpgroup wg owns rows [64 wg, 64 wg + 64) of the q tile; the
// producer warp loads Q once and streams 128-key K/V tiles through a ring
// of STAGES slots.  The online softmax is in base 2 on the unscaled
// scores: p = 2^(s c - m c) with c = sm_scale log2(e), one FFMA each.
template <int DH, int BK, int STAGES>
__global__ void __launch_bounds__(kSpecThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   uint16_t* __restrict__ o, float* __restrict__ lse, int t,
                   int causal, float sm_scale) {
  constexpr int BQ = 128;
  constexpr uint32_t QB = BQ * DH * 2, KB = BK * DH * 2;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  const uint32_t base = smem_u32(smem_tma);
  const uint32_t full = base, empty = base + 8 * STAGES,
                 qbar = base + 16 * STAGES;
  const uint32_t sq = tiles_base(base, 16 * STAGES + 8);
  const uint32_t sk0 = sq + QB;  // slot s: K at sk0 + 2 s KB, V after it

  const int nq = (t + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * BQ, head = blockIdx.y;
  const int nk_all = (t + BK - 1) / BK;
  const int nk_diag = (q0 + BQ - 1) / BK + 1;
  const int nk = causal && nk_diag < nk_all ? nk_diag : nk_all;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kGroups * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      mbar_expect_tx(qbar, QB);
      tma_tile<DH, BQ>(sq, &qmap, qbar, q0, head);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
        const uint32_t sk = sk0 + 2 * s * KB;
        mbar_expect_tx(full + 8 * s, 2 * KB);
        tma_tile<DH, BK>(sk, &kmap, full + 8 * s, kt * BK, head);
        tma_tile<DH, BK>(sk + KB, &vmap, full + 8 * s, kt * BK, head);
      }
    }
    return;
  }

  const int wg = warp / 4, g = lane / 4, tg = lane % 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + g;
  const float c = sm_scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 64][32], sc[BK / 2];
  zero(acc);
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES, k0 = kt * BK;
    const uint32_t sk = sk0 + 2 * s * KB;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    wgmma_fence();
    gemm_nt<DH, BQ, BK>(sc, sq, wg * 64, sk);
    wgmma_commit_wait();
    reg_fence(sc);
    // only the tiles that reach past q0 and a ragged last tile hold dead
    // keys
    rescale<DH>(acc, online_softmax<BK>(
                         sc, m, l, (causal && k0 + BK - 1 > q0) || k0 + BK > t,
                         k0, row0, t, causal, tg, c));
    wgmma_fence();
    gemm_pv<DH, BK>(acc, sc, sk + KB);
    wgmma_commit_wait();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
  const size_t rb = static_cast<size_t>(head) * t;
  store_rows<DH>(o + rb * DH, acc, row0, t, tg, 1.f / l[0], 1.f / l[1]);
  if (tg == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < t)
        lse[rb + row0 + 8 * i] = m[i] * sm_scale + log2f(l[i]) * kLn2;
}

// dk/dv: one block per (128 keys, head); warpgroup wg owns keys
// [64 wg, 64 wg + 64) and keeps its dk and dv accumulators in registers
// to the end.  The producer warp loads K and V once and streams BQ-row
// (Q, dO) tiles, with their lse (as lse log2(e); +inf past t, so p = 0
// there) and delta staged beside them, from the diagonal when causal.
// Transposed scores: s^T = k . q^T and dp^T = v . do^T.
template <int DH, int BQ, int STAGES>
__global__ void __launch_bounds__(kSpecThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                        int t, int causal, float sm_scale) {
  constexpr int BK = 128;
  constexpr uint32_t QB = BQ * DH * 2, KB = BK * DH * 2;
  constexpr int HEADER = 16 * STAGES + 8 + STAGES * 2 * BQ * 4;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  const uint32_t base = smem_u32(smem_tma);
  const uint32_t full = base, empty = base + 8 * STAGES,
                 kvbar = base + 16 * STAGES;
  float* stats = reinterpret_cast<float*>(smem_tma + 16 * STAGES + 8);
  const uint32_t sk = tiles_base(base, HEADER), sv = sk + KB;
  const uint32_t sq0 = sv + KB;  // slot s: Q at sq0 + 2 s QB, dO after it

  const int k0 = static_cast<int>(blockIdx.x) * BK, head = blockIdx.y;
  const size_t rb = static_cast<size_t>(head) * t;
  const int nqt = (t + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer's lanes
      mbar_init(empty + 8 * s, kGroups * 4);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * KB);
      tma_tile<DH, BK>(sk, &kmap, kvbar, k0, head);
      tma_tile<DH, BK>(sv, &vmap, kvbar, k0, head);
    }
    for (int qt = qt0, i = 0; qt < nqt; ++qt, ++i) {
      const int s = i % STAGES, q0 = qt * BQ;
      if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
      float* ls = stats + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const bool live = q0 + r < t;
        ls[r] = live ? lse[rb + q0 + r] * kLog2e : INFINITY;
        ls[BQ + r] = live ? delta[rb + q0 + r] : 0.f;
      }
      if (lane == 0) {
        const uint32_t sq = sq0 + 2 * s * QB;
        mbar_expect_tx(full + 8 * s, 2 * QB);
        tma_tile<DH, BQ>(sq, &qmap, full + 8 * s, q0, head);
        tma_tile<DH, BQ>(sq + QB, &domap, full + 8 * s, q0, head);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const int wg = warp / 4, g = lane / 4, tg = lane % 4;
  const int key0 = k0 + wg * 64 + (warp % 4) * 16 + g, key1 = key0 + 8;
  const float c = sm_scale * kLog2e;
  float dka[DH / 64][32], dva[DH / 64][32];
  zero(dka);
  zero(dva);
  mbar_wait(kvbar, 0);

  for (int qt = qt0, i = 0; qt < nqt; ++qt, ++i) {
    const int s = i % STAGES, q0 = qt * BQ;
    const uint32_t sq = sq0 + 2 * s * QB;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const float* ls = stats + s * 2 * BQ;
    const float* dl = ls + BQ;
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
    gemm_nt<DH, BK, BQ>(st, sk, wg * 64, sq);
    gemm_nt<DH, BK, BQ>(dpt, sv, wg * 64, sq + QB);
    wgmma_commit_wait();
    reg_fence(st);
    reg_fence(dpt);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tg + (e & 1);
        st[4 * j + e] = exp2_approx(fmaf(st[4 * j + e], c, -ls[col]));
      }
    // only the q tiles that overlap this block's keys hold dead pairs
    if (causal && q0 < k0 + BK) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((e < 2 ? key0 : key1) > q0 + 8 * j + 2 * tg + (e & 1))
            st[4 * j + e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tg + (e & 1);
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - dl[col]) * sm_scale;
      }
    wgmma_fence();
    gemm_pv<DH, BQ>(dva, st, sq + QB);
    gemm_pv<DH, BQ>(dka, dpt, sq);
    wgmma_commit_wait();
    reg_fence(dka);
    reg_fence(dva);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  store_rows<DH>(dk + rb * DH, dka, key0, t, tg, 1.f, 1.f);
  store_rows<DH>(dv + rb * DH, dva, key0, t, tg, 1.f, 1.f);
}

// dq: one block per (128 query rows, head), heaviest causal q tile first;
// warpgroup wg owns rows [64 wg, 64 wg + 64).  The producer warp loads Q
// and dO once and streams BK-key K/V tiles up to the diagonal.
template <int DH, int BK, int STAGES>
__global__ void __launch_bounds__(kSpecThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dq, int t, int causal,
                      float sm_scale) {
  constexpr int BQ = 128;
  constexpr uint32_t QB = BQ * DH * 2, KB = BK * DH * 2;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  const uint32_t base = smem_u32(smem_tma);
  const uint32_t full = base, empty = base + 8 * STAGES,
                 qbar = base + 16 * STAGES;
  const uint32_t sq = tiles_base(base, 16 * STAGES + 8), sdo = sq + QB;
  const uint32_t sk0 = sdo + QB;  // slot s: K at sk0 + 2 s KB, V after it

  const int nq = (t + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * BQ, head = blockIdx.y;
  const size_t rb = static_cast<size_t>(head) * t;
  const int nk_all = (t + BK - 1) / BK;
  const int nk_diag = (q0 + BQ - 1) / BK + 1;
  const int nk = causal && nk_diag < nk_all ? nk_diag : nk_all;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kGroups * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * QB);
      tma_tile<DH, BQ>(sq, &qmap, qbar, q0, head);
      tma_tile<DH, BQ>(sdo, &domap, qbar, q0, head);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
        const uint32_t sk = sk0 + 2 * s * KB;
        mbar_expect_tx(full + 8 * s, 2 * KB);
        tma_tile<DH, BK>(sk, &kmap, full + 8 * s, kt * BK, head);
        tma_tile<DH, BK>(sk + KB, &vmap, full + 8 * s, kt * BK, head);
      }
    }
    return;
  }

  const int wg = warp / 4, g = lane / 4, tg = lane % 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + g, row1 = row0 + 8;
  const float c = sm_scale * kLog2e;
  // lse in base 2, +inf past t (p = 0 there); delta 0 past t
  const float lr0 = row0 < t ? lse[rb + row0] * kLog2e : INFINITY;
  const float lr1 = row1 < t ? lse[rb + row1] * kLog2e : INFINITY;
  const float dr0 = row0 < t ? delta[rb + row0] : 0.f;
  const float dr1 = row1 < t ? delta[rb + row1] : 0.f;
  float dqa[DH / 64][32];
  zero(dqa);
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES, kb = kt * BK;
    const uint32_t sk = sk0 + 2 * s * KB;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
    gemm_nt<DH, BQ, BK>(sc, sq, wg * 64, sk);
    wgmma_commit();
    gemm_nt<DH, BQ, BK>(dp, sdo, wg * 64, sk + KB);
    wgmma_commit();
    wgmma_wait<1>();  // s; dp may still run
    reg_fence(sc);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = exp2_approx(fmaf(sc[4 * j], c, -lr0));
      sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], c, -lr0));
      sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], c, -lr1));
      sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], c, -lr1));
    }
    // dead keys: causal tiles that reach past q0, a ragged last tile
    if ((causal && kb + BK - 1 > q0) || kb + BK > t) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + 8 * j + 2 * tg + (e & 1);
          if (key >= t || (causal && key > (e < 2 ? row0 : row1)))
            sc[4 * j + e] = 0.f;
        }
    }
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      dp[4 * j] = sc[4 * j] * (dp[4 * j] - dr0) * sm_scale;
      dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - dr0) * sm_scale;
      dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - dr1) * sm_scale;
      dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - dr1) * sm_scale;
    }
    wgmma_fence();
    gemm_pv<DH, BK>(dqa, dp, sk);
    wgmma_commit_wait();
    reg_fence(dqa);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  store_rows<DH>(dq + rb * DH, dqa, row0, t, tg, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

size_t f32_fwd_smem(int dh) {
  return sizeof(float) * (2 * kTile * (dh + 4) + dh * kST + kTile * kST);
}
size_t f32_dkdv_smem(int dh) {
  return sizeof(float) *
         (4 * kTile * (dh + 4) + 2 * dh * kST + kTile * kST + 2 * kTile);
}
size_t f32_dq_smem(int dh) {
  return sizeof(float) * (3 * kTile * (dh + 4) + 2 * dh * kST + kTile * kST);
}

template <int DH>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int t, int causal, float scale,
                    cudaStream_t s) {
  const dim3 grid((t + kTile - 1) / kTile, bh);
  return launch(flash_fwd_f32<DH>, grid, kScalarThreads, f32_fwd_smem(DH), s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), t, causal, scale);
}

template <int DH>
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, void* dk, void* dv, int bh, int t, int causal,
                    float scale, cudaStream_t s) {
  const dim3 grid((t + kTile - 1) / kTile, bh);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdl = static_cast<const float*>(delta);
  cudaError_t err = launch(flash_bwd_dkdv_f32<DH>, grid, kScalarThreads,
                           f32_dkdv_smem(DH), s, fq, fk, fv, fdo, flse, fdl,
                           static_cast<float*>(dk), static_cast<float*>(dv),
                           t, causal, scale);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_f32<DH>, grid, kScalarThreads, f32_dq_smem(DH),
                s, fq, fk, fv, fdo, flse, fdl, static_cast<float*>(dq), t,
                causal, scale);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (bh, t, dh) bf16 tensor as a 3-D map read in boxes of `rows` rows by
// 64 columns, 128-byte swizzled.  The bounds are per head, so the rows of
// a ragged last tile past t read as zeros, never as the next head's rows.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int t,
                     int dh, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(t) * dh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// shared bytes of a TMA kernel: its header, the slack to the first
// 1024-byte boundary, its tiles
constexpr size_t tma_smem(size_t header, size_t tiles) {
  return header + 1024 + tiles;
}

// Tiles per instantiation and their shared memory (of the 227 KB a block
// may use): forward 128 x 128, 3 slots: 113 KB at dh 64, 225 KB at 128;
// dk/dv 128 keys by BQ queries, 2 slots: 66 KB at (64, 64), 98 KB at
// (128, 32); dq 128 queries by BK keys, 2 slots: 65 KB at (64, 64),
// 129 KB at (128, 64).
constexpr int kFwdBK = 128, kFwdStages = 3, kBwdStages = 2;

template <int DH>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int t, int causal, float scale,
                     cudaStream_t s) {
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = make_map(&qm, q, bh, t, DH, 128)) != cudaSuccess ||
      (err = make_map(&km, k, bh, t, DH, kFwdBK)) != cudaSuccess ||
      (err = make_map(&vm, v, bh, t, DH, kFwdBK)) != cudaSuccess)
    return err;
  const size_t smem = tma_smem(16 * kFwdStages + 8,
                               (128 + 2 * kFwdStages * kFwdBK) * DH * 2);
  const dim3 grid((t + 127) / 128, bh);
  return launch(flash_fwd_bf16<DH, kFwdBK, kFwdStages>, grid, kSpecThreads,
                smem, s,
                qm, km, vm, static_cast<uint16_t*>(o),
                static_cast<float*>(lse), t, causal, scale);
}

// q tile of the dk/dv pass and k tile of the dq pass: BQ 64 at head dim
// 64, 32 at 128, which keeps dk, dv and the two score accumulators in
// registers (dh 128: 2 x 64 + 2 x 16 f32 a thread); BK 64 at both
template <int DH, int BQ, int BK>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, int bh, int t, int causal,
                     float scale, cudaStream_t s) {
  CUtensorMap qm, km, vm, dom;
  const float* flse = static_cast<const float*>(lse);
  const float* fdl = static_cast<const float*>(delta);
  cudaError_t err;
  if ((err = make_map(&qm, q, bh, t, DH, BQ)) != cudaSuccess ||
      (err = make_map(&km, k, bh, t, DH, 128)) != cudaSuccess ||
      (err = make_map(&vm, v, bh, t, DH, 128)) != cudaSuccess ||
      (err = make_map(&dom, dout, bh, t, DH, BQ)) != cudaSuccess)
    return err;
  const dim3 grid((t + 127) / 128, bh);
  err = launch(flash_bwd_dkdv_bf16<DH, BQ, kBwdStages>, grid, kSpecThreads,
               tma_smem(16 * kBwdStages + 8 + kBwdStages * 2 * BQ * 4,
                        (2 * 128 + 2 * kBwdStages * BQ) * DH * 2),
               s, qm, km, vm, dom, flse, fdl, static_cast<uint16_t*>(dk),
               static_cast<uint16_t*>(dv), t, causal, scale);
  if (err != cudaSuccess) return err;
  if ((err = make_map(&qm, q, bh, t, DH, 128)) != cudaSuccess ||
      (err = make_map(&km, k, bh, t, DH, BK)) != cudaSuccess ||
      (err = make_map(&vm, v, bh, t, DH, BK)) != cudaSuccess ||
      (err = make_map(&dom, dout, bh, t, DH, 128)) != cudaSuccess)
    return err;
  return launch(flash_bwd_dq_bf16<DH, BK, kBwdStages>, grid, kSpecThreads,
                tma_smem(16 * kBwdStages + 8,
                         (2 * 128 + 2 * kBwdStages * BK) * DH * 2),
                s, qm, km, vm, dom, flse, fdl, static_cast<uint16_t*>(dq), t,
                causal, scale);
}


}  // namespace

// dtype codes: 0 = bfloat16, 1 = float32.  Each returns the cudaError_t of
// its launches (0 = success); an unsupported (dtype, head_dim) or an empty
// shape returns cudaErrorInvalidValue without launching.
extern "C" int znicz_flash_fwd(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, void* o,
                               void* lse, int bh, int t, int causal,
                               float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0 && head_dim == 64)
    err = fwd_bf16<64>(q, k, v, o, lse, bh, t, causal, sm_scale, s);
  else if (dtype == 0 && head_dim == 128)
    err = fwd_bf16<128>(q, k, v, o, lse, bh, t, causal, sm_scale, s);
  else if (dtype == 1 && head_dim == 64)
    err = fwd_f32<64>(q, k, v, o, lse, bh, t, causal, sm_scale, s);
  else if (dtype == 1 && head_dim == 128)
    err = fwd_f32<128>(q, k, v, o, lse, bh, t, causal, sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int znicz_flash_bwd(int dtype, int head_dim, const void* q,
                               const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, int bh, int t, int causal,
                               float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0 && head_dim == 64)
    err = bwd_bf16<64, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                               t, causal, sm_scale, s);
  else if (dtype == 0 && head_dim == 128)
    err = bwd_bf16<128, 32, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                t, causal, sm_scale, s);
  else if (dtype == 1 && head_dim == 64)
    err = bwd_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, causal,
                      sm_scale, s);
  else if (dtype == 1 && head_dim == 128)
    err = bwd_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, causal,
                       sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* znicz_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
