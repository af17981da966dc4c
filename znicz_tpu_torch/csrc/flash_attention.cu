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
// the 67 TFLOP/s CUDA cores).
//
// Design (simple and right first; wgmma, TMA, warp specialisation and a
// pipelined K/V ring are later work):
//  - The TPU kernel keeps all of K and V for a head in VMEM and takes
//    a whole-row softmax.  At T = 2048 that is more than a block's
//    shared memory, so the forward runs one block per (q tile of 64
//    rows, head) and walks 64-row K/V tiles with an online softmax
//    (m, l, acc in f32), writing o and lse at the end.  A causal block
//    stops at its diagonal tile: the tiles above it hold only masked
//    scores, which add exactly 0.  Causal q tiles are scheduled
//    heaviest first.
//  - The TPU backward carries dk/dv across its sequential q grid axis
//    in a revisited output block; GPU blocks have no such carry.  So
//    the backward takes two passes, neither with atomics (hence
//    deterministic): one block per (k tile, head) loops over q tiles
//    (from the diagonal when causal) accumulating dk and dv in f32
//    registers; one block per (q tile, head) loops over k tiles and
//    writes dq.  Both rebuild p from lse.
//  - bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32
//    accumulate), four warps of 16 rows each.  The score accumulators
//    stay in registers and are repacked as the A operand of the next
//    product (the m16n8 C layout equals the k16 A layout), so p and ds
//    never touch shared memory.  Shared tiles have a row stride of
//    DH + 8 halves, which makes every fragment load conflict-free.
//  - f32: CUDA-core FMAs in full f32 (no TF32), 256 threads each owning
//    a 4 x 4 micro-tile of the 64 x 64 score tile, so f32 results stay
//    within the reference's f32 bands.
//  - A ragged last tile (T not a multiple of 64) is masked in the
//    kernel: rows past T load as 0, keys past T score -1e30 (p = 0),
//    and rows past T are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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
// bf16 path: tensor cores through mma.sync.m16n8k16 (f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 rows each

// D += A . B for one m16n8k16 tile: A 16x16 row-major, B 16x8 "col"
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 bit patterns into one register, lo in the low half
__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// two f32 values rounded to bf16 (round to nearest even) in one register
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [r0, r0 + R) of a (t, DH) bf16 matrix into shared memory with row
// stride DH + 8 halves (16-byte loads; rows at or past t are 0)
template <int DH, int R>
__device__ void copy_rows(uint16_t* dst, const uint16_t* src, int r0, int t) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < R * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r0 + r) * DH + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c * 8) = val;
  }
}

// Fragment coordinates (PTX ISA, mma.m16n8k16): lane = 4 * g + tg.
// A (16 x 16): a0 (g, 2tg..), a1 (g + 8, 2tg..), a2 (g, 2tg + 8..),
// a3 (g + 8, 2tg + 8..).  B (16 x 8): b0 (k = 2tg.., n = g),
// b1 (k = 2tg + 8.., n = g).  C (16 x 8): c0, c1 (g, 2tg..),
// c2, c3 (g + 8, 2tg..).

// A from a row-major shared matrix, rows r0.., columns c0..
template <int S>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* M,
                                       int r0, int c0, int g, int tg) {
  a[0] = ld32(M + (r0 + g) * S + c0 + 2 * tg);
  a[1] = ld32(M + (r0 + g + 8) * S + c0 + 2 * tg);
  a[2] = ld32(M + (r0 + g) * S + c0 + 8 + 2 * tg);
  a[3] = ld32(M + (r0 + g + 8) * S + c0 + 8 + 2 * tg);
}

// B[kk][n] = M[n0 + n][k0 + kk]: the rows of M are B's columns
template <int S>
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const uint16_t* M, int n0, int k0,
                                            int g, int tg) {
  b0 = ld32(M + (n0 + g) * S + k0 + 2 * tg);
  b1 = ld32(M + (n0 + g) * S + k0 + 8 + 2 * tg);
}

// B[kk][n] = M[k0 + kk][n0 + n]: the rows of M are B's rows
template <int S>
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1,
                                            const uint16_t* M, int k0, int n0,
                                            int g, int tg) {
  const uint16_t* p = M + (k0 + 2 * tg) * S + n0 + g;
  b0 = pack_u16(p[0], p[S]);
  b1 = pack_u16(p[8 * S], p[9 * S]);
}

// C tiles j = 2kk, 2kk + 1 (columns 16kk .. 16kk + 15), rounded to bf16,
// as the A operand of the next product
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

__device__ __forceinline__ void store_pair(uint16_t* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(lo, hi);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_bf16(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                   float* __restrict__ lse, int t, int causal,
                   float sm_scale) {
  constexpr int S = DH + 8, KS = DH / 16, ND = DH / 8, NJ = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Ks = Qs + kTile * S;
  uint16_t* Vs = Ks + kTile * S;

  const int nq = (t + kTile - 1) / kTile;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const size_t rb = static_cast<size_t>(blockIdx.y) * t;
  const size_t base = rb * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  copy_rows<DH, kTile>(Qs, q + base, q0, t);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    frag_a<S>(qa[kk], Qs, warp * 16, kk * 16, g, tg);

  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;
  float oacc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nd][e] = 0.f;

  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    copy_rows<DH, kTile>(Ks, k + base, kt * kTile, t);
    copy_rows<DH, kTile>(Vs, v + base, kt * kTile, t);
    __syncthreads();
    float sacc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        frag_b_rows<S>(b0, b1, Ks, j * 8, kk * 16, g, tg);
        mma16816(sacc[j], qa[kk], b0, b1);
      }
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kTile + j * 8 + 2 * tg + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float s =
            dead(row, key, t, causal) ? kMaskValue : sacc[j][e] * sm_scale;
        sacc[j][e] = s;
        if (e < 2)
          mx0 = fmaxf(mx0, s);
        else
          mx1 = fmaxf(mx1, s);
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sacc[j][0] = expf(sacc[j][0] - mn0);
      sacc[j][1] = expf(sacc[j][1] - mn0);
      sacc[j][2] = expf(sacc[j][2] - mn1);
      sacc[j][3] = expf(sacc[j][3] - mn1);
      rs0 += sacc[j][0] + sacc[j][1];
      rs1 += sacc[j][2] + sacc[j][3];
    }
    // partial row sums: the quad's four lanes share alpha, so they sum
    // once at the end
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      oacc[nd][0] *= a0;
      oacc[nd][1] *= a0;
      oacc[nd][2] *= a1;
      oacc[nd][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, sacc[2 * kk], sacc[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        frag_b_cols<S>(b0, b1, Vs, kk * 16, nd * 8, g, tg);
        mma16816(oacc[nd], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  if (row0 < t) {
    uint16_t* orow = o + base + static_cast<size_t>(row0) * DH + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store_pair(orow + nd * 8, oacc[nd][0] / l0, oacc[nd][1] / l0);
    if (tg == 0) lse[rb + row0] = m0 + logf(l0);
  }
  if (row1 < t) {
    uint16_t* orow = o + base + static_cast<size_t>(row1) * DH + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store_pair(orow + nd * 8, oacc[nd][2] / l1, oacc[nd][3] / l1);
    if (tg == 0) lse[rb + row1] = m1 + logf(l1);
  }
}

// dk/dv: one block per (k tile of 64 keys, head); each warp owns 16 keys
// and walks q tiles of BQ rows with the transposed scores s^T = k . q^T
template <int DH, int BQ>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_bf16(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        const uint16_t* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                        int t, int causal, float sm_scale) {
  constexpr int S = DH + 8, KS = DH / 16, ND = DH / 8, NJ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Vs = Ks + kTile * S;
  uint16_t* Qs = Vs + kTile * S;
  uint16_t* dOs = Qs + BQ * S;
  float* ls = reinterpret_cast<float*>(dOs + BQ * S);
  float* dl = ls + BQ;

  const int k0 = static_cast<int>(blockIdx.x) * kTile;
  const size_t rb = static_cast<size_t>(blockIdx.y) * t;
  const size_t base = rb * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;

  copy_rows<DH, kTile>(Ks, k + base, k0, t);
  copy_rows<DH, kTile>(Vs, v + base, k0, t);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  const int nqt = (t + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    copy_rows<DH, BQ>(Qs, q + base, q0, t);
    copy_rows<DH, BQ>(dOs, dout + base, q0, t);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const bool live = q0 + i < t;
      ls[i] = live ? lse[rb + q0 + i] : 0.f;
      dl[i] = live ? delta[rb + q0 + i] : 0.f;
    }
    __syncthreads();
    float sacc[NJ][4], dpacc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<S>(ka, Ks, warp * 16, kk * 16, g, tg);
      frag_a<S>(va, Vs, warp * 16, kk * 16, g, tg);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        frag_b_rows<S>(b0, b1, Qs, j * 8, kk * 16, g, tg);
        mma16816(sacc[j], ka, b0, b1);
        frag_b_rows<S>(b0, b1, dOs, j * 8, kk * 16, g, tg);
        mma16816(dpacc[j], va, b0, b1);
      }
    }
    // p in place of s, ds in place of dp (both f32, unrounded)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tg + (e & 1), qi = q0 + col;
        const int key = e < 2 ? key0 : key1;
        const float p = dead(qi, key, t, causal) || qi >= t
                            ? 0.f
                            : expf(sacc[j][e] * sm_scale - ls[col]);
        sacc[j][e] = p;
        dpacc[j][e] = p * (dpacc[j][e] - dl[col]) * sm_scale;
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, sacc[2 * kk], sacc[2 * kk + 1]);
      acc_to_a(da, dpacc[2 * kk], dpacc[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        frag_b_cols<S>(b0, b1, dOs, kk * 16, nd * 8, g, tg);
        mma16816(dva[nd], pa, b0, b1);
        frag_b_cols<S>(b0, b1, Qs, kk * 16, nd * 8, g, tg);
        mma16816(dka[nd], da, b0, b1);
      }
    }
  }
  if (key0 < t) {
    const size_t row = base + static_cast<size_t>(key0) * DH + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store_pair(dk + row + nd * 8, dka[nd][0], dka[nd][1]);
      store_pair(dv + row + nd * 8, dva[nd][0], dva[nd][1]);
    }
  }
  if (key1 < t) {
    const size_t row = base + static_cast<size_t>(key1) * DH + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store_pair(dk + row + nd * 8, dka[nd][2], dka[nd][3]);
      store_pair(dv + row + nd * 8, dva[nd][2], dva[nd][3]);
    }
  }
}

// dq: one block per (q tile of 64 rows, head); each warp owns 16 rows and
// walks k tiles of BK keys up to the diagonal
template <int DH, int BK>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_bf16(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dq, int t, int causal,
                      float sm_scale) {
  constexpr int S = DH + 8, KS = DH / 16, ND = DH / 8, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* dOs = Qs + kTile * S;
  uint16_t* Ks = dOs + kTile * S;
  uint16_t* Vs = Ks + BK * S;

  const int nq = (t + kTile - 1) / kTile;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * kTile;
  const size_t rb = static_cast<size_t>(blockIdx.y) * t;
  const size_t base = rb * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lr0 = row0 < t ? lse[rb + row0] : 0.f;
  const float lr1 = row1 < t ? lse[rb + row1] : 0.f;
  const float dr0 = row0 < t ? delta[rb + row0] : 0.f;
  const float dr1 = row1 < t ? delta[rb + row1] : 0.f;

  copy_rows<DH, kTile>(Qs, q + base, q0, t);
  copy_rows<DH, kTile>(dOs, dout + base, q0, t);
  float dqa[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;

  const int nkt_all = (t + BK - 1) / BK;
  const int nkt_diag = (q0 + kTile - 1) / BK + 1;
  const int nkt = causal && nkt_diag < nkt_all ? nkt_diag : nkt_all;
  for (int kt = 0; kt < nkt; ++kt) {
    const int kb = kt * BK;
    __syncthreads();
    copy_rows<DH, BK>(Ks, k + base, kb, t);
    copy_rows<DH, BK>(Vs, v + base, kb, t);
    __syncthreads();
    float sacc[NJ][4], dpacc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a<S>(qa, Qs, warp * 16, kk * 16, g, tg);
      frag_a<S>(oa, dOs, warp * 16, kk * 16, g, tg);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        frag_b_rows<S>(b0, b1, Ks, j * 8, kk * 16, g, tg);
        mma16816(sacc[j], qa, b0, b1);
        frag_b_rows<S>(b0, b1, Vs, j * 8, kk * 16, g, tg);
        mma16816(dpacc[j], oa, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + j * 8 + 2 * tg + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float p = dead(row, key, t, causal) || row >= t
                            ? 0.f
                            : expf(sacc[j][e] * sm_scale - (e < 2 ? lr0 : lr1));
        dpacc[j][e] = p * (dpacc[j][e] - (e < 2 ? dr0 : dr1)) * sm_scale;
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dpacc[2 * kk], dpacc[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        frag_b_cols<S>(b0, b1, Ks, kk * 16, nd * 8, g, tg);
        mma16816(dqa[nd], da, b0, b1);
      }
    }
  }
  if (row0 < t) {
    uint16_t* row = dq + base + static_cast<size_t>(row0) * DH + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store_pair(row + nd * 8, dqa[nd][0], dqa[nd][1]);
  }
  if (row1 < t) {
    uint16_t* row = dq + base + static_cast<size_t>(row1) * DH + 2 * tg;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store_pair(row + nd * 8, dqa[nd][2], dqa[nd][3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB needs the per-kernel opt-in; the
// launch error (an over-large request, too many threads) is returned,
// since a refused launch never runs and a later synchronize would not
// report it.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

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
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int t, int causal, float scale,
                     cudaStream_t s) {
  const dim3 grid((t + kTile - 1) / kTile, bh);
  const size_t smem = 3 * kTile * (DH + 8) * sizeof(uint16_t);
  return launch(flash_fwd_bf16<DH>, grid, kMmaThreads, smem, s,
                static_cast<const uint16_t*>(q),
                static_cast<const uint16_t*>(k),
                static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
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

// q tile of the dk/dv pass and k tile of the dq pass: 64 rows at head
// dim 64; 32 at 128, which keeps the accumulators within the register
// file without spilling
template <int DH, int B2>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, int bh, int t, int causal,
                     float scale, cudaStream_t s) {
  const dim3 grid((t + kTile - 1) / kTile, bh);
  const uint16_t* hq = static_cast<const uint16_t*>(q);
  const uint16_t* hk = static_cast<const uint16_t*>(k);
  const uint16_t* hv = static_cast<const uint16_t*>(v);
  const uint16_t* hdo = static_cast<const uint16_t*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fdl = static_cast<const float*>(delta);
  const size_t tiles = (2 * kTile + 2 * B2) * (DH + 8) * sizeof(uint16_t);
  cudaError_t err = launch(flash_bwd_dkdv_bf16<DH, B2>, grid, kMmaThreads,
                           tiles + 2 * B2 * sizeof(float), s, hq, hk, hv, hdo,
                           flse, fdl, static_cast<uint16_t*>(dk),
                           static_cast<uint16_t*>(dv), t, causal, scale);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_bf16<DH, B2>, grid, kMmaThreads, tiles, s, hq,
                hk, hv, hdo, flse, fdl, static_cast<uint16_t*>(dq), t, causal,
                scale);
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
    err = bwd_bf16<64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t,
                           causal, sm_scale, s);
  else if (dtype == 0 && head_dim == 128)
    err = bwd_bf16<128, 32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t,
                            causal, sm_scale, s);
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
