// The f32 CUDA-core GEMM tile that gemm.cu and conv.cu share.
//
// One 128x128 output tile per block of 256 threads, each thread owning an
// 8x8 sub-tile of f32 sums in registers.  The K loop walks 8-deep tiles
// staged in shared memory, double-buffered: the next tile's global loads
// are in flight while the current one is multiplied.  What feeds the loop
// is a pair of tile loaders, one per operand: each ``load`` call hands back
// this thread's 4 elements of the next 128 (outer) x 8 (k) tile and steps
// to the one after.  A loader's ``kKC`` says how its 4 elements lie: 4
// consecutive k of one outer index (o = tid / 2), or 4 consecutive outer
// indices of one k (k = tid / 32).  gemm.cu's loaders read dense row-major
// matrices; conv.cu's gather im2col patches by index arithmetic.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace znicz_tile {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
static_assert(kThreads == 256, "the tile loaders assume 256 threads");
static_assert(BM * BK == 4 * kThreads && BN * BK == 4 * kThreads,
              "each thread stages 4 elements of each operand tile");
static_assert(BM == BN, "one store_tile serves both operands");

__device__ __forceinline__ void set4(float (&r)[4], float4 v) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void zero4(float (&r)[4]) {
  r[0] = r[1] = r[2] = r[3] = 0.f;
}

// 4 consecutive floats at p (16-byte aligned) in one load.
__device__ __forceinline__ void load4(float (&r)[4], const float* p) {
  set4(r, *reinterpret_cast<const float4*>(p));
}

// A dense operand of O (outer) x K.  KC: stored k-contiguous, X[o * K + k]
// (A, or B^T); otherwise outer-contiguous, X[k * O + o] (B, or A^T).
// Elements past O or K read as 0.  ``vec``: the stored rows are aligned to
// 4 elements, so 4 neighbours come in one load.
template <bool KC>
struct DenseTile {
  static constexpr bool kKC = KC;
  const float* X;
  int O, K, o0, k0;
  bool vec;

  __device__ __forceinline__ void load(float (&r)[4]) {
    const int tid = threadIdx.x;
    if (KC) {
      const int o = o0 + tid / 2;
      const int k = k0 + (tid % 2) * 4;
      const float* p = X + static_cast<size_t>(o) * K + k;
      if (vec && o < O && k + 3 < K) {
        load4(r, p);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = (o < O && k + j < K) ? p[j] : 0.f;
      }
    } else {
      const int k = k0 + tid / 32;
      const int o = o0 + (tid % 32) * 4;
      const float* p = X + static_cast<size_t>(k) * O + o;
      if (vec && k < K && o + 3 < O) {
        load4(r, p);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = (k < K && o + j < O) ? p[j] : 0.f;
      }
    }
    k0 += BK;
  }
};

// Where one thread's 4 elements go in the [k][outer] shared tile.
template <bool KC>
__device__ __forceinline__ void store_tile(float (*S)[BM],
                                           const float (&r)[4]) {
  const int tid = threadIdx.x;
  if (KC) {
    const int o = tid / 2;
    const int c = (tid % 2) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) S[c + j][o] = r[j];
  } else {
    *reinterpret_cast<float4*>(&S[tid / 32][(tid % 32) * 4]) =
        make_float4(r[0], r[1], r[2], r[3]);
  }
}

// The K loop over n_k tiles from loaders la (A, the block's 128 rows) and
// lb (B, its 128 columns).  acc is this thread's 8x8 sub-tile, rows ty*8..
// and columns tx*8.. of the block's tile, ty = tid / 16 and tx = tid % 16.
// Each output is one thread's sum in a fixed order: no split, no atomics.
template <class LA, class LB>
__device__ __forceinline__ void mainloop(LA& la, LB& lb, int n_k,
                                         float (&acc)[TM][TN]) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (n_k <= 0) return;

  float ra[4], rb[4];
  la.load(ra);
  lb.load(rb);
  store_tile<LA::kKC>(As[0], ra);
  store_tile<LB::kKC>(Bs[0], rb);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_k;
    if (more) {  // the next tile's loads fly while this one is multiplied
      la.load(ra);
      lb.load(rb);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * TN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][tx * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_tile<LA::kKC>(As[cur ^ 1], ra);
      store_tile<LB::kKC>(Bs[cur ^ 1], rb);
    }
    // one barrier a step: the buffer written above is read next step, and
    // the one read above is written only after the next barrier
    __syncthreads();
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// blocks for a grid-stride loop over ``items``: enough to fill the card
// several times over
inline int blocks_for(long long items) {
  const long long want = (items + 255) / 256;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

}  // namespace znicz_tile
