// The f32 CUDA-core GEMM main loop that gemm.cu and conv.cu's forward
// share, for Hopper (sm_90a): true f32 FFMA sums, no TF32.
//
// A block is a grid of WM x WN warps; each warp owns a 64 x 32 patch of
// the output and each thread an 8 x 8 sub-tile of f32 sums in registers,
// read as four 4 x 4 quarters: lane (r, c) = (lane / 4, lane % 4) owns
// rows 4r .. 4r + 3 and 32 + 4r .. + 3 of the patch and columns 4c .. 4c
// + 3 and 16 + 4c .. + 3 (row_of / col_of).  The K loop walks kBK-deep k
// tiles through a kStages-deep ring in shared memory with one barrier a k
// tile; tile kt + kStages - 1 is in flight while tile kt is multiplied.
//
// Both operands are staged outer-contiguous: a stage holds kBK rows of
// one k each, the BM (BN) outer indices contiguous, pitch(BO) = BO + 4
// floats apart.  A thread reads 4 consecutive rows (columns) of one k as
// one float4, two a k; a warp's 8 (4) distinct float4s are one run of
// 128 (64) bytes and the rest broadcasts, free of bank conflicts.  (On
// the H100 the alternative, k-contiguous stages read 2 or 4 k of a row at
// a time, ran the FC products markedly slower.)  What lies that way in
// global memory (B (K, N), A^T stored (K, M)) arrives by cp.async, 16
// bytes of 4 neighbours a copy (AsyncLoader); what lies k-contiguous (A
// (M, K), B^T stored (N, K), the conv forward's im2col patches) is
// fetched into registers, 16 bytes of 4 k a load, while the tile before
// is multiplied, and stored transposed after it (StagedLoader, conv.cu's
// GatherA): 4 single-float stores a chunk, at most 2-way bank conflicts
// with the pitch of BO + 4.
// Each output is one thread's sum over k in ascending order: no split
// inside a block, no atomics, so two launches are bit-identical.
//
// A loader is a struct with ``fetch(stage)``, issued for tile kt +
// kStages - 1 right after the barrier of tile kt, and ``store(stage)``,
// after tile kt is multiplied; the next k tile each time.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace znicz_tile {

using znicz_hopper::cp_async16;
using znicz_hopper::cp_async4;
using znicz_hopper::cp_async_commit;
using znicz_hopper::cp_async_wait;
using znicz_hopper::smem_u32;

// k tile depth and ring depth: 16 x 4 ran the paths' products faster
// than 32 x 3 on the H100 (and the ring of a 128 x 128 tile takes 66 KB,
// so three blocks an SM fit by shared memory)
constexpr int kBK = 16, kStages = 4;
// blocks an SM each kernel's registers are capped for (__launch_bounds__):
// 128 registers a thread at 256 threads, no spills on the 128 x 128 tile
constexpr int kMinBlocks = 2;
constexpr int TM = 8, TN = 8;            // a thread's sub-tile
constexpr int kWarpM = 64, kWarpN = 32;  // a warp's patch of the output

// floats between the k rows of a stage BO wide
__host__ __device__ constexpr int pitch(int bo) { return bo + 4; }

// A block tile of BM x BN (WM x WN warps).
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = BM / kWarpM, WN = BN / kWarpN;
  static_assert(WM * kWarpM == BM && WN * kWarpN == BN, "whole warps");
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kA = kBK * pitch(BM), kB = kBK * pitch(BN);
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kStages * (kA + kB);
};

// The block-tile row of this thread's i-th row (i < TM) ...
template <class T>
__device__ __forceinline__ int row_of(int i) {
  return (threadIdx.x / 32 % T::WM) * kWarpM + threadIdx.x % 32 / 4 * 4 +
         (i & 3) + 32 * (i >> 2);
}

// ... and the block-tile column of its j-th column (j < TN).
template <class T>
__device__ __forceinline__ int col_of(int j) {
  return (threadIdx.x / 32 / T::WM) * kWarpN + threadIdx.x % 4 * 4 +
         (j & 3) + 16 * (j >> 2);
}

// Which 16-byte chunks of a tile this thread moves.  KC (k-contiguous in
// global memory): chunk column q (4 k) of outer rows o = first + step p;
// OC: chunk column q (4 outer indices) of k rows first + step p.  q and
// the row stride are fixed a thread, so per-row state is set up once.
template <int BO, int THREADS, bool KC>
struct Chunks {
  static constexpr int kPer = KC ? kBK / 4 : BO / 4;  // chunks a row
  static constexpr int kStep = THREADS / kPer;        // rows between passes
  static constexpr int kRows = KC ? BO : kBK;         // rows a tile
  static constexpr int kPasses = (kRows + kStep - 1) / kStep;
  static_assert(THREADS % kPer == 0, "a fixed chunk column a thread");
  __device__ static int q() { return threadIdx.x % kPer; }
  __device__ static int row(int p) { return threadIdx.x / kPer + kStep * p; }
};

// Four k of outer row o, v[e] at k 4q + e, into a stage (transposed).
template <int BO>
__device__ __forceinline__ void store_kc(float* stage, int o, int q,
                                         const float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) stage[(4 * q + e) * pitch(BO) + o] = v[e];
}

// A dense operand lying outer-contiguous, X[k * ld + o] (o < O, k in
// [k0, kend), a split-K slice), by cp.async; elements past O or kend
// arrive as zeros.  vec: the base is 16-byte aligned and ld % 4 == 0, so
// a chunk is one 16-byte copy (0 bytes read, 16 zeros written past an
// edge); else 4 one-float copies, each with its own test.
template <class T, int BO>
struct AsyncLoader {
  using C = Chunks<BO, T::kThreads, false>;
  const float* X;
  int O, ld, kend, o0, k0;
  bool vec;

  __device__ __forceinline__ void fetch(float* stage) {
    const int o = o0 + 4 * C::q();
#pragma unroll
    for (int p = 0; p < C::kPasses; ++p) {
      const int r = C::row(p);
      if (r >= C::kRows) break;
      const int k = k0 + r;
      const float* src = X + static_cast<size_t>(k) * ld + o;
      const uint32_t dst = smem_u32(stage + r * pitch(BO) + 4 * C::q());
      if (vec) {
        const bool ok = o < O && k < kend;
        cp_async16(dst, ok ? src : X, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = o + e < O && k < kend;
          cp_async4(dst + 4 * e, ok ? src + e : X, ok ? 4 : 0);
        }
      }
    }
    k0 += kBK;
  }
  __device__ __forceinline__ void store(float*) {}
};

// A dense operand lying k-contiguous, X[o * ld + k], through registers:
// fetch loads this thread's chunks of the next tile (16 bytes of 4 k a
// load where vec, else 4 loads; zeros past O or kend), store writes them
// transposed into the stage.
template <class T, int BO>
struct StagedLoader {
  using C = Chunks<BO, T::kThreads, true>;
  const float* X;
  int O, ld, kend, o0, k0;
  bool vec;
  float v[C::kPasses][4];

  __device__ __forceinline__ void fetch(float*) {
    const int k = k0 + 4 * C::q();
#pragma unroll
    for (int p = 0; p < C::kPasses; ++p) {
      const int o = o0 + C::row(p);
      const float* src = X + static_cast<size_t>(o) * ld + k;
      if (vec) {
        const float4 f = o < O && k < kend
                             ? *reinterpret_cast<const float4*>(src)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        v[p][0] = f.x;
        v[p][1] = f.y;
        v[p][2] = f.z;
        v[p][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[p][e] = o < O && k + e < kend ? src[e] : 0.f;
      }
    }
    k0 += kBK;
  }
  __device__ __forceinline__ void store(float* stage) {
#pragma unroll
    for (int p = 0; p < C::kPasses; ++p)
      if (C::row(p) < C::kRows) store_kc<BO>(stage, C::row(p), C::q(), v[p]);
  }
};

// This thread's values of one operand at k 2h, 2h + 1 of a stage BO
// wide: v[i][kk] for rows base .. base + 3 and base + RUN .. + 3 of k 2h
// + kk, two 16-byte reads a k.
template <int BO, int RUN>
__device__ __forceinline__ void fragment(const float* s, int h, int base,
                                         float (&v)[8][2]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 f = *reinterpret_cast<const float4*>(
          s + (2 * h + kk) * pitch(BO) + base + RUN * r);
      v[4 * r][kk] = f.x;
      v[4 * r + 1][kk] = f.y;
      v[4 * r + 2][kk] = f.z;
      v[4 * r + 3][kk] = f.w;
    }
}

// The K loop over n_k tiles from loaders la (A, the block's BM rows) and
// lb (B, its BN columns) through the ring at `smem` (T::kSmem bytes of
// dynamic shared memory).  acc[i][j] is the sum for row_of(i), col_of(j).
template <class T, class LA, class LB>
__device__ __forceinline__ void mainloop(float* smem, LA& la, LB& lb, int n_k,
                                         float (&acc)[TM][TN]) {
  float* As = smem;
  float* Bs = smem + kStages * T::kA;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int a_base = row_of<T>(0), b_base = col_of<T>(0);

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      la.fetch(As + s * T::kA);
      lb.fetch(Bs + s * T::kB);
      la.store(As + s * T::kA);
      lb.store(Bs + s * T::kB);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < n_k; ++kt) {
    // tile kt has landed for everyone (copies waited for, stores before
    // this barrier), and everyone is done with kt - 1, whose stage the
    // next tile takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const bool more = kt + kStages - 1 < n_k;
    float* an = As + (kt + kStages - 1) % kStages * T::kA;
    float* bn = Bs + (kt + kStages - 1) % kStages * T::kB;
    if (more) {
      la.fetch(an);
      lb.fetch(bn);
    }
    cp_async_commit();
    const float* as = As + (kt % kStages) * T::kA;
    const float* bs = Bs + (kt % kStages) * T::kB;
#pragma unroll
    for (int h = 0; h < kBK / 2; ++h) {
      float a[TM][2], b[TN][2];
      fragment<T::BM, 32>(as, h, a_base, a);
      fragment<T::BN, 16>(bs, h, b_base, b);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
    if (more) {
      la.store(an);
      lb.store(bn);
    }
  }
  cp_async_wait<0>();
}

// Residency of a kernel of `threads` threads and `smem` bytes of dynamic
// shared memory: blocks an SM, from the card's occupancy calculator.
template <typename... KArgs>
int blocks_per_sm(void (*kernel)(KArgs...), int threads, int smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n;
}

// The card's SMs (asked once a process).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

// Slices of K for `tiles` output tiles over k_tiles k tiles, with `wave`
// blocks resident at once (split_k in kernels/conv.py and gemm_plan in
// kernels/gemm.py are its twins): the count whose grid fills its last
// wave best, up to max_waves waves, the fewest slices on a tie; each
// slice a whole number of k tiles.  For w waves the fullest grid has the
// most slices that fit, so w * wave / tiles (rounded down, then by whole
// k tiles) is the only candidate.
inline long long whole_wave_splits(long long tiles, long long wave,
                                   long long k_tiles, int max_waves) {
  long long best = 0, best_waves = 1;
  for (long long w = 1; w <= max_waves; ++w) {
    long long s = w * wave / tiles;
    s = s < 1 ? 1 : s;
    s = s < k_tiles ? s : k_tiles;
    const long long per = (k_tiles + s - 1) / s;
    const long long sp = (k_tiles + per - 1) / per;
    const long long waves = (sp * tiles + wave - 1) / wave;
    if (sp * best_waves > best * waves) {  // a fuller last wave
      best = sp;
      best_waves = waves;
    }
  }
  return best;
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
