// One Kohonen SOM batch step for Hopper (sm_90a), float32.
//
// Replaces znicz_tpu/ops/pallas/kohonen.py :: som_step (the pallas_call at
// :72, kernel body :22-58) with its semantics:
//   d2[b, j]  = |x_b|^2 - 2 x_b . w_j + |w_j|^2   (that formula, not
//               (x - w)^2, which rounds near-ties the other way)
//   winner[b] = the smallest j attaining min_j d2[b, j]
//   h[b, j]   = exp(-|c_winner[b] - c_j|^2 / (2 sigma^2)), the grid
//               distance taken as |c_w|^2 - 2 c_w . c_j + |c_j|^2; rows b >=
//               bs contribute nothing (h = 0)
//   w'_j      = w_j + alpha (sum_b h[b, j] x_b - den_j w_j) / (den_j + 1),
//               den_j = sum_b h[b, j]
// All in full f32 on the CUDA cores: no TF32 and no bf16, whose rounding
// flips winners (the TPU kernel's note at :28-32 measured 40 % of weights
// diverging with bf16 passes).
//
// Bound: at the SOM's shapes (x 500 x 16, W 256 x 16: 48 KB; the parity
// sweep's 64 x 128 against 256 x 128) a step is a few MFLOP and tens of
// KB, microseconds below one launch, so it is bound by launch latency.
// The TPU kernel fuses everything into one VMEM pass for that reason; the
// reference's epoch scan collapses the dispatches.  Here a step is two
// launches (the counterpart of the scan is a host loop of them with no
// synchronisation), simple and deterministic first:
//  - som_winners_kernel: one warp per sample; lane l scans neurons l,
//    l + 32, ... in order, keeping the first minimum, and a shuffle
//    reduction keeps the smaller distance and on a tie the smaller index;
//  - som_update_kernel: one block per neuron; each thread owns some of the
//    D columns and sums h[b] x[b, d] over b = 0 .. B-1 in that fixed order
//    (h staged in shared memory a chunk at a time).  No atomics, so two
//    launches are bit-identical.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWinnerThreads = 256;  // 8 warps: 8 samples a block
constexpr int kUpdateThreads = 128;
constexpr int kChunk = 1024;  // h values staged per pass over b

__global__ void som_winners_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   int* __restrict__ winner, int B, int N,
                                   int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kWinnerThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* xb = x + static_cast<long long>(b) * D;
  float x2 = 0.f;
  for (int d = 0; d < D; ++d) x2 += xb[d] * xb[d];
  float best = INFINITY;
  int best_j = N;
  for (int j = lane; j < N; j += 32) {
    const float* wj = w + static_cast<long long>(j) * D;
    float dot = 0.f, w2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = wj[d];
      dot += xb[d] * v;
      w2 += v * v;
    }
    const float d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, dot)), w2);
    if (d2 < best) {  // j ascends: the first minimum of this lane stays
      best = d2;
      best_j = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
    if (ob < best || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
  }
  if (lane == 0) winner[b] = best_j < N ? best_j : 0;  // all-NaN row: 0
}

__global__ void som_update_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ coords,
                                  const int* __restrict__ winner,
                                  float* __restrict__ new_w, int B, int D,
                                  int bs, float alpha, float sigma) {
  __shared__ float h[kChunk];
  const int j = blockIdx.x;
  const float cr = coords[2 * j], cc = coords[2 * j + 1];
  const float c2 = __fadd_rn(__fmul_rn(cr, cr), __fmul_rn(cc, cc));
  const float two_s2 = __fmul_rn(__fmul_rn(2.f, sigma), sigma);
  const float* wj = w + static_cast<long long>(j) * D;
  float* out = new_w + static_cast<long long>(j) * D;
  for (int d0 = 0; d0 < D; d0 += kUpdateThreads) {
    const int d = d0 + threadIdx.x;
    float num = 0.f, den = 0.f;
    for (int b0 = 0; b0 < B; b0 += kChunk) {
      const int nb = min(kChunk, B - b0);
      __syncthreads();  // the previous chunk's h is consumed
      for (int i = threadIdx.x; i < nb; i += kUpdateThreads) {
        const int b = b0 + i;
        float v = 0.f;
        if (b < bs) {
          const int k = winner[b];
          const float wr = coords[2 * k], wc = coords[2 * k + 1];
          const float wc2 = __fadd_rn(__fmul_rn(wr, wr), __fmul_rn(wc, wc));
          const float dot = __fadd_rn(__fmul_rn(wr, cr), __fmul_rn(wc, cc));
          const float g2 = __fadd_rn(__fsub_rn(wc2, __fmul_rn(2.f, dot)), c2);
          v = expf(__fdiv_rn(-g2, two_s2));
        }
        h[i] = v;
      }
      __syncthreads();
      for (int i = 0; i < nb; ++i) {  // b ascending: a fixed order
        den = __fadd_rn(den, h[i]);
        if (d < D)
          num = __fadd_rn(num,
                          __fmul_rn(h[i], x[static_cast<long long>(b0 + i) *
                                                D + d]));
      }
    }
    if (d < D) {
      const float wv = wj[d];
      out[d] = __fadd_rn(
          wv, __fdiv_rn(__fmul_rn(alpha, __fsub_rn(num, __fmul_rn(den, wv))),
                        __fadd_rn(den, 1.f)));
    }
  }
}

}  // namespace

// One SOM step: x (B, D), w (N, D), coords (N, 2) f32, contiguous ->
// new_w (N, D) f32 and winner (B,) int32; rows b >= bs contribute nothing.
// Returns the cudaError_t of the two launches (0 = success); bad sizes
// return cudaErrorInvalidValue without launching.
extern "C" int znicz_som_step_f32(const void* x, const void* w,
                                  const void* coords, void* new_w,
                                  void* winner, int B, int N, int D, int bs,
                                  float alpha, float sigma, void* stream) {
  if (B < 1 || N < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int warps = kWinnerThreads / 32;
  som_winners_kernel<<<(B + warps - 1) / warps, kWinnerThreads, 0, s>>>(
      xp, static_cast<const float*>(w), static_cast<int*>(winner), B, N, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  som_update_kernel<<<N, kUpdateThreads, 0, s>>>(
      xp, static_cast<const float*>(w), static_cast<const float*>(coords),
      static_cast<const int*>(winner), static_cast<float*>(new_w), B, D, bs,
      alpha, sigma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_kohonen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
