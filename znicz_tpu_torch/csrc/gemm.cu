// Fused FC GEMM and activation backward for Hopper (sm_90a), float32.
//
// Replaces two Pallas calls of znicz_tpu/ops/pallas/gemm.py:
//  - matmul (:76, body _matmul_kernel), reached through fc_forward (:129)
//    and through the two products of fc_backward (:137);
//  - _act_backward (:119, body _act_bwd_kernel).
//
// gemm: C (M, N) = act(op(A) . op(B) + bias), f32 in and out, f32 sums on
// the CUDA cores (no TF32, so the reference's f32 bands hold).  op(A) is
// A (M, K) row-major or, with trans_a, the transpose of a stored (K, M)
// row-major matrix; op(B) is B (K, N) or the transpose of a stored (N, K).
// So the backward's err.W^T and x^T.err products read the stored (in, out)
// weights and (batch, in) activations as they are, with no copy.  bias
// (N) may be null.  act is one of the reference's fused set (codes below),
// applied to the biased sum as activations.forward does.
//
// Bound: operations at the FC shapes.  (1024, 4096) x (4096, 4096) is
// 34.4 GFLOP against 134 MB of operands and result, far above the f32
// CUDA cores' ridge of ~20 flop/byte, so 2*M*N*K / 67 TFLOP/s (0.51 ms).
//
// Design (right and simple first; wgmma, TMA and a bf16 instantiation
// are later work): the 128x128 tile of tile_f32.cuh, shared with conv.cu,
// over two dense tile loaders.  The TPU kernel's (m, n, k) grid carries its
// sum across k in VMEM scratch; here the k axis is the tile's K loop inside
// the block.  Loads past a ragged edge read as zero and stores are masked,
// so nothing is padded in device memory (the reference pads outside its
// kernel).  Bias and activation run in the epilogue, before the one store
// of each output.  No split-K and no atomics: each output is one thread's
// sum in a fixed order, so two launches are bit-identical.
//
// act_backward: out = err * act'(y), the derivative taken from the
// forward output y (activations.derivative_from_output), one elementwise
// pass.  Bound: bytes (y and err read once, out written once: 12 bytes an
// element).  A grid-stride loop over 16-byte vectors where the size and
// alignment allow, else over single elements.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tile_f32.cuh"

namespace {

using namespace znicz_tile;

// activation codes, the order of kernels/gemm.py ACT_CODES
enum Act { kLinear = 0, kTanh = 1, kRelu = 2, kStrictRelu = 3, kSigmoid = 4 };

// LeCun tanh constants (ops/activations.py TANH_A, TANH_B), as f32
constexpr float kTanhA = 1.7159f;
constexpr float kTanhB = 2.0f / 3.0f;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kTanh:
      return kTanhA * tanhf(kTanhB * v);
    case kRelu:  // soft ReLU log(1 + e^v) in the stable form
      return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    case kStrictRelu:
      return fmaxf(v, 0.f);
    case kSigmoid:
      return 1.f / (1.f + expf(-v));
    default:
      return v;
  }
}

__device__ __forceinline__ float derivative(float y, int act) {
  switch (act) {
    case kTanh:  // y = A tanh(Bv)  =>  dy/dv = B (A - y^2 / A)
      return kTanhB * (kTanhA - y * y / kTanhA);
    case kRelu:  // y = log(1 + e^v)  =>  dy/dv = 1 - e^-y
      return 1.f - expf(-y);
    case kStrictRelu:
      return y > 0.f ? 1.f : 0.f;
    case kSigmoid:
      return y * (1.f - y);
    default:
      return 1.f;
  }
}

template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C, int M,
                int N, int K, int act, bool vec_a, bool vec_b, bool vec_c) {
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  DenseTile<A_KC> la{A, M, K, m0, 0, vec_a};
  DenseTile<B_KC> lb{B, N, K, n0, 0, vec_b};
  float acc[TM][TN];
  mainloop(la, lb, (K + BK - 1) / BK, acc);

  const int ty = threadIdx.x / (BN / TN);  // this thread's 8 rows ...
  const int tx = threadIdx.x % (BN / TN);  // ... and 8 columns
  const int n_first = n0 + tx * TN;
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j)
    bv[j] = (bias != nullptr && n_first + j < N) ? bias[n_first + j] : 0.f;
  // 16-byte stores where the rows are aligned and the 8 columns all exist
  const bool vec_row = vec_c && n_first + TN <= N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) break;
    float out[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) out[j] = activate(acc[i][j] + bv[j], act);
    float* row = C + static_cast<size_t>(m) * N + n_first;
    if (vec_row) {
      *reinterpret_cast<float4*>(row) =
          make_float4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n_first + j < N) row[j] = out[j];
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(256)
act_backward_f32_kernel(const float* __restrict__ y,
                        const float* __restrict__ err,
                        float* __restrict__ out, long long n, int act) {
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * VEC;
  for (long long i =
           (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
           VEC;
       i < n; i += stride) {
    if (VEC == 4) {
      const float4 yv = *reinterpret_cast<const float4*>(y + i);
      const float4 ev = *reinterpret_cast<const float4*>(err + i);
      *reinterpret_cast<float4*>(out + i) = make_float4(
          ev.x * derivative(yv.x, act), ev.y * derivative(yv.y, act),
          ev.z * derivative(yv.z, act), ev.w * derivative(yv.w, act));
    } else {
      out[i] = err[i] * derivative(y[i], act);
    }
  }
}

template <bool A_KC, bool B_KC>
void launch_gemm(const float* A, const float* B, const float* bias, float* C,
                 int M, int N, int K, int act, bool vec_a, bool vec_b,
                 bool vec_c, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<A_KC, B_KC><<<grid, kThreads, 0, stream>>>(
      A, B, bias, C, M, N, K, act, vec_a, vec_b, vec_c);
}

}  // namespace

// C = act(op(A) . op(B) + bias), all f32, row-major.  A is (M, K), or
// (K, M) stored and read transposed when trans_a; B is (K, N), or (N, K)
// stored and read transposed when trans_b; bias (N) or null; C (M, N).
// Returns the cudaError_t of the launch (0 = success); a bad shape or
// activation code returns cudaErrorInvalidValue without launching.
extern "C" int znicz_gemm_f32(const void* A, const void* B, const void* bias,
                              void* C, int M, int N, int K, int trans_a,
                              int trans_b, int act, void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kLinear || act > kSigmoid)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* bs = static_cast<const float*>(bias);
  float* c = static_cast<float*>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows of the stored operands start 16-byte aligned iff the base is and
  // the stored row length is a multiple of 4 floats
  const bool vec_a = aligned16(a) && (trans_a ? M : K) % 4 == 0;
  const bool vec_b = aligned16(b) && (trans_b ? K : N) % 4 == 0;
  const bool vec_c = aligned16(c) && N % 4 == 0;
  if (!trans_a && !trans_b)
    launch_gemm<true, false>(a, b, bs, c, M, N, K, act, vec_a, vec_b, vec_c,
                                    s);
  else if (!trans_a && trans_b)
    launch_gemm<true, true>(a, b, bs, c, M, N, K, act, vec_a, vec_b, vec_c,
                                    s);
  else if (trans_a && !trans_b)
    launch_gemm<false, false>(a, b, bs, c, M, N, K, act, vec_a, vec_b, vec_c,
                                    s);
  else
    launch_gemm<false, true>(a, b, bs, c, M, N, K, act, vec_a, vec_b, vec_c,
                                    s);
  return static_cast<int>(cudaGetLastError());
}

// out = err * act'(y) over n f32 elements.  Same return convention.
extern "C" int znicz_act_backward_f32(const void* y, const void* err,
                                      void* out, long long n, int act,
                                      void* stream) {
  if (n < 1 || act < kLinear || act > kSigmoid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yp = static_cast<const float*>(y);
  const float* ep = static_cast<const float*>(err);
  float* op = static_cast<float*>(out);
  if (n % 4 == 0 && aligned16(yp) && aligned16(ep) && aligned16(op))
    act_backward_f32_kernel<4><<<blocks_for(n / 4), 256, 0, s>>>(yp, ep, op,
                                                                 n, act);
  else
    act_backward_f32_kernel<1><<<blocks_for(n), 256, 0, s>>>(yp, ep, op, n,
                                                             act);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
