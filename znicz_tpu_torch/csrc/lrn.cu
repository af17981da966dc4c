// Local response normalization (cross-channel, AlexNet's) forward and
// backward for Hopper (sm_90a), f32, over (rows, C): NHWC flattened.
//
// Replaces znicz_tpu/ops/pallas/lrn.py :: lrn_forward (the pallas_call at
// :65) and lrn_backward (:79) with the semantics of ops/lrn.py:
//   d_i  = k + alpha * sum_{j in [i - half, i + n-1-half]} x_j^2  (clipped)
//   y_i  = x_i * d_i^-beta
//   dx_j = e_j d_j^-beta - 2 alpha beta x_j * sum_{i: j in window(i)} t_i,
//          t_i = e_i x_i d_i^-beta / d_i
// with half = n / 2; the backward's window is the forward's adjoint, whose
// lower reach is n-1-half (lrn.py :20-32).  d^-beta is sqrt(sqrt(d)) / d
// exactly when beta = 0.75, as ops/lrn.py computes it, else powf.  Every
// sum runs in channel order and every operation is its round-to-nearest
// intrinsic, so no product is fused into an add: the kernel computes the
// plain version's arithmetic in the plain version's order.
//
// Bound: bytes.  About 3n + 10 flops an element against 8 bytes forward (x
// read, y written) and 12 backward (x and e read, dx written): AlexNet's
// norm1 (128 x 55 x 55 x 96, 148.7 MB a tensor) needs 0.089 ms forward and
// 0.133 ms backward at 3.35 TB/s.  Design: each block stages a tile of
// whole rows in shared memory (the TPU kernel's lane rolls become indexed
// reads of the staged row), so x is read from device memory once; the
// backward keeps d^-beta and t of the tile there too, since t_i of a
// neighbour is needed by the adjoint window.  One thread an element,
// consecutive threads on consecutive channels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 2048;  // elements a block stages (whole rows)

struct LrnArgs {
  long long rows;
  int c, n, rows_per_block;
  float alpha, beta, k, two_alpha_beta;
  bool beta34;
};

__device__ __forceinline__ float neg_beta_pow(float d, const LrnArgs& a) {
  return a.beta34 ? __fdiv_rn(__fsqrt_rn(__fsqrt_rn(d)), d)
                  : powf(d, -a.beta);
}

// d = k + alpha * (window sum of x^2 around channel c of the staged row)
__device__ __forceinline__ float denom(const float* xr, int c,
                                       const LrnArgs& a) {
  const int lo = a.n / 2;
  float s = 0.f;
  for (int o = 0; o < a.n; ++o) {
    const int j = c - lo + o;
    if (j >= 0 && j < a.c) s = __fadd_rn(s, __fmul_rn(xr[j], xr[j]));
  }
  return __fadd_rn(a.k, __fmul_rn(a.alpha, s));
}

__global__ void lrn_fwd_kernel(const float* __restrict__ x,
                               float* __restrict__ y, LrnArgs a) {
  extern __shared__ float smem[];
  const long long row0 = blockIdx.x * static_cast<long long>(a.rows_per_block);
  const int nr = static_cast<int>(
      min(static_cast<long long>(a.rows_per_block), a.rows - row0));
  const int count = nr * a.c;
  const float* xb = x + row0 * a.c;
  for (int i = threadIdx.x; i < count; i += blockDim.x) smem[i] = xb[i];
  __syncthreads();
  float* yb = y + row0 * a.c;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / a.c, c = i - r * a.c;
    const float* xr = smem + r * a.c;
    yb[i] = __fmul_rn(xr[c], neg_beta_pow(denom(xr, c, a), a));
  }
}

__global__ void lrn_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ e,
                               float* __restrict__ dx, LrnArgs a) {
  extern __shared__ float smem[];
  const int tile = a.rows_per_block * a.c;
  float* sx = smem;             // x of the tile
  float* sd = smem + tile;      // d^-beta
  float* st = smem + 2 * tile;  // t = e x d^-beta / d
  const long long row0 = blockIdx.x * static_cast<long long>(a.rows_per_block);
  const int nr = static_cast<int>(
      min(static_cast<long long>(a.rows_per_block), a.rows - row0));
  const int count = nr * a.c;
  const float* xb = x + row0 * a.c;
  const float* eb = e + row0 * a.c;
  for (int i = threadIdx.x; i < count; i += blockDim.x) sx[i] = xb[i];
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / a.c, c = i - r * a.c;
    const float d = denom(sx + r * a.c, c, a);
    const float dnb = neg_beta_pow(d, a);
    sd[i] = dnb;
    st[i] = __fmul_rn(__fmul_rn(eb[i], sx[i]), __fdiv_rn(dnb, d));
  }
  __syncthreads();
  const int lo = a.n - 1 - a.n / 2;  // the adjoint window's lower reach
  float* ob = dx + row0 * a.c;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / a.c, c = i - r * a.c;
    const float* tr = st + r * a.c;
    float s = 0.f;
    for (int o = 0; o < a.n; ++o) {
      const int j = c - lo + o;
      if (j >= 0 && j < a.c) s = __fadd_rn(s, tr[j]);
    }
    ob[i] = __fsub_rn(__fmul_rn(eb[i], sd[i]),
                      __fmul_rn(__fmul_rn(a.two_alpha_beta, sx[i]), s));
  }
}

int prepare(LrnArgs& a, long long rows, int c, int n, float alpha,
            float beta, int beta34, float k, float two_alpha_beta) {
  if (rows < 1 || c < 1 || n < 1) return -1;
  a.rows = rows;
  a.c = c;
  a.n = n;
  a.rows_per_block = c >= kTileElems ? 1 : kTileElems / c;
  a.alpha = alpha;
  a.beta = beta;
  a.k = k;
  a.two_alpha_beta = two_alpha_beta;
  a.beta34 = beta34 != 0;
  return 0;
}

cudaError_t launch(const void* kernel, int arrays, const LrnArgs& a,
                   void** args, cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(arrays) * a.rows_per_block * a.c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                          dim3(kThreads), args, smem, s);
}

}  // namespace

// y (rows, c) = LRN of x (rows, c), both contiguous f32; beta34 says
// that beta is 0.75 (the caller decides it on beta's double value, as the
// plain version does).  Returns the cudaError_t of the launch (0 =
// success); bad sizes return cudaErrorInvalidValue without launching.
extern "C" int znicz_lrn_forward_f32(const void* x, void* y, long long rows,
                                     int c, int n, float alpha, float beta,
                                     int beta34, float k, void* stream) {
  LrnArgs a;
  if (prepare(a, rows, c, n, alpha, beta, beta34, k, 0.f) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  void* args[] = {&xp, &yp, &a};
  return static_cast<int>(launch(reinterpret_cast<const void*>(
                                     lrn_fwd_kernel),
                                 1, a, args,
                                 static_cast<cudaStream_t>(stream)));
}

// dx (rows, c) = the LRN input gradient of the cotangent e at x; the scalar
// 2 alpha beta is given as the plain version rounds it (f32 of the double
// product).
extern "C" int znicz_lrn_backward_f32(const void* x, const void* e, void* dx,
                                      long long rows, int c, int n,
                                      float alpha, float beta, int beta34,
                                      float k, float two_alpha_beta,
                                      void* stream) {
  LrnArgs a;
  if (prepare(a, rows, c, n, alpha, beta, beta34, k, two_alpha_beta) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(e);
  float* op = static_cast<float*>(dx);
  void* args[] = {&xp, &ep, &op, &a};
  return static_cast<int>(launch(reinterpret_cast<const void*>(
                                     lrn_bwd_kernel),
                                 3, a, args,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" const char* znicz_lrn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
