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
// reads of the staged row), so x is read from device memory once.
//
// The element path of both directions (c % 4 != 0, a pointer off 16
// bytes, or c > 4096): one thread an element, consecutive threads on
// consecutive channels; the backward keeps d^-beta and t of the tile in
// shared memory too, since t_i of a neighbour is needed by the adjoint
// window.
//
// The quad path of both directions (lrn_fwd_quad_kernel<N>,
// lrn_bwd_quad_kernel<N>, kernels/lrn.py lrn_plan): a thread owns 4
// consecutive channels of one row, a block whole rows (threadIdx.x the
// channel quad, threadIdx.y the row: no division an element).  x (and
// e) come in as one float4 each, y (dx) goes out as one, so every byte
// moves once: x is staged in shared memory for the neighbours' windows;
// the backward then stages the 4 values of t, with one barrier between,
// and keeps e and d^-beta in registers from t to the output.  The
// windows are the plain version's: the first tap, then each next one
// added in channel order, 0 past the row's ends (ops/lrn.py window_sum).
// N = 5 (AlexNet's, with beta 0.75) unrolls them over the neighbouring
// quads, read as float4; N = 0 takes n (and beta) at run time.

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

// s[i] = sum_{o < n} v(4 q + i - lo + o) in order of o, the first tap as
// it is: v(p) is row[p] (squared where kSquare) inside the row, 0 outside;
// own is row[4 q .. 4 q + 3], already in registers.
template <int kN, int kLo, bool kSquare>
__device__ __forceinline__ void window4(const float* row, int c, int q,
                                        int lo, int n, float4 own,
                                        float s[4]) {
  if constexpr (kN > 0) {
    static_assert(kLo <= 4 && kN - 1 - kLo <= 4, "one quad a side");
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4 l = q > 0 ? row4[q - 1] : z;
    const float4 r = 4 * q + 4 < c ? row4[q + 1] : z;
    float v[12] = {l.x, l.y, l.z, l.w, own.x, own.y, own.z, own.w,
                   r.x, r.y, r.z, r.w};
    if (kSquare) {
#pragma unroll
      for (int m = 0; m < 12; ++m) v[m] = __fmul_rn(v[m], v[m]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = v[4 + i - kLo];
#pragma unroll
      for (int o = 1; o < kN; ++o) s[i] = __fadd_rn(s[i], v[4 + i - kLo + o]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int o = 0; o < n; ++o) {
        const int p = 4 * q + i - lo + o;
        float t = p >= 0 && p < c ? row[p] : 0.f;
        if (kSquare) t = __fmul_rn(t, t);
        s[i] = o == 0 ? t : __fadd_rn(s[i], t);
      }
    }
  }
}

// d^-beta of the 4 window sums s at (k, alpha, beta) as ops/lrn.py
// computes it: d = k + alpha s, then sqrt(sqrt(d)) / d at beta 0.75.
__device__ __forceinline__ void neg_beta_pow4(const float s[4], bool beta34,
                                              const LrnArgs& a, float d[4],
                                              float dnb[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = __fadd_rn(a.k, __fmul_rn(a.alpha, s[i]));
    dnb[i] = beta34 ? __fdiv_rn(__fsqrt_rn(__fsqrt_rn(d[i])), d[i])
                    : powf(d[i], -a.beta);
  }
}

template <int kN>
__global__ void __launch_bounds__(1024)
    lrn_fwd_quad_kernel(const float4* __restrict__ x,
                        float4* __restrict__ y, LrnArgs a) {
  extern __shared__ float4 smem4[];
  const int n = kN > 0 ? kN : a.n;
  const bool beta34 = kN > 0 || a.beta34;
  const int q = threadIdx.x, qn = a.c >> 2;
  float* sx = reinterpret_cast<float*>(smem4) + threadIdx.y * a.c;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < a.rows;
  const long long at = row * qn + q;
  float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) xv = x[at];
  reinterpret_cast<float4*>(sx)[q] = xv;
  __syncthreads();
  float s[4], d[4], dnb[4];
  window4<kN, kN / 2, true>(sx, a.c, q, n / 2, n, xv, s);
  neg_beta_pow4(s, beta34, a, d, dnb);
  if (live)
    y[at] = make_float4(__fmul_rn(xv.x, dnb[0]), __fmul_rn(xv.y, dnb[1]),
                        __fmul_rn(xv.z, dnb[2]), __fmul_rn(xv.w, dnb[3]));
}

template <int kN>
__global__ void __launch_bounds__(1024)
    lrn_bwd_quad_kernel(const float4* __restrict__ x,
                        const float4* __restrict__ e,
                        float4* __restrict__ dx, LrnArgs a) {
  extern __shared__ float4 smem4[];
  const int n = kN > 0 ? kN : a.n;
  const bool beta34 = kN > 0 || a.beta34;
  const int q = threadIdx.x, qn = a.c >> 2;
  float* sx = reinterpret_cast<float*>(smem4) + threadIdx.y * a.c;
  float* st = reinterpret_cast<float*>(smem4) +
              (blockDim.y + threadIdx.y) * a.c;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < a.rows;
  const long long at = row * qn + q;
  float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), ev = xv;
  if (live) {
    xv = x[at];
    ev = e[at];
  }
  reinterpret_cast<float4*>(sx)[q] = xv;
  __syncthreads();
  float s[4], d[4], dnb[4], t[4];
  window4<kN, kN / 2, true>(sx, a.c, q, n / 2, n, xv, s);
  neg_beta_pow4(s, beta34, a, d, dnb);
  const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
  const float ea[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    t[i] = __fmul_rn(__fmul_rn(ea[i], xa[i]), __fdiv_rn(dnb[i], d[i]));
  const float4 tv = make_float4(t[0], t[1], t[2], t[3]);
  reinterpret_cast<float4*>(st)[q] = tv;
  __syncthreads();
  window4<kN, kN - 1 - kN / 2, false>(st, a.c, q, n - 1 - n / 2, n, tv, s);
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __fsub_rn(__fmul_rn(ea[i], dnb[i]),
                     __fmul_rn(__fmul_rn(a.two_alpha_beta, xa[i]), s[i]));
  if (live) dx[at] = make_float4(o[0], o[1], o[2], o[3]);
}

constexpr int kQuadThreads = 256;  // a quad block's target size
constexpr int kMaxQuads = 1024;    // channel quads of a row at most

// The quad path at (c, n, beta34) of a kernel that stages ``arrays``
// rows of floats a row of its block (the forward x, the backward x and
// t); false: the element path.
struct QuadPlan {
  int tx, ty, smem, n_fixed;
};

bool quad_plan(int c, int n, int beta34, bool aligned, int arrays,
               QuadPlan& q) {
  if (c % 4 != 0 || !aligned || c / 4 > kMaxQuads) return false;
  q.tx = c / 4;
  q.ty = q.tx >= kQuadThreads ? 1 : kQuadThreads / q.tx;
  q.smem = arrays * q.ty * c * static_cast<int>(sizeof(float));
  q.n_fixed = n == 5 && beta34 ? 5 : 0;
  return true;
}

cudaError_t launch_quad(const void* kernel5, const void* kernel0,
                        const QuadPlan& qp, long long rows, void** args,
                        cudaStream_t s) {
  const long long blocks = (rows + qp.ty - 1) / qp.ty;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaLaunchKernel(qp.n_fixed == 5 ? kernel5 : kernel0,
                          dim3(static_cast<unsigned>(blocks)),
                          dim3(qp.tx, qp.ty), args, qp.smem, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  QuadPlan qp;
  if (quad_plan(c, n, beta34, aligned16(x) && aligned16(y), 1, qp)) {
    const float4* xp = static_cast<const float4*>(x);
    float4* yp = static_cast<float4*>(y);
    void* args[] = {&xp, &yp, &a};
    return static_cast<int>(launch_quad(
        reinterpret_cast<const void*>(lrn_fwd_quad_kernel<5>),
        reinterpret_cast<const void*>(lrn_fwd_quad_kernel<0>), qp, rows,
        args, s));
  }
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  void* args[] = {&xp, &yp, &a};
  return static_cast<int>(launch(
      reinterpret_cast<const void*>(lrn_fwd_kernel), 1, a, args, s));
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  QuadPlan qp;
  if (quad_plan(c, n, beta34, aligned16(x) && aligned16(e) && aligned16(dx),
                2, qp)) {
    const float4* xp = static_cast<const float4*>(x);
    const float4* ep = static_cast<const float4*>(e);
    float4* op = static_cast<float4*>(dx);
    void* args[] = {&xp, &ep, &op, &a};
    return static_cast<int>(launch_quad(
        reinterpret_cast<const void*>(lrn_bwd_quad_kernel<5>),
        reinterpret_cast<const void*>(lrn_bwd_quad_kernel<0>), qp, rows,
        args, s));
  }
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(e);
  float* op = static_cast<float*>(dx);
  void* args[] = {&xp, &ep, &op, &a};
  return static_cast<int>(
      launch(reinterpret_cast<const void*>(lrn_bwd_kernel), 3, a, args, s));
}

// The launch of one direction (backward != 0: the backward) at
// (rows, c, n) into out[0..5]: quad path (1) or element path (0), rows a
// block, threads x and y, shared-memory bytes, and the quad kernel's
// fixed n (5, or 0 for n at run time; 0 on the element path).
// kernels/lrn.py lrn_plan is its twin.
extern "C" int znicz_lrn_plan(long long rows, int c, int n, int beta34,
                              int aligned, int backward, int* out) {
  LrnArgs a;
  if (prepare(a, rows, c, n, 0.f, 0.f, beta34, 0.f, 0.f) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int arrays = backward ? 2 : 1;
  QuadPlan qp;
  if (quad_plan(c, n, beta34, aligned != 0, arrays, qp)) {
    const int v[6] = {1, qp.ty, qp.tx, qp.ty, qp.smem, qp.n_fixed};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
  } else {
    // the element kernels stage x (forward) or x, d^-beta and t
    const int v[6] = {0, a.rows_per_block, kThreads, 1,
                      (backward ? 3 : 1) * a.rows_per_block * c *
                          static_cast<int>(sizeof(float)),
                      0};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
  }
  return 0;
}

extern "C" const char* znicz_lrn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
