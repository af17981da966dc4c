// In-place SGD-with-momentum and AdamW updates for Hopper (sm_90a).
//
// Replaces znicz_tpu/ops/pallas/_elementwise.py :: tiled_update (:81)
// with the kernel bodies of ops/pallas/sgd.py :: _kernel (:19, for
// fused_sgd_update) and ops/pallas/adam.py :: _kernel (:19, for
// fused_adam_update).  Semantics are the reference's (ops/sgd.py,
// ops/adam.py), on one parameter leaf:
//
//   sgd:   g = grad / bs + wd * ((1 - l1) * w + l1 * sign(w))
//          vel = mom * vel + lr * g;  w -= vel
//   adamw: g = grad / bs;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
//          w -= lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * w)
//
// w, grad, m and v are f32; the SGD velocity is f32 or bf16 (state_dtype),
// widened for the math and rounded to nearest-even on its one store.  The
// scalars (lr, wd, ..., the bias corrections c1 = 1 - b1^t and c2 =
// 1 - b2^t, and the batch size bs) are read from device memory, the
// counterpart of the TPU kernel's SMEM pack: bs is a device value (the
// mask's sum) and the caller computes c1, c2 on the device from its step
// count, so no host sync is needed to launch a step.
//
// Bound: bytes.  A few flops per element against 16 bytes (SGD with bf16
// velocity: w read+write, grad read, vel read+write at 2 bytes), 20 (f32
// velocity) or 28 (AdamW), so time = bytes / 3.35 TB/s.
//
// Design: one pass, every element read and written once, in place (the
// TPU kernel's input_output_aliases).  A grid-stride loop over 4-element
// vectors (16-byte f32 loads, 8-byte bf16 loads) where the size and
// alignment allow, else over single elements.  The TPU kernel tiles rows
// to fit VMEM and falls back to jnp when no tile fits; a GPU streams any
// size, so there is no fallback.  Every operation is written as its
// round-to-nearest intrinsic in the order of the reference formula, so
// nothing is contracted into an FMA and the result is the plain PyTorch
// version's, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <int VEC, typename T>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f32(p[j]);
}
template <>
__device__ __forceinline__ void load<4, float>(const float* p,
                                               float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
template <>
__device__ __forceinline__ void load<4, __nv_bfloat16>(
    const __nv_bfloat16* p, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

template <int VEC, typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) from_f32(v[j], p + j);
}
template <>
__device__ __forceinline__ void store<4, float>(float* p,
                                                const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store<4, __nv_bfloat16>(__nv_bfloat16* p,
                                                        const float (&v)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float sign(float w) {
  return w > 0.f ? 1.f : (w < 0.f ? -1.f : w);  // jnp.sign: 0 stays 0
}

template <typename V, int VEC>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(float* __restrict__ w, const float* __restrict__ grad,
           V* __restrict__ vel, long long n, const float* __restrict__ lr_p,
           const float* __restrict__ wd_p, const float* __restrict__ l1_p,
           const float* __restrict__ mom_p, const float* __restrict__ bs_p) {
  const float lr = *lr_p, wd = *wd_p, l1 = *l1_p, mom = *mom_p, bs = *bs_p;
  const float one_m_l1 = __fsub_rn(1.f, l1);
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * VEC;
  for (long long i =
           (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
           VEC;
       i < n; i += stride) {
    float wv[VEC], gv[VEC], vv[VEC];
    load<VEC>(w + i, wv);
    load<VEC>(grad + i, gv);
    load<VEC>(vel + i, vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float g = __fdiv_rn(gv[j], bs);
      const float decay = __fadd_rn(__fmul_rn(one_m_l1, wv[j]),
                                    __fmul_rn(l1, sign(wv[j])));
      g = __fadd_rn(g, __fmul_rn(wd, decay));
      vv[j] = __fadd_rn(__fmul_rn(mom, vv[j]), __fmul_rn(lr, g));
      wv[j] = __fsub_rn(wv[j], vv[j]);
    }
    store<VEC>(w + i, wv);
    store<VEC>(vel + i, vv);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ w, const float* __restrict__ grad,
            float* __restrict__ m, float* __restrict__ v, long long n,
            const float* __restrict__ lr_p, const float* __restrict__ wd_p,
            const float* __restrict__ b1_p, const float* __restrict__ b2_p,
            const float* __restrict__ eps_p, const float* __restrict__ c1_p,
            const float* __restrict__ c2_p, const float* __restrict__ bs_p) {
  const float lr = *lr_p, wd = *wd_p, b1 = *b1_p, b2 = *b2_p, eps = *eps_p,
              c1 = *c1_p, c2 = *c2_p, bs = *bs_p;
  const float one_m_b1 = __fsub_rn(1.f, b1), one_m_b2 = __fsub_rn(1.f, b2);
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * VEC;
  for (long long i =
           (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
           VEC;
       i < n; i += stride) {
    float wv[VEC], gv[VEC], mv[VEC], vv[VEC];
    load<VEC>(w + i, wv);
    load<VEC>(grad + i, gv);
    load<VEC>(m + i, mv);
    load<VEC>(v + i, vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float g = __fdiv_rn(gv[j], bs);
      mv[j] = __fadd_rn(__fmul_rn(b1, mv[j]), __fmul_rn(one_m_b1, g));
      vv[j] = __fadd_rn(__fmul_rn(b2, vv[j]),
                        __fmul_rn(one_m_b2, __fmul_rn(g, g)));
      const float mhat = __fdiv_rn(mv[j], c1);
      const float vhat = __fdiv_rn(vv[j], c2);
      const float step =
          __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                    __fmul_rn(wd, wv[j]));
      wv[j] = __fsub_rn(wv[j], __fmul_rn(lr, step));
    }
    store<VEC>(w + i, wv);
    store<VEC>(m + i, mv);
    store<VEC>(v + i, vv);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int blocks_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

template <typename V>
void launch_sgd(float* w, const float* g, V* vel, long long n,
                const float* const* h, cudaStream_t s) {
  if (n % 4 == 0 && aligned(w, 16) && aligned(g, 16) &&
      aligned(vel, 4 * sizeof(V)))
    sgd_kernel<V, 4><<<blocks_for(n / 4), kThreads, 0, s>>>(
        w, g, vel, n, h[0], h[1], h[2], h[3], h[4]);
  else
    sgd_kernel<V, 1><<<blocks_for(n), kThreads, 0, s>>>(
        w, g, vel, n, h[0], h[1], h[2], h[3], h[4]);
}

}  // namespace

// One in-place SGD step over n elements.  vel_dtype: 0 = bfloat16,
// 1 = float32.  hyper: 5 device pointers to f32 scalars, in the order
// lr, wd, l1, mom, bs.  Returns the cudaError_t of the launch (0 =
// success); a bad argument returns cudaErrorInvalidValue without
// launching.
extern "C" int znicz_sgd_update(int vel_dtype, void* w, const void* grad,
                                void* vel, long long n,
                                const void* const* hyper, void* stream) {
  if (n < 1 || (vel_dtype != 0 && vel_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* h = reinterpret_cast<const float* const*>(hyper);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wp = static_cast<float*>(w);
  const float* gp = static_cast<const float*>(grad);
  if (vel_dtype == 0)
    launch_sgd(wp, gp, static_cast<__nv_bfloat16*>(vel), n, h, s);
  else
    launch_sgd(wp, gp, static_cast<float*>(vel), n, h, s);
  return static_cast<int>(cudaGetLastError());
}

// One in-place AdamW step over n f32 elements.  hyper: 8 device pointers
// to f32 scalars, in the order lr, wd, b1, b2, eps, c1, c2, bs.  Same
// return convention.
extern "C" int znicz_adam_update(void* w, const void* grad, void* m, void* v,
                                 long long n, const void* const* hyper,
                                 void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* const* h = reinterpret_cast<const float* const*>(hyper);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wp = static_cast<float*>(w);
  const float* gp = static_cast<const float*>(grad);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  if (n % 4 == 0 && aligned(wp, 16) && aligned(gp, 16) && aligned(mp, 16) &&
      aligned(vp, 16))
    adam_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(
        wp, gp, mp, vp, n, h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7]);
  else
    adam_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(
        wp, gp, mp, vp, n, h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7]);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_optim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
