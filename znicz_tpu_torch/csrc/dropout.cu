// Inverted dropout forward for Hopper (sm_90a), f32 and bf16, any shape
// (flat).
//
// Replaces znicz_tpu/ops/pallas/dropout.py :: dropout_forward (the
// pallas_calls at :56, drawing in-kernel, and :62, taking bits=), with its
// rule (:18-21, :48-50):
//   keep_i = bits_i > thresh,  thresh = uint32(min(max(ratio, 0), 1 - 1e-9)
//            * (2^32 - 1))  (the caller computes it as the reference does)
//   mask_i = keep_i ? T(scale) : 0,  scale = f32(1 / (1 - ratio))
//   y_i    = T(x_i * mask_i)   (the product of two T values, rounded once)
// in x's dtype T (float or bfloat16, as the TPU kernel's out_shape, :53-54),
// and returns the mask for the backward.  The bits come from the caller
// (one uint32 an element, the TPU kernel's bits= operand) or from
// counter_rng.cuh's Philox keyed by (seed, flat index): element i takes word
// i % 4 of block i / 4, so the bits never depend on the launch geometry.
//
// Bound: bytes.  One compare and one multiply an element against 12 bytes
// at f32 (x read, y and the mask written; 16 with bits) and 6 at bf16 (10
// with bits), so time = bytes / 3.35 TB/s.  The ten Philox rounds per four
// elements (about 20 integer multiplies) fit under that on Hopper's integer
// units, but only if they overlap the loads in flight.
//
// Design.  A group is 16 bytes of x: four f32 elements (one Philox block)
// or eight bf16 (two blocks).  One thread a group, one block a 256 groups
// (a grid-stride loop past kMaxBlocks), plain stores (dropout_plan, twin
// kernels/dropout.py dropout_plan).  On the H100 at 64 M elements the
// Philox work hides under the traffic at one group a thread: four groups a
// thread in flight over one whole wave of the occupancy calculator's
// residency, the previous kernel's four-wave grid and __stcs stores each
// ran slower (PERF.md).  An element kernel (one element a thread,
// grid-stride) takes any size and alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 256;
// the largest grid a launch takes (a grid-stride loop covers the rest)
constexpr long long kMaxBlocks = 0x7fffffffLL;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerGroup = 4;
  __device__ static float mask_of(float scale) { return scale; }
  __device__ static float zero() { return 0.f; }
  __device__ static float mul(float x, float m) { return __fmul_rn(x, m); }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerGroup = 8;
  __device__ static __nv_bfloat16 mask_of(float scale) {
    return __float2bfloat16_rn(scale);
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
  // the f32 product of two bf16 values is exact, so one rounding to bf16
  __device__ static __nv_bfloat16 mul(__nv_bfloat16 x, __nv_bfloat16 m) {
    return __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(x), __bfloat162float(m)));
  }
};

// Groups of 16 bytes: x, y and mask as uint4, bits (when given) as
// kPerGroup / 4 uint4 a group.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_vec_kernel(const uint4* __restrict__ x,
                       const uint4* __restrict__ bits, uint64_t seed,
                       uint32_t thresh, float scale, uint4* __restrict__ y,
                       uint4* __restrict__ mask, long long groups) {
  constexpr int kPer = Elem<T>::kPerGroup;
  constexpr int kBlocks = kPer / 4;  // Philox blocks a group
  const T keep = Elem<T>::mask_of(scale);
  const T drop = Elem<T>::zero();
  for (long long g = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * kThreads) {
    const uint4 v = __ldg(x + g);
    uint4 b[kBlocks];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
      b[j] = bits != nullptr
                 ? __ldg(bits + g * kBlocks + j)
                 : znicz_rng::group_bits(
                       static_cast<unsigned long long>(g) * kBlocks + j,
                       seed);
    const T* xv = reinterpret_cast<const T*>(&v);
    uint4 mo, yo;
    T* mv = reinterpret_cast<T*>(&mo);
    T* yv = reinterpret_cast<T*>(&yo);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const T m = znicz_rng::word(b[e / 4], e % 4) > thresh ? keep : drop;
      mv[e] = m;
      yv[e] = Elem<T>::mul(xv[e], m);
    }
    mask[g] = mo;
    y[g] = yo;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_elem_kernel(const T* __restrict__ x,
                        const uint32_t* __restrict__ bits, uint64_t seed,
                        uint32_t thresh, float scale, T* __restrict__ y,
                        T* __restrict__ mask, long long n) {
  const T keep = Elem<T>::mask_of(scale);
  const T drop = Elem<T>::zero();
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint32_t w =
        bits != nullptr ? bits[i] : znicz_rng::element_bits(i, seed);
    const T m = w > thresh ? keep : drop;
    mask[i] = m;
    y[i] = Elem<T>::mul(x[i], m);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The launch at n elements (dropout_plan in kernels/dropout.py is its
// twin): the vector path where n fills whole groups and every operand
// lies on 16 bytes, else the element path; one block a kThreads groups
// (or elements), at most kMaxBlocks.
struct Plan {
  bool vec;
  long long items;  // groups (vector path) or elements
  int blocks;
};

bool plan_of(long long n, int dtype, bool aligned, Plan& p) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return false;
  const int per = dtype == 0 ? 4 : 8;
  p.vec = n % per == 0 && aligned;
  p.items = p.vec ? n / per : n;
  const long long want = (p.items + kThreads - 1) / kThreads;
  p.blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  return true;
}

template <typename T>
const void* kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(dropout_vec_kernel<T>)
             : reinterpret_cast<const void*>(dropout_elem_kernel<T>);
}

}  // namespace

// y and mask (n elements each, x's dtype) of x, all contiguous; dtype 0 =
// float32, 1 = bfloat16; bits is null (draw from seed) or n uint32.
// Returns the cudaError_t of the launch (0 = success); a bad argument
// returns cudaErrorInvalidValue without launching.
extern "C" int znicz_dropout_forward(const void* x, const void* bits,
                                     unsigned long long seed,
                                     unsigned int thresh, float scale,
                                     void* y, void* mask, long long n,
                                     int dtype, void* stream) {
  const bool aligned = aligned16(x) && aligned16(y) && aligned16(mask) &&
                       (bits == nullptr || aligned16(bits));
  Plan p;
  if (!plan_of(n, dtype, aligned, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      dtype == 0 ? kernel_of<float>(p.vec) : kernel_of<__nv_bfloat16>(p.vec);
  uint64_t sd = seed;
  uint32_t th = thresh;
  float sc = scale;
  long long items = p.items;
  // both kernels take (x, bits, seed, thresh, scale, y, mask, count)
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&bits), &sd,
                  &th, &sc, &y, &mask, &items};
  return static_cast<int>(cudaLaunchKernel(
      kernel, dim3(static_cast<unsigned>(p.blocks)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// The launch at n elements into out[0..2]: vector path (1) or element path
// (0), blocks and threads.
extern "C" int znicz_dropout_plan(long long n, int dtype, int aligned,
                                  int* out) {
  Plan p;
  if (!plan_of(n, dtype, aligned != 0, p))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.vec ? 1 : 0;
  out[1] = p.blocks;
  out[2] = kThreads;
  return 0;
}

extern "C" const char* znicz_dropout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
