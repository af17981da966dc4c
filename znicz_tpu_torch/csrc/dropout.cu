// Inverted dropout forward for Hopper (sm_90a), f32, any shape (flat).
//
// Replaces znicz_tpu/ops/pallas/dropout.py :: dropout_forward (the
// pallas_calls at :56, drawing in-kernel, and :62, taking bits=), with its
// rule (:18-21, :48-50):
//   keep_i = bits_i > thresh,  thresh = uint32(min(max(ratio, 0), 1 - 1e-9)
//            * (2^32 - 1))  (the caller computes it as the reference does)
//   mask_i = keep_i ? scale : 0,  scale = f32(1 / (1 - ratio))
//   y_i    = x_i * mask_i
// and returns the mask for the backward.  The bits come from the caller
// (one uint32 an element, the TPU kernel's bits= operand) or from
// counter_rng.cuh's Philox keyed by (seed, flat index): one Philox block
// gives the four elements of a 16-byte vector.
//
// Bound: bytes.  One compare and one multiply an element against 12 bytes
// (x read, y and the mask written; 16 with bits), so time = bytes / 3.35
// TB/s.  The ten Philox rounds per four elements (about 20 integer
// multiplies) stay below that on Hopper's integer units.  A grid-stride
// loop over 16-byte vectors where size and alignment allow, else over
// single elements.

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float keep_scale(uint32_t b, uint32_t thresh,
                                            float scale) {
  return b > thresh ? scale : 0.f;
}

__global__ void dropout_vec4_kernel(const float4* __restrict__ x,
                                    const uint4* __restrict__ bits,
                                    unsigned long long seed, uint32_t thresh,
                                    float scale, float4* __restrict__ y,
                                    float4* __restrict__ mask,
                                    long long groups) {
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 b = bits != nullptr ? bits[g] : znicz_rng::group_bits(g, seed);
    const float4 v = x[g];
    const float4 m = make_float4(
        keep_scale(b.x, thresh, scale), keep_scale(b.y, thresh, scale),
        keep_scale(b.z, thresh, scale), keep_scale(b.w, thresh, scale));
    mask[g] = m;
    y[g] = make_float4(__fmul_rn(v.x, m.x), __fmul_rn(v.y, m.y),
                       __fmul_rn(v.z, m.z), __fmul_rn(v.w, m.w));
  }
}

__global__ void dropout_kernel(const float* __restrict__ x,
                               const uint32_t* __restrict__ bits,
                               unsigned long long seed, uint32_t thresh,
                               float scale, float* __restrict__ y,
                               float* __restrict__ mask, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint32_t b =
        bits != nullptr ? bits[i] : znicz_rng::element_bits(i, seed);
    const float m = keep_scale(b, thresh, scale);
    mask[i] = m;
    y[i] = __fmul_rn(x[i], m);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int blocks_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
}

}  // namespace

// y and mask (n elements each) of x, all contiguous f32; bits is null (draw
// from seed) or n uint32.  Returns the cudaError_t of the launch (0 =
// success); n < 1 returns cudaErrorInvalidValue without launching.
extern "C" int znicz_dropout_forward_f32(const void* x, const void* bits,
                                         unsigned long long seed,
                                         unsigned int thresh, float scale,
                                         void* y, void* mask, long long n,
                                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(mask) &&
      (bits == nullptr || aligned16(bits)))
    dropout_vec4_kernel<<<blocks_for(n / 4), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const uint4*>(bits), seed,
        thresh, scale, static_cast<float4*>(y), static_cast<float4*>(mask),
        n / 4);
  else
    dropout_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(bits),
        seed, thresh, scale, static_cast<float*>(y),
        static_cast<float*>(mask), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_dropout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
