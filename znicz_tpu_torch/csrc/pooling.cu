// Stochastic pooling (Zeiler & Fergus) forward for Hopper (sm_90a), f32,
// NHWC.
//
// Replaces znicz_tpu/ops/pallas/pooling.py :: stochastic_pool (the
// pallas_calls at :84, drawing in-kernel, and :89, taking bits=), with its
// semantics bit for bit (:25-49):
//   u        = (bits >> 8) * 2^-24, one draw per output element;
//   p_k      = max(x_k, 0), or |x_k| for the abs variant, 0 outside the
//              input (a border window is clipped: ops/pooling.py
//              pool_out_size's ceil-mode windows);
//   winner   = #{k : cdf_k < u * total}, a STRICT compare, clamped to K-1,
//              so a window of zero mass picks tap 0, always inside;
//   y        = the SIGNED x at the winner;
//   offset   = the winner's flat row * W + col (ops/pooling.py offsets_of),
//              which the gradient unit scatters through.
// total and cdf are running f32 sums in tap order (iy, ix), as the plain
// version sums them, and no product feeds an add, so the kernel and the
// plain version agree bit for bit on the same bits.
//
// The bits come from the caller (bits != null: one uint32 per output
// element, flat NHWC order, as the TPU kernel's bits= operand) or from
// counter_rng.cuh's Philox keyed by (seed, flat output index).
//
// Bound: bytes.  The TPU kernel takes a patch tensor (M, K, C) the caller
// builds; here the kernel reads the NHWC input directly by index
// arithmetic, so the input is read from device memory about once (a k3 s2
// window re-reads its overlap from cache) and y and the offsets are
// written once: (n*h*w*c + 2 * n*oh*ow*c) * 4 bytes over 3.35 TB/s, plus
// the bits when they are given.  Threads of a warp take consecutive
// channels, so every tap load is coalesced; the window's K taps sit in
// registers (dispatched on a compile-time bound).
//
// Two paths, the same arithmetic on each element:
//  - four channels a thread (c % 4 == 0, x, y, the offsets and the bits
//    16-byte aligned, K <= 16): a block is (c / 4, pixels) threads, so a
//    thread finds its output pixel with two divisions for four outputs;
//    it loads each tap as a float4, draws its four words with ONE Philox
//    block (element i takes word i % 4 of group i / 4, and its four
//    elements are one group), takes bits= as a uint4, and stores y and
//    the offsets as a float4 and an int4;
//  - one element a thread otherwise (K <= 64), every element paying its
//    own Philox block and three divisions.

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 256;

struct PoolArgs {
  int n, h, w, c, oh, ow, ky, kx, sy, sx, k;
};

template <int KMAX>
__global__ void stochastic_pool_kernel(const float* __restrict__ x,
                                       const uint32_t* __restrict__ bits,
                                       unsigned long long seed,
                                       float* __restrict__ y,
                                       int* __restrict__ off, PoolArgs a,
                                       bool use_abs, int total_out) {
  // every element index fits 32 bits (the caller checks), and 32-bit
  // division is several times cheaper than 64-bit on the GPU; the loop
  // counter is 64-bit so that its last stride cannot overflow
  for (long long step = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
       step < total_out; step += static_cast<long long>(gridDim.x) *
                                 blockDim.x) {
    const int i = static_cast<int>(step);
    const int ch = i % a.c;
    int pix = i / a.c;
    const int ox = pix % a.ow;
    pix /= a.ow;
    const int oy = pix % a.oh;
    const int b = pix / a.oh;
    const int r0 = oy * a.sy, c0 = ox * a.sx;
    const float* xb = x + (b * a.h * a.w) * a.c + ch;
    float v[KMAX];
    float total = 0.f;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      v[t] = 0.f;
      if (t < a.k) {
        const int iy = t / a.kx, ix = t - iy * a.kx;
        const int r = r0 + iy, col = c0 + ix;
        if (r < a.h && col < a.w)
          v[t] = xb[(r * a.w + col) * a.c];
        // outside taps hold 0, whose probability is 0 in both variants
        total = __fadd_rn(total, use_abs ? fabsf(v[t]) : fmaxf(v[t], 0.f));
      }
    }
    const uint32_t word =
        bits != nullptr ? bits[i]
                        : znicz_rng::element_bits(
                              static_cast<unsigned long long>(i), seed);
    const float target = __fmul_rn(znicz_rng::uniform24(word), total);
    float cdf = 0.f;
    int idx = 0;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t < a.k) {
        cdf = __fadd_rn(cdf, use_abs ? fabsf(v[t]) : fmaxf(v[t], 0.f));
        idx += cdf < target;
      }
    }
    idx = min(idx, a.k - 1);
    float picked = v[0];
#pragma unroll
    for (int t = 1; t < KMAX; ++t)
      if (t == idx) picked = v[t];
    y[i] = picked;
    const int iy = idx / a.kx;
    off[i] = (r0 + iy) * a.w + c0 + (idx - iy * a.kx);
  }
}

// The pick of one channel from its taps v and its word: (y, offset).
template <int KMAX>
__device__ __forceinline__ void pick4(const float4 (&v)[KMAX], int j,
                                      uint32_t word, const PoolArgs& a,
                                      bool use_abs, int r0, int c0,
                                      float& y, int& off) {
  auto ch = [j](const float4& f) {
    return j == 0 ? f.x : j == 1 ? f.y : j == 2 ? f.z : f.w;
  };
  float total = 0.f;
#pragma unroll
  for (int t = 0; t < KMAX; ++t)
    if (t < a.k) {
      const float p = ch(v[t]);
      total = __fadd_rn(total, use_abs ? fabsf(p) : fmaxf(p, 0.f));
    }
  const float target = __fmul_rn(znicz_rng::uniform24(word), total);
  float cdf = 0.f;
  int idx = 0;
#pragma unroll
  for (int t = 0; t < KMAX; ++t)
    if (t < a.k) {
      const float p = ch(v[t]);
      cdf = __fadd_rn(cdf, use_abs ? fabsf(p) : fmaxf(p, 0.f));
      idx += cdf < target;
    }
  idx = min(idx, a.k - 1);
  float picked = ch(v[0]);
#pragma unroll
  for (int t = 1; t < KMAX; ++t)
    if (t == idx) picked = ch(v[t]);
  y = picked;
  const int iy = idx / a.kx;
  off = (r0 + iy) * a.w + c0 + (idx - iy * a.kx);
}

// Four channels a thread: threadIdx.x the channel vector, the block's
// blockDim.y output pixels one a threadIdx.y.
template <int KMAX>
__global__ void stochastic_pool4_kernel(const float* __restrict__ x,
                                        const uint32_t* __restrict__ bits,
                                        unsigned long long seed,
                                        float* __restrict__ y,
                                        int* __restrict__ off, PoolArgs a,
                                        bool use_abs, int pixels) {
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  if (pix >= pixels) return;
  const int ch = 4 * threadIdx.x;
  const int ox = pix % a.ow, rest = pix / a.ow;
  const int oy = rest % a.oh, b = rest / a.oh;
  const int r0 = oy * a.sy, c0 = ox * a.sx;
  const float* xb = x + (b * a.h * a.w) * a.c + ch;
  float4 v[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    v[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < a.k) {
      const int iy = t / a.kx, ix = t - iy * a.kx;
      const int r = r0 + iy, col = c0 + ix;
      if (r < a.h && col < a.w)
        v[t] = *reinterpret_cast<const float4*>(xb + (r * a.w + col) * a.c);
    }
  }
  const int i = pix * a.c + ch;  // the first of the four outputs
  const uint4 words =
      bits != nullptr ? *reinterpret_cast<const uint4*>(bits + i)
                      : znicz_rng::group_bits(
                            static_cast<unsigned long long>(i) >> 2, seed);
  float4 yv;
  int4 ov;
  pick4(v, 0, words.x, a, use_abs, r0, c0, yv.x, ov.x);
  pick4(v, 1, words.y, a, use_abs, r0, c0, yv.y, ov.y);
  pick4(v, 2, words.z, a, use_abs, r0, c0, yv.z, ov.z);
  pick4(v, 3, words.w, a, use_abs, r0, c0, yv.w, ov.w);
  *reinterpret_cast<float4*>(y + i) = yv;
  *reinterpret_cast<int4*>(off + i) = ov;
}

template <int KMAX>
void launch(const float* x, const uint32_t* bits, unsigned long long seed,
            float* y, int* off, const PoolArgs& a, bool use_abs,
            int total_out, cudaStream_t s) {
  const int want = (total_out + kThreads - 1) / kThreads;
  const int blocks = want < 132 * 32 ? want : 132 * 32;
  stochastic_pool_kernel<KMAX><<<blocks, kThreads, 0, s>>>(
      x, bits, seed, y, off, a, use_abs, total_out);
}

template <int KMAX>
void launch4(const float* x, const uint32_t* bits, unsigned long long seed,
             float* y, int* off, const PoolArgs& a, bool use_abs,
             cudaStream_t s) {
  const int vecs = a.c / 4;
  const int per = vecs < kThreads ? kThreads / vecs : 1;  // pixels a block
  const int pixels = a.n * a.oh * a.ow;
  stochastic_pool4_kernel<KMAX><<<(pixels + per - 1) / per, dim3(vecs, per),
                                  0, s>>>(x, bits, seed, y, off, a, use_abs,
                                          pixels);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// y and off (n, oh, ow, c) from x (n, h, w, c), all contiguous; bits is
// null (draw from seed) or n*oh*ow*c uint32.  Returns the cudaError_t of the
// launch (0 = success); a bad geometry, a window of more than 64 taps or a
// tensor of 2^31 elements or more returns cudaErrorInvalidValue without
// launching.
extern "C" int znicz_stochastic_pool_f32(const void* x, const void* bits,
                                         unsigned long long seed, void* y,
                                         void* off, int n, int h, int w,
                                         int c, int oh, int ow, int ky,
                                         int kx, int sy, int sx,
                                         int use_abs, void* stream) {
  const PoolArgs a{n, h, w, c, oh, ow, ky, kx, sy, sx, ky * kx};
  if (n < 1 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1 || ky < 1 ||
      kx < 1 || sy < 1 || sx < 1 || a.k > 64 || (oh - 1) * sy >= h ||
      (ow - 1) * sx >= w ||
      static_cast<long long>(n) * h * w * c >= (1LL << 31) ||
      static_cast<long long>(n) * oh * ow * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  float* yp = static_cast<float*>(y);
  int* op = static_cast<int*>(off);
  const int total_out = n * oh * ow * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ab = use_abs != 0;
  if (c % 4 == 0 && c / 4 <= 1024 && a.k <= 16 && aligned16(xp) &&
      aligned16(yp) && aligned16(op) && (bp == nullptr || aligned16(bp))) {
    if (a.k <= 4)
      launch4<4>(xp, bp, seed, yp, op, a, ab, s);
    else if (a.k <= 9)
      launch4<9>(xp, bp, seed, yp, op, a, ab, s);
    else
      launch4<16>(xp, bp, seed, yp, op, a, ab, s);
  } else if (a.k <= 4)
    launch<4>(xp, bp, seed, yp, op, a, ab, total_out, s);
  else if (a.k <= 9)
    launch<9>(xp, bp, seed, yp, op, a, ab, total_out, s);
  else if (a.k <= 16)
    launch<16>(xp, bp, seed, yp, op, a, ab, total_out, s);
  else if (a.k <= 32)
    launch<32>(xp, bp, seed, yp, op, a, ab, total_out, s);
  else
    launch<64>(xp, bp, seed, yp, op, a, ab, total_out, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_pooling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
