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
// TPU kernel's input_output_aliases).  The TPU kernel tiles rows to fit
// VMEM and falls back to jnp when no tile fits; a GPU streams any size,
// so there is no fallback.  Every operation is written as its
// round-to-nearest intrinsic in the order of the reference formula, so
// nothing is contracted into an FMA and the result is the plain PyTorch
// version's, bit for bit.
//
// SGD updates one leaf a launch: a grid-stride loop over 4-element
// vectors (16-byte f32 loads, 8-byte bf16 loads) where the size and
// alignment allow, else over single elements.
//
// AdamW updates up to kAdamLeaves leaves in one launch (a whole fused
// step of the repo's models), so no leaf pays a launch, its ramp and its
// tail of its own.  The leaves' table is passed by value, in the kernel's
// parameter space (under 4 KB).  The leaves' 16-byte vectors form one
// index space (a leaf whose operands are not all 16-byte aligned gives
// none), cut into chunks of kUnroll * kThreads contiguous vectors that
// the blocks take in turn (block b chunks b, b + G, ...), so the grid
// sweeps memory together; each leaf's last n % 4 elements (all of an
// unaligned leaf) form a second, scalar space that the grid strides
// over after its vectors.  The grid is kAdamWaves whole waves at the
// residency the card's occupancy calculator gives (fewer blocks where
// there is less work: adam_grid, twin kernels/optim.py adam_grid).  A
// thread issues kUnroll 16-byte loads of each of w, grad, m and v (128
// bytes) before the math.  On the H100, giving each block one contiguous
// range of the vectors instead ran slower, and so did streaming
// (evict-first) loads and stores, so neither is used.

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

constexpr int kAdamLeaves = 32;  // leaves a launch's table holds
constexpr int kUnroll = 2;       // 16-byte vectors of each operand a thread
                                 // loads before the math
constexpr int kAdamWaves = 4;    // the most waves of resident blocks

// One leaf of an AdamW launch: its operands, its device scalars, and
// where it lies in the launch's vector and scalar index spaces.
struct AdamLeaf {
  float* w;
  const float* g;
  float* m;
  float* v;
  const float* lr;
  const float* wd;
  const float* c1;
  const float* c2;
  long long vec0;   // its first vector
  long long vecs;   // its vectors (0 where an operand is unaligned)
  long long tail0;  // its first scalar; element 4 * vecs + (s - tail0)
  long long n;
};

struct AdamTable {
  AdamLeaf leaf[kAdamLeaves];
  const float* b1;
  const float* b2;
  const float* eps;
  const float* bs;
  long long vecs;   // the launch's vectors
  long long tails;  // and scalars
  int count;
};

struct AdamConsts {
  float b1, b2, eps, bs, one_m_b1, one_m_b2;
};

// The reference formula on one element, with leaf scalars (lr, wd, c1,
// c2) h.
__device__ __forceinline__ void adam_element(const AdamConsts& k,
                                             const float4& h, float& w,
                                             float g, float& m, float& v) {
  g = __fdiv_rn(g, k.bs);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.one_m_b1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.one_m_b2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, h.z);
  const float vhat = __fdiv_rn(v, h.w);
  const float step =
      __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), k.eps)),
                __fmul_rn(h.y, w));
  w = __fsub_rn(w, __fmul_rn(h.x, step));
}

__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const __grid_constant__ AdamTable t) {
  __shared__ float4 hyper[kAdamLeaves];  // (lr, wd, c1, c2) a leaf
  if (threadIdx.x < t.count) {
    const AdamLeaf& l = t.leaf[threadIdx.x];
    hyper[threadIdx.x] = make_float4(*l.lr, *l.wd, *l.c1, *l.c2);
  }
  AdamConsts k;
  k.b1 = *t.b1;
  k.b2 = *t.b2;
  k.eps = *t.eps;
  k.bs = *t.bs;
  k.one_m_b1 = __fsub_rn(1.f, k.b1);
  k.one_m_b2 = __fsub_rn(1.f, k.b2);
  __syncthreads();

  // chunk c is vectors [c * kChunk, (c + 1) * kChunk), thread t taking
  // c * kChunk + u * kThreads + t; a thread's vectors only grow, so its
  // leaf only moves forward
  constexpr long long kChunk = static_cast<long long>(kUnroll) * kThreads;
  int leaf = 0;
  for (long long base = blockIdx.x * kChunk + threadIdx.x; base < t.vecs;
       base += gridDim.x * kChunk) {
    float4 wv[kUnroll], gv[kUnroll], mv[kUnroll], vv[kUnroll];
    int lf[kUnroll];
    long long at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kThreads;
      while (leaf + 1 < t.count && j >= t.leaf[leaf + 1].vec0) ++leaf;
      lf[u] = leaf;
      at[u] = j - t.leaf[leaf].vec0;
      if (j < t.vecs) {
        const AdamLeaf& l = t.leaf[leaf];
        wv[u] = reinterpret_cast<const float4*>(l.w)[at[u]];
        gv[u] = reinterpret_cast<const float4*>(l.g)[at[u]];
        mv[u] = reinterpret_cast<const float4*>(l.m)[at[u]];
        vv[u] = reinterpret_cast<const float4*>(l.v)[at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= t.vecs) continue;
      const float4 h = hyper[lf[u]];
      adam_element(k, h, wv[u].x, gv[u].x, mv[u].x, vv[u].x);
      adam_element(k, h, wv[u].y, gv[u].y, mv[u].y, vv[u].y);
      adam_element(k, h, wv[u].z, gv[u].z, mv[u].z, vv[u].z);
      adam_element(k, h, wv[u].w, gv[u].w, mv[u].w, vv[u].w);
      const AdamLeaf& l = t.leaf[lf[u]];
      reinterpret_cast<float4*>(l.w)[at[u]] = wv[u];
      reinterpret_cast<float4*>(l.m)[at[u]] = mv[u];
      reinterpret_cast<float4*>(l.v)[at[u]] = vv[u];
    }
  }

  // the scalar space: every leaf's tail, and the whole of an unaligned
  // leaf
  leaf = 0;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       s < t.tails; s += static_cast<long long>(gridDim.x) * kThreads) {
    while (leaf + 1 < t.count && s >= t.leaf[leaf + 1].tail0) ++leaf;
    const AdamLeaf& l = t.leaf[leaf];
    const long long i = 4 * l.vecs + (s - l.tail0);
    float w = l.w[i], m = l.m[i], v = l.v[i];
    adam_element(k, hyper[leaf], w, l.g[i], m, v);
    l.w[i] = w;
    l.m[i] = m;
    l.v[i] = v;
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int blocks_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

// adam_multi_kernel's resident blocks an SM and the card's SMs (asked
// once a process)
int adam_residency() {
  static int blocks = 0;
  if (blocks == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, adam_multi_kernel,
                                                  kThreads, 0);
  return blocks;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

// The AdamW grid: kAdamWaves waves (a wave is the resident blocks an SM
// times the SMs), or one block a chunk of kUnroll * kThreads vectors
// where there are fewer, and at least the blocks the scalars need.
long long adam_grid(long long vecs, long long tails, long long wave) {
  const long long chunk = static_cast<long long>(kUnroll) * kThreads;
  long long want = (vecs + chunk - 1) / chunk;
  const long long for_tails = (tails + kThreads - 1) / kThreads;
  if (for_tails > want) want = for_tails;
  const long long most = kAdamWaves * wave;
  return want < 1 ? 1 : (want < most ? want : most);
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

// One in-place AdamW step over `count` leaves (1 to 32) in one launch.
// ops: 4 * count pointers, leaf by leaf w, grad, m, v (f32, n[i]
// elements each); leaf_hyper: 4 * count device pointers to f32 scalars,
// leaf by leaf lr, wd, c1, c2; hyper: 4 device pointers, b1, b2, eps, bs.
// Same return convention.
extern "C" int znicz_adam_update_multi(int count, void* const* ops,
                                       const long long* n,
                                       const void* const* leaf_hyper,
                                       const void* const* hyper,
                                       void* stream) {
  if (count < 1 || count > kAdamLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t = {};
  const float* const* h = reinterpret_cast<const float* const*>(hyper);
  const float* const* lh = reinterpret_cast<const float* const*>(leaf_hyper);
  t.b1 = h[0];
  t.b2 = h[1];
  t.eps = h[2];
  t.bs = h[3];
  t.count = count;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    AdamLeaf& l = t.leaf[i];
    l.w = static_cast<float*>(ops[4 * i]);
    l.g = static_cast<const float*>(ops[4 * i + 1]);
    l.m = static_cast<float*>(ops[4 * i + 2]);
    l.v = static_cast<float*>(ops[4 * i + 3]);
    l.lr = lh[4 * i];
    l.wd = lh[4 * i + 1];
    l.c1 = lh[4 * i + 2];
    l.c2 = lh[4 * i + 3];
    l.n = n[i];
    const bool vec = aligned(l.w, 16) && aligned(l.g, 16) &&
                     aligned(l.m, 16) && aligned(l.v, 16);
    l.vecs = vec ? n[i] / 4 : 0;
    l.vec0 = t.vecs;
    l.tail0 = t.tails;
    t.vecs += l.vecs;
    t.tails += n[i] - 4 * l.vecs;
  }
  const long long blocks =
      adam_grid(t.vecs, t.tails,
                static_cast<long long>(adam_residency()) * sm_count());
  adam_multi_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// The AdamW grid on this card for a launch of `vecs` vectors and `tails`
// scalars (adam_grid at the card's residency).
extern "C" long long znicz_adam_grid(long long vecs, long long tails) {
  return adam_grid(vecs, tails,
                   static_cast<long long>(adam_residency()) * sm_count());
}

// adam_multi_kernel's resident blocks an SM on this card.
extern "C" int znicz_adam_residency() { return adam_residency(); }

extern "C" const char* znicz_optim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
