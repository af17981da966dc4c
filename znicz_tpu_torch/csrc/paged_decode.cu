// Paged flash-decode for Hopper (sm_90a): single-query attention over
// the block-paged KV arena.
//
// Replaces znicz_tpu/ops/pallas/decode.py::paged_flash_decode (kernel
// body _kernel).  Semantics are the reference's: q (B, H, Dh) against
// one arena layer k/v_pages (N, page, H, Dh) through page_table (B, P);
// key row t = p*page + r counts iff t < lengths[b]; f32 online softmax
// with sm_scale = 1/sqrt(Dh); o (B, H, Dh) float32.
//
// Bound: device-memory bytes.  Each query row meets every live K and V
// row once (2 * Dh * sizeof(T) bytes for 4 * Dh flops), far below the
// card's ~295 flop/byte ridge, so the least time is
// sum(lengths) * H * 2 * Dh * sizeof(T) / 3.35 TB/s.
//
// Design (simple and right first; split-K over pages, TMA and several
// heads per block are later work):
//  - one block per (head, slot); the TPU grid's sequential page axis
//    becomes a loop inside the block, which reads page_table and
//    lengths itself (no scalar prefetch) and stops at row lengths[b] —
//    masked rows add exactly 0 once one row is valid, so they are
//    skipped rather than scored;
//  - TPR = Dh / VEC threads share one key row: each holds VEC elements
//    (one coalesced 16-byte load of bf16 or f32) of q, k, v and of its
//    running output; the q.k partial sums meet by warp shuffle;
//  - the block's kThreads / TPR row groups each run an f32 online
//    softmax (m, l, acc) over rows g, g + GROUPS, ...; the groups'
//    states merge in shared memory at the end (the flash-decoding
//    combine), so rows are read once and in parallel.
// Contract violations (a length outside [1, P*page], a page id outside
// [0, N)) trap: the decoder checks both on the host before upload, and
// reading a wrong page must never pass silently.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;  // the serve plane's mask constant

template <typename T>
struct Vec16 {
  static constexpr int n = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ out, int H, int n_pages, int page,
                    int P, float sm_scale) {
  constexpr int VEC = Vec16<T>::n;
  constexpr int TPR = DH / VEC;           // threads per key row
  constexpr int GROUPS = kThreads / TPR;  // rows in flight per block
  static_assert(DH % VEC == 0, "head_dim must fill whole 16-byte loads");
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row group fits one warp");
  static_assert(DH <= kThreads, "the combine gives each thread <= 1 column");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % TPR;
  const int g = threadIdx.x / TPR;

  const int len = lengths[b];
  if (len < 1 || len > P * page) __trap();

  float qv[VEC];
  load16(q + (static_cast<size_t>(b) * H + h) * DH + lane * VEC, qv);

  const int32_t* pt = page_table + static_cast<size_t>(b) * P;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const size_t col = static_cast<size_t>(h) * DH + lane * VEC;

  float m = kMaskValue, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // uniform trip count across the block: every lane of a warp reaches
  // the shuffles together, whatever its row's validity
  for (int base = 0; base < len; base += GROUPS) {
    const int t = base + g;
    const bool valid = t < len;
    float kv[VEC], vv[VEC];
    float s = 0.f;
    if (valid) {
      const int pg = pt[t / page];
      if (pg < 0 || pg >= n_pages) __trap();
      const size_t off =
          (static_cast<size_t>(pg) * page + t % page) * row_stride + col;
      load16(k_pages + off, kv);
      load16(v_pages + off, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += qv[i] * kv[i];
    }
#pragma unroll
    for (int w = TPR / 2; w > 0; w >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, w);
    if (valid) {
      s *= sm_scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * alpha + p * vv[i];
      m = m_new;
    }
  }

  __shared__ float s_m[GROUPS];
  __shared__ float s_l[GROUPS];
  __shared__ float s_acc[GROUPS][DH];
  if (lane == 0) {
    s_m[g] = m;
    s_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_acc[g][lane * VEC + i] = acc[i];
  __syncthreads();

  const int d = threadIdx.x;
  if (d < DH) {
    float m_all = kMaskValue;
#pragma unroll 8
    for (int gg = 0; gg < GROUPS; ++gg) m_all = fmaxf(m_all, s_m[gg]);
    float l_all = 0.f, o = 0.f;
#pragma unroll 8
    for (int gg = 0; gg < GROUPS; ++gg) {
      // a group that saw no valid row holds m = -1e30: weight exactly 0
      const float w = expf(s_m[gg] - m_all);
      l_all += s_l[gg] * w;
      o += s_acc[gg][d] * w;
    }
    out[(static_cast<size_t>(b) * H + h) * DH + d] = o / l_all;
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* pt,
            const void* len, void* out, int B, int H, int n_pages, int page,
            int P, float sm_scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_decode_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(len), static_cast<float*>(out), H, n_pages,
      page, P, sm_scale);
}

}  // namespace

// dtype codes: 0 = bfloat16, 1 = float32.  Returns the cudaError_t of the
// launch (0 = success); an unsupported (dtype, head_dim) returns
// cudaErrorInvalidValue without launching.
extern "C" int znicz_paged_decode(int dtype, int head_dim, const void* q,
                                  const void* k_pages, const void* v_pages,
                                  const void* page_table,
                                  const void* lengths, void* out, int B,
                                  int H, int n_pages, int page, int P,
                                  float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    launch<__nv_bfloat16, 64>(q, k_pages, v_pages, page_table, lengths, out,
                              B, H, n_pages, page, P, sm_scale, s);
  else if (dtype == 0 && head_dim == 128)
    launch<__nv_bfloat16, 128>(q, k_pages, v_pages, page_table, lengths, out,
                               B, H, n_pages, page, P, sm_scale, s);
  else if (dtype == 1 && head_dim == 64)
    launch<float, 64>(q, k_pages, v_pages, page_table, lengths, out, B, H,
                      n_pages, page, P, sm_scale, s);
  else if (dtype == 1 && head_dim == 128)
    launch<float, 128>(q, k_pages, v_pages, page_table, lengths, out, B, H,
                       n_pages, page, P, sm_scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
