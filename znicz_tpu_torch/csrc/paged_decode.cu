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
// Design: flash-decoding, split over pages, up to 32 heads a block.
//  - The grid is (split, slot, head block).  Split s owns page-table
//    entries [s*pps, (s+1)*pps); pps comes from the host's shapes alone
//    (decode_split in kernels/decode.py: about two blocks an SM over the
//    batch and the head blocks at the widest page view), never from
//    lengths, which stay on the card.  A split that starts at or past
//    lengths[b] writes the empty state (m = -1e30, l = 0, acc = 0) and
//    exits, so a short slot costs one near-empty block a split and a long
//    one fills the card.
//  - Head block z takes heads [32z, min(H, 32z + 32)); at H <= 32 there
//    is one, holding every head.  One page of one slot, all H heads, is
//    one contiguous run of page * H * Dh elements of the arena, and a
//    block's heads are one run of each row.  The block reads its split's
//    page ids into shared memory once, then thread 0 streams the live
//    rows in chunks of cr rows (the largest divisor of page whose rows
//    fit 16 KB an operand) by the TMA's 1-D bulk copy (one copy of the
//    chunk where the block holds every head, else one a row) into a ring
//    of up to 4 K+V stages on mbarriers, at most 96 KB: two blocks an SM,
//    so every block of the widest view is resident at once, whichever
//    slots are long, and two of a bf16 split's four pages are in flight
//    while one is scored; no load waits on the page table.  Only live
//    rows are read.
//  - Warp w takes head 32z + w, q in registers (the last head block's
//    warps past H only keep the block's barriers).  TPR = Dh / VEC
//    lanes share one key row (VEC elements of a 16-byte load each; the
//    q.k partial sums meet by shuffle), so a warp scores 32 / TPR row
//    groups at once, each two rows a step (loads and shuffles
//    interleaved, one rescale) with its own f32 online softmax (m, l,
//    acc) in base 2 (scores scaled by log2 e); the groups merge by
//    shuffle in a fixed order at the end of the split.
//  - A second kernel merges each (b, h) over the splits in split order
//    (rescale by exp(m_s - m_all), divide by l_all > 0), from the f32
//    workspace (B, splits, H, Dh + 2) the wrapper allocates.  It is
//    launched as a programmatic dependent of the split kernel, so its
//    launch overlaps the split kernel's last writes.  No atomics: two launches
//    are bit-identical.
// Contract violations (a length outside [1, P*page], a page id outside
// [0, N)) trap: the decoder checks both on the host before upload, and
// reading a wrong page must never pass silently.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace znicz_hopper;

constexpr float kMaskValue = -1e30f;  // the serve plane's mask constant
constexpr int kMaxHeads = 32;         // a block's heads, one warp each
constexpr int kMaxStages = 4;
constexpr int kRows = 2;  // key rows a row group scores at once
// the combine: threads a block, and splits whose acc rows a round stages
constexpr int kCombineThreads = 256, kCombineSplits = 32;
// the most splits the combine's shared memory takes (48 KB at Dh 128)
constexpr int kMaxSplits = 4096;
constexpr float kLog2e = 1.4426950408889634f;
// one operand's rows in a stage (at most 16 KB: a 16-row page of bf16 at
// H 8, Dh 64), and the whole ring (at most 96 KB: two blocks an SM, so
// all 256 blocks of the widest view at B 8 are resident at once,
// whichever slots are long)
constexpr int kChunkBytes = 16 * 1024, kRingBytes = 96 * 1024;

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

// Chunk c of the split (rows c*cr.. of it, inside one page) into its
// stage of the ring: K at `dst`, V stage_bytes after it, both counted on
// the stage's mbarrier.  The block's heads are a run of each arena row of
// H heads: a block of every head copies the chunk as one run, any other
// block one run a row.  The run's place is recomputed here from the
// block's indices, so the score loop keeps no register for it.  Thread 0
// only.
template <typename T, int DH>
__device__ __forceinline__ void issue_chunk(
    const T* k_pages, const T* v_pages, const int* pages, int c, int cr,
    int live, int page, int H, uint32_t stage_bytes, int stages,
    uint32_t ring, uint32_t bar0) {
  const int h0 = blockIdx.z * kMaxHeads;
  const size_t row_elems = static_cast<size_t>(H) * DH;
  const uint32_t row_bytes =
      min(H - h0, static_cast<int>(blockDim.x) / 32) * DH * sizeof(T);
  const int s = c % stages, r = c * cr;
  const int rows = min(cr, live - r);
  const size_t off =
      (static_cast<size_t>(pages[r / page]) * page + r % page) * row_elems +
      static_cast<size_t>(h0) * DH;
  const uint32_t bar = bar0 + 8 * s;
  const uint32_t dst = ring + 2u * s * stage_bytes;
  mbar_expect_tx(bar, 2u * rows * row_bytes);
  if (row_bytes == row_elems * sizeof(T)) {
    bulk_load(dst, k_pages + off, rows * row_bytes, bar);
    bulk_load(dst + stage_bytes, v_pages + off, rows * row_bytes, bar);
    return;
  }
  for (int i = 0; i < rows; ++i) {
    bulk_load(dst + i * row_bytes, k_pages + off + i * row_elems, row_bytes,
              bar);
    bulk_load(dst + stage_bytes + i * row_bytes,
              v_pages + off + i * row_elems, row_bytes, bar);
  }
}

// One split of one slot and one head block: the partial state (acc[Dh],
// m, l) of each of its heads into ws[b][split][h].  The dynamic shared
// memory holds `stages` K+V stages of `cr` rows of blockDim.x / 32 heads
// each, then the split's page ids.
template <typename T, int DH>
__global__ void __launch_bounds__(kMaxHeads * 32, 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ ws, int H, int n_pages, int page,
                    int P, int pps, int cr, int stages, float sm_scale) {
  constexpr int VEC = Vec16<T>::n;
  constexpr int TPR = DH / VEC;  // lanes a key row
  constexpr int G = 32 / TPR;    // rows a warp scores at once
  static_assert(DH % VEC == 0, "head_dim must fill whole 16-byte loads");
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row group fits one warp");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];

  const int split = blockIdx.x, b = blockIdx.y;
  const int hs = blockDim.x / 32;              // the heads a stage row holds
  const int h0 = blockIdx.z * kMaxHeads;       // the block's first head
  const int hb = min(H - h0, hs);              // and its number of heads
  const int hl = threadIdx.x / 32, h = h0 + hl, lane = threadIdx.x % 32;
  const bool active = hl < hb;                 // warp-uniform
  const int g = lane / TPR, sub = lane % TPR;

  // this thread's first page id is read beside the length, not after it
  const int j0 = threadIdx.x;
  const int pg0 = j0 < pps && split * pps + j0 < P
                      ? page_table[static_cast<size_t>(b) * P + split * pps +
                                   j0]
                      : 0;
  const int len = lengths[b];
  if (len < 1 || len > P * page) __trap();
  const int row0 = split * pps * page;  // the split's first key row
  const int live = min(len - row0, pps * page);
  float* part =
      ws + ((static_cast<size_t>(b) * gridDim.x + split) * H + h) * (DH + 2);
  if (live <= 0) {  // past the slot's length: the empty state
    if (!active) return;
    for (int d = lane; d < DH; d += 32) part[d] = 0.f;
    if (lane == 0) {
      part[DH] = kMaskValue;
      part[DH + 1] = 0.f;
    }
    return;
  }

  const int srow = hb * DH;                               // a stage row
  const uint32_t stage_bytes = cr * hs * DH * sizeof(T);  // one operand
  int* pages = reinterpret_cast<int*>(smem + 2u * stages * stage_bytes);
  const int n_pages_live = (live + page - 1) / page;
  for (int j = threadIdx.x; j < n_pages_live; j += blockDim.x) {
    const int pg =
        j == j0 ? pg0
                : page_table[static_cast<size_t>(b) * P + split * pps + j];
    if (pg < 0 || pg >= n_pages) __trap();
    pages[j] = pg;
  }
  const uint32_t ring = smem_u32(smem), bar0 = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (live + cr - 1) / cr;
  if (threadIdx.x == 0)
    for (int c = 0; c < stages && c < n_chunks; ++c)
      issue_chunk<T, DH>(k_pages, v_pages, pages, c, cr, live, page, H,
                         stage_bytes, stages, ring, bar0);

  float qv[VEC];
  if (active)
    load16(q + (static_cast<size_t>(b) * H + h) * DH + sub * VEC, qv);
  float m = kMaskValue, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  const int col = hl * DH + sub * VEC;
  const float scale_log2 = sm_scale * kLog2e;  // scores in log2 units
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % stages;
    mbar_wait(bar0 + 8 * s, (c / stages) & 1);
    const int rows = min(cr, live - c * cr);
    const T* ks = reinterpret_cast<const T*>(smem + 2u * s * stage_bytes);
    const T* vs = reinterpret_cast<const T*>(smem + (2u * s + 1) *
                                             stage_bytes);
    // kRows rows a group at a time, their loads and shuffles interleaved,
    // one rescale for them all; a uniform trip count across the warp, so
    // every lane reaches the shuffles together, whatever its rows'
    // validity
#pragma unroll 1
    for (int base = 0; active && base < rows; base += G * kRows) {
      float sc[kRows], vv[kRows][VEC];
      bool valid[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = base + g + G * u;
        valid[u] = r < rows;
        sc[u] = 0.f;
        if (valid[u]) {
          float kv[VEC];
          load16(ks + r * srow + col, kv);
          load16(vs + r * srow + col, vv[u]);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sc[u] += qv[i] * kv[i];
        }
      }
#pragma unroll
      for (int w = TPR / 2; w > 0; w >>= 1)
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], w);
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        sc[u] *= scale_log2;
        if (valid[u]) m_new = fmaxf(m_new, sc[u]);
      }
      const float alpha = exp2f(m - m_new);  // 1 where no row is valid
      l *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (!valid[u]) continue;
        const float p = exp2f(sc[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += p * vv[u][i];
      }
      m = m_new;
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (threadIdx.x == 0 && c + stages < n_chunks)
      issue_chunk<T, DH>(k_pages, v_pages, pages, c + stages, cr, live, page,
                         H, stage_bytes, stages, ring, bar0);
  }

  // every row is read: the combine may launch (a block that exits
  // counts as launched); it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the warp's row groups into group 0, in a fixed order; a group that
  // saw no row holds m = -1e30 and weighs exactly 0
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float a = exp2f(m - m_new), a_o = exp2f(m_o - m_new);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = acc[i] * a + __shfl_xor_sync(0xffffffffu, acc[i], off) * a_o;
    m = m_new;
  }
  if (active && g == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[sub * VEC + i] = acc[i];
    if (sub == 0) {
      part[DH] = m;
      part[DH + 1] = l;
    }
  }
}

// o[b, h] from the splits' partial states, merged in split order, by
// kCombineThreads threads: every split's m and l and the first
// kCombineSplits splits' acc rows are fetched at once, then each round's
// weighted acc rows are staged in shared memory and thread d adds column
// d of them in split order.  It is launched as the split kernel's
// programmatic dependent, so its launch overlaps the split kernel's last
// writes; it reads the workspace only after that grid has finished and
// its writes are visible.
template <int DH>
__global__ void __launch_bounds__(kCombineThreads)
paged_decode_kernel_combine(const float* __restrict__ ws,
                            float* __restrict__ out, int splits, int H) {
  constexpr int kPer = kCombineSplits * DH / kCombineThreads;
  static_assert(kPer * kCombineThreads == kCombineSplits * DH, "whole rounds");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ float sh[];  // weights [splits], l [splits], a round
  float* cw = sh;
  float* cl = sh + splits;
  float* tile = sh + 2 * splits;  // [kCombineSplits][DH]
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const size_t step = static_cast<size_t>(H) * (DH + 2);
  const float* p = ws + (static_cast<size_t>(b) * splits * H + h) * (DH + 2);

  float a[kPer];  // this thread's acc values of the round at s0
  auto fetch = [&](int s0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + kCombineThreads * i, s = s0 + e / DH;
      a[i] = s < splits ? p[s * step + e % DH] : 0.f;
    }
  };
  fetch(0);
  for (int s = t; s < splits; s += kCombineThreads) {
    cw[s] = p[s * step + DH];
    cl[s] = p[s * step + DH + 1];
  }
  __syncthreads();
  float m_all = kMaskValue;
  for (int s = 0; s < splits; ++s) m_all = fmaxf(m_all, cw[s]);
  __syncthreads();
  for (int s = t; s < splits; s += kCombineThreads)
    cw[s] = exp2f(cw[s] - m_all);
  __syncthreads();
  float l_all = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) l_all += cl[s] * cw[s];
  for (int s0 = 0; s0 < splits; s0 += kCombineSplits) {
    if (s0 > 0) {
      fetch(s0);
      __syncthreads();  // everyone is done with the last round's tile
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + kCombineThreads * i;
      if (s0 + e / DH < splits) tile[e] = a[i] * cw[s0 + e / DH];
    }
    __syncthreads();
    if (t < DH) {
      const int n = min(kCombineSplits, splits - s0);
      for (int j = 0; j < n; ++j) o += tile[j * DH + t];
    }
  }
  if (t < DH) out[(static_cast<size_t>(b) * H + h) * DH + t] = o / l_all;
}

// the rows a stage holds: the largest divisor of page whose rows of all
// heads fit one operand's stage (0: not even one row does)
int chunk_rows(int page, size_t row_bytes) {
  for (int r = page; r >= 1; --r)
    if (page % r == 0 && r * row_bytes <= kChunkBytes) return r;
  return 0;
}

template <typename T, int DH>
cudaError_t run(const void* q, const void* k, const void* v, const void* pt,
                const void* len, void* ws, void* out, int B, int H,
                int n_pages, int page, int P, int pps, int splits,
                float sm_scale, cudaStream_t stream) {
  const int hs = H < kMaxHeads ? H : kMaxHeads;  // a block's heads
  const size_t row_bytes = static_cast<size_t>(hs) * DH * sizeof(T);
  const int cr = chunk_rows(page, row_bytes);
  if (cr < 1) return cudaErrorInvalidValue;
  const int chunks = (pps * page + cr - 1) / cr;  // of a whole split
  int stages = chunks < kMaxStages ? chunks : kMaxStages;
  while (stages > 1 && 2 * stages * cr * row_bytes > kRingBytes) --stages;
  const size_t smem = 2 * stages * cr * row_bytes + pps * sizeof(int);
  cudaError_t err = launch(
      paged_decode_kernel<T, DH>,
      dim3(splits, B, (H + kMaxHeads - 1) / kMaxHeads), 32 * hs, smem,
      stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(len), static_cast<float*>(ws), H, n_pages,
      page, P, pps, cr, stages, sm_scale);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = (2 * splits + kCombineSplits * DH) * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_decode_kernel_combine<DH>,
                            static_cast<const float*>(ws),
                            static_cast<float*>(out), splits, H);
}

}  // namespace

// dtype codes: 0 = bfloat16, 1 = float32.  ws is f32 scratch of B *
// splits * H * (head_dim + 2); the page view's P entries go to splits of
// pps each (splits = ceil(P / pps)).  Returns the cudaError_t of the
// launches (0 = success); an unsupported (dtype, head_dim), a split
// count that does not cover the view or more than 4096 splits (the
// combine's shared memory) returns cudaErrorInvalidValue without
// launching.
extern "C" int znicz_paged_decode(int dtype, int head_dim, const void* q,
                                  const void* k_pages, const void* v_pages,
                                  const void* page_table,
                                  const void* lengths, void* ws, void* out,
                                  int B, int H, int n_pages, int page, int P,
                                  int pps, int splits, float sm_scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || page < 1 || P < 1 || pps < 1 ||
      splits != (P + pps - 1) / pps || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0 && head_dim == 64)
    err = run<__nv_bfloat16, 64>(q, k_pages, v_pages, page_table, lengths,
                                 ws, out, B, H, n_pages, page, P, pps, splits,
                                 sm_scale, s);
  else if (dtype == 0 && head_dim == 128)
    err = run<__nv_bfloat16, 128>(q, k_pages, v_pages, page_table, lengths,
                                  ws, out, B, H, n_pages, page, P, pps,
                                  splits, sm_scale, s);
  else if (dtype == 1 && head_dim == 64)
    err = run<float, 64>(q, k_pages, v_pages, page_table, lengths, ws, out,
                         B, H, n_pages, page, P, pps, splits, sm_scale, s);
  else if (dtype == 1 && head_dim == 128)
    err = run<float, 128>(q, k_pages, v_pages, page_table, lengths, ws, out,
                          B, H, n_pages, page, P, pps, splits, sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* znicz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
