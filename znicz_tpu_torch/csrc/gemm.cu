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
// Design: the shared f32 loop of tile_f32.cuh (conv.cu's forward runs on
// it too) over two dense tile loaders, chosen by how each operand lies:
// B (K, N) and A^T stored (K, M) arrive by cp.async (AsyncLoader), A (M,
// K) and B^T stored (N, K) through registers, stored transposed
// (StagedLoader), so the transposed forms read the stored matrices in
// place.  The TPU kernel's (m, n, k) grid carries its sum across k in
// VMEM scratch; here the k axis is the loop inside the block.  Tiles of
// 128 rows by 128 columns (64 where n <= 64).  A product whose tile grid
// fills the card poorly (AlexNet's batch-128 products: 32-72 tiles for
// 132 SMs) splits K over grid z into slices of whole k tiles, the count
// that fills the last of at most 4 waves of resident blocks best
// (gemm_plan, the conv weight gradient's rule); the slices write f32
// partials, and gemm_reduce_kernel adds them in slice order and applies
// bias and activation once.  Loads past a ragged edge arrive as zeros and
// stores are masked, so nothing is padded in device memory (the reference
// pads outside its kernel).  Unsplit, bias and activation run in the
// epilogue, before the one store of each output.  No atomics: every sum
// has a fixed order, so two launches are bit-identical.
//
// act_backward: err_v = err * act'(y), the derivative taken from the
// forward output y (activations.derivative_from_output), and with it the
// bias gradient grad_b[j] = sum_i err_v[i, j] in the same pass.  Bound:
// bytes (y and err read once, err_v written once: 12 bytes an element, and
// 4 a column of grad_b).  At the FC shapes (AlexNet's 128 x 4096) those
// bytes take ~1.9 us and a launch's own floor ~5 us, so the design's point
// is the launch it saves: the reference forms grad_b with a column sum
// outside its kernel, which XLA fuses on the TPU; PyTorch eager cannot, and
// would read err_v again in a second launch.  Each block takes a tile of
// kActCols 16-byte vectors (64 columns; one column a thread off the vector
// path) and kActLanes row lanes; the rows are split over the `ranks`
// blocks of one thread-block cluster.  Each lane sums its rows in row
// order (their loads issued together, kActUnroll at a time), each block
// its lanes in lane order into a row of rank 0's shared memory (a
// distributed-shared-memory store), and after one cluster barrier rank 0
// adds the rows in rank order.  No atomics: the order is fixed, so two
// launches are bit-identical, and kernels/gemm.py
// act_bias_backward_plain sums in this order.  The product
// and the sums are rounded as written (__fmul_rn, __fadd_rn), so nothing
// is contracted into an FMA and err_v is the value summed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tile_f32.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace znicz_tile;
using znicz_hopper::launch;

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

// C (or split z's partial) of the block's tile.  A and B through dense
// loaders over the split's k range [z * per, min(K, (z + 1) * per)).
// Unsplit (gridDim.z 1): act(acc + bias) into C.  Split: the raw sums
// into part[z] (M, N); gemm_reduce_kernel adds the slices in order and
// applies bias and activation once.
template <int BM, int BN, bool A_KC, bool B_KC>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, kMinBlocks)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C,
                float* __restrict__ part, int M, int N, int K, int per,
                int act, bool vec_a, bool vec_b, bool vec_c) {
  using T = Tile<BM, BN>;
  using LA = std::conditional_t<A_KC, StagedLoader<T, BM>, AsyncLoader<T, BM>>;
  using LB = std::conditional_t<B_KC, StagedLoader<T, BN>, AsyncLoader<T, BN>>;
  extern __shared__ __align__(16) float gemm_smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kbeg = blockIdx.z * per;
  const int kend = kbeg + per < K ? kbeg + per : K;
  LA la{A, M, A_KC ? K : M, kend, m0, kbeg, vec_a};
  LB lb{B, N, B_KC ? K : N, kend, n0, kbeg, vec_b};
  float acc[TM][TN];
  mainloop<T>(gemm_smem, la, lb, (kend - kbeg + kBK - 1) / kBK, acc);

  const bool split = gridDim.z > 1;
  float* out = split ? part + static_cast<size_t>(blockIdx.z) * M * N : C;
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + col_of<T>(j);
    bv[j] = !split && bias != nullptr && n < N ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + row_of<T>(i);
    if (m >= M) continue;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      v[j] = split ? acc[i][j] : activate(acc[i][j] + bv[j], act);
    float* row = out + static_cast<size_t>(m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two runs of 4 columns, 16-byte stores
      const int n = n0 + col_of<T>(4 * h);
      if (vec_c && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = v[4 * h + e];
      }
    }
  }
}

// C = act(sum of the S partials in slice order + bias), VEC elements a
// step (4 where N % 4 == 0 and every pointer is 16-byte aligned).
template <int VEC>
__global__ void __launch_bounds__(256)
gemm_reduce_kernel(const float* __restrict__ part, int splits, long long mn,
                   int N, const float* __restrict__ bias, int act,
                   float* __restrict__ C) {
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * VEC;
  for (long long i =
           (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
           VEC;
       i < mn; i += stride) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* p = part + s * mn + i;
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        acc[0] += v.x;
        acc[1] += v.y;
        acc[2] += v.z;
        acc[3] += v.w;
      } else {
        acc[0] += p[0];
      }
    }
    const int n = static_cast<int>(i % N);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] = activate(acc[e] + (bias != nullptr ? bias[n + e] : 0.f), act);
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(C + i) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
      C[i] = acc[0];
  }
}

// act_backward's block: kActCols column threads by kActLanes row lanes;
// the rows split over a cluster of at most kActMaxRanks blocks
// (kernels/gemm.py act_bias_plan chooses the launch)
constexpr int kActCols = 16;
constexpr int kActLanes = 16;
constexpr int kActMaxRanks = 8;
// rows of a lane whose loads are in flight together
constexpr int kActUnroll = 4;

// err_v (m, n) = err * act'(y) and grad_b (n) = the column sums of err_v:
// each lane's rows in row order, a block's lanes in lane order, the
// cluster's ranks in rank order.  Grid (tiles, ranks), clusters of
// (1, ranks, 1), kActCols * kActLanes threads.
template <int VEC>
__global__ void __launch_bounds__(kActCols * kActLanes)
act_backward_f32_kernel(const float* __restrict__ y,
                        const float* __restrict__ err,
                        float* __restrict__ out, float* __restrict__ grad_b,
                        long long m, long long n, long long rows_per_lane,
                        int act) {
  __shared__ __align__(16) float lane_part[kActLanes][kActCols * VEC];
  // rank 0's: every rank's partial, a row a rank
  __shared__ __align__(16) float rank_part[kActMaxRanks][kActCols * VEC];
  // this block has started: the wait before the store into rank 0 pairs
  // it, so no rank stores into a block that does not exist yet
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int cx = static_cast<int>(threadIdx.x) % kActCols;
  const int lane = static_cast<int>(threadIdx.x) / kActCols;
  const long long col =
      (static_cast<long long>(blockIdx.x) * kActCols + cx) * VEC;
  const long long r0 =
      (static_cast<long long>(blockIdx.y) * kActLanes + lane) *
      rows_per_lane;
  const long long r1 = r0 + rows_per_lane < m ? r0 + rows_per_lane : m;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (col < n) {
    // kActUnroll rows at a time: every row's loads are issued before the
    // first is used, so a lane's rows cost one trip to memory, not one a
    // row; the sums still take the rows in order
    for (long long rb = r0; rb < r1; rb += kActUnroll) {
      float yv[kActUnroll][VEC], ev[kActUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kActUnroll; ++u) {
        if (rb + u >= r1) break;
        const long long i = (rb + u) * n + col;
        if constexpr (VEC == 4) {
          const float4 a = *reinterpret_cast<const float4*>(y + i);
          const float4 b = *reinterpret_cast<const float4*>(err + i);
          yv[u][0] = a.x, yv[u][1] = a.y, yv[u][2] = a.z, yv[u][3] = a.w;
          ev[u][0] = b.x, ev[u][1] = b.y, ev[u][2] = b.z, ev[u][3] = b.w;
        } else {
          yv[u][0] = y[i];
          ev[u][0] = err[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kActUnroll; ++u) {
        if (rb + u >= r1) break;
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[e] = __fmul_rn(ev[u][e], derivative(yv[u][e], act));
          acc[e] = __fadd_rn(acc[e], v[e]);
        }
        const long long i = (rb + u) * n + col;
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(out + i) =
              make_float4(v[0], v[1], v[2], v[3]);
        else
          out[i] = v[0];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) lane_part[lane][cx * VEC + e] = acc[e];
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane == 0) {
    // the block's partial, its lanes in lane order, stored into rank 0's
    // shared memory at this rank's row (a remote store for ranks > 0)
    float* dst = cluster.map_shared_rank(&rank_part[0][0], 0) +
                 rank * kActCols * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float b = 0.f;
#pragma unroll
      for (int l = 0; l < kActLanes; ++l)
        b = __fadd_rn(b, lane_part[l][cx * VEC + e]);
      dst[cx * VEC + e] = b;
    }
  }
  // every rank's partial has landed in rank 0, and after this barrier no
  // rank touches another's memory, so the others may leave
  cluster.sync();
  if (rank == 0 && lane == 0 && col < n) {
    const int ranks = static_cast<int>(cluster.num_blocks());
    float g[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) g[e] = 0.f;
#pragma unroll
    for (int r = 0; r < kActMaxRanks; ++r) {
      if (r >= ranks) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        g[e] = __fadd_rn(g[e], rank_part[r][cx * VEC + e]);
    }
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(grad_b + col) =
          make_float4(g[0], g[1], g[2], g[3]);
    else
      grad_b[col] = g[0];
  }
}

// An empty kernel: launched with act_backward's grid and clusters, it
// times the floor of such a launch (the smoke holds act_backward's time
// against it).
__global__ void __launch_bounds__(kActCols * kActLanes) empty_kernel() {}

// A cluster of 1, 2, 4 or 8 ranks and `tiles` (at most 2^31 - 1) tiles
bool act_grid_ok(long long tiles, int ranks) {
  return tiles >= 1 && tiles <= 0x7fffffffLL && ranks >= 1 &&
         ranks <= kActMaxRanks && (ranks & (ranks - 1)) == 0;
}

// act_backward's launch configuration (grid, block, clusters) for
// `tiles` column tiles by `ranks` blocks of a cluster
cudaLaunchConfig_t act_config(long long tiles, int ranks, cudaStream_t s,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles),
                     static_cast<unsigned>(ranks));
  cfg.blockDim = dim3(kActCols * kActLanes);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = static_cast<unsigned>(ranks);
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The GEMM's tile: 128 rows by 128 columns, 64 where n <= 64
// (gemm_tile in kernels/gemm.py is its twin).
int gemm_bn(int n) { return n <= 64 ? 64 : 128; }

constexpr int kGemmBM = 128;
// the most waves of resident blocks the split-K schedule spreads over
constexpr int kGemmMaxWaves = 4;

template <int BN, bool A_KC, bool B_KC>
int gemm_residency_of() {
  using T = Tile<kGemmBM, BN>;
  return blocks_per_sm(gemm_f32_kernel<kGemmBM, BN, A_KC, B_KC>, T::kThreads,
                       T::kSmem);
}

template <int BN>
int gemm_residency_of(bool trans_a, bool trans_b) {
  if (!trans_a && !trans_b) return gemm_residency_of<BN, true, false>();
  if (!trans_a) return gemm_residency_of<BN, true, true>();
  if (!trans_b) return gemm_residency_of<BN, false, false>();
  return gemm_residency_of<BN, false, true>();
}

// Blocks an SM of the instantiation for BN columns and these layouts.
int gemm_residency(int bn, bool trans_a, bool trans_b) {
  return bn == 64 ? gemm_residency_of<64>(trans_a, trans_b)
                  : gemm_residency_of<128>(trans_a, trans_b);
}

// Blocks an SM of the tile of BN columns: the least over its four
// operand layouts, so that the schedule is a function of the shape alone.
int gemm_residency(int bn) {
  int least = gemm_residency(bn, false, false);
  for (int t = 1; t < 4; ++t) {
    const int r = gemm_residency(bn, t & 1, t >> 1);
    least = r < least ? r : least;
  }
  return least;
}

// out = {BM, BN, resident blocks an SM, splits, per (k a slice)}.
void gemm_plan(int m, int n, int k, int* out) {
  const int bn = gemm_bn(n), per_sm = gemm_residency(bn);
  const long long t = static_cast<long long>((m + kGemmBM - 1) / kGemmBM) *
                      ((n + bn - 1) / bn);
  const long long k_tiles = (k + kBK - 1) / kBK;
  const long long splits = whole_wave_splits(
      t, static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1),
      k_tiles, kGemmMaxWaves);
  const long long per = (k_tiles + splits - 1) / splits * kBK;
  out[0] = kGemmBM;
  out[1] = bn;
  out[2] = per_sm;
  out[3] = static_cast<int>((k + per - 1) / per);
  out[4] = static_cast<int>(per);
}

template <int BN, bool A_KC, bool B_KC>
cudaError_t launch_gemm(const float* A, const float* B, const float* bias,
                        float* C, float* part, int M, int N, int K,
                        int splits, int per, int act, bool vec_a, bool vec_b,
                        bool vec_c, cudaStream_t stream) {
  using T = Tile<kGemmBM, BN>;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  return launch(gemm_f32_kernel<kGemmBM, BN, A_KC, B_KC>, grid, T::kThreads,
                T::kSmem, stream, A, B, bias, C, part, M, N, K, per, act,
                vec_a, vec_b, vec_c);
}

template <int BN>
cudaError_t launch_layout(bool trans_a, bool trans_b, const float* A,
                          const float* B, const float* bias, float* C,
                          float* part, int M, int N, int K, int splits,
                          int per, int act, bool va, bool vb, bool vc,
                          cudaStream_t s) {
  if (!trans_a && !trans_b)
    return launch_gemm<BN, true, false>(A, B, bias, C, part, M, N, K, splits,
                                        per, act, va, vb, vc, s);
  if (!trans_a)
    return launch_gemm<BN, true, true>(A, B, bias, C, part, M, N, K, splits,
                                       per, act, va, vb, vc, s);
  if (!trans_b)
    return launch_gemm<BN, false, false>(A, B, bias, C, part, M, N, K,
                                         splits, per, act, va, vb, vc, s);
  return launch_gemm<BN, false, true>(A, B, bias, C, part, M, N, K, splits,
                                      per, act, va, vb, vc, s);
}

}  // namespace

// C = act(op(A) . op(B) + bias), all f32, row-major.  A is (M, K), or
// (K, M) stored and read transposed when trans_a; B is (K, N), or (N, K)
// stored and read transposed when trans_b; bias (N) or null; C (M, N).
// K is split into `splits` slices of `per` (per % 32 == 0, splits * per
// >= K > (splits - 1) * per); with splits > 1, part is scratch of splits
// * M * N floats (else unused, may be null).  Returns the cudaError_t of
// the launches (0 = success); a bad shape, split or activation code
// returns cudaErrorInvalidValue without launching.
extern "C" int znicz_gemm_f32(const void* A, const void* B, const void* bias,
                              void* C, void* part, int M, int N, int K,
                              int trans_a, int trans_b, int act, int splits,
                              int per, void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kLinear || act > kSigmoid ||
      splits < 1 || splits > 65535 || per < 1 || per % kBK != 0 ||
      static_cast<long long>(splits) * per < K ||
      static_cast<long long>(splits - 1) * per >= K ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* bs = static_cast<const float*>(bias);
  float* c = static_cast<float*>(C);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows of the stored operands start 16-byte aligned iff the base is and
  // the stored row length is a multiple of 4 floats
  const bool va = aligned16(a) && (trans_a ? M : K) % 4 == 0;
  const bool vb = aligned16(b) && (trans_b ? K : N) % 4 == 0;
  const bool vc = aligned16(c) && N % 4 == 0;
  const cudaError_t err =
      gemm_bn(N) == 64
          ? launch_layout<64>(trans_a, trans_b, a, b, bs, c, p, M, N, K,
                             splits, per, act, va, vb, vc, s)
          : launch_layout<128>(trans_a, trans_b, a, b, bs, c, p, M, N, K,
                             splits, per, act, va, vb, vc, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  if (N % 4 == 0 && aligned16(p) && aligned16(c) &&
      (bs == nullptr || aligned16(bs)))
    gemm_reduce_kernel<4><<<blocks_for(mn / 4), 256, 0, s>>>(p, splits, mn,
                                                             N, bs, act, c);
  else
    gemm_reduce_kernel<1><<<blocks_for(mn), 256, 0, s>>>(p, splits, mn, N,
                                                         bs, act, c);
  return static_cast<int>(cudaGetLastError());
}

// The GEMM's schedule for an (m, k) x (k, n) product as this card runs
// it: out = {BM, BN, resident blocks an SM (the least of the tile's four
// layouts), splits, per}.  kernels/gemm.py gemm_plan computes the same
// from its table of residencies; the smoke holds one against the other.
extern "C" int znicz_gemm_f32_plan(int m, int n, int k, int* out) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  gemm_plan(m, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

// err_v = err * act'(y) over (m, n) f32 row-major and grad_b (n) its
// column sums, on the launch kernels/gemm.py act_bias_plan gives: `tiles`
// blocks of kActCols * vec columns by `ranks` blocks of a cluster,
// rows_per_lane rows to a lane; vec 4 needs n % 4 == 0 and every pointer
// 16-byte aligned.  Same return convention; a launch that does not cover
// (m, n) returns cudaErrorInvalidValue without launching.
extern "C" int znicz_act_backward_f32(const void* y, const void* err,
                                      void* out, void* grad_b, long long m,
                                      long long n, long long tiles,
                                      int ranks, long long rows_per_lane,
                                      int vec, int act, void* stream) {
  const float* yp = static_cast<const float*>(y);
  const float* ep = static_cast<const float*>(err);
  float* op = static_cast<float*>(out);
  float* gp = static_cast<float*>(grad_b);
  if (m < 1 || n < 1 || act < kLinear || act > kSigmoid || gp == nullptr ||
      (vec != 1 && vec != 4) || !act_grid_ok(tiles, ranks) ||
      rows_per_lane < 1 || tiles * kActCols * vec < n ||
      rows_per_lane * ranks * kActLanes < m ||
      (vec == 4 && (n % 4 != 0 || !aligned16(yp) || !aligned16(ep) ||
                    !aligned16(op) || !aligned16(gp))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      act_config(tiles, ranks, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err_code =
      vec == 4 ? cudaLaunchKernelEx(&cfg, act_backward_f32_kernel<4>, yp, ep,
                                    op, gp, m, n, rows_per_lane, act)
               : cudaLaunchKernelEx(&cfg, act_backward_f32_kernel<1>, yp, ep,
                                    op, gp, m, n, rows_per_lane, act);
  if (err_code != cudaSuccess) return static_cast<int>(err_code);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel over act_backward's grid and clusters for `tiles` by
// `ranks`.  Same return convention.
extern "C" int znicz_empty_launch(long long tiles, int ranks, void* stream) {
  if (!act_grid_ok(tiles, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      act_config(tiles, ranks, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err_code = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err_code != cudaSuccess) return static_cast<int>(err_code);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM on this card of the instantiation for BN (64 or
// 128) columns and the given operand layouts (0 for no such tile).
extern "C" int znicz_gemm_f32_residency(int bn, int trans_a, int trans_b) {
  if (bn != 64 && bn != 128) return 0;
  return gemm_residency(bn, trans_a != 0, trans_b != 0);
}

extern "C" const char* znicz_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
