// One Kohonen SOM batch step for Hopper (sm_90a), float32, as one launch
// on one thread-block cluster.
//
// Replaces znicz_tpu/ops/pallas/kohonen.py :: som_step (the pallas_call at
// :72, kernel body :22-58) with its semantics:
//   d2[b, j]  = |x_b|^2 - 2 x_b . w_j + |w_j|^2   (that formula, not
//               (x - w)^2, which rounds near-ties the other way)
//   winner[b] = the smallest j attaining min_j d2[b, j]
//   h[b, j]   = exp(-|c_winner[b] - c_j|^2 / (2 sigma^2)), the grid
//               distance taken as |c_w|^2 - 2 c_w . c_j + |c_j|^2; rows b >=
//               bs contribute nothing (h = 0)
//   w'_j      = w_j + alpha (sum_b h[b, j] x_b - den_j w_j) / (den_j + 1),
//               den_j = sum_b h[b, j]
// All in full f32 on the CUDA cores: no TF32 and no bf16, whose rounding
// flips winners (the TPU kernel's note at :28-32 measured 40 % of weights
// diverging with bf16 passes).
//
// Bound: at the SOM's shapes (x 500 x 16, W 256 x 16: 48 KB; the parity
// sweep's 64 x 128 against 256 x 128) a step is a few MFLOP and tens of
// KB, microseconds, so what bounds it is latency: the launch, the chain of
// dependent phases (winners before the update) and the serial sums.  The
// TPU kernel fuses the step into one VMEM pass for that reason.  Here a
// step is one launch of one cluster of kRanks blocks on neighbouring SMs,
// and nothing but x, W, coords and the outputs touches device memory:
//  - rank r owns a contiguous run of neurons (som_plan: ceil(N / 8)
//    each), keeps their rows of W in shared memory (one cp.async each,
//    all in flight with the first chunk's x) and accumulates their sums
//    there ("resident"; a W too large for shared memory is read from
//    device memory and summed into new_w instead);
//  - the samples go in chunks (som_plan's chunk, 4 * 2^k <= 2048).  Phase
//    A: each rank stages the chunk's x transposed (d-major) and computes
//    d2 against its own neurons, a thread 4 samples x 4 neurons with the
//    d-loop in ascending order (one fmaf a step, as the two-launch kernel
//    before it compiled `dot += x * w`), keeping each sample's first
//    minimum; the rank's minimum of each sample, a (d2, j) pair, is
//    pushed into every rank's shared memory (distributed shared memory
//    stores: no round trip to wait on, where reads of the peers' memory
//    measured slower);
//  - after a cluster barrier every rank reduces each sample's kRanks
//    pairs from its own shared memory, keeping the smaller d2, on a tie
//    the smaller j (NaN never wins, an all-NaN row gives 0): the first
//    minimum whatever the order, so the winners do not depend on the
//    split;
//  - h depends on a sample only through its winner's grid cell, so where
//    N < chunk ("table") each rank computes h for its own neurons against
//    every cell once a launch, and a sample reads its winner's row (the
//    same bits); else against each chunk's winners;
//  - phase B sums num = h^T x and den = h^T 1 for the rank's neurons, a
//    thread 4 neurons x 4 columns over one of `slices` contiguous runs of
//    the chunk's samples (fmaf, samples ascending); a chunk's runs are
//    added in run order and the chunk's sum to the running sum.  A fixed
//    order with no atomics: two launches give the same bits
//    (kernels/kohonen.py som_step_twin repeats it in torch);
//  - a rank arrives on the cluster barrier once it has read the pairs
//    (a release arrival: its reads of them are ordered before the peers'
//    next pushes, which follow their wait.acquire on it) and waits on it
//    before it pushes the next chunk's, so no push lands on pairs still
//    being read; a relaxed arrival at entry pairs the first chunk's wait,
//    so no push reaches a block that has not started; the last wait
//    pairs the last arrival before exit.
// Every phase is latency-bound at 16 warps an SM: by clock64 stamps on
// the card, no one phase holds most of bench_kohonen's step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRanks = 8;        // the cluster: the portable size
constexpr int kThreads = 512;    // a block
constexpr int kMaxChunk = 4 * kThreads;
constexpr int kSmemBudget = 232448;  // 227 KB a block on sm_90
constexpr int kPart = 20;        // a phase-B partial: 16 sums + 4 dens

struct SomPlan {
  int per;       // neurons a rank (the last ranks may own fewer or none)
  int pp;        // per rounded up to 4: the pitch of h's rows
  int dp;        // D rounded up to 4
  int chunk;     // samples a chunk, 4 * 2^k
  int slices;    // runs of a chunk's samples in phase B
  int resident;  // W and the sums in shared memory
  int table;     // h a row per grid cell, once (N < chunk), not a sample
  int smem;      // dynamic shared memory bytes
};

__host__ __device__ constexpr int up4(int v) { return (v + 3) & ~3; }

// Offsets (floats, each a multiple of 4) of the shared-memory regions.
struct Layout {
  int w, sums, den, w2, cells, xt, pad, paj, prd, key, wr, wc, wc2, hs, pb,
      total;
  __host__ __device__ Layout(const SomPlan& p, int N) {
    const int tiles = (p.pp / 4) * (p.dp / 4);
    int o = 0;
    auto take = [&o](int n) {
      const int at = o;
      o += up4(n);
      return at;
    };
    w = take(p.resident ? p.per * (p.dp + 4) : 0);
    sums = take(p.resident ? 16 * tiles : 0);  // num, tile-major
    den = take(p.per);
    w2 = take(p.per);
    cells = take(p.table ? 2 * N : 0);  // every neuron's grid cell
    xt = take(p.dp * (p.chunk + 4));
    pad = take(4 * kThreads);
    paj = take(4 * kThreads);
    prd = take(2 * kRanks * p.chunk);  // every rank's (d2, j) pairs
    key = take(p.chunk);      // each sample's row of h
    wr = take(p.table ? 0 : p.chunk);
    wc = take(p.table ? 0 : p.chunk);
    wc2 = take(p.table ? 0 : p.chunk);
    hs = take((p.table ? N + 1 : p.chunk) * p.pp);
    pb = take(p.slices > 1 ? p.slices * tiles * kPart : 0);
    total = o;
  }
};

// The launch's plan; false where even the smallest chunk does not fit.
bool make_plan(int B, int N, int D, SomPlan& p) {
  p.per = (N + kRanks - 1) / kRanks;
  p.pp = up4(p.per);
  p.dp = up4(D);
  int first = 4;
  while (first < B && first < kMaxChunk) first *= 2;
  const int tiles = (p.pp / 4) * (p.dp / 4);
  for (int resident = 1; resident >= 0; --resident) {
    for (int chunk = first; chunk >= 4; chunk /= 2) {
      p.chunk = chunk;
      p.resident = resident;
      p.table = N < chunk;
      p.slices = 1;
      while (2 * p.slices * tiles <= kThreads && 2 * p.slices <= chunk / 4)
        p.slices *= 2;
      const long long bytes = 4LL * Layout(p, N).total;
      if (bytes <= kSmemBudget) {
        p.smem = static_cast<int>(bytes);
        return true;
      }
    }
  }
  return false;
}

// A 4-byte asynchronous copy into shared memory (zeros where !valid).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows r < rows of a (rows, width) row-major matrix as (r, c) pairs, c
// fastest, the block's threads in turn: fn(r, c) for each, with no
// division an element.
template <class Fn>
__device__ __forceinline__ void each_cell(int rows, int width, Fn fn) {
  const int step_r = blockDim.x / width, step_c = blockDim.x % width;
  int r = threadIdx.x / width, c = threadIdx.x % width;
  while (r < rows) {
    fn(r, c);
    r += step_r;
    c += step_c;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// Chunk b0's x, transposed, into xt (pitch xp), zeros past nb: coalesced
// reads of x's rows, and xp % 32 == 4 spreads the transposed stores over
// the banks.
__device__ __forceinline__ void stage_x(float* xt, const float* x, int b0,
                                        int nb, int chunk, int xp, int D) {
  const float* xc = x + static_cast<long long>(b0) * D;
  each_cell(chunk, D, [&](int b, int d) {
    copy4(xt + d * xp + b, b < nb ? xc + b * D + d : x, b < nb);
  });
}

__device__ __forceinline__ float norm2(float r, float c) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(c, c));
}

// a / b for the step's one divisor b = 2 sigma^2, from inv = RN(1/b): q =
// RN(a inv) is within an ulp of a / b, the remainder a - q b is exact in an
// fma, and q + (a - q b) inv rounded once is a / b correctly rounded
// (Markstein's theorem, for a normal inv and quotient; a quotient in the
// subnormal range is below 6e-8, where exp gives 1 whatever its last
// bits).  An infinite q (b = 0, or past the float range) is a / b's own
// infinity.  Branch-free, where __fdiv_rn's range checks and slow path
// serialise the four values a lane keeps in flight.
__device__ __forceinline__ float div_by(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return isinf(q) ? q : fmaf(fmaf(-q, b, a), inv, q);
}

// h of this rank's neurons (their grid cells at cells, (row, col) pairs)
// against rows r < rows of sources: src(r, sr, sc, s2) gives row r's cell
// and |cell|^2, and whether it counts (else the row is 0).  Four rows a
// lane in flight: each h is a chain of dependent operations (the
// division, the exponential).
template <class Source>
__device__ __forceinline__ void h_rows(float* hs, int rows, int pp, int P,
                                       const float* cells, float two_s2,
                                       Source src) {
  const float inv = __frcp_rn(two_s2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int j = lane; j < pp; j += 32) {
    const bool own = j < P;
    const float jr = own ? cells[2 * j] : 0.f;
    const float jc = own ? cells[2 * j + 1] : 0.f;
    const float j2 = norm2(jr, jc);
    for (int r1 = warp; r1 < rows; r1 += 4 * warps) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r1 + u * warps;
        if (r >= rows) break;
        float sr, sc, s2, v = 0.f;
        if (src(r, sr, sc, s2) && own) {
          const float dot = __fadd_rn(__fmul_rn(sr, jr), __fmul_rn(sc, jc));
          const float g2 = __fadd_rn(__fsub_rn(s2, __fmul_rn(2.f, dot)), j2);
          v = expf(div_by(-g2, two_s2, inv));
        }
        hs[r * pp + j] = v;
      }
    }
  }
}

// v into the float2 at local_addr's offset in rank's shared memory
__device__ __forceinline__ void store_remote(float2* local_addr, int rank,
                                             float2 v) {
  const unsigned at =
      static_cast<unsigned>(__cvta_generic_to_shared(local_addr));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(at), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote),
               "f"(v.x), "f"(v.y)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// an arrival that orders no memory: it says only that this block has
// started, which a peer must know before it touches this block's memory
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d2 of 4 samples against neurons j0 .. j0 + 3 from their dots, each
// sample's first minimum kept (j ascends; NaN never wins)
__device__ __forceinline__ void keep_first_min(const float (&acc)[4][4],
                                               const float (&x2)[4],
                                               const float* w2, int j0, int P,
                                               int lo, float (&best)[4],
                                               int (&bj)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + k;
    if (j >= P) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d2 =
          __fadd_rn(__fsub_rn(x2[i], __fmul_rn(2.f, acc[i][k])), w2[j]);
      if (d2 < best[i]) {
        best[i] = d2;
        bj[i] = lo + j;
      }
    }
  }
}

// (d, j) before (bd, bj): the smaller distance, on a tie the smaller index
__device__ __forceinline__ bool before(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

__device__ __forceinline__ float pick(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    som_step_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ coords,
                    float* __restrict__ new_w, int* __restrict__ winner,
                    int B, int N, int D, int bs, float alpha, float sigma,
                    SomPlan p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L(p, N);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x;
  const int lo = min(rank * p.per, N);
  const int P = min(lo + p.per, N) - lo;  // this rank's neurons
  const int xp = p.chunk + 4;             // xT's row pitch
  const int pq = p.pp / 4, dq_n = p.dp / 4, tiles = pq * dq_n;
  float* xt = sm + L.xt;
  float* hs = sm + L.hs;
  float* den = sm + L.den;
  int* key = reinterpret_cast<int*>(sm + L.key);
  // the running sums: resident tile-major (sums[(4 k + i) tiles + tile]
  // for neuron 4 jq + k, column dq + i dq_n), else new_w's rows
  float* num =
      kResident ? sm + L.sums : new_w + static_cast<long long>(lo) * D;
  // W's rows: resident at pitch dp + 4 (zeros past D; the 4 spread a
  // column over the banks), else in device memory
  const int wp = kResident ? p.dp + 4 : D;
  const float* wl = kResident ? sm + L.w : w + static_cast<long long>(lo) * D;
  const float* cells = sm + L.cells;

  // this block has started: the first chunk's wait pairs it, so no
  // peer pushes into this block's memory before it exists
  cluster_arrive_relaxed();
  // every copy of the first chunk's x, W's rows and the grid in flight
  stage_x(xt, x, 0, min(p.chunk, B), p.chunk, xp, D);
  if (kResident)
    each_cell(P, p.dp, [&](int j, int d) {
      copy4(sm + L.w + j * wp + d,
            w + static_cast<long long>(lo + j) * D + min(d, D - 1), d < D);
    });
  if (p.table)
    for (int i = tid; i < 2 * N; i += kThreads)
      copy4(sm + L.cells + i, coords + i, true);
  for (int i = D * xp + tid; i < p.dp * xp; i += kThreads) xt[i] = 0.f;
  if (kResident)
    for (int i = tid; i < 16 * tiles; i += kThreads) num[i] = 0.f;
  else
    for (int i = tid; i < P * D; i += kThreads) num[i] = 0.f;
  for (int j = tid; j < P; j += kThreads) den[j] = 0.f;
  copy_wait();
  __syncthreads();
  for (int j = tid; j < P; j += kThreads) {
    const float* wj = wl + static_cast<long long>(j) * wp;
    float w2 = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) w2 = fmaf(wj[d], wj[d], w2);
    sm[L.w2 + j] = w2;
  }
  const float two_s2 = __fmul_rn(__fmul_rn(2.f, sigma), sigma);
  if (p.table)  // row k: the winner k's cell; row N: zeros
    h_rows(hs, N + 1, p.pp, P, cells + 2 * lo, two_s2,
           [&](int k, float& sr, float& sc, float& s2) {
             if (k >= N) return false;
             sr = cells[2 * k];
             sc = cells[2 * k + 1];
             s2 = norm2(sr, sc);
             return true;
           });
  const int sq_n = p.chunk / 4, groups = kThreads / sq_n;
  const int sq = tid & (sq_n - 1), g = tid / sq_n;
  const int nq = (P + 3) / 4;

  for (int b0 = 0, c = 0; b0 < B; b0 += p.chunk, ++c) {
    const int nb = min(p.chunk, B - b0);
    __syncthreads();  // the last chunk's xT, h and keys are consumed
    if (c > 0) {
      stage_x(xt, x, b0, nb, p.chunk, xp, D);
      copy_wait();
      __syncthreads();
    }

    // Phase A: each thread's 4 samples against its neuron quads
    float best[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    int bj[4] = {N, N, N, N};
    if (g < nq) {
      float x2[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float4 v =
            *reinterpret_cast<const float4*>(xt + d * xp + 4 * sq);
        x2[0] = fmaf(v.x, v.x, x2[0]);
        x2[1] = fmaf(v.y, v.y, x2[1]);
        x2[2] = fmaf(v.z, v.z, x2[2]);
        x2[3] = fmaf(v.w, v.w, x2[3]);
      }
      for (int q = g; q < nq; q += groups) {
        const float* wr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) wr[k] = wl + min(4 * q + k, P - 1) * wp;
        float acc[4][4] = {};
        if (kResident) {
          for (int d0 = 0; d0 < p.dp; d0 += 4) {  // zeros past D add 0
            float4 v[4], u[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              v[r] = *reinterpret_cast<const float4*>(xt + (d0 + r) * xp +
                                                      4 * sq);
              u[r] = *reinterpret_cast<const float4*>(wr[r] + d0);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)  // d = d0 + r ascending
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float wv = pick(u[k], r);
                acc[0][k] = fmaf(v[r].x, wv, acc[0][k]);
                acc[1][k] = fmaf(v[r].y, wv, acc[1][k]);
                acc[2][k] = fmaf(v[r].z, wv, acc[2][k]);
                acc[3][k] = fmaf(v[r].w, wv, acc[3][k]);
              }
          }
        } else {
          for (int d = 0; d < D; ++d) {
            const float4 v =
                *reinterpret_cast<const float4*>(xt + d * xp + 4 * sq);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float wv = __ldg(wr[k] + d);
              acc[0][k] = fmaf(v.x, wv, acc[0][k]);
              acc[1][k] = fmaf(v.y, wv, acc[1][k]);
              acc[2][k] = fmaf(v.z, wv, acc[2][k]);
              acc[3][k] = fmaf(v.w, wv, acc[3][k]);
            }
          }
        }
        keep_first_min(acc, x2, sm + L.w2, 4 * q, P, lo, best, bj);
      }
    }
    *reinterpret_cast<float4*>(sm + L.pad + g * p.chunk + 4 * sq) =
        make_float4(best[0], best[1], best[2], best[3]);
    *reinterpret_cast<int4*>(reinterpret_cast<int*>(sm + L.paj) +
                             g * p.chunk + 4 * sq) =
        make_int4(bj[0], bj[1], bj[2], bj[3]);
    __syncthreads();
    // every rank has started (c == 0) or has read the last pairs
    cluster_wait();
    float2* pairs = reinterpret_cast<float2*>(sm + L.prd);
    const int* paj = reinterpret_cast<const int*>(sm + L.paj);
    for (int b = tid; b < nb; b += kThreads) {
      float bd = sm[L.pad + b];
      int jb = paj[b];
      for (int gg = 1; gg < groups; ++gg) {
        const float d = sm[L.pad + gg * p.chunk + b];
        const int j = paj[gg * p.chunk + b];
        if (before(d, j, bd, jb)) {
          bd = d;
          jb = j;
        }
      }
      // pushed into every rank's shared memory: stores do not wait on
      // the round trip that reads of the peers' memory would
      const float2 pr = make_float2(bd, __int_as_float(jb));
#pragma unroll
      for (int r = 0; r < kRanks; ++r)
        store_remote(pairs + rank * p.chunk + b, r, pr);
    }
    cluster_arrive();
    cluster_wait();  // every rank's pairs have landed
    for (int b = tid; b < p.chunk; b += kThreads) {
      if (b >= nb) {  // padding: a row of zeros
        key[b] = p.table ? N : b;
        continue;
      }
      float2 pr[kRanks];
#pragma unroll
      for (int r = 0; r < kRanks; ++r) pr[r] = pairs[r * p.chunk + b];
      float bd = INFINITY;
      int jb = N;
#pragma unroll
      for (int r = 0; r < kRanks; ++r) {
        const int j = __float_as_int(pr[r].y);
        if (before(pr[r].x, j, bd, jb)) {
          bd = pr[r].x;
          jb = j;
        }
      }
      const int k = jb < N ? jb : 0;  // an all-NaN row: 0
      if (rank == 0) winner[b0 + b] = k;
      if (p.table) {
        key[b] = b0 + b < bs ? k : N;
      } else {
        key[b] = b;
        const float wr = coords[2 * k], wc = coords[2 * k + 1];
        sm[L.wr + b] = wr;
        sm[L.wc + b] = wc;
        sm[L.wc2 + b] = norm2(wr, wc);
      }
    }
    // done with the pairs: the release orders this block's reads of them
    // before the peers' next pushes (after their next wait.acquire)
    cluster_arrive();
    __syncthreads();
    if (!p.table) {
      h_rows(hs, p.chunk, p.pp, P, coords + 2 * lo, two_s2,
             [&](int b, float& sr, float& sc, float& s2) {
               if (b >= nb || b0 + b >= bs) return false;
               sr = sm[L.wr + b];
               sc = sm[L.wc + b];
               s2 = sm[L.wc2 + b];
               return true;
             });
      __syncthreads();
    }

    // Phase B: a thread's 4 neurons x 4 columns over one run of samples;
    // the partials and running sums tile-major, so that neighbouring
    // threads touch neighbouring words
    const int quads = (nb + 3) / 4;
    for (int item = tid; item < tiles * p.slices; item += kThreads) {
      const int tile = item % tiles, s = item / tiles;
      const int jq = tile % pq, dq = tile / pq;
      if (4 * jq >= P) continue;
      float acc[4][4] = {}, dn[4] = {};
      const int q1 = (s + 1) * quads / p.slices;
      for (int q = s * quads / p.slices; q < q1; ++q) {
        const int4 kq = reinterpret_cast<const int4*>(key)[q];
        const int rows[4] = {kq.x, kq.y, kq.z, kq.w};
        float4 h[4], v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          h[u] = *reinterpret_cast<const float4*>(hs + rows[u] * p.pp +
                                                  4 * jq);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = *reinterpret_cast<const float4*>(
              xt + (dq + i * dq_n) * xp + 4 * q);
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // b = 4 q + u ascending
          const float hu[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xu = pick(v[i], u);
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k][i] = fmaf(hu[k], xu, acc[k][i]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) dn[k] = __fadd_rn(dn[k], hu[k]);
        }
      }
      if (p.slices > 1) {
        float* out = sm + L.pb + s * kPart * tiles + tile;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int i = 0; i < 4; ++i) out[(4 * k + i) * tiles] = acc[k][i];
          out[(16 + k) * tiles] = dn[k];
        }
        continue;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jq + k;
        if (j >= P) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = dq + i * dq_n;
          float* to = kResident ? num + (4 * k + i) * tiles + tile
                                : num + j * D + d;
          if (kResident || d < D) *to = __fadd_rn(*to, acc[k][i]);
        }
        if (dq == 0) den[j] = __fadd_rn(den[j], dn[k]);
      }
    }
    if (p.slices > 1) {  // the runs in order, then onto the running sums
      __syncthreads();
      // resident sums take every tile's parts (the unused ones are never
      // read); den only the tiles of column quad 0, whose tile is jq
      each_cell(kPart, tiles, [&](int part, int tile) {
        int j = 4 * tile + part - 16, d = 0;
        if (part < 16 && !kResident) {
          j = 4 * (tile % pq) + (part >> 2);
          d = tile / pq + (part & 3) * dq_n;
        }
        if (part < 16 ? !kResident && (j >= P || d >= D)
                      : tile >= pq || j >= P)
          return;
        const float* in = sm + L.pb + part * tiles + tile;
        float sum = in[0];
        for (int s = 1; s < p.slices; ++s)
          sum = __fadd_rn(sum, in[s * kPart * tiles]);
        float* to = part >= 16 ? den + j
                    : kResident ? num + part * tiles + tile
                                : num + j * D + d;
        *to = __fadd_rn(*to, sum);
      });
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int d = lane; d < D; d += 32) {
    const int dq = d % dq_n, i = d / dq_n;
    for (int j = warp; j < P; j += kThreads / 32) {
      const float wv = wl[j * wp + d], dn = den[j];
      const float nm =
          kResident ? num[(4 * (j & 3) + i) * tiles + j / 4 + pq * dq]
                    : num[j * D + d];
      new_w[static_cast<long long>(lo + j) * D + d] = __fadd_rn(
          wv, __fdiv_rn(__fmul_rn(alpha, __fsub_rn(nm, __fmul_rn(dn, wv))),
                        __fadd_rn(dn, 1.f)));
    }
  }
  cluster_wait();  // no rank writes into this block's memory any more
}

cudaLaunchConfig_t cluster_config(const SomPlan& p, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kRanks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Lets the plan's instantiation take more than 48 KB of shared memory on
// the current device, as the launch needs it (set on every such call: the
// attribute is per device).
cudaError_t allow_smem(const SomPlan& p) {
  if (p.smem <= 48 * 1024) return cudaSuccess;
  return p.resident
             ? cudaFuncSetAttribute(som_step_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    p.smem)
             : cudaFuncSetAttribute(som_step_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    p.smem);
}

}  // namespace

// One SOM step: x (B, D), w (N, D), coords (N, 2) f32, contiguous ->
// new_w (N, D) f32 and winner (B,) int32; rows b >= bs contribute nothing.
// Returns the cudaError_t of the launch (0 = success); bad sizes, and a
// shape whose smallest chunk does not fit a block's shared memory, return
// cudaErrorInvalidValue without launching.
extern "C" int znicz_som_step_f32(const void* x, const void* w,
                                  const void* coords, void* new_w,
                                  void* winner, int B, int N, int D, int bs,
                                  float alpha, float sigma, void* stream) {
  SomPlan p;
  if (B < 1 || N < 1 || D < 1 || !make_plan(B, N, D, p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(p, static_cast<cudaStream_t>(stream), &attr);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* cp = static_cast<const float*>(coords);
  float* op = static_cast<float*>(new_w);
  int* ip = static_cast<int*>(winner);
  err = p.resident
            ? cudaLaunchKernelEx(&cfg, som_step_kernel<true>, xp, wp, cp, op,
                                 ip, B, N, D, bs, alpha, sigma, p)
            : cudaLaunchKernelEx(&cfg, som_step_kernel<false>, xp, wp, cp,
                                 op, ip, B, N, D, bs, alpha, sigma, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a step at (B, N, D) into out[0..7]: per, pp, dp, chunk,
// slices, resident, table, smem bytes (kernels/kohonen.py som_plan is its
// twin).
extern "C" int znicz_som_plan(int B, int N, int D, int* out) {
  SomPlan p;
  if (B < 1 || N < 1 || D < 1 || !make_plan(B, N, D, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v[8] = {p.per,      p.pp,    p.dp,    p.chunk,
                    p.slices,   p.resident, p.table, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// How many clusters of the step's launch at (B, N, D) the card holds at
// once (cudaOccupancyMaxActiveClusters) into *out; 0 would never launch.
extern "C" int znicz_som_clusters(int B, int N, int D, int* out) {
  SomPlan p;
  if (B < 1 || N < 1 || D < 1 || !make_plan(B, N, D, p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, nullptr, &attr);
  return static_cast<int>(
      p.resident ? cudaOccupancyMaxActiveClusters(out, som_step_kernel<true>,
                                                  &cfg)
                 : cudaOccupancyMaxActiveClusters(out, som_step_kernel<false>,
                                                  &cfg));
}

extern "C" const char* znicz_kohonen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
