// 2-D convolution forward, input gradient and weight gradient for Hopper
// (sm_90a), NHWC activations and HWIO weights: all three in float32, the
// forward also on bf16 operands (f32 sums, bf16 out).
//
// Replaces three Pallas calls of the JAX package:
//  - conv2d_im2col (znicz_tpu/ops/pallas/conv.py:97): y = conv(x, w) + b,
//    in f32 and in bf16;
//  - _adjoint_call (znicz_tpu/ops/pallas/conv_bwd.py:98), the input
//    gradient of conv2d_backward and the forward of deconv2d (:164);
//  - _grad_call (znicz_tpu/ops/pallas/conv_bwd.py:118), the weight and bias
//    gradients of conv2d_backward, and deconv2d_backward's (:180) weight
//    gradient with input and error swapped (its err_input is the forward).
// Geometry is the reference's: strides (sy, sx) and explicit top/left pads
// (pt, pl); the bottom/right pads only set the output size, which the
// caller passes as (oh, ow) for the forward and weight gradient and as
// (h, w) for the input gradient, so any output size is taken (deconv's
// slack or cropped out_shape).
//
// Bound: operations at AlexNet's shapes.  Each of the three is a GEMM of
// 27-115 GFLOP at batch 128 (conv1: 387200 x 96 x 363; conv2: 93312 x 256
// x 2400) over 40-150 MB of operands, far above the f32 CUDA cores' ridge
// of ~20 flop/byte, so 2*M*N*K / 67 TFLOP/s; bf16: / 989 TFLOP/s on the
// tensor cores, where conv1 (cin 3) is bound by its bytes instead.  At
// narrow channel counts the input gradient is bound by bytes too (the
// deconv forward to 3 channels: 20 MB for 0.2 GFLOP).
//
// Design.  Every kernel is an implicit GEMM: nothing is materialized, the
// loaders gather each tile from the NHWC tensors by index arithmetic and
// read zeros outside the image, so no padded, dilated or phase-split copy
// exists in device memory.  The TPU kernels need those copies because
// Mosaic cannot slice with a stride and the MXU wants dense taps; a GPU
// thread computes the address instead.  The f32 kernels sum on the CUDA
// cores (no TF32), so the reference's f32 bands hold.  No split without a
// fixed-order reduction and no atomics: two launches are bit-identical.
//
//  forward, f32:   the shared f32 loop of tile_f32.cuh (gemm.cu runs on
//                  it too): M = n*oh*ow pixels, N = cout, K = ky*kx*cin
//                  in (iy, ix, ci) order, in which the HWIO weights
//                  already are a row-major (K, N) matrix, fetched by
//                  cp.async; the im2col patch gathered through registers
//                  and stored transposed (GatherA), 16-byte loads of 4
//                  channels where cin % 4 == 0, one-float loads else
//                  (conv1's 3).  Tiles by cout and grid fill
//                  (fwd_f32_tile): N 64, 96 or 128, whichever pads cout
//                  least (conv1's 96 takes 96); M 128, or 64 where its
//                  grid fills the last wave of resident blocks (the
//                  card's own residency) better.  Bias in the epilogue.
//  forward, bf16:  the same GEMM on the tensor cores: two consumer
//                  warpgroups (BM = 128) issue wgmma m64nNk16 (bf16 in, f32
//                  sums) on 64-deep k tiles, 128-byte swizzled in shared
//                  memory, fed by all 256 threads through a 4-stage
//                  cp.async ring.  A (the im2col patch) is K-major: where
//                  cin % 8 == 0 one 16-byte copy carries 8 channels of one
//                  tap, a copy outside the image reads 0 bytes and writes
//                  zeros; else (conv1's cin 3) the threads gather 2-byte
//                  values through registers.  B (the weights) is N-major,
//                  read with the transpose bit, N tiles of 64/128/192/256
//                  chosen by cout (fwd_bf16_tile).  The epilogue adds the
//                  widened bias to the f32 sums, rounds once to bf16 (the
//                  Pallas kernel's acc += b; acc.astype(y.dtype)) and
//                  stores 16-byte rows staged through shared memory.
//  input gradient: M = input pixels, N = cin, K = taps*cout; w read
//                  transposed per tap from its stored layout.  At stride
//                  > 1 most taps of a pixel miss the output grid, so the
//                  pixels are split by their residue mod the stride
//                  (grid z): every tap of a residue class hits, none is
//                  wasted.  This is the GPU form of the TPU kernel's phase
//                  split.  A class that no tap reaches writes zeros.  The
//                  tile is chosen by cin (input_grad_tile): 256 x 8 up to
//                  8 channels (the deconv to 3 channels, a pass bound by
//                  its bytes), 128 x 32/64/96 up to 96, else 128 x 128.
//                  k tiles 32 deep (64 from 96 channels) come through a
//                  3-stage cp.async ring, 16 bytes (4 cout of one tap) a
//                  copy where cout % 4 == 0, stored k-contiguous with
//                  rows BK + 4 floats apart, so the inner product's
//                  float4 reads of consecutive rows hit distinct banks.
//  weight gradient: M = ky*kx*cin rows (iy, ix, ci), N = cout, K =
//                  n*oh*ow pixels.  M*N is small and K long, so K is split
//                  into S slices (grid z) that write f32 partials (S, M+1,
//                  N); a second kernel sums them in slice order.  Row M is
//                  the bias gradient: the blocks of row tile 0 also sum
//                  the staged e tiles' columns (no extra row of tiles for
//                  it).  Its own kernel, not the shared f32 tile: both
//                  operands are contiguous along the outer index (x's
//                  patch row of a pixel in (ix, ci) for each iy, e's row
//                  in cout), so 32-deep k tiles of pixels come through a
//                  3-stage cp.async ring as 16-byte copies (4 channels of
//                  one tap; one-float copies where cin % 4 != 0, conv1's
//                  3) straight into [k][outer] shared tiles, each loader
//                  row a pixel cursor stepping 32 pixels a tile.  Tiles
//                  128 or 64 by 128 or 64 by (rows, cout) (weight_grad_
//                  tile); S fills the last of at most 4 waves of resident
//                  blocks best (split_k; the card's own residency from
//                  cudaOccupancyMaxActiveBlocksPerMultiprocessor in
//                  znicz_conv2d_weight_grad_plan).
// Registers (ptxas, sm_90a), no spills: the f32 forward 125-147 (capped
// at 128 for 256 threads), two blocks of 256 threads an SM at 128 x 128
// and 128 x 96, three to six of the smaller tiles; the bf16 forward 100 /
// 155 / 203 / 245 at N 64 / 128 / 192 / 256, one block of 256 threads an
// SM; the input gradient 116 / 120 / 168 / 246 / 254 at N 8 / 32 / 64 /
// 96 / 128, one block an SM (two at N 8 and 32, by registers and shared
// memory); the weight gradient 173 / 167 at 128 x 128 (the one-float /
// 16-byte loader), one block an SM, 123 / 111 at 128 x 64 and 121 / 111
// at 64 x 128, two, and 79 at 64 x 64, three.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "tile_f32.cuh"

namespace {

using namespace znicz_hopper;
using namespace znicz_tile;

struct ConvArgs {
  int n, h, w, cin;  // x (n, h, w, cin)
  int oh, ow, cout;  // y and its cotangent e (n, oh, ow, cout)
  int ky, kx, sy, sx, pt, pl;
};

// k -> (iy, ix, ci) of the forward's K, kept incrementally: ci fastest.
struct FwdCursor {
  int k, ci, ix, iy;

  __device__ void start(int k_, int cin, int kx) {
    k = k_;
    ci = k % cin;
    const int tap = k / cin;
    ix = tap % kx;
    iy = tap / kx;
  }
  __device__ __forceinline__ void step(int by, int cin, int kx) {
    k += by;
    ci += by;
    while (ci >= cin) {
      ci -= cin;
      if (++ix == kx) {
        ix = 0;
        ++iy;
      }
    }
  }
};

// The window origin in x of output pixel m, and the offset of its image;
// ok false past the last pixel.
struct Window {
  int h0, w0, img;
  bool ok;

  __device__ Window(const ConvArgs& g, int m) {
    const int per_img = g.oh * g.ow;
    ok = m < g.n * per_img;
    const int n = ok ? m / per_img : 0;
    const int r = m - n * per_img;
    h0 = (r / g.ow) * g.sy - g.pt;
    w0 = (r % g.ow) * g.sx - g.pl;
    img = n * g.h * g.w * g.cin;
  }
  // the offset of tap (iy, ix) in x, or -1 outside the image
  __device__ __forceinline__ int at(const ConvArgs& g, int iy, int ix) const {
    const int h = h0 + iy, w = w0 + ix;
    if (!ok || h < 0 || h >= g.h || w < 0 || w >= g.w) return -1;
    return img + (h * g.w + w) * g.cin;
  }
};

// ----------------------------------------------------------- forward, f32

// A (M x K) of the forward, gathered from x through registers into the
// shared f32 loop's stages (the StagedLoader pattern): row m = output
// pixel (n, oy, ox), column k = (iy, ix, ci), A = x[n, oy*sy + iy - pt,
// ox*sx + ix - pl, ci] or 0 outside the image.  Thread t takes chunk
// column q = t % (kBK / 4) (4 k) of rows first + step p.  Each row's
// window (origin h0, w0 and the offset in x of its tap (0, 0)) is
// computed once into shared memory (`rows`), so a thread keeps one (ci,
// ix, iy) cursor for its chunk's first k, stepped kBK a tile by
// precomputed increments with two carries (no loop).  VEC (cin % 4 == 0,
// x 16-byte aligned): the 4 k are 4 channels of one tap, one 16-byte
// load; else (conv1's cin 3) 4 loads, each with its own tap.  Off the
// image reads nothing and stores zeros; rows past the last pixel have an
// origin no tap reaches.
template <class T, bool VEC>
struct GatherA {
  using C = Chunks<T::BM, T::kThreads, true>;
  const float* x;
  const int4* rows;      // the BM rows' windows: h0, w0, offset
  int H, W, cin, kx, K;
  int k, ci, ix, iy;     // the cursor at this thread's chunk's first k
  int dci, dix, diy;     // one k tile (kBK) in (ci, ix, iy)
  float v[C::kPasses][4];

  // the window of output pixel m (its rows entry)
  __device__ static int4 window(const ConvArgs& g, int m) {
    const int per_img = g.oh * g.ow;
    if (m >= g.n * per_img) return make_int4(-(1 << 29), 0, 0, 0);
    const int n = m / per_img, r = m - n * per_img;
    const int h0 = (r / g.ow) * g.sy - g.pt, w0 = (r % g.ow) * g.sx - g.pl;
    return make_int4(h0, w0, ((n * g.h + h0) * g.w + w0) * g.cin, 0);
  }

  __device__ GatherA(const float* x_, const int4* rows_, const ConvArgs& g)
      : x(x_), rows(rows_), H(g.h), W(g.w), cin(g.cin), kx(g.kx),
        K(g.ky * g.kx * g.cin) {
    k = 4 * C::q();
    ci = k % cin;
    ix = k / cin % kx;
    iy = k / cin / kx;
    dci = kBK % cin;
    dix = kBK / cin % kx;
    diy = kBK / cin / kx;
  }

  __device__ __forceinline__ static bool inside(int v, int size) {
    return static_cast<unsigned>(v) < static_cast<unsigned>(size);
  }

  __device__ __forceinline__ void fetch(float*) {
    const int tap = (iy * W + ix) * cin + ci;  // VEC: the chunk's offset
#pragma unroll
    for (int p = 0; p < C::kPasses; ++p) {
      const int row = C::row(p);
      const int4 win = rows[row < C::kRows ? row : 0];
      if (VEC) {
        const bool ok = k < K && inside(win.x + iy, H) && inside(win.y + ix, W);
        const float4 f = ok ? *reinterpret_cast<const float4*>(x + win.z + tap)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[p][0] = f.x;
        v[p][1] = f.y;
        v[p][2] = f.z;
        v[p][3] = f.w;
      } else {
        int c = ci, jx = ix, jy = iy;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k + e < K && inside(win.x + jy, H) &&
                          inside(win.y + jx, W);
          v[p][e] = ok ? x[win.z + (jy * W + jx) * cin + c] : 0.f;
          if (++c == cin) {
            c = 0;
            if (++jx == kx) {
              jx = 0;
              ++jy;
            }
          }
        }
      }
    }
    k += kBK;
    ci += dci;
    ix += dix;
    iy += diy;
    if (ci >= cin) {
      ci -= cin;
      ++ix;
    }
    if (ix >= kx) {
      ix -= kx;
      ++iy;
    }
  }

  __device__ __forceinline__ void store(float* stage) {
#pragma unroll
    for (int p = 0; p < C::kPasses; ++p)
      if (C::row(p) < C::kRows)
        store_kc<T::BM>(stage, C::row(p), C::q(), v[p]);
  }
};

// The forward's dynamic shared memory: the ring, then the rows' windows.
template <class T>
constexpr int fwd_f32_smem() {
  return T::kSmem + static_cast<int>(sizeof(int4)) * T::BM;
}

// y = conv(x, w) + bias on the shared f32 loop: A gathered (KC), B the
// HWIO weights as a row-major (K, cout) matrix (OC); bias in the
// epilogue, 16-byte stores of each row's two runs of 4 columns.
template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, kMinBlocks)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                ConvArgs g, bool vec_w, bool vec_y) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) float fwd_ring[];
  int4* rows = reinterpret_cast<int4*>(fwd_ring + kStages * (T::kA + T::kB));
  const int M = g.n * g.oh * g.ow, N = g.cout, K = g.ky * g.kx * g.cin;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  for (int r = threadIdx.x; r < T::BM; r += T::kThreads)
    rows[r] = GatherA<T, VEC>::window(g, m0 + r);
  __syncthreads();
  GatherA<T, VEC> la(x, rows, g);
  AsyncLoader<T, BN> lb{w, N, N, K, n0, 0, vec_w};
  float acc[TM][TN];
  mainloop<T>(fwd_ring, la, lb, (K + kBK - 1) / kBK, acc);

  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + col_of<T>(j);
    bv[j] = bias != nullptr && n < N ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + row_of<T>(i);
    if (m >= M) continue;
    float* row = y + static_cast<size_t>(m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns col_of(4h) .. + 3
      const int n = n0 + col_of<T>(4 * h);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * h + e] + bv[4 * h + e];
      if (vec_y && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = v[e];
      }
    }
  }
}

// ---------------------------------------------------------- forward, bf16

constexpr int kBfBM = 128, kBfBK = 64, kBfStages = 4, kBfThreads = 256;
constexpr uint32_t kRow = 128;              // bytes of a 64-element row
constexpr uint32_t kAtom = kBfBK * kRow;    // an MN-major atom: 64 k x 64 n
constexpr uint32_t kBfABytes = kBfBM * kRow;

template <int BN>
__host__ __device__ constexpr uint32_t bf_stage_bytes() {
  return kBfABytes + BN * kRow;
}
// the ring, and the slack that aligns it to the 1024-byte swizzle atom;
// the epilogue stages the 128 x (BN + 8) bf16 output tile in it
template <int BN>
__host__ __device__ constexpr size_t bf_smem() {
  return 1024 + kBfStages * bf_stage_bytes<BN>();
}

// byte offset of the 16-byte chunk c of row r of a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRow + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The next k tile of A into the stage at shared address `sa`: 128 rows
// (output pixels m0..) of 64 k.  vec: thread t copies chunk t % 8 (8
// channels of one tap) of rows t / 8 + 32 p; its cursor `c` is at that
// chunk's k and steps one tile.  Else thread t gathers the 32 k of half t
// % 2 of row t / 2 one value at a time (cursor at its first k).
struct BfA {
  const uint16_t* x;
  Window win[4];
  FwdCursor c;
  bool vec;

  __device__ BfA(const uint16_t* x_, const ConvArgs& g, int m0, bool vec_)
      : x(x_),
        win{Window(g, m0 + (vec_ ? threadIdx.x / 8 : threadIdx.x / 2)),
            Window(g, m0 + threadIdx.x / 8 + 32),
            Window(g, m0 + threadIdx.x / 8 + 64),
            Window(g, m0 + threadIdx.x / 8 + 96)},
        vec(vec_) {
    c.start(vec ? (threadIdx.x % 8) * 8 : (threadIdx.x % 2) * 32, g.cin,
            g.kx);
  }

  __device__ __forceinline__ void load(const ConvArgs& g, int K,
                                       uint32_t sa) {
    if (vec) {
      const int chunk = threadIdx.x % 8, r0 = threadIdx.x / 8;
      const bool kok = c.k < K;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int off = kok ? win[p].at(g, c.iy, c.ix) : -1;
        cp_async16(sa + swz(r0 + 32 * p, chunk),
                   off >= 0 ? x + off + c.ci : x, off >= 0 ? 16 : 0);
      }
      c.step(kBfBK, g.cin, g.kx);
    } else {
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      uint32_t v[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        uint16_t lo = 0, hi = 0;
        int off = c.k < K ? win[0].at(g, c.iy, c.ix) : -1;
        if (off >= 0) lo = x[off + c.ci];
        c.step(1, g.cin, g.kx);
        off = c.k < K ? win[0].at(g, c.iy, c.ix) : -1;
        if (off >= 0) hi = x[off + c.ci];
        c.step(1, g.cin, g.kx);
        v[j / 2] =
            static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w4[4] = {v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                v[4 * q + 3]};
        st_shared_v4(sa + swz(r, half * 4 + q), w4);
      }
      c.step(32, g.cin, g.kx);  // the other half's 32 k
    }
  }
};

// The k tile `kt` of B (the weights' rows kt*64.., columns n0..n0+BN)
// into the stage at `sb`, MN-major: BN / 64 atoms of 64 k rows x 128
// bytes.  vec (cout % 8 == 0): 16-byte copies of 8 columns; else one
// 2-byte value a store.
template <int BN>
__device__ __forceinline__ void bf_load_b(const uint16_t* w, int K, int N,
                                          int n0, int kt, bool vec,
                                          uint32_t sb) {
  const int k0 = kt * kBfBK;
  if (vec) {
    constexpr int kChunks = BN / 8;  // a row's 16-byte chunks
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
      const int q = threadIdx.x + kBfThreads * p;
      const int kr = q / kChunks, cc = q % kChunks;
      const int k = k0 + kr, n = n0 + cc * 8;
      const bool ok = k < K && n < N;
      cp_async16(sb + (cc / 8) * kAtom + swz(kr, cc % 8),
                 ok ? w + static_cast<size_t>(k) * N + n : w, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < BN / 4; ++p) {
      const int q = threadIdx.x + kBfThreads * p;
      const int kr = q / BN, nn = q % BN;
      const int k = k0 + kr, n = n0 + nn;
      const uint16_t v =
          k < K && n < N ? w[static_cast<size_t>(k) * N + n] : uint16_t(0);
      st_shared_u16(sb + (nn / 64) * kAtom + swz(kr, (nn % 64) / 8) +
                        (nn % 8) * 2,
                    v);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kBfThreads, 1)
conv_fwd_bf16_kernel(const uint16_t* __restrict__ x,
                     const uint16_t* __restrict__ w,
                     const uint16_t* __restrict__ bias,
                     uint16_t* __restrict__ y, ConvArgs g, bool vec_x,
                     bool vec_w, bool vec_y) {
  extern __shared__ __align__(1024) unsigned char bf_smem_raw[];
  const uint32_t raw = smem_u32(bf_smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int M = g.n * g.oh * g.ow, N = g.cout, K = g.ky * g.kx * g.cin;
  const int m0 = blockIdx.x * kBfBM, n0 = blockIdx.y * BN;
  const int nk = (K + kBfBK - 1) / kBfBK;
  constexpr uint32_t kStage = bf_stage_bytes<BN>();
  static_assert(kBfBM * (BN + 8) * 2 <= kBfStages * kStage,
                "the staged output tile fits in the ring");

  BfA la(x, g, m0, vec_x);
  auto load = [&](int kt) {
    const uint32_t sa = base + (kt % kBfStages) * kStage;
    la.load(g, K, sa);
    bf_load_b<BN>(w, K, N, n0, kt, vec_w, sa + kBfABytes);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int s = 0; s < kBfStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    // this thread's copies of tile kt have landed; after the barrier
    // everyone's have, and every warpgroup is done with tile kt - 1
    cp_async_wait<kBfStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t sa = base + (kt % kBfStages) * kStage;
    const uint32_t sb = sa + kBfABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBfBK / 16; ++kk)
      wgmma_ss<1>(acc, sw128(sa + wg * 64 * kRow + kk * 32),
                  sw128_mn(sb + kk * 16 * kRow, kAtom), 1);
    wgmma_commit();
    // tile kt + 3 into the stage tile kt - 1 left, while wgmma runs
    if (kt + kBfStages - 1 < nk) load(kt + kBfStages - 1);
    cp_async_commit();
    wgmma_wait<0>();
    reg_fence(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile there

  // accumulator entry 4j + e: row 16 (warp % 4) + lane / 4 + 8 (e >> 1)
  // of the warpgroup's 64, column 8j + 2 (lane % 4) + (e & 1)
  constexpr int kCs = BN + 8;  // staged row stride (bf16): no bank conflict
  const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  unsigned char* staged = bf_smem_raw + (base - raw);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4), n = n0 + col;
    const float b0 =
        bias != nullptr && n < N ? bf16_to_f32(bias[n]) : 0.f;
    const float b1 =
        bias != nullptr && n + 1 < N ? bf16_to_f32(bias[n + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(staged +
                                   ((row0 + 8 * h) * kCs + col) * 2) =
          pack_f32(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;
#pragma unroll
  for (int p = 0; p < kBfBM * kChunks / kBfThreads; ++p) {
    const int q = threadIdx.x + kBfThreads * p;
    const int r = q / kChunks, cc = q % kChunks;
    const int m = m0 + r, n = n0 + cc * 8;
    if (m >= M || n >= N) continue;
    const unsigned char* src = staged + (r * kCs + cc * 8) * 2;
    uint16_t* dst = y + static_cast<size_t>(m) * N + n;
    if (vec_y) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < N) dst[e] = s16[e];
    }
  }
}

// --------------------------------------------------------- input gradient

// The residue class of grid z: input pixels with (h + pt) % sy == ry and
// (w + pl) % sx == rx, and the taps iy = ry + jy*sy, ix = rx + jx*sx that
// reach them.
struct ResidueClass {
  int ry, rx, h0, w0, hc, wc, ny, nx;

  __device__ ResidueClass(const ConvArgs& g, int cls) {
    ry = cls / g.sx;
    rx = cls % g.sx;
    h0 = ((ry - g.pt) % g.sy + g.sy) % g.sy;  // first h of the class
    w0 = ((rx - g.pl) % g.sx + g.sx) % g.sx;
    hc = h0 < g.h ? (g.h - h0 + g.sy - 1) / g.sy : 0;
    wc = w0 < g.w ? (g.w - w0 + g.sx - 1) / g.sx : 0;
    ny = ry < g.ky ? (g.ky - ry + g.sy - 1) / g.sy : 0;
    nx = rx < g.kx ? (g.kx - rx + g.sx - 1) / g.sx : 0;
  }
};

// k -> (jy, jx, co) kept incrementally: co fastest, then jx, then jy.
struct TapCursor {
  int k, co, jx, jy;

  __device__ void start(int k_, int cout, int nx) {
    k = k_;
    co = k % cout;
    const int t = k / cout;
    jx = t % nx;
    jy = t / nx;
  }
  __device__ __forceinline__ void step(int by, int cout, int nx) {
    k += by;
    co += by;
    while (co >= cout) {
      co -= cout;
      if (++jx == nx) {
        jx = 0;
        ++jy;
      }
    }
  }
};

constexpr int kIgStages = 3;
constexpr int kIgThreads = 256;

// A tile shape of the input gradient: BM pixels x BN input channels, each
// thread TM x TN of them, over k tiles BK deep.  A thread's rows ty + RT i
// and columns tx + CT j are interleaved, so a warp's float4 reads of one
// k step fall on consecutive staged rows: with rows S = BK + 4 floats
// apart (S / 4 odd), 8 consecutive rows (a quarter warp's 128 bytes) hit
// 8 distinct 4-bank groups.  A loader pass fills Rows rows of Chunks
// 16-byte chunks.
template <int BM_, int BN_, int TM_, int TN_, int BK_>
struct IgTile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int RT = BM / TM, CT = BN / TN, S = BK + 4;
  static constexpr int Chunks = BK / 4, Rows = kIgThreads / Chunks;
  static_assert(RT * CT == kIgThreads, "256 threads a block");
  static_assert(BM % Rows == 0 && (S / 4) % 2 == 1, "whole loader passes");
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kIgStages * (BM + BN) * S;
};

// the family, by cin (input_grad_tile in kernels/conv.py is its twin):
// 64-deep k tiles from 96 channels (half the barriers); 32-deep below,
// where 64 halved the blocks an SM at N 8 and was no faster at N 64
using IgNarrow = IgTile<256, 8, 1, 8, 32>;  // cin <= 8: the deconv to 3
using IgN32 = IgTile<128, 32, 8, 2, 32>;
using IgN64 = IgTile<128, 64, 8, 4, 32>;
using IgN96 = IgTile<128, 96, 8, 6, 64>;
using IgWide = IgTile<128, 128, 8, 8, 64>;

int input_grad_bn(int cin) {
  return cin <= 8 ? 8 : cin <= 32 ? 32 : cin <= 64 ? 64 : cin <= 96 ? 96
                                                                     : 128;
}

// A (Mc x Kc), gathered from e: row = input pixel (n, h, w) of the class,
// column (jy, jx, co); A = e[n, oy, ox, co] with oy = (h + pt - iy) / sy
// (exact in the class), or 0 off the output grid.  B (Kc x cin): B[(jy,
// jx, co), ci] = w[iy, ix, ci, co], the stored HWIO weights read
// transposed per tap (co contiguous).  Both are staged k-contiguous, row
// by row: thread t fills the 4 k at column 4 (t % Chunks) of rows t /
// Chunks + Rows p of each stage.  vec (cout % 4 == 0, 16-byte aligned e
// and w): those 4 k are 4 channels of one tap, one 16-byte cp.async (0
// bytes read, zeros written, off the grid); else 4 loads and stores.
template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__(kIgThreads, 1)
conv_input_grad_kernel(const float* __restrict__ e,
                       const float* __restrict__ w, float* __restrict__ ei,
                       ConvArgs g, bool vec) {
  using T = IgTile<BM, BN, TM, TN, BK>;
  extern __shared__ __align__(16) float ig_smem[];
  const ResidueClass c(g, blockIdx.z);
  const int Mc = g.n * c.hc * c.wc;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  if (m0 >= Mc) return;  // the whole block: this class has fewer pixels
  const int Kc = c.ny * c.nx * g.cout;
  const int nk = (Kc + BK - 1) / BK;
  const int per_img = c.hc * c.wc;
  constexpr int S = T::S;
  float* As = ig_smem;                        // [stage][BM][S]
  float* Bs = ig_smem + kIgStages * BM * S;   // [stage][BN][S]

  constexpr int Rows = T::Rows;
  constexpr int AP = BM / Rows, BP = (BN + Rows - 1) / Rows;
  const int col = (threadIdx.x % T::Chunks) * 4;
  const int r0 = threadIdx.x / T::Chunks;
  int oy0[AP], ox0[AP], img[AP];  // the output pixel tap (0, 0) reads
#pragma unroll
  for (int p = 0; p < AP; ++p) {
    const int m = m0 + r0 + Rows * p;
    const int n = m < Mc ? m / per_img : 0, r = m - n * per_img;
    const int h = c.h0 + (r / c.wc) * g.sy, wi = c.w0 + (r % c.wc) * g.sx;
    oy0[p] = m < Mc ? (h + g.pt - c.ry) / g.sy : -(1 << 30);  // never in
    ox0[p] = (wi + g.pl - c.rx) / g.sx;
    img[p] = n * g.oh * g.ow * g.cout;
  }
  TapCursor t;
  t.start(col, g.cout, c.nx > 0 ? c.nx : 1);

  // the next k tile into stage s (tiles load in order; t is at its k)
  auto load = [&](int s) {
    float* as = As + s * BM * S + col;
    float* bs = Bs + s * BN * S + col;
    if (vec) {
      const bool kok = t.k < Kc;
      const int tap = (c.ry + t.jy * g.sy) * g.kx + c.rx + t.jx * g.sx;
#pragma unroll
      for (int p = 0; p < AP; ++p) {
        const int oy = oy0[p] - t.jy, ox = ox0[p] - t.jx;
        const bool ok = kok && oy >= 0 && oy < g.oh && ox >= 0 && ox < g.ow;
        cp_async16(smem_u32(as + (r0 + Rows * p) * S),
                   ok ? e + img[p] + (oy * g.ow + ox) * g.cout + t.co : e,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int p = 0; p < BP; ++p) {
        const int row = r0 + Rows * p, ci = n0 + row;
        if (row >= T::BN) break;
        const bool ok = kok && ci < g.cin;
        cp_async16(smem_u32(bs + row * S),
                   ok ? w + (static_cast<size_t>(tap) * g.cin + ci) * g.cout +
                            t.co
                      : w,
                   ok ? 16 : 0);
      }
    } else {
      TapCursor u = t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool kok = u.k < Kc;
        const int tap = (c.ry + u.jy * g.sy) * g.kx + c.rx + u.jx * g.sx;
#pragma unroll
        for (int p = 0; p < AP; ++p) {
          const int oy = oy0[p] - u.jy, ox = ox0[p] - u.jx;
          const bool ok =
              kok && oy >= 0 && oy < g.oh && ox >= 0 && ox < g.ow;
          as[(r0 + Rows * p) * S + j] =
              ok ? e[img[p] + (oy * g.ow + ox) * g.cout + u.co] : 0.f;
        }
#pragma unroll
        for (int p = 0; p < BP; ++p) {
          const int row = r0 + Rows * p, ci = n0 + row;
          if (row >= T::BN) break;
          bs[row * S + j] =
              kok && ci < g.cin
                  ? w[(static_cast<size_t>(tap) * g.cin + ci) * g.cout + u.co]
                  : 0.f;
        }
        u.step(1, g.cout, c.nx);
      }
    }
    t.step(BK, g.cout, c.nx > 0 ? c.nx : 1);
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  const int ty = threadIdx.x / T::CT, tx = threadIdx.x % T::CT;

#pragma unroll 1
  for (int s = 0; s < kIgStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed for everyone, and everyone is done with kt - 1,
    // whose stage the next load takes
    cp_async_wait<kIgStages - 2>();
    __syncthreads();
    if (kt + kIgStages - 1 < nk) load((kt + kIgStages - 1) % kIgStages);
    cp_async_commit();
    const float* as = As + (kt % kIgStages) * BM * S;
    const float* bs = Bs + (kt % kIgStages) * BN * S;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[T::TM];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (ty + T::RT * i) * S + k);
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + (tx + T::CT * j) * S + k);
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + ty + T::RT * i;
    if (m >= Mc) break;
    const int n = m / per_img, r = m - n * per_img;
    const int h = c.h0 + (r / c.wc) * g.sy, wi = c.w0 + (r % c.wc) * g.sx;
    float* row = ei + ((static_cast<size_t>(n) * g.h + h) * g.w + wi) * g.cin;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int ci = n0 + tx + T::CT * j;
      if (ci < g.cin) row[ci] = acc[i][j];
    }
  }
}

// -------------------------------------------------------- weight gradient

constexpr int kWgBK = 32, kWgStages = 3, kWgThreads = 256;
// the most waves of resident blocks the split-K schedule spreads over
constexpr int kWgMaxWaves = 4;

// A tile shape of the weight gradient: BM rows of (iy, ix, ci) x BN
// output channels, each thread TM x TN of them over k tiles kWgBK pixels
// deep.  Both operands are staged [k][outer] (x's patch row of a pixel
// and e's row are contiguous along the outer index), so a 16-byte copy
// lands 4 rows or 4 channels of one pixel with no transpose.  A thread's
// rows are ty*4 + 64 i + (0..3) and its columns tx*4 + 64 j + (0..3):
// its float4 reads of one k row are the warp's 16 consecutive float4s
// (B) or two broadcasts (A), free of bank conflicts.  MinBlocks is the
// residency the registers are capped for (__launch_bounds__).
template <int BM_, int BN_, int MinBlocks_>
struct WgTile {
  static constexpr int BM = BM_, BN = BN_, MinBlocks = MinBlocks_;
  static constexpr int TM = BM / 16, TN = BN / 16, RT = 16, CT = 16;
  static constexpr int CA = BM / 4, CB = BN / 4;  // 16-byte chunks a row
  static constexpr int PA = kWgThreads / CA, PB = kWgThreads / CB;
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kWgStages * kWgBK * (BM + BN);
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 reads");
  static_assert(kWgBK % PA == 0 && kWgBK % PB == 0, "whole loader passes");
  static_assert(RT * BN * 4 <= kSmem, "the bias sums fit in the ring");
};

// the family, by the product's shape (weight_grad_tile in kernels/conv.py
// is its twin): 128 wide where rows and cout allow, 64 where rows <= 64
// (build_deep's cin-3 layers) or cout <= 64
using WgWide = WgTile<128, 128, 1>;
using WgN64 = WgTile<128, 64, 2>;
using WgM64 = WgTile<64, 128, 2>;
using WgSmall = WgTile<64, 64, 3>;

// gw's partial of split blockIdx.z into part[z] (M+1 rows of N: rows
// (iy, ix, ci), then the bias).  A (M x K) gathered from x: row m = (iy,
// ix, ci), column k = pixel (n, oy, ox) of the split's K range, A = x[n,
// oy*sy + iy - pt, ox*sx + ix - pl, ci] or 0 outside the image.  B (K x
// N) = e's rows of those pixels.  Thread t copies A's chunk t % CA (4
// rows, one 16-byte copy of 4 channels of one tap where VA, cin % 4 ==
// 0; else 4 one-float copies) of pixel rows t / CA + PA p of each k
// tile, keeping a (n, oy, ox) cursor per row that steps kWgBK pixels a
// tile; a copy off the image reads 0 bytes and writes zeros.  The
// blocks of row tile 0 also sum each staged e column (k rows ty, ty +
// 16, ...), then over ty in order: the bias row of the partial.
template <int BM, int BN, int MinBlocks, bool VA>
__global__ void __launch_bounds__(kWgThreads, MinBlocks)
conv_weight_grad_kernel(const float* __restrict__ x,
                        const float* __restrict__ e,
                        float* __restrict__ part, ConvArgs g, int per,
                        bool vec_e, bool vec_p) {
  using T = WgTile<BM, BN, MinBlocks>;
  extern __shared__ __align__(16) float wg_smem[];
  float* As = wg_smem;                              // [stage][BK][BM]
  float* Bs = wg_smem + kWgStages * kWgBK * BM;     // [stage][BK][BN]
  const int M = g.ky * g.kx * g.cin, N = g.cout;
  const int K = g.n * g.oh * g.ow;
  const int kbeg = blockIdx.z * per;
  const int kend = kbeg + per < K ? kbeg + per : K;
  const int nk = (kend - kbeg + kWgBK - 1) / kWgBK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool bias_block = blockIdx.x == 0;

  // this thread's A chunk: rows m..m+3, each a tap (dy, dx) and channel
  constexpr int AP = kWgBK / T::PA, BP = kWgBK / T::PB;
  const int ca = threadIdx.x % T::CA, ra = threadIdx.x / T::CA;
  const int m = m0 + 4 * ca;
  int dy[VA ? 1 : 4], dx[VA ? 1 : 4], ci[VA ? 1 : 4];
  bool mok[VA ? 1 : 4];
#pragma unroll
  for (int j = 0; j < (VA ? 1 : 4); ++j) {
    const int mm = m + j;
    ci[j] = mm % g.cin;
    const int tap = mm / g.cin;
    dx[j] = tap % g.kx;
    dy[j] = tap / g.kx;
    mok[j] = mm < M;
  }
  // the pixel cursors of rows ra + PA p: k, and (n, oy, ox) of it
  int pk[AP], pn[AP], py[AP], px[AP];
  const int per_img = g.oh * g.ow;
#pragma unroll
  for (int p = 0; p < AP; ++p) {
    pk[p] = kbeg + ra + T::PA * p;
    pn[p] = pk[p] / per_img;
    const int r = pk[p] - pn[p] * per_img;
    py[p] = r / g.ow;
    px[p] = r - py[p] * g.ow;
  }
  const int cb = threadIdx.x % T::CB, rb = threadIdx.x / T::CB;
  int kb = kbeg + rb;  // e's pixel of B row rb of the next tile

  // the next k tile into stage s (tiles load in order)
  auto load = [&](int s) {
    const uint32_t as = smem_u32(As + s * kWgBK * BM + 4 * ca);
#pragma unroll
    for (int p = 0; p < AP; ++p) {
      const uint32_t dst = as + (ra + T::PA * p) * BM * 4;
      const bool kok = pk[p] < kend;
      const int h0 = py[p] * g.sy - g.pt, w0 = px[p] * g.sx - g.pl;
      const float* img = x + static_cast<size_t>(pn[p]) * g.h * g.w * g.cin;
#pragma unroll
      for (int j = 0; j < (VA ? 1 : 4); ++j) {
        const int hh = h0 + dy[j], ww = w0 + dx[j];
        const bool ok = kok && mok[j] && hh >= 0 && hh < g.h && ww >= 0 &&
                        ww < g.w;
        const float* src = img + (hh * g.w + ww) * g.cin + ci[j];
        if (VA)
          cp_async16(dst, ok ? src : x, ok ? 16 : 0);
        else
          cp_async4(dst + 4 * j, ok ? src : x, ok ? 4 : 0);
      }
      pk[p] += kWgBK;
      px[p] += kWgBK;
      while (px[p] >= g.ow) {
        px[p] -= g.ow;
        if (++py[p] == g.oh) {
          py[p] = 0;
          ++pn[p];
        }
      }
    }
    const uint32_t bs = smem_u32(Bs + s * kWgBK * BN + 4 * cb);
    const int n = n0 + 4 * cb;
#pragma unroll
    for (int p = 0; p < BP; ++p) {
      const uint32_t dst = bs + (rb + T::PB * p) * BN * 4;
      const int k = kb + T::PB * p;
      const float* src = e + static_cast<size_t>(k) * N + n;
      if (vec_e) {
        const bool ok = k < kend && n < N;
        cp_async16(dst, ok ? src : e, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = k < kend && n + j < N;
          cp_async4(dst + 4 * j, ok ? src + j : e, ok ? 4 : 0);
        }
      }
    }
    kb += kWgBK;
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  float bsum[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) bsum[j] = 0.f;
  const int ty = threadIdx.x / T::CT, tx = threadIdx.x % T::CT;

#pragma unroll 1
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed for everyone, and everyone is done with kt - 1,
    // whose stage the next load takes
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (kt + kWgStages - 1 < nk) load((kt + kWgStages - 1) % kWgStages);
    cp_async_commit();
    const float* as = As + (kt % kWgStages) * kWgBK * BM + ty * 4;
    const float* bs = Bs + (kt % kWgStages) * kWgBK * BN + tx * 4;
#pragma unroll
    for (int k = 0; k < kWgBK; ++k) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * BM + 64 * i);
        a[4 * i] = v.x;
        a[4 * i + 1] = v.y;
        a[4 * i + 2] = v.z;
        a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < T::TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + 64 * j);
        b[4 * j] = v.x;
        b[4 * j + 1] = v.y;
        b[4 * j + 2] = v.z;
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (bias_block) {
#pragma unroll
      for (int k = 0; k < kWgBK / T::RT; ++k)
#pragma unroll
        for (int j = 0; j < T::TN / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (ty + T::RT * k) * BN + 64 * j);
          bsum[4 * j] += v.x;
          bsum[4 * j + 1] += v.y;
          bsum[4 * j + 2] += v.z;
          bsum[4 * j + 3] += v.w;
        }
    }
  }
  cp_async_wait<0>();

  float* out = part + static_cast<size_t>(blockIdx.z) * (M + 1) * N;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = m0 + ty * 4 + 64 * (i / 4) + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < T::TN / 4; ++j) {
      const int n = n0 + tx * 4 + 64 * j;
      float* dst = out + static_cast<size_t>(row) * N + n;
      if (vec_p && n < N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (n + jj < N) dst[jj] = acc[i][4 * j + jj];
      }
    }
  }
  if (bias_block) {  // uniform over the block
    __syncthreads();  // every warp is done with the ring
    float* red = wg_smem;  // [RT][BN]
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      red[ty * BN + tx * 4 + 64 * (j / 4) + j % 4] = bsum[j];
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += kWgThreads) {
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < T::RT; ++r) v += red[r * BN + c];
      if (n0 + c < N) out[static_cast<size_t>(M) * N + n0 + c] = v;
    }
  }
}

// gw and gb from the (S, M+1, N) partials, each sum in slice order.
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ part, int splits,
                     long long rows_n, long long m_n,
                     float* __restrict__ gw, float* __restrict__ gb) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows_n; i += stride) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[s * rows_n + i];
    if (i < m_n)
      gw[i] = acc;
    else
      gb[i - m_n] = acc;
  }
}

ConvArgs make_args(int n, int h, int w, int cin, int oh, int ow, int cout,
                   int ky, int kx, int sy, int sx, int pt, int pl) {
  return ConvArgs{n, h, w, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl};
}

bool bad_args(const ConvArgs& g) {
  return g.n < 1 || g.h < 1 || g.w < 1 || g.cin < 1 || g.oh < 1 ||
         g.ow < 1 || g.cout < 1 || g.ky < 1 || g.kx < 1 || g.sy < 1 ||
         g.sx < 1 || g.pt < 0 || g.pl < 0;
}

unsigned tiles(long long items, int per) {
  return static_cast<unsigned>((items + per - 1) / per);
}

// The f32 forward's N tile for `cout` output channels: the first of 64,
// 96 and 128 that holds cout, or above 128 the one of 128, 96 and 64
// that pads cout least, the wider on a tie.
int fwd_f32_bn(int cout) {
  if (cout <= 64) return 64;
  if (cout <= 96) return 96;
  if (cout <= 128) return 128;
  int best = 128;
  for (int bn = 96; bn >= 64; bn -= 32)
    if (tiles(cout, bn) * bn < tiles(cout, best) * best) best = bn;
  return best;
}

// Blocks an SM on this card of the BM x BN forward with the VEC gather.
template <int BM, int BN, bool VEC>
int fwd_blocks() {
  using T = Tile<BM, BN>;
  return blocks_per_sm(conv_fwd_kernel<BM, BN, VEC>, T::kThreads,
                       fwd_f32_smem<T>());
}

template <int BM, int BN>
int fwd_blocks(bool vec) {
  return vec ? fwd_blocks<BM, BN, true>() : fwd_blocks<BM, BN, false>();
}

int fwd_blocks(int bm, int bn, bool vec) {
  switch (bm * 1000 + bn) {
    case 128064: return fwd_blocks<128, 64>(vec);
    case 128096: return fwd_blocks<128, 96>(vec);
    case 128128: return fwd_blocks<128, 128>(vec);
    case 64064: return fwd_blocks<64, 64>(vec);
    case 64096: return fwd_blocks<64, 96>(vec);
    default: return fwd_blocks<64, 128>(vec);
  }
}

// Blocks an SM of the BM x BN forward: the fewer of its two gathers', so
// that the tile is a function of the shape.  Asked of the card once a
// tile and process (every launch plans its tile; the answers stay).
int fwd_residency(int bm, int bn) {
  static int cache[2][3];  // [BM 64, 128][BN 64, 96, 128]; 0: not asked
  int& r = cache[bm == 128][(bn - 64) / 32];
  if (r == 0) {
    const int a = fwd_blocks(bm, bn, true), b = fwd_blocks(bm, bn, false);
    r = a < b ? a : b;
  }
  return r;
}

// The fill of the last of the waves that `t` tiles take, `wave` blocks
// resident at once, as the fraction t / (waves * wave): true if (ta,
// wave_a) fills strictly better than (tb, wave_b).
bool fills_better(long long ta, long long wave_a, long long tb,
                  long long wave_b) {
  const long long ra = (ta + wave_a - 1) / wave_a * wave_a;
  const long long rb = (tb + wave_b - 1) / wave_b * wave_b;
  return ta * rb > tb * ra;
}

// The f32 forward's tile for m output pixels and cout channels
// (fwd_f32_tile in kernels/conv.py is its twin): N by cout
// (fwd_f32_bn); M 128, or 64 where its grid fills its last wave of
// resident blocks strictly better.  out = {BM, BN, blocks an SM}.
void fwd_f32_plan(long long m, int cout, int* out) {
  const int bn = fwd_f32_bn(cout), sms = sm_count();
  const long long nt = tiles(cout, bn);
  int res[2] = {fwd_residency(128, bn), fwd_residency(64, bn)};
  for (int& r : res) r = r > 0 ? r : 1;  // 0: the launch itself will fail
  const long long t128 = tiles(m, 128) * nt, t64 = tiles(m, 64) * nt;
  const bool small = fills_better(t64, static_cast<long long>(sms) * res[1],
                                  t128, static_cast<long long>(sms) * res[0]);
  out[0] = small ? 64 : 128;
  out[1] = bn;
  out[2] = res[small ? 1 : 0];
}

template <int BM, int BN>
cudaError_t fwd_f32(const float* x, const float* w, const float* bias,
                    float* y, const ConvArgs& g, cudaStream_t s) {
  using T = Tile<BM, BN>;
  const dim3 grid(tiles(static_cast<long long>(g.n) * g.oh * g.ow, BM),
                  tiles(g.cout, BN));
  const bool vw = aligned16(w) && g.cout % 4 == 0;
  const bool vy = aligned16(y) && g.cout % 4 == 0;
  if (aligned16(x) && g.cin % 4 == 0)
    return launch(conv_fwd_kernel<BM, BN, true>, grid, T::kThreads,
                  fwd_f32_smem<T>(), s, x, w, bias, y, g, vw, vy);
  return launch(conv_fwd_kernel<BM, BN, false>, grid, T::kThreads,
                fwd_f32_smem<T>(), s, x, w, bias, y, g, vw, vy);
}

int launch_fwd_f32(const void* x, const void* w, const void* bias, void* y,
                   const ConvArgs& g, void* stream) {
  if (bad_args(g)) return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int plan[3];
  fwd_f32_plan(static_cast<long long>(g.n) * g.oh * g.ow, g.cout, plan);
  cudaError_t err;
  switch (plan[0] * 1000 + plan[1]) {
    case 128064: err = fwd_f32<128, 64>(xp, wp, bp, yp, g, s); break;
    case 128096: err = fwd_f32<128, 96>(xp, wp, bp, yp, g, s); break;
    case 64096: err = fwd_f32<64, 96>(xp, wp, bp, yp, g, s); break;
    case 128128: err = fwd_f32<128, 128>(xp, wp, bp, yp, g, s); break;
    case 64064: err = fwd_f32<64, 64>(xp, wp, bp, yp, g, s); break;
    default: err = fwd_f32<64, 128>(xp, wp, bp, yp, g, s);
  }
  return static_cast<int>(err);
}

// The N tile of the bf16 forward: the least padded cout, the wider tile
// on a tie (fwd_bf16_tile in kernels/conv.py is its twin).
int fwd_bf16_bn(int cout) {
  if (cout <= 64) return 64;
  if (cout <= 128) return 128;
  if (cout <= 192) return 192;
  if (cout <= 256) return 256;
  int best = 256;
  for (int bn = 192; bn >= 128; bn -= 64)
    if ((cout + bn - 1) / bn * bn < (cout + best - 1) / best * best)
      best = bn;
  return best;
}

template <int BN>
cudaError_t fwd_bf16(const uint16_t* x, const uint16_t* w,
                     const uint16_t* bias, uint16_t* y, const ConvArgs& g,
                     cudaStream_t s) {
  const dim3 grid(tiles(static_cast<long long>(g.n) * g.oh * g.ow, kBfBM),
                  tiles(g.cout, BN));
  return launch(conv_fwd_bf16_kernel<BN>, grid, kBfThreads,
                bf_smem<BN>(), s, x, w, bias, y, g,
                aligned16(x) && g.cin % 8 == 0,
                aligned16(w) && g.cout % 8 == 0,
                aligned16(y) && g.cout % 8 == 0);
}

template <class T>
cudaError_t input_grad(const float* e, const float* w, float* ei,
                       const ConvArgs& g, cudaStream_t s) {
  // the largest residue class has ceil(h / sy) * ceil(w / sx) pixels
  const long long most = static_cast<long long>(g.n) *
                         ((g.h + g.sy - 1) / g.sy) * ((g.w + g.sx - 1) / g.sx);
  const dim3 grid(tiles(most, T::BM), tiles(g.cin, T::BN), g.sy * g.sx);
  return launch(conv_input_grad_kernel<T::BM, T::BN, T::TM, T::TN, T::BK>,
                grid,
                kIgThreads, T::kSmem, s, e, w, ei, g,
                aligned16(e) && aligned16(w) && g.cout % 4 == 0);
}

// The weight gradient's tile for M = ky*kx*cin rows and cout
// (weight_grad_tile in kernels/conv.py is its twin): 0 WgWide, 1 WgN64,
// 2 WgM64, 3 WgSmall.
int weight_grad_code(int M, int cout) {
  return M > 64 ? (cout > 64 ? 0 : 1) : (cout > 64 ? 2 : 3);
}

template <class T, bool VA>
constexpr auto wg_kernel() {
  return conv_weight_grad_kernel<T::BM, T::BN, T::MinBlocks, VA>;
}

template <class T>
void wg_tile(int* bm, int* bn, int* per_sm) {
  *bm = T::BM;
  *bn = T::BN;
  // both loaders' instantiations must agree (the smoke checks it)
  const int a = blocks_per_sm(wg_kernel<T, true>(), kWgThreads, T::kSmem);
  const int b = blocks_per_sm(wg_kernel<T, false>(), kWgThreads, T::kSmem);
  *per_sm = a == b ? a : -1;
}

template <class T>
cudaError_t weight_grad(const float* x, const float* e, float* part,
                        const ConvArgs& g, int splits, int per,
                        cudaStream_t s) {
  const dim3 grid(tiles(static_cast<long long>(g.ky) * g.kx * g.cin, T::BM),
                  tiles(g.cout, T::BN), splits);
  const bool ve = aligned16(e) && g.cout % 4 == 0;
  const bool vp = aligned16(part) && g.cout % 4 == 0;
  if (aligned16(x) && g.cin % 4 == 0)
    return launch(wg_kernel<T, true>(), grid, kWgThreads, T::kSmem, s, x, e,
                  part, g, per, ve, vp);
  return launch(wg_kernel<T, false>(), grid, kWgThreads, T::kSmem, s, x, e,
                part, g, per, ve, vp);
}

}  // namespace

// Each entry returns the cudaError_t of its launches (0 = success); bad
// geometry returns cudaErrorInvalidValue without launching.  All tensors
// are contiguous, f32 unless the name says bf16: x (n, h, w, cin), w (ky,
// kx, cin, cout), y and e (n, oh, ow, cout), bias and gb (cout).

// y = conv(x, w) + bias (bias may be null).
extern "C" int znicz_conv2d_fwd_f32(const void* x, const void* w,
                                    const void* bias, void* y, int n, int h,
                                    int wd, int cin, int oh, int ow,
                                    int cout, int ky, int kx, int sy, int sx,
                                    int pt, int pl, void* stream) {
  return launch_fwd_f32(
      x, w, bias, y,
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl), stream);
}

// The same on bf16 x, w, bias and y; f32 sums, one rounding a value.
extern "C" int znicz_conv2d_fwd_bf16(const void* x, const void* w,
                                     const void* bias, void* y, int n, int h,
                                     int wd, int cin, int oh, int ow,
                                     int cout, int ky, int kx, int sy,
                                     int sx, int pt, int pl, void* stream) {
  const ConvArgs g =
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl);
  if (bad_args(g)) return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const uint16_t* wp = static_cast<const uint16_t*>(w);
  const uint16_t* bp = static_cast<const uint16_t*>(bias);
  uint16_t* yp = static_cast<uint16_t*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fwd_bf16_bn(cout)) {
    case 64:
      err = fwd_bf16<64>(xp, wp, bp, yp, g, s);
      break;
    case 128:
      err = fwd_bf16<128>(xp, wp, bp, yp, g, s);
      break;
    case 192:
      err = fwd_bf16<192>(xp, wp, bp, yp, g, s);
      break;
    default:
      err = fwd_bf16<256>(xp, wp, bp, yp, g, s);
  }
  return static_cast<int>(err);
}

// The bf16 forward's N tile for `cout` output channels.
extern "C" int znicz_conv2d_fwd_bf16_tile(int cout) {
  return fwd_bf16_bn(cout);
}

// The f32 forward's tile for m = n*oh*ow output pixels and cout
// channels, as this card runs it: out = {BM, BN, resident blocks an SM}.  kernels/conv.py
// fwd_f32_tile computes the same from its table of residencies; the
// smoke holds one against the other.
extern "C" int znicz_conv2d_fwd_f32_plan(long long m, int cout, int* out) {
  if (m < 1 || cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  fwd_f32_plan(m, cout, out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM on this card of the f32 forward's (bm, bn) tile
// with the 16-byte (vec 1) or the one-float (vec 0) gather; the plan
// takes the fewer of the two.  0 for no such tile.
extern "C" int znicz_conv2d_fwd_f32_residency(int bm, int bn, int vec) {
  if ((bm != 64 && bm != 128) || (bn != 64 && bn != 96 && bn != 128))
    return 0;
  return fwd_blocks(bm, bn, vec != 0);
}

// ei (n, h, w, cin) = the input gradient of the cotangent e (n, oh, ow,
// cout); (h, w, pt, pl) give the input geometry.
extern "C" int znicz_conv2d_input_grad_f32(const void* e, const void* w,
                                           void* ei, int n, int h, int wd,
                                           int cin, int oh, int ow, int cout,
                                           int ky, int kx, int sy, int sx,
                                           int pt, int pl, void* stream) {
  const ConvArgs g =
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl);
  if (bad_args(g)) return static_cast<int>(cudaErrorInvalidValue);
  const float* ep = static_cast<const float*>(e);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(ei);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (input_grad_bn(cin)) {
    case 8:
      err = input_grad<IgNarrow>(ep, wp, op, g, s);
      break;
    case 32:
      err = input_grad<IgN32>(ep, wp, op, g, s);
      break;
    case 64:
      err = input_grad<IgN64>(ep, wp, op, g, s);
      break;
    case 96:
      err = input_grad<IgN96>(ep, wp, op, g, s);
      break;
    default:
      err = input_grad<IgWide>(ep, wp, op, g, s);
  }
  return static_cast<int>(err);
}

// The input gradient's N tile (its M tile: 256 at N 8, else 128) for
// `cin` input channels.
extern "C" int znicz_conv2d_input_grad_tile(int cin) {
  return input_grad_bn(cin);
}

// gw (ky, kx, cin, cout) and gb (cout) of x and the cotangent e, K split
// into `splits` slices of `per` pixels (per % 32 == 0, splits * per >=
// n*oh*ow > (splits - 1) * per); part is scratch of splits * (ky*kx*cin +
// 1) * cout floats.
extern "C" int znicz_conv2d_weight_grad_f32(
    const void* x, const void* e, void* part, void* gw, void* gb, int n,
    int h, int wd, int cin, int oh, int ow, int cout, int ky, int kx, int sy,
    int sx, int pt, int pl, int splits, int per, void* stream) {
  const ConvArgs g =
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl);
  const long long K = static_cast<long long>(n) * oh * ow;
  if (bad_args(g) || splits < 1 || splits > 65535 || per < 1 ||
      per % kWgBK != 0 || static_cast<long long>(splits) * per < K ||
      static_cast<long long>(splits - 1) * per >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(e);
  float* pp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = ky * kx * cin;
  cudaError_t err;
  switch (weight_grad_code(M, cout)) {
    case 0:
      err = weight_grad<WgWide>(xp, ep, pp, g, splits, per, s);
      break;
    case 1:
      err = weight_grad<WgN64>(xp, ep, pp, g, splits, per, s);
      break;
    case 2:
      err = weight_grad<WgM64>(xp, ep, pp, g, splits, per, s);
      break;
    default:
      err = weight_grad<WgSmall>(xp, ep, pp, g, splits, per, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(M) + 1;
  reduce_splits_kernel<<<blocks_for(rows * cout), 256, 0, s>>>(
      pp, splits, rows * cout, (rows - 1) * cout, static_cast<float*>(gw),
      static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}

// The weight gradient's schedule for a product of `rows` = ky*kx*cin + 1
// rows (the partials' rows), cout columns and k pixels, as this card
// runs it: out = {BM, BN, resident blocks an SM (-1 if the two loaders'
// instantiations differ), splits, per}.  kernels/conv.py split_k computes
// the same from its table of residencies; the smoke holds one against the
// other.
extern "C" int znicz_conv2d_weight_grad_plan(int rows, int cout, int k,
                                             int* out) {
  if (rows < 2 || cout < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int bm, bn, per_sm;
  switch (weight_grad_code(rows - 1, cout)) {
    case 0:
      wg_tile<WgWide>(&bm, &bn, &per_sm);
      break;
    case 1:
      wg_tile<WgN64>(&bm, &bn, &per_sm);
      break;
    case 2:
      wg_tile<WgM64>(&bm, &bn, &per_sm);
      break;
    default:
      wg_tile<WgSmall>(&bm, &bn, &per_sm);
  }
  const int sms = sm_count();
  const long long t = static_cast<long long>(tiles(rows - 1, bm)) *
                      tiles(cout, bn);
  const long long k_tiles = (k + kWgBK - 1) / kWgBK;
  const long long splits = whole_wave_splits(
      t, static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1), k_tiles,
      kWgMaxWaves);
  const long long per = (k_tiles + splits - 1) / splits * kWgBK;
  out[0] = bm;
  out[1] = bn;
  out[2] = per_sm;
  out[3] = static_cast<int>((k + per - 1) / per);
  out[4] = static_cast<int>(per);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
