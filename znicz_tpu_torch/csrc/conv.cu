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
// of ~20 flop/byte, so 2*M*N*K / 67 TFLOP/s (bf16: / 989 TFLOP/s on the
// tensor cores, which these kernels do not use).
//
// Design (right and simple first; wgmma and TMA are later work): an
// implicit GEMM on the 128x128 tile of tile_f32.cuh, shared with gemm.cu
// (256 threads, each an 8x8 sub-tile of f32 sums in registers, the K loop
// over 8-deep tiles double-buffered in shared memory).  Nothing is
// materialized: the loaders gather each tile element from the
// NHWC tensor by index arithmetic (pixel and tap kept incrementally as the
// K loop advances) and read zeros outside the image, so no padded, dilated
// or phase-split copy exists in device memory.  The TPU kernels need those
// copies because Mosaic cannot slice with a stride and the MXU wants dense
// taps; a GPU thread computes the address instead.  f32 sums on the CUDA
// cores, no TF32, so the reference's f32 bands hold.  The bf16 forward is
// the same kernel with loaders that widen bf16 to f32 as they fill the f32
// tile; the epilogue adds the widened bias to the f32 sums and rounds once
// to bf16, as the Pallas kernel does (acc += b; acc.astype(y.dtype)).
//
//  forward:        M = n*oh*ow pixels, N = cout, K = ky*kx*cin in (iy, ix,
//                  ci) order, in which the HWIO weights already are a
//                  row-major (K, N) matrix; bias in the epilogue.
//  input gradient: M = input pixels, N = cin, K = taps*cout; w read
//                  transposed per tap from its stored layout.  At stride
//                  > 1 most taps of a pixel miss the output grid, so the
//                  pixels are split by their residue mod the stride
//                  (grid z): every tap of a residue class hits, none is
//                  wasted.  This is the GPU form of the TPU kernel's phase
//                  split.  A class that no tap reaches writes zeros.
//  weight gradient: M = ky*kx*cin (+1), N = cout, K = n*oh*ow.  M*N is
//                  small and K long, so K is split into S slices (grid z)
//                  that write f32 partials (S, M+1, N); a second kernel
//                  sums them in slice order.  Row M of A is all ones, so
//                  row M of the product is the bias gradient, summed in
//                  the same fixed order.  No atomics: two launches are
//                  bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tile_f32.cuh"

namespace {

using namespace znicz_tile;

struct ConvArgs {
  int n, h, w, cin;  // x (n, h, w, cin)
  int oh, ow, cout;  // y and its cotangent e (n, oh, ow, cout)
  int ky, kx, sy, sx, pt, pl;
};

// One row of a thread's sub-tile (+ bias) into a row of N elements at
// columns n_first..n_first+7, 16-byte stores where the row allows; bf16
// rows round each f32 sum once.
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&acc)[TN],
                                          const float (&bv)[TN], int n_first,
                                          int N, bool vec) {
  if (vec && n_first + TN <= N) {
    uint4 u;
    unsigned* words = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int j = 0; j < TN / 2; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[2 * j] + bv[2 * j], acc[2 * j + 1] + bv[2 * j + 1]);
      words[j] = *reinterpret_cast<const unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(row) = u;
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (n_first + j < N) row[j] = __float2bfloat16_rn(acc[j] + bv[j]);
  }
}

__device__ __forceinline__ void store_row(float* row, const float (&acc)[TN],
                                          const float (&bv)[TN], int n_first,
                                          int N, bool vec) {
  if (vec && n_first + TN <= N) {
    *reinterpret_cast<float4*>(row) = make_float4(
        acc[0] + bv[0], acc[1] + bv[1], acc[2] + bv[2], acc[3] + bv[3]);
    *reinterpret_cast<float4*>(row + 4) = make_float4(
        acc[4] + bv[4], acc[5] + bv[5], acc[6] + bv[6], acc[7] + bv[7]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (n_first + j < N) row[j] = acc[j] + bv[j];
  }
}

// ---------------------------------------------------------------- forward

// A (M x K) of the forward, gathered from x: row m = output pixel (n, oy,
// ox), column k = (iy, ix, ci), A = x[n, oy*sy + iy - pt, ox*sx + ix - pl,
// ci] or 0 outside the image.  k-contiguous: a thread loads 4 consecutive k
// of its pixel; with cin % 4 == 0 they are 4 channels of one tap (one load
// of 16 bytes in f32, 8 in bf16).  T: float or __nv_bfloat16.
template <class T>
struct FwdA {
  static constexpr bool kKC = true;
  const T* img;  // x of this thread's image
  int W, H, cin, kx, K;
  bool vec, row_ok;
  int h0, w0;          // the pixel's window origin in x
  int k, ci, ix, iy;   // this thread's first k of the next tile

  __device__ FwdA(const T* x, const ConvArgs& g, int m0, bool vec_)
      : W(g.w), H(g.h), cin(g.cin), kx(g.kx), K(g.ky * g.kx * g.cin),
        vec(vec_) {
    const int m = m0 + threadIdx.x / 2;
    const int per_img = g.oh * g.ow;
    row_ok = m < g.n * per_img;
    const int n = row_ok ? m / per_img : 0;
    const int r = m - n * per_img;
    h0 = (r / g.ow) * g.sy - g.pt;
    w0 = (r % g.ow) * g.sx - g.pl;
    img = x + static_cast<size_t>(n) * g.h * g.w * g.cin;
    k = (threadIdx.x % 2) * 4;
    ci = k % cin;
    const int tap = k / cin;
    ix = tap % kx;
    iy = tap / kx;
  }

  __device__ __forceinline__ float at(int kk, int c, int jx, int jy) const {
    const int h = h0 + jy, w = w0 + jx;
    if (!row_ok || kk >= K || h < 0 || h >= H || w < 0 || w >= W) return 0.f;
    return widen(img[(static_cast<size_t>(h) * W + w) * cin + c]);
  }

  __device__ __forceinline__ void load(float (&r)[4]) {
    if (vec) {
      const int h = h0 + iy, w = w0 + ix;
      if (row_ok && k < K && h >= 0 && h < H && w >= 0 && w < W)
        load4(r, img + (static_cast<size_t>(h) * W + w) * cin + ci);
      else
        zero4(r);
    } else {
      int c = ci, jx = ix, jy = iy;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = at(k + j, c, jx, jy);
        if (++c == cin) {
          c = 0;
          if (++jx == kx) {
            jx = 0;
            ++jy;
          }
        }
      }
    }
    k += BK;
    ci += BK;
    while (ci >= cin) {
      ci -= cin;
      if (++ix == kx) {
        ix = 0;
        ++iy;
      }
    }
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ y, ConvArgs g,
                bool vec_x, bool vec_w, bool vec_y) {
  const int M = g.n * g.oh * g.ow, N = g.cout, K = g.ky * g.kx * g.cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  FwdA<T> la(x, g, m0, vec_x);
  DenseTile<false, T> lb{w, N, K, n0, 0, vec_w};
  float acc[TM][TN];
  mainloop(la, lb, (K + BK - 1) / BK, acc);

  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  const int n_first = n0 + tx * TN;
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j)
    bv[j] = (bias != nullptr && n_first + j < N) ? widen(bias[n_first + j])
                                                 : 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) break;
    store_row(y + static_cast<size_t>(m) * N + n_first, acc[i], bv, n_first,
              N, vec_y);
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

// A (Mc x Kc) of the input gradient, gathered from e: row = input pixel
// (n, h, w) of the class, column (jy, jx, co); A = e[n, oy, ox, co] with
// oy = (h + pt - iy) / sy (exact in the class), or 0 off the output grid.
struct IgradA {
  static constexpr bool kKC = true;
  const float* img;  // e of this thread's image
  int oh, ow, cout, nx, Kc;
  bool vec, row_ok;
  int oy0, ox0;  // the output pixel that tap (jy, jx) = (0, 0) reads
  TapCursor t;

  __device__ IgradA(const float* e, const ConvArgs& g, const ResidueClass& c,
                    int m0, bool vec_)
      : oh(g.oh), ow(g.ow), cout(g.cout), nx(c.nx),
        Kc(c.ny * c.nx * g.cout), vec(vec_) {
    const int m = m0 + threadIdx.x / 2;
    const int per_img = c.hc * c.wc;
    row_ok = m < g.n * per_img;
    const int n = row_ok ? m / per_img : 0;
    const int r = m - n * per_img;
    const int h = c.h0 + (r / c.wc) * g.sy;
    const int w = c.w0 + (r % c.wc) * g.sx;
    oy0 = (h + g.pt - c.ry) / g.sy;
    ox0 = (w + g.pl - c.rx) / g.sx;
    img = e + static_cast<size_t>(n) * g.oh * g.ow * g.cout;
    t.start((threadIdx.x % 2) * 4, cout, nx > 0 ? nx : 1);
  }

  __device__ __forceinline__ const float* row(int kk, int jx, int jy) const {
    const int oy = oy0 - jy, ox = ox0 - jx;
    if (!row_ok || kk >= Kc || oy < 0 || oy >= oh || ox < 0 || ox >= ow)
      return nullptr;
    return img + (static_cast<size_t>(oy) * ow + ox) * cout;
  }

  __device__ __forceinline__ void load(float (&r)[4]) {
    if (vec) {
      const float* p = row(t.k, t.jx, t.jy);
      if (p)
        set4(r, *reinterpret_cast<const float4*>(p + t.co));
      else
        zero4(r);
    } else {
      TapCursor u = t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = row(u.k, u.jx, u.jy);
        r[j] = p ? p[u.co] : 0.f;
        u.step(1, cout, nx);
      }
    }
    t.step(BK, cout, nx);
  }
};

// B (Kc x cin) of the input gradient: B[(jy, jx, co), ci] = w[iy, ix, ci,
// co], the stored HWIO weights read transposed per tap (co contiguous).
struct IgradB {
  static constexpr bool kKC = true;
  const float* w;
  int cin, cout, kx, sy, sx, ry, rx, nx, Kc, ci;
  bool vec;
  TapCursor t;

  __device__ IgradB(const float* w_, const ConvArgs& g, const ResidueClass& c,
                    int n0, bool vec_)
      : w(w_), cin(g.cin), cout(g.cout), kx(g.kx), sy(g.sy), sx(g.sx),
        ry(c.ry), rx(c.rx), nx(c.nx), Kc(c.ny * c.nx * g.cout),
        ci(n0 + threadIdx.x / 2), vec(vec_) {
    t.start((threadIdx.x % 2) * 4, cout, nx > 0 ? nx : 1);
  }

  __device__ __forceinline__ const float* row(int kk, int jx, int jy) const {
    if (ci >= cin || kk >= Kc) return nullptr;
    const int tap = (ry + jy * sy) * kx + rx + jx * sx;
    return w + (static_cast<size_t>(tap) * cin + ci) * cout;
  }

  __device__ __forceinline__ void load(float (&r)[4]) {
    if (vec) {
      const float* p = row(t.k, t.jx, t.jy);
      if (p)
        set4(r, *reinterpret_cast<const float4*>(p + t.co));
      else
        zero4(r);
    } else {
      TapCursor u = t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = row(u.k, u.jx, u.jy);
        r[j] = p ? p[u.co] : 0.f;
        u.step(1, cout, nx);
      }
    }
    t.step(BK, cout, nx);
  }
};

__global__ void __launch_bounds__(kThreads)
conv_input_grad_kernel(const float* __restrict__ e,
                       const float* __restrict__ w, float* __restrict__ ei,
                       ConvArgs g, bool vec_e, bool vec_w, bool vec_o) {
  const ResidueClass c(g, blockIdx.z);
  const int Mc = g.n * c.hc * c.wc;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= Mc) return;  // the whole block: this class has fewer pixels
  IgradA la(e, g, c, m0, vec_e);
  IgradB lb(w, g, c, n0, vec_w);
  float acc[TM][TN];
  mainloop(la, lb, (c.ny * c.nx * g.cout + BK - 1) / BK, acc);

  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  const int n_first = n0 + tx * TN;
  const float zeros[TN] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int per_img = c.hc * c.wc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= Mc) break;
    const int n = m / per_img, r = m - n * per_img;
    const int h = c.h0 + (r / c.wc) * g.sy;
    const int wi = c.w0 + (r % c.wc) * g.sx;
    float* row =
        ei + ((static_cast<size_t>(n) * g.h + h) * g.w + wi) * g.cin + n_first;
    store_row(row, acc[i], zeros, n_first, g.cin, vec_o);
  }
}

// -------------------------------------------------------- weight gradient

// A ((M+1) x K) of the weight gradient, gathered from x: row m = (iy, ix,
// ci) for m < M = ky*kx*cin, row M all ones (its product row is the bias
// gradient); column k = pixel (n, oy, ox) of this split's K range; A =
// x[n, oy*sy + iy - pt, ox*sx + ix - pl, ci] or 0 outside the image.
// Outer-contiguous: a thread loads 4 consecutive m of one k; with cin % 4
// == 0 they are 4 channels of one tap (a float4).
struct WgradA {
  static constexpr bool kKC = false;
  const float* x;
  int H, W, cin, kx, oh, ow, sy, sx, pt, pl, M, kend;
  bool vec;
  int m, ci, ix, iy;  // this thread's first row
  int k, n, oy, ox;   // this thread's pixel of the next tile

  __device__ WgradA(const float* x_, const ConvArgs& g, int m0, int kbeg,
                    int kend_, bool vec_)
      : x(x_), H(g.h), W(g.w), cin(g.cin), kx(g.kx), oh(g.oh), ow(g.ow),
        sy(g.sy), sx(g.sx), pt(g.pt), pl(g.pl), M(g.ky * g.kx * g.cin),
        kend(kend_), vec(vec_) {
    m = m0 + (threadIdx.x % 32) * 4;
    ci = m % cin;
    const int tap = m / cin;
    ix = tap % kx;
    iy = tap / kx;
    k = kbeg + threadIdx.x / 32;
    const int per_img = oh * ow;
    n = k / per_img;
    const int r = k - n * per_img;
    oy = r / ow;
    ox = r % ow;
  }

  // row (tap jy, jx) of x at this thread's pixel, or null outside
  __device__ __forceinline__ const float* pixel(int jx, int jy) const {
    const int h = oy * sy + jy - pt, w = ox * sx + jx - pl;
    if (h < 0 || h >= H || w < 0 || w >= W) return nullptr;
    return x + ((static_cast<size_t>(n) * H + h) * W + w) * cin;
  }

  __device__ __forceinline__ void load(float (&r)[4]) {
    const bool ok_k = k < kend;
    if (vec && m < M) {  // M % 4 == 0 here: 4 channels of one tap
      const float* p = ok_k ? pixel(ix, iy) : nullptr;
      if (p)
        set4(r, *reinterpret_cast<const float4*>(p + ci));
      else
        zero4(r);
    } else {
      int c = ci, jx = ix, jy = iy;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = 0.f;
        if (ok_k && m + j < M) {
          const float* p = pixel(jx, jy);
          v = p ? p[c] : 0.f;
        } else if (ok_k && m + j == M) {
          v = 1.f;
        }
        r[j] = v;
        if (++c == cin) {
          c = 0;
          if (++jx == kx) {
            jx = 0;
            ++jy;
          }
        }
      }
    }
    k += BK;
    ox += BK;
    while (ox >= ow) {
      ox -= ow;
      if (++oy == oh) {
        oy = 0;
        ++n;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
conv_weight_grad_kernel(const float* __restrict__ x,
                        const float* __restrict__ e,
                        float* __restrict__ part, ConvArgs g, int per,
                        bool vec_x, bool vec_e, bool vec_p) {
  const int rows = g.ky * g.kx * g.cin + 1, N = g.cout;
  const int K = g.n * g.oh * g.ow;
  const int kbeg = blockIdx.z * per;
  const int kend = kbeg + per < K ? kbeg + per : K;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  WgradA la(x, g, m0, kbeg, kend, vec_x);
  DenseTile<false> lb{e + static_cast<size_t>(kbeg) * N, N, kend - kbeg,
                      n0, 0, vec_e};
  float acc[TM][TN];
  mainloop(la, lb, (kend - kbeg + BK - 1) / BK, acc);

  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  const int n_first = n0 + tx * TN;
  const float zeros[TN] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float* out = part + static_cast<size_t>(blockIdx.z) * rows * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= rows) break;
    store_row(out + static_cast<size_t>(m) * N + n_first, acc[i], zeros,
              n_first, N, vec_p);
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

template <class T>
int launch_fwd(const void* x, const void* w, const void* bias, void* y,
               const ConvArgs& g, void* stream) {
  if (bad_args(g)) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  const dim3 grid(tiles(static_cast<long long>(g.n) * g.oh * g.ow, BM),
                  tiles(g.cout, BN));
  // a row of TN outputs is one 16-byte store in f32 (two) and in bf16
  const bool vec_y = aligned16(yp) && g.cout % (16 / sizeof(T)) == 0;
  conv_fwd_kernel<T><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      xp, wp, static_cast<const T*>(bias), yp, g,
      aligned4(xp) && g.cin % 4 == 0, aligned4(wp) && g.cout % 4 == 0,
      vec_y);
  return static_cast<int>(cudaGetLastError());
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
  return launch_fwd<float>(
      x, w, bias, y,
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl), stream);
}

// The same on bf16 x, w, bias and y; f32 sums, one rounding a value.
extern "C" int znicz_conv2d_fwd_bf16(const void* x, const void* w,
                                     const void* bias, void* y, int n, int h,
                                     int wd, int cin, int oh, int ow,
                                     int cout, int ky, int kx, int sy,
                                     int sx, int pt, int pl, void* stream) {
  return launch_fwd<__nv_bfloat16>(
      x, w, bias, y,
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl), stream);
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
  // the largest residue class has ceil(h / sy) * ceil(w / sx) pixels
  const long long most = static_cast<long long>(n) * ((h + sy - 1) / sy) *
                         ((wd + sx - 1) / sx);
  const dim3 grid(tiles(most, BM), tiles(cin, BN), sy * sx);
  conv_input_grad_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ep, wp, op, g, aligned16(ep) && cout % 4 == 0,
      aligned16(wp) && cout % 4 == 0, aligned16(op) && cin % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

// gw (ky, kx, cin, cout) and gb (cout) of x and the cotangent e, K split
// into `splits` slices of `per` pixels (per % 8 == 0, splits * per >=
// n*oh*ow > (splits - 1) * per); part is scratch of splits * (ky*kx*cin +
// 1) * cout floats.
extern "C" int znicz_conv2d_weight_grad_f32(
    const void* x, const void* e, void* part, void* gw, void* gb, int n,
    int h, int wd, int cin, int oh, int ow, int cout, int ky, int kx, int sy,
    int sx, int pt, int pl, int splits, int per, void* stream) {
  const ConvArgs g =
      make_args(n, h, wd, cin, oh, ow, cout, ky, kx, sy, sx, pt, pl);
  const long long K = static_cast<long long>(n) * oh * ow;
  if (bad_args(g) || splits < 1 || per < 1 || per % BK != 0 ||
      static_cast<long long>(splits) * per < K ||
      static_cast<long long>(splits - 1) * per >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(e);
  float* pp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(ky) * kx * cin + 1;
  const dim3 grid(tiles(rows, BM), tiles(cout, BN), splits);
  conv_weight_grad_kernel<<<grid, kThreads, 0, s>>>(
      xp, ep, pp, g, per, aligned16(xp) && cin % 4 == 0,
      aligned16(ep) && cout % 4 == 0, aligned16(pp) && cout % 4 == 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_splits_kernel<<<blocks_for(rows * cout), 256, 0, s>>>(
      pp, splits, rows * cout, (rows - 1) * cout, static_cast<float*>(gw),
      static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* znicz_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
