// Blot gather (kernel B2): sample one image at a batch of coordinate grids.
//
// Replaces the Pallas TPU kernel subpixal_tpu/kernels/blot.py ·
// sample_cutouts_pallas (its pl.pallas_call at kernels/blot.py:283, body
// _blot_kernel, weights _band_matrix_t / _tap_weight). A vector machine
// has no fast scalar gather, so that kernel DMA's a static tile per cutout
// and writes the separable interpolation as banded one-hot matrix products
// on the MXU. Hopper gathers through its caches, so the matrix form has no
// reason to exist here.
//
// Design: one thread per output pixel of the flattened (B, h, w) batch,
// grid-stride. Each thread takes floor and fraction of its coordinate per
// axis, the per-axis tap weights by the formulas of
// subpixal_tpu_torch/ops/interp.py · _axis_weights (the plain version),
// and reads its K x K footprint through __ldg. It writes the value, or
// `fill`, and a validity byte: valid means the whole footprint lies inside
// the image. There is no tile, so nothing can escape one: the wrapper's
// per-cutout `escaped` counts are zeros by construction. spline3 samples
// B-spline coefficients; the prefilter stays plain torch outside the
// kernel, as the JAX package runs it as XLA outside Pallas.
//
// Weights: the Lagrange basis (poly3, poly5) in product form,
// w_i = c_i * prod_{j != i} (t - o_j), from prefix and suffix products and
// the constant reciprocals c_i = 1 / prod_{j != i} (i - j), built at
// compile time: a divide per factor cannot become a multiply under IEEE
// rules, and dividing once per factor cost about two dozen divides per
// output, a third of the gather's time. The windowed sinc takes one
// reciprocal of its tap sum, the B-spline a multiply by 1/6. The sinc's
// scale `sinscl` is a run-time argument, so one build serves every scale.
//
// What bounds it on this card: the L1 load rate of the footprints. Per
// output pixel it reads 8 bytes of coordinates, writes 5, and gathers
// K*K = 36 taps at poly5; neighbouring pixels' footprints overlap almost
// entirely, so the taps hit L1, and 36 warp-wide loads per 32 outputs are
// about the time the kernel takes beyond the linear interpolant's 4 taps.
// Staging each cutout's window in shared memory first (one CTA per tile,
// a bounding-box reduction, cp.async row copies, then the taps from shared
// memory) was slower at every shape measured on the H100: L1 and shared
// memory are the same SRAM on Hopper, so staging only adds a serial
// load, reduce, copy and barrier chain to every tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// interpolant codes, in the order of subpixal_tpu_torch.kernels.blot._CODES
enum : int {
  I_NEAREST = 0,
  I_LINEAR = 1,
  I_POLY3 = 2,
  I_POLY5 = 3,
  I_SPLINE3 = 4,
  I_SINC = 5,
};

constexpr int kThreads = 256;

template <int I> struct Taps;
template <> struct Taps<I_LINEAR> { static constexpr int LO = 0, N = 2; };
template <> struct Taps<I_POLY3> { static constexpr int LO = -1, N = 4; };
template <> struct Taps<I_POLY5> { static constexpr int LO = -2, N = 6; };
template <> struct Taps<I_SPLINE3> { static constexpr int LO = -1, N = 4; };
template <> struct Taps<I_SINC> { static constexpr int LO = -2, N = 6; };

// c_i = 1 / prod_{j != i} (i - j), the Lagrange basis' constants on N
// taps, built at compile time (a constexpr variable must be)
template <int N>
struct LagrangeC {
  float c[N];
  __host__ __device__ constexpr LagrangeC() : c{} {
    for (int i = 0; i < N; ++i) {
      double p = 1.0;
      for (int j = 0; j < N; ++j)
        if (j != i) p *= (double)(i - j);
      c[i] = (float)(1.0 / p);
    }
  }
};

// sinc(x / sinscl) * sinc(x / 3) on |x| < 3, the plain version's formula
// with the divide by sinscl a multiply by its reciprocal (exact at
// sinscl = 1, 0.5 and 2; within an ulp of the plain version's argument
// elsewhere)
__device__ __forceinline__ float lanczos3(float x, float inv_sinscl) {
  const float xs = x * inv_sinscl;
  const float pxs = 3.14159265358979323846f * xs;
  const float pw = 3.14159265358979323846f * x / 3.0f;
  const float sinc_main = fabsf(xs) < 1e-7f ? 1.0f : sinf(pxs) / pxs;
  const float sinc_win = fabsf(x) < 1e-7f ? 1.0f : sinf(pw) / pw;
  return fabsf(x) >= 3.0f ? 0.0f : sinc_main * sinc_win;
}

// inv_sinscl: 1 / sinscl, read by the sinc only
template <int I>
__device__ __forceinline__ void axis_weights(float t, float inv_sinscl,
                                             float (&w)[Taps<I>::N]) {
  constexpr int LO = Taps<I>::LO, N = Taps<I>::N;
  if constexpr (I == I_LINEAR) {
    w[0] = 1.0f - t;
    w[1] = t;
  } else if constexpr (I == I_SPLINE3) {  // cubic B-spline basis, offsets -1..2
    constexpr float k6 = 1.0f / 6.0f;
    const float t2 = t * t, t3 = t2 * t;
    w[0] = (1.0f - 3.0f * t + 3.0f * t2 - t3) * k6;
    w[1] = (4.0f - 6.0f * t2 + 3.0f * t3) * k6;
    w[2] = (1.0f + 3.0f * t + 3.0f * t2 - 3.0f * t3) * k6;
    w[3] = t3 * k6;
  } else if constexpr (I == I_SINC) {  // windowed sinc, normalised over the taps
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      w[i] = lanczos3(t - (float)(LO + i), inv_sinscl);
      s += w[i];
    }
    // a tap sum near 0 (reachable at sinscl < 1: at sinscl = 0.5 every
    // tap of t = 0.5 is a zero of the sinc) takes bilinear weights on
    // taps 0 and +1, as the plain version does
    if (fabsf(s) < 1e-3f) {
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = 0.0f;
      w[-LO] = 1.0f - t;
      w[-LO + 1] = t;
    } else {
      const float inv = 1.0f / s;
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] *= inv;
    }
  } else {  // Lagrange basis over offsets LO .. LO+N-1 (poly3, poly5)
    constexpr LagrangeC<N> kC;
    float d[N], pre[N], suf[N];
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = t - (float)(LO + j);
    pre[0] = 1.0f;
#pragma unroll
    for (int i = 1; i < N; ++i) pre[i] = pre[i - 1] * d[i - 1];
    suf[N - 1] = 1.0f;
#pragma unroll
    for (int i = N - 2; i >= 0; --i) suf[i] = suf[i + 1] * d[i + 1];
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = kC.c[i] * (pre[i] * suf[i]);
  }
}

__global__ void nearest_kernel(const float* __restrict__ img, int H, int W,
                               const float* __restrict__ xs,
                               const float* __restrict__ ys, long long n,
                               float* __restrict__ out,
                               uint8_t* __restrict__ valid, float fill, int row0) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // floor(x + 0.5): the reference's (int)(x + 0.5) rounding
    const float fx = floorf(__ldg(xs + i) + 0.5f);
    const float fy = floorf(__ldg(ys + i) + 0.5f) - (float)row0;
    const bool ok = fx >= 0.0f && fx < (float)W && fy >= 0.0f && fy < (float)H;
    out[i] = ok ? __ldg(img + (long long)fy * W + (long long)fx) : fill;
    valid[i] = ok;
  }
}

// Whether the K x K footprint at floors (x0, y0) lies in the image, whose
// rows are [ylo, yhi) of the points' frame; the float test also rejects
// NaN and keeps the int casts in range.
template <int I>
__device__ __forceinline__ bool inside(float x0, float y0, float ylo, float yhi, int W) {
  constexpr int LO = Taps<I>::LO, N = Taps<I>::N;
  return x0 + (float)LO >= 0.0f && x0 + (float)(LO + N - 1) < (float)W &&
         y0 + (float)LO >= ylo && y0 + (float)(LO + N - 1) < yhi;
}

// BAND: the image is a band of rows [row0, row0 + H) of the points' frame.
// floor(y) stays in that frame, so the fraction is y's own and the tests
// are exact integer compares. A template parameter: with the row origin a
// run-time value poly5 took 8.88-8.91 us at 512 x 32^2 against 8.35-8.39
// for the kernel without it (chip_smoke.py, one call, NVIDIA H100 80GB
// HBM3, 700 W).
template <int I, bool BAND>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ xs,
              const float* __restrict__ ys, long long n, float* __restrict__ out,
              uint8_t* __restrict__ valid, float fill, float inv_sinscl, int row0) {
  constexpr int LO = Taps<I>::LO, N = Taps<I>::N;
  const float ylo = BAND ? (float)row0 : 0.0f;
  const float yhi = BAND ? (float)(row0 + H) : (float)H;
  const long long r_lo = BAND ? (long long)LO - row0 : (long long)LO;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = __ldg(xs + i), y = __ldg(ys + i);
    const float x0 = floorf(x), y0 = floorf(y);
    if (!inside<I>(x0, y0, ylo, yhi, W)) {
      out[i] = fill;
      valid[i] = 0;
      continue;
    }
    float wx[N], wy[N];
    axis_weights<I>(x - x0, inv_sinscl, wx);
    axis_weights<I>(y - y0, inv_sinscl, wy);
    const float* p = img + ((long long)y0 + r_lo) * W + ((long long)x0 + LO);
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float row = 0.0f;
#pragma unroll
      for (int c = 0; c < N; ++c) row = row + wx[c] * __ldg(p + (long long)r * W + c);
      acc = acc + wy[r] * row;
    }
    out[i] = acc;
    valid[i] = 1;
  }
}

template <int I>
void launch_gather(unsigned g, cudaStream_t st, const float* img, int H, int W,
                   const float* xs, const float* ys, long long n, float* out, uint8_t* valid,
                   float fill, float inv_sinscl, int row0) {
  if (row0 == 0)
    gather_kernel<I, false><<<g, kThreads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill,
                                                    inv_sinscl, 0);
  else
    gather_kernel<I, true><<<g, kThreads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill,
                                                   inv_sinscl, row0);
}

}  // namespace

// Sample `img` (H, W) at the n points (xs, ys) on `stream`; writes out[n]
// and valid[n] (0/1 bytes). `sinscl` scales the sinc interpolant's
// argument (read by the sinc only); `row0` is the row of the points' frame
// at which `img` starts (a band of a larger plane; 0 for a whole plane).
// Returns cudaGetLastError(); an unknown interpolant code returns
// cudaErrorInvalidValue without launching.
extern "C" int blot_gather_launch(const float* img, int H, int W, const float* xs,
                                  const float* ys, long long n, float* out, uint8_t* valid,
                                  int interp, float fill, float sinscl, int row0,
                                  void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond this
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
  const float inv = 1.0f / sinscl;
  switch (interp) {
    case I_NEAREST:
      nearest_kernel<<<g, kThreads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill, row0);
      break;
    case I_LINEAR:
      launch_gather<I_LINEAR>(g, st, img, H, W, xs, ys, n, out, valid, fill, inv, row0);
      break;
    case I_POLY3:
      launch_gather<I_POLY3>(g, st, img, H, W, xs, ys, n, out, valid, fill, inv, row0);
      break;
    case I_POLY5:
      launch_gather<I_POLY5>(g, st, img, H, W, xs, ys, n, out, valid, fill, inv, row0);
      break;
    case I_SPLINE3:
      launch_gather<I_SPLINE3>(g, st, img, H, W, xs, ys, n, out, valid, fill, inv, row0);
      break;
    case I_SINC:
      launch_gather<I_SINC>(g, st, img, H, W, xs, ys, n, out, valid, fill, inv, row0);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
