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
// Design: one thread per output pixel of the flattened (B, h, w) batch.
// Each thread takes floor and fraction of its coordinate per axis, the
// per-axis tap weights by the formulas of
// subpixal_tpu_torch/ops/interp.py · _axis_weights (the plain version),
// and reads its K x K footprint through __ldg. It writes the value, or
// `fill`, and a validity byte: valid means the whole footprint lies inside
// the image. There is no tile, so nothing can escape one: the wrapper's
// per-cutout `escaped` counts are zeros by construction. spline3 samples
// B-spline coefficients; the prefilter stays plain torch outside the
// kernel, as the JAX package runs it as XLA outside Pallas.
//
// What bounds it on this card: per output pixel it reads 8 bytes of
// coordinates and K*K = 36 image values at poly5, and writes 5 bytes. The
// footprints of neighbouring pixels overlap almost entirely and a cutout's
// source window is a few KB, so the reads hit L1/L2; the bound is the
// load-issue rate of the 36 gathers and the tap arithmetic, not device
// memory. The design keeps the footprint loads in consecutive threads on
// consecutive columns; staging each cutout's window in shared memory is
// the later step if the gather shows up in the iteration time.

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

template <int I> struct Taps;
template <> struct Taps<I_LINEAR> { static constexpr int LO = 0, N = 2; };
template <> struct Taps<I_POLY3> { static constexpr int LO = -1, N = 4; };
template <> struct Taps<I_POLY5> { static constexpr int LO = -2, N = 6; };
template <> struct Taps<I_SPLINE3> { static constexpr int LO = -1, N = 4; };
template <> struct Taps<I_SINC> { static constexpr int LO = -2, N = 6; };

__device__ __forceinline__ float lanczos3(float x) {
  // sinc(x) * sinc(x / 3) on |x| < 3 (the plain version's sinscl = 1)
  const float pxs = 3.14159265358979323846f * x;
  const float pw = 3.14159265358979323846f * x / 3.0f;
  const bool small = fabsf(x) < 1e-7f;
  const float sinc_main = small ? 1.0f : sinf(pxs) / pxs;
  const float sinc_win = small ? 1.0f : sinf(pw) / pw;
  return fabsf(x) >= 3.0f ? 0.0f : sinc_main * sinc_win;
}

template <int I>
__device__ __forceinline__ void axis_weights(float t, float* w) {
  constexpr int LO = Taps<I>::LO, N = Taps<I>::N;
  if constexpr (I == I_LINEAR) {
    w[0] = 1.0f - t;
    w[1] = t;
  } else if constexpr (I == I_SPLINE3) {  // cubic B-spline basis, offsets -1..2
    const float t2 = t * t, t3 = t2 * t;
    w[0] = (1.0f - 3.0f * t + 3.0f * t2 - t3) / 6.0f;
    w[1] = (4.0f - 6.0f * t2 + 3.0f * t3) / 6.0f;
    w[2] = (1.0f + 3.0f * t + 3.0f * t2 - 3.0f * t3) / 6.0f;
    w[3] = t3 / 6.0f;
  } else if constexpr (I == I_SINC) {  // Lanczos-3, normalised over the taps
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      w[i] = lanczos3(t - (float)(LO + i));
      s += w[i];
    }
    if (fabsf(s) < 1e-3f) {  // degenerate sum: bilinear weights
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = 0.0f;
      w[-LO] = 1.0f - t;
      w[-LO + 1] = t;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = w[i] / s;
    }
  } else {  // Lagrange basis over offsets LO .. LO+N-1 (poly3, poly5)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float wi = 1.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j != i) wi = wi * (t - (float)(LO + j)) / (float)(i - j);
      }
      w[i] = wi;
    }
  }
}

__global__ void nearest_kernel(const float* __restrict__ img, int H, int W,
                               const float* __restrict__ xs,
                               const float* __restrict__ ys, long long n,
                               float* __restrict__ out,
                               uint8_t* __restrict__ valid, float fill) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // floor(x + 0.5): the reference's (int)(x + 0.5) rounding
    const float fx = floorf(__ldg(xs + i) + 0.5f);
    const float fy = floorf(__ldg(ys + i) + 0.5f);
    const bool ok = fx >= 0.0f && fx < (float)W && fy >= 0.0f && fy < (float)H;
    out[i] = ok ? __ldg(img + (long long)fy * W + (long long)fx) : fill;
    valid[i] = ok;
  }
}

template <int I>
__global__ void gather_kernel(const float* __restrict__ img, int H, int W,
                              const float* __restrict__ xs,
                              const float* __restrict__ ys, long long n,
                              float* __restrict__ out,
                              uint8_t* __restrict__ valid, float fill) {
  constexpr int LO = Taps<I>::LO, N = Taps<I>::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = __ldg(xs + i);
    const float y = __ldg(ys + i);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    // the footprint rows/cols x0+LO .. x0+LO+N-1 must lie in the image;
    // the float test also rejects NaN and keeps the casts below in range
    const bool ok = x0 + (float)LO >= 0.0f && x0 + (float)(LO + N - 1) < (float)W &&
                    y0 + (float)LO >= 0.0f && y0 + (float)(LO + N - 1) < (float)H;
    if (!ok) {
      out[i] = fill;
      valid[i] = 0;
      continue;
    }
    float wx[N], wy[N];
    axis_weights<I>(x - x0, wx);
    axis_weights<I>(y - y0, wy);
    const float* base = img + ((long long)y0 + LO) * W + ((long long)x0 + LO);
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float row = 0.0f;
#pragma unroll
      for (int c = 0; c < N; ++c) row = row + wx[c] * __ldg(base + (long long)r * W + c);
      acc = acc + wy[r] * row;
    }
    out[i] = acc;
    valid[i] = 1;
  }
}

}  // namespace

// Sample `img` (H, W) at the n points (xs, ys) on `stream`; writes out[n]
// and valid[n] (0/1 bytes). Returns cudaGetLastError(); an unknown
// interpolant code returns cudaErrorInvalidValue without launching.
extern "C" int blot_gather_launch(const float* img, int H, int W,
                                  const float* xs, const float* ys,
                                  long long n, float* out, uint8_t* valid,
                                  int interp, float fill, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond this
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
  switch (interp) {
    case I_NEAREST:
      nearest_kernel<<<g, threads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill);
      break;
    case I_LINEAR:
      gather_kernel<I_LINEAR><<<g, threads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill);
      break;
    case I_POLY3:
      gather_kernel<I_POLY3><<<g, threads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill);
      break;
    case I_POLY5:
      gather_kernel<I_POLY5><<<g, threads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill);
      break;
    case I_SPLINE3:
      gather_kernel<I_SPLINE3><<<g, threads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill);
      break;
    case I_SINC:
      gather_kernel<I_SINC><<<g, threads, 0, st>>>(img, H, W, xs, ys, n, out, valid, fill);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
