// Drizzle deposit (kernel B1): scatter one input plane onto an output grid.
//
// Replaces the Pallas TPU kernel subpixal_tpu/kernels/drizzle.py ·
// drizzle_deposit_pallas (its pl.pallas_call at kernels/drizzle.py:444,
// body _driz_kernel, weights _overlap_matrix_t). That kernel walks input
// blocks IN ORDER on one core and deposits each block into a static
// output tile with one MXU contraction of separable per-axis overlap
// matrices. Hopper runs blocks in parallel and in no order, so a tile
// carried from one grid step to the next has no counterpart here.
//
// Design: one thread per input pixel (grid-stride loop). A pixel with
// weight <= 0 deposits nothing. Every other pixel walks the same
// K x K candidate window as the plain version
// (subpixal_tpu_torch/ops/drizzle.py · drizzle_deposit: K = ceil(2*reach)+1
// cells from floor(x - reach + 0.5)) with the same per-kernel weight
// formulas, and atomicAdd's w*a*data and w*a into the f32 sci and wht
// planes. Per-pixel atomics need no separability, so all seven drizzle
// kernels are covered, tophat included. There is no static tile, so no
// pixel can escape one: the wrapper's `escaped` count is 0 by
// construction.
//
// What bounds it on this card: per input pixel it reads 16 bytes (data,
// weight, x, y) and issues 2*K*K f32 atomics (8 at the default square
// kernel with pixfrac 1, where K = 2). Neighbouring pixels hit the same
// output cells, so the atomics, resolved in L2, bound it rather than
// device-memory bandwidth. The design keeps the arithmetic per pixel
// small and skips zero-weight cells; a tiled shared-memory accumulation
// is the later step if the deposit shows up in the iteration time.
//
// Atomics sum in an order that changes from run to run, so results match
// the plain version to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// kernel codes, in the order of subpixal_tpu_torch.kernels.drizzle._CODES
enum : int {
  K_SQUARE = 0,  // square and turbo: box overlap
  K_POINT = 1,
  K_GAUSSIAN = 2,
  K_LANCZOS2 = 3,
  K_LANCZOS3 = 4,
  K_TOPHAT = 5,
};

__device__ __forceinline__ float lanczos1d(float u, float a) {
  // sinc(u) * sinc(u / a) on |u| < a, 0 outside
  const float pu = 3.14159265358979323846f * u;
  const float val = fabsf(u) < 1e-7f
      ? 1.0f
      : a * sinf(pu) * sinf(pu / a) / fmaxf(pu * pu, 1e-30f);
  return fabsf(u) >= a ? 0.0f : val;
}

struct Params {
  int Ho, Wo, kernel, K;
  float half;    // 0.5 * pixfrac * pscale_ratio
  float norm;    // 4 * half * half (square-kernel area)
  float half2;   // half * half (tophat radius squared)
  float sigma2;  // gaussian sigma squared
  float s;       // max(pixfrac * pscale_ratio, 1e-3) (lanczos scale)
  float reach;   // window half-extent
};

__device__ __forceinline__ float cell_weight(const Params& p, float x,
                                             float y, float cx, float cy) {
  switch (p.kernel) {
    case K_SQUARE: {
      const float ox = fminf(x + p.half, cx + 0.5f) - fmaxf(x - p.half, cx - 0.5f);
      const float oy = fminf(y + p.half, cy + 0.5f) - fmaxf(y - p.half, cy - 0.5f);
      return fmaxf(ox, 0.0f) * fmaxf(oy, 0.0f) / p.norm;
    }
    case K_GAUSSIAN: {
      const float dx = cx - x, dy = cy - y;
      const float r2 = dx * dx + dy * dy;
      return expf(-0.5f * r2 / p.sigma2);
    }
    case K_LANCZOS2:
      return lanczos1d((cx - x) / p.s, 2.0f) * lanczos1d((cy - y) / p.s, 2.0f);
    case K_LANCZOS3:
      return lanczos1d((cx - x) / p.s, 3.0f) * lanczos1d((cy - y) / p.s, 3.0f);
    default: {  // K_TOPHAT: uniform within a circle of radius `half`
      const float dx = cx - x, dy = cy - y;
      return (dx * dx + dy * dy <= p.half2) ? 1.0f : 0.0f;
    }
  }
}

__global__ void deposit_kernel(const float* __restrict__ data,
                               const float* __restrict__ wht,
                               const float* __restrict__ xo,
                               const float* __restrict__ yo, long long n,
                               float* __restrict__ sci,
                               float* __restrict__ wout, Params p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float w = wht != nullptr ? __ldg(wht + i) : 1.0f;
    if (!(w > 0.0f)) continue;
    const float x = __ldg(xo + i);
    const float y = __ldg(yo + i);
    const float v = __ldg(data + i);
    if (p.kernel == K_POINT) {  // all mass to the nearest output cell
      const float fx = floorf(x + 0.5f);
      const float fy = floorf(y + 0.5f);
      if (fx >= 0.0f && fx < (float)p.Wo && fy >= 0.0f && fy < (float)p.Ho) {
        const long long c = (long long)fy * p.Wo + (long long)fx;
        atomicAdd(sci + c, w * v);
        atomicAdd(wout + c, w);
      }
      continue;
    }
    const float c0x = floorf(x - p.reach + 0.5f);
    const float c0y = floorf(y - p.reach + 0.5f);
    // windows wholly off the grid deposit nothing; the test also keeps the
    // float->int conversions below in range and drops NaN positions
    if (!(c0x < (float)p.Wo && c0x + (float)p.K > 0.0f &&
          c0y < (float)p.Ho && c0y + (float)p.K > 0.0f))
      continue;
    const int ix0 = (int)c0x;
    const int iy0 = (int)c0y;
    for (int dy = 0; dy < p.K; ++dy) {
      const int cy = iy0 + dy;
      if (cy < 0 || cy >= p.Ho) continue;
      for (int dx = 0; dx < p.K; ++dx) {
        const int cx = ix0 + dx;
        if (cx < 0 || cx >= p.Wo) continue;
        const float a = cell_weight(p, x, y, (float)cx, (float)cy);
        if (a == 0.0f) continue;
        const float wa = w * a;
        const long long c = (long long)cy * p.Wo + cx;
        atomicAdd(sci + c, wa * v);
        atomicAdd(wout + c, wa);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; `wht` may be null (unit weights). sci and wout are
// (Ho, Wo) accumulators the caller zeroed. Returns cudaGetLastError().
extern "C" int drizzle_deposit_launch(
    const float* data, const float* wht, const float* xo, const float* yo,
    long long n, float* sci, float* wout, int Ho, int Wo, int kernel, int K,
    float half, float norm, float half2, float sigma2, float s, float reach,
    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Params p{Ho, Wo, kernel, K, half, norm, half2, sigma2, s, reach};
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond this
  deposit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      data, wht, xo, yo, n, sci, wout, p);
  return (int)cudaGetLastError();
}
