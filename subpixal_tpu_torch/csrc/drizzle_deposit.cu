// Drizzle deposit (kernel B1): scatter a stack of E input planes onto one
// output grid, summed over the stack.
//
// Replaces the Pallas TPU kernel subpixal_tpu/kernels/drizzle.py ·
// drizzle_deposit_pallas (its pl.pallas_call at kernels/drizzle.py:444,
// body _driz_kernel, weights _overlap_matrix_t). That kernel walks input
// blocks IN ORDER on one core and carries a static output tile from one
// grid step to the next, depositing each block with one MXU contraction of
// separable per-axis overlap matrices. Hopper runs blocks in parallel and
// in no order, so no tile can be carried between blocks.
//
// What bounds it on this card: each input pixel is read once (data,
// weight, x, y: 16 bytes) and each output cell written once (sci, wht),
// so the least time is bytes over 3.35 TB/s. A first design (one thread
// per pixel, 2*K*K global f32 atomics per pixel: 8 at square / pixfrac 1)
// ran at a third of that bound: neighbouring pixels of a warp hit the same
// output cells, and those atomics serialise in L2.
//
// Design: one block per 16 x 128 input tile of one plane, grid (tiles, E),
// so the whole stack is one launch. The tile is the JAX package's
// DEPOSIT_BLOCK, which is forced: under the sparse deposit a plane is a
// column of compacted 16 x 128 blocks from different parts of the frame,
// and a tile that straddled two of them would reach across the frame.
// Each of the block's 8 warps owns a 2 x 128 strip of the tile and a
// window of shared memory of its own, so no two warps ever write one
// cell and no block barrier is needed.
//   1. Each lane loads its 8 pixels (data, weight, x, y) with every load
//      in flight at once (addresses clamped into the plane; a branch per
//      load would serialise their latencies). Pixels outside the plane,
//      with weight <= 0, NaN positions or windows wholly off the grid are
//      dead. Warp reductions give the strip's window of cells.
//   2. When the window fits the warp's shared memory (sized by the wrapper
//      for the planes' ratios and K), the warp zeroes it and walks its
//      pixels: for each offset (dy, dx) of the K x K window every lane adds
//      w*a*data and w*a at its own cell, then __syncwarp. Lanes whose
//      windows start at different cells touch different cells at every
//      offset, so they add with plain loads and stores; only lanes whose
//      windows start at one cell (a pixmap finer than the grid) use
//      shared-memory atomics, which Hopper runs as compare-and-swap loops
//      for floats and which a first tiled design spent most of its time
//      in. The window may reach K - 1 cells past the grid; those cells are
//      dropped at the flush, which adds each nonzero cell to device memory
//      with one global atomic per plane (a `red`): about 1.5 global
//      atomics per output cell at square / pixfrac 1 instead of 8 per
//      input pixel.
//   3. A window that does not fit (a large rotation or scale, or a pixmap
//      that folds) is deposited by the same warp with direct global
//      atomics, pixel by pixel: the kernel's own path for such strips.
// The cell weights are the plain version's formulas
// (subpixal_tpu_torch/ops/drizzle.py · drizzle_deposit: K = ceil(2*reach)+1
// cells from floor(x - reach + 0.5)) for all seven drizzle kernels, tophat
// included, split by axis where they factor (one factor per window row,
// one per cell); each plane has its own ratio, hence its own half, s,
// sigma, reach and K, read from a small parameter array. The kernel code
// is a template parameter. There is no static output tile, so no pixel can
// escape one: the wrapper's `escaped` counts are 0 by construction.
//
// What still bounds it: each warp walks its pixels' K x K offsets one
// after the other, a chain of dependent shared-memory reads and writes,
// and about 24 warps fit on an SM; the measured times are in PERF.md.
//
// Atomics sum in an order that changes from run to run, and the factored
// weights round differently from the plain version's by an ulp, so
// results match the plain version to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTileH = 16, kTileW = 128;  // DEPOSIT_BLOCK
constexpr int kWarps = 8;                  // one strip of 2 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kParams = 8;  // floats per plane
// the largest window a warp may ask for (sci + wht, f32)
constexpr int kMaxCells = (227 * 1024) / (8 * kWarps);

// kernel codes, in the order of subpixal_tpu_torch.kernels.drizzle._CODES
enum : int {
  K_SQUARE = 0,  // square and turbo: box overlap
  K_POINT = 1,
  K_GAUSSIAN = 2,
  K_LANCZOS2 = 3,
  K_LANCZOS3 = 4,
  K_TOPHAT = 5,
};

struct Plane {
  int K;         // window side in cells (1 for point)
  float half;    // 0.5 * pixfrac * pscale_ratio
  float norm;    // 4 * half * half (square-kernel area)
  float half2;   // half * half (tophat radius squared)
  float sigma2;  // gaussian sigma squared
  float s;       // max(pixfrac * pscale_ratio, 1e-3) (lanczos scale)
  float reach;   // window half-extent
};

// prm[e * kParams + ...] = K, half, norm, half2, sigma2, s, reach, unused
__device__ __forceinline__ Plane load_plane(const float* __restrict__ prm,
                                            int e) {
  const float* q = prm + (long long)e * kParams;
  Plane p;
  p.K = (int)__ldg(q);
  p.half = __ldg(q + 1);
  p.norm = __ldg(q + 2);
  p.half2 = __ldg(q + 3);
  p.sigma2 = __ldg(q + 4);
  p.s = __ldg(q + 5);
  p.reach = __ldg(q + 6);
  return p;
}

__device__ __forceinline__ float lanczos1d(float u, float a) {
  // sinc(u) * sinc(u / a) on |u| < a, 0 outside
  const float pu = 3.14159265358979323846f * u;
  const float val = fabsf(u) < 1e-7f
      ? 1.0f
      : a * sinf(pu) * sinf(pu / a) / fmaxf(pu * pu, 1e-30f);
  return fabsf(u) >= a ? 0.0f : val;
}

// The plain version's cell weights, split by axis: axis_weight<KC> is the
// factor of one axis (for tophat the squared distance), combine<KC> joins
// the two, so a pixel computes one factor per row and one per cell of its
// window. They round differently from the plain version by an ulp or so
// (square multiplies by 1/norm, gaussian multiplies two exponentials).
template <int KC>
__device__ __forceinline__ float axis_weight(const Plane& p, float pos, float cell) {
  if (KC == K_SQUARE) {
    const float o = fminf(pos + p.half, cell + 0.5f) - fmaxf(pos - p.half, cell - 0.5f);
    return fmaxf(o, 0.0f);
  } else if (KC == K_POINT) {
    return 1.0f;
  } else if (KC == K_GAUSSIAN) {
    const float d = cell - pos;
    return expf(-0.5f * d * d / p.sigma2);
  } else if (KC == K_LANCZOS2) {
    return lanczos1d((cell - pos) / p.s, 2.0f);
  } else if (KC == K_LANCZOS3) {
    return lanczos1d((cell - pos) / p.s, 3.0f);
  } else {  // K_TOPHAT
    const float d = cell - pos;
    return __fmul_rn(d, d);  // not fused into the sum: the test is exact
  }
}

template <int KC>
__device__ __forceinline__ float combine(const Plane& p, float inv_norm, float wx,
                                         float wy) {
  if (KC == K_SQUARE) return wx * wy * inv_norm;
  if (KC == K_TOPHAT) return (__fadd_rn(wx, wy) <= p.half2) ? 1.0f : 0.0f;
  return wx * wy;
}

// One warp's strip: kStripRows rows of the tile; lane l takes pixel j at
// row j / kChunks of the strip and column pix_col(l, j): the even columns
// of each half row, then the odd ones, so the 32 pixels of one slot j lie
// two columns apart and their windows do not overlap when K <= 2.
constexpr int kStripRows = kTileH / kWarps;
constexpr int kChunks = kTileW / 32;
constexpr int kPix = kStripRows * kChunks;  // pixels per lane
static_assert(kChunks == 4, "pix_col interleaves two halves of 64 columns");

__device__ __forceinline__ int pix_col(int lane, int j) {
  return 2 * lane + (j & 1) + 64 * ((j >> 1) & 1);
}

// Inclusive prefix maximum of v over the lanes of the warp.
__device__ __forceinline__ int prefix_max(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// Three blocks an SM, as their shared windows allow: without the hint
// ptxas caps registers at 64 and spills.
template <int KC>
__global__ void __launch_bounds__(kThreads, 3)
deposit_tiles(const float* __restrict__ data, const float* __restrict__ wht,
              const float* __restrict__ xo, const float* __restrict__ yo,
              int H, int W, int tiles_x, const float* __restrict__ prm,
              float* __restrict__ sci, float* __restrict__ wout, int Ho, int Wo,
              int cap_cells, int* __restrict__ direct_strips) {
  extern __shared__ float win[];  // per warp: cap_cells of sci, then of wht
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_x) * kTileH + warp * kStripRows;
  const int c0 = (blockIdx.x % tiles_x) * kTileW;
  const Plane p = load_plane(prm, e);
  const int K = KC == K_POINT ? 1 : p.K;
  const float off = KC == K_POINT ? 0.5f : 0.5f - p.reach;
  const float inv_norm = 1.0f / p.norm;
  const long long base = (long long)e * H * W;

  // ---- 1. load the lane's pixels: addresses clamped into the plane, so
  // every load is unconditional and all of them are in flight at once ----
  float pw[kPix], px[kPix], py[kPix], pv[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int r = min(r0 + j / kChunks, H - 1);
    const int c = min(c0 + pix_col(lane, j), W - 1);
    const long long i = base + (long long)r * W + c;
    px[j] = __ldg(xo + i);
    py[j] = __ldg(yo + i);
    pv[j] = __ldg(data + i);
    pw[j] = wht != nullptr ? __ldg(wht + i) : 1.0f;
  }
  // live pixels: inside the plane, weight > 0 and a window not wholly off
  // the grid (which also drops NaN positions and keeps the float->int
  // conversions in range); the strip's window of cells
  unsigned live = 0;
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float fx = floorf(px[j] + off), fy = floorf(py[j] + off);
    if (!(r0 + j / kChunks < H && c0 + pix_col(lane, j) < W &&
          pw[j] > 0.0f && fx < (float)Wo && fx + (float)K > 0.0f &&
          fy < (float)Ho && fy + (float)K > 0.0f))
      continue;
    live |= 1u << j;
    bx0 = min(bx0, (int)fx);
    bx1 = max(bx1, (int)fx + K - 1);
    by0 = min(by0, (int)fy);
    by1 = max(by1, (int)fy + K - 1);
  }
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  if (bx0 > bx1) return;  // nothing live in the strip (warp-uniform)
  const int bw = bx1 - bx0 + 1;
  const long long n = (long long)bw * (by1 - by0 + 1);

  if (n > cap_cells) {
    // ---- 3. the window does not fit: direct global atomics ----
    if (direct_strips != nullptr && lane == 0) atomicAdd(direct_strips, 1);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!((live >> j) & 1u)) continue;
      const int cx0 = (int)floorf(px[j] + off), cy0 = (int)floorf(py[j] + off);
      for (int dy = 0; dy < K; ++dy) {
        const int cy = cy0 + dy;
        if (cy < 0 || cy >= Ho) continue;
        const float wy = axis_weight<KC>(p, py[j], (float)cy);
        for (int dx = 0; dx < K; ++dx) {
          const int cx = cx0 + dx;
          if (cx < 0 || cx >= Wo) continue;
          const float a = combine<KC>(p, inv_norm, axis_weight<KC>(p, px[j], (float)cx), wy);
          if (a == 0.0f) continue;
          const float wa = pw[j] * a;
          const long long c = (long long)cy * Wo + cx;
          atomicAdd(sci + c, wa * pv[j]);
          atomicAdd(wout + c, wa);
        }
      }
    }
    return;
  }

  // ---- 2. accumulate in the warp's shared window, then flush ----
  // The window may reach K - 1 cells past the grid: those cells are
  // accumulated like the others and dropped at the flush, so the deposit
  // itself tests no bounds.
  float* ssci = win + (size_t)warp * 2 * cap_cells;
  float* swht = ssci + cap_cells;
  for (int i = lane; i < n; i += 32) {
    ssci[i] = 0.0f;
    swht[i] = 0.0f;
  }
  __syncwarp();
  // slots whose windows do not overlap across the lanes, the common case
  // at K <= 2: every lane's window starts K or more cells right of the
  // previous lane's (live or not; a lane without a usable position makes
  // the test fail), so the starts grow by K along the warp
  unsigned apart = 0;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float fx = floorf(px[j] + off);
    const bool pos = fabsf(fx) < 1e9f;  // finite and in int range
    const int cx0 = pos ? (int)fx : 0;
    const int prev = __shfl_up_sync(0xffffffffu, cx0, 1);
    const bool prev_pos = __shfl_up_sync(0xffffffffu, pos, 1);
    if (__all_sync(0xffffffffu, pos && (lane == 0 || (prev_pos && prev + K <= cx0))))
      apart |= 1u << j;
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const bool on = (live >> j) & 1u;
    if (!__any_sync(0xffffffffu, on)) continue;
    const int cx0 = (int)floorf(px[j] + off), cy0 = (int)floorf(py[j] + off);
    const int start = on ? (cy0 - by0) * bw + (cx0 - bx0) : -1 - lane;
    if ((apart >> j) & 1u) {
      // no cell is shared: each lane adds its whole window plainly
      if (on) {
        float fy = (float)cy0;
        for (int dy = 0; dy < K; ++dy, fy += 1.0f) {
          const float wy = axis_weight<KC>(p, py[j], fy);
          float fx = (float)cx0;
          for (int dx = 0; dx < K; ++dx, fx += 1.0f) {
            const float wa = pw[j] * combine<KC>(p, inv_norm, axis_weight<KC>(p, px[j], fx), wy);
            const int c = start + dy * bw + dx;
            ssci[c] += wa * pv[j];
            swht[c] += wa;
          }
        }
      }
      __syncwarp();
      continue;
    }
    // Windows overlap. Between two barriers every lane adds at the same
    // offset (dy, dx) of its window, so lanes whose windows start at
    // different cells touch different cells and add plainly; lanes whose
    // windows start at one cell (a pixmap finer than the grid) add
    // atomically. Window starts that increase along the lanes are all
    // distinct; otherwise the lanes match theirs.
    const int before = __shfl_up_sync(0xffffffffu, prefix_max(on ? start : INT_MIN, lane), 1);
    bool alone = true;
    if (!__all_sync(0xffffffffu, !on || lane == 0 || before < start))
      alone = __match_any_sync(0xffffffffu, start) == (1u << lane);
    float fy = (float)cy0;
    for (int dy = 0; dy < K; ++dy, fy += 1.0f) {
      const float wy = on ? axis_weight<KC>(p, py[j], fy) : 0.0f;
      float fx = (float)cx0;
      for (int dx = 0; dx < K; ++dx, fx += 1.0f) {
        if (on) {
          const float wa = pw[j] * combine<KC>(p, inv_norm, axis_weight<KC>(p, px[j], fx), wy);
          const int c = start + dy * bw + dx;
          if (alone) {
            ssci[c] += wa * pv[j];
            swht[c] += wa;
          } else {
            atomicAdd(ssci + c, wa * pv[j]);
            atomicAdd(swht + c, wa);
          }
        }
        __syncwarp();
      }
    }
  }
  // flush row by row: lanes take consecutive cells of a row
  for (int r = 0; r <= by1 - by0; ++r) {
    const int gy = by0 + r;
    if (gy < 0 || gy >= Ho) continue;
    for (int k = lane; k < bw; k += 32) {
      const int gx = bx0 + k;
      if (gx < 0 || gx >= Wo) continue;
      const float s = ssci[r * bw + k], w = swht[r * bw + k];
      const long long g = (long long)gy * Wo + gx;
      if (s != 0.0f) atomicAdd(sci + g, s);
      if (w != 0.0f) atomicAdd(wout + g, w);
    }
  }
}

template <int KC>
int launch(const float* data, const float* wht, const float* xo,
           const float* yo, int E, int H, int W, const float* prm, float* sci,
           float* wout, int Ho, int Wo, int cap_cells, int* direct_strips,
           cudaStream_t stream) {
  const size_t bytes = 2 * sizeof(float) * (size_t)cap_cells * kWarps;
  if (bytes > 48 * 1024) {  // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        deposit_tiles<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)E);
  deposit_tiles<KC><<<grid, kThreads, bytes, stream>>>(
      data, wht, xo, yo, H, W, tiles_x, prm, sci, wout, Ho, Wo, cap_cells,
      direct_strips);
  return (int)cudaGetLastError();
}

}  // namespace

// Deposit E planes of (H, W) f32 data, weights (`wht` may be null: unit
// weights), x and y onto the (Ho, Wo) accumulators sci and wout, which the
// caller zeroed, on `stream`. prm holds kParams floats per plane (K, half,
// norm, half2, sigma2, s, reach, unused) on the device. cap_cells is the
// shared-memory window of each warp in cells (at most kMaxCells).
// direct_strips is null or an int the kernel adds one to for each 2 x 128
// strip that took the direct global-atomics path. Returns cudaGetLastError() after the launch, or the
// error that prevented it.
extern "C" int drizzle_deposit_stack_launch(
    const float* data, const float* wht, const float* xo, const float* yo,
    int E, int H, int W, const float* prm, float* sci, float* wout, int Ho,
    int Wo, int kernel, int cap_cells, int* direct_strips, void* stream) {
  if (E <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (E > 65535 || Ho <= 0 || Wo <= 0 || cap_cells < 1 ||
      cap_cells > kMaxCells)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kernel) {
    case K_SQUARE:
      return launch<K_SQUARE>(data, wht, xo, yo, E, H, W, prm, sci, wout, Ho,
                              Wo, cap_cells, direct_strips, s);
    case K_POINT:
      return launch<K_POINT>(data, wht, xo, yo, E, H, W, prm, sci, wout, Ho,
                             Wo, cap_cells, direct_strips, s);
    case K_GAUSSIAN:
      return launch<K_GAUSSIAN>(data, wht, xo, yo, E, H, W, prm, sci, wout, Ho,
                                Wo, cap_cells, direct_strips, s);
    case K_LANCZOS2:
      return launch<K_LANCZOS2>(data, wht, xo, yo, E, H, W, prm, sci, wout, Ho,
                                Wo, cap_cells, direct_strips, s);
    case K_LANCZOS3:
      return launch<K_LANCZOS3>(data, wht, xo, yo, E, H, W, prm, sci, wout, Ho,
                                Wo, cap_cells, direct_strips, s);
    case K_TOPHAT:
      return launch<K_TOPHAT>(data, wht, xo, yo, E, H, W, prm, sci, wout, Ho,
                              Wo, cap_cells, direct_strips, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
