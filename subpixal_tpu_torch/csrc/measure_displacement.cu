// Fused displacement measurement (kernel B3): one correlation window per
// cutout pair.
//
// Replaces the Pallas TPU kernel subpixal_tpu/kernels/measure.py ·
// measure_displacement_rank3 (its pl.pallas_call at kernels/measure.py:427,
// body _kernel, constants _consts). That kernel keeps a block of cutouts
// rank-3 in VMEM and writes every stage as batched MXU contractions:
// ones-vector matmuls for the per-cutout sums, one-hot matmuls against a
// static twist table for the integer-shift phase, bf16 operand splits for
// the forward DFT. Those are Mosaic workarounds; none is needed here.
//
// Per pair b (the stages of ops/correlate.py · measure_window):
//   1. normalise each side (_normalize): 'CC' takes the masked data;
//      masked 'NCC'/'ZNCC' remove the masked mean and divide by the masked
//      std times sqrt(n); unmasked 'NCC'/'ZNCC' keep the raw data and take
//      the DC-free power H*W*sum((x - mean)^2), which equals the spectral
//      Parseval power of _spectral_ncc_product;
//   2. both half-spectra;
//   3. the cross-spectrum G = F(img) * conj(F(ref)); unmasked NCC scales it
//      by n / sqrt(P_ref * P_img) and zeroes the DC bin;
//   4. the correlation at the ny x nx integer lags of the search box, a
//      direct half-spectrum DFT with the hermitian fold weights, divided by
//      H*W, and its first-index argmax in row-major (ny, nx) order (the
//      order torch.argmax takes; NaN counts as the largest value);
//   5. the integer-shift phase twist Dy(u) Dx(v), by table lookup of
//      (u*s0) mod N;
//   6. the usfac-upsampled nwin x nwin window as the separable product
//      (K2y) Gd (K2x)^T (float64-built kernels, fold weights and 1/(H*W)
//      in K2x).
// Every twiddle comes from cos/sin(2*pi*j/N) tables built in float64 and
// cast to f32, indexed by an exact integer, so the integer part of every
// phase is exact, as the reference's int32 reduction makes it.
//
// What bounds it on this card: bytes. With FFT half-spectra a 32 x 32
// pair needs about 0.2 MFLOP against 10 KB of inputs (ref, img, a bool
// mask) and 1 KB of window, below the card's f32 ridge point (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte). But the work per pair is small and its
// stages depend on each other, so what a design loses time to is latency:
// barriers, idle threads, serial steps and bank conflicts.
//
// Two kernels, picked by shape in measure_window_launch:
//
// * measure_fft_kernel, for square power-of-two cutouts of 16, 32 or 64
//   (the align path's 32 x 32 cutouts, bench.py's 64 x 64 batch): a group
//   of kPair = 64 threads (two warps) per pair, several pairs per block, so
//   a stage barrier is a named barrier of the pair's 64 threads, and the
//   per-pair sums (masked count, mean, variance, Parseval power) and the
//   argmax are warp shuffles plus one exchange through shared memory. (One
//   warp per pair was slower at 32 x 32 and 64 x 64: with 512 pairs an SM
//   holds about 4 warps and every stall is exposed; four warps a pair
//   gained nothing over two.) A thread's loads of each pass are all in
//   flight at once: the mask type (none, bytes, f32) is a template
//   parameter, so no branch stands between them (a branch there made
//   their latencies add up), and a side is scaled by one reciprocal, not a
//   division per value (whose slow path every masked-out zero takes).
//   Both sides go through ONE complex 2-D FFT: z = a_ref + i*a_img, one
//   thread per row and then one per column, each holding its line in
//   registers (a radix-2 FFT of up to 32 points; a 64-point line is two
//   32-point passes joined by one radix-2 step, so no thread holds more
//   than 64 floats of it). The half-spectra split by hermitian symmetry,
//   R = (Z[k] + conj Z[-k]) / 2 and I = (Z[k] - conj Z[-k]) / 2i.
//   Shared-memory rows have a padded stride (W + 1), so thread r reading
//   row r and thread c reading column c hit distinct banks; the twiddle
//   tables are read by every thread at one index (a broadcast). K2y and
//   K2x are staged in shared memory once per block (K2y with a padded
//   stride), while the pairs' first loads are in flight. The coarse lags,
//   the twist and the window keep the direct sums above.
// * measure_kernel, for every other shape (H or W not a power of two, or
//   above 64; the 256 x 256 oversized bucket): one 256-thread block per
//   pair with block reductions and direct separable half-spectrum DFTs.
//   Its per-pair buffers live in shared memory up to kSmemMax (17 KB at
//   32 x 32, 67 KB at 64 x 64), else in a global workspace the wrapper
//   allocates (1 MB a pair at 256 x 256), served by L2.
//
// No tensor cores: the bound is bytes, which tensor cores do not shorten,
// and TF32 keeps about three decimal digits, short of the 5e-4-of-max bar
// the window is held to without a 3xTF32 split. Everything is f32.
//
// Masks are read as bytes when the caller has bool masks (the align loop's),
// else as f32.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// per-pair buffers go to shared memory up to this many bytes
constexpr size_t kSmemMax = 100 * 1024;

enum : int { M_CC = 0, M_NCC = 1, M_SPECTRAL = 2 };

// A (B, H, W) mask: bytes or f32, or null (all ones).
struct Mask {
  const void* p;
  int f32;
  __device__ __forceinline__ float at(long long i) const {
    if (p == nullptr) return 1.0f;
    return f32 ? __ldg(static_cast<const float*>(p) + i)
               : (float)__ldg(static_cast<const unsigned char*>(p) + i);
  }
};

__device__ __forceinline__ int mod(long long a, int n) {
  int r = (int)(a % n);
  return r < 0 ? r + n : r;
}

// ===================== one block per pair (any shape) =====================

// offsets (in floats) of one pair's buffers
struct Layout {
  int Wr, trows;
  long long a, tr, ti, rr, ri, ir, ii, total;
};

__host__ __device__ inline Layout make_layout(int H, int W, int nwin, int ny, int nx) {
  Layout L;
  L.Wr = W / 2 + 1;
  L.trows = H > nwin ? H : nwin;
  if (ny > L.trows) L.trows = ny;  // the coarse stage's rows share tr/ti
  long long hw = (long long)H * W;
  if ((long long)ny * nx > hw) hw = (long long)ny * nx;  // coarse lags share a
  const long long t = (long long)L.trows * L.Wr;
  const long long s = (long long)H * L.Wr;
  L.a = 0;
  L.tr = hw;
  L.ti = L.tr + t;
  L.rr = L.ti + t;
  L.ri = L.rr + s;
  L.ir = L.ri + s;
  L.ii = L.ir + s;
  L.total = L.ii + s;
  return L;
}

inline size_t smem_bytes(int H, int W, long long per_pair, bool pair_in_smem) {
  return sizeof(float) * (2 * (size_t)(H + W) + (pair_in_smem ? (size_t)per_pair : 0));
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red[] may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) red[0] = s;
  }
  __syncthreads();
  return red[0];
}

// One side of the correlation into a[]. Returns the DC-free power in
// M_SPECTRAL mode, 0 otherwise. The caller synchronises before reading a[].
__device__ float load_side(const float* __restrict__ x, Mask m, long long off,
                           float* a, int HW, int mode, float* red) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (mode == M_SPECTRAL) {
    float s = 0.0f;
    for (int i = t; i < HW; i += nt) {
      const float v = __ldg(x + off + i);
      a[i] = v;
      s += v;
    }
    const float mean = block_sum(s, red) / (float)HW;
    float q = 0.0f;
    for (int i = t; i < HW; i += nt) {
      const float d = a[i] - mean;
      q += d * d;
    }
    return (float)HW * block_sum(q, red);
  }
  float sm = 0.0f, sa = 0.0f;
  for (int i = t; i < HW; i += nt) {
    const float mi = m.at(off + i);
    const float v = __ldg(x + off + i) * mi;
    a[i] = v;
    sm += mi;
    sa += v;
  }
  if (mode == M_CC) return 0.0f;
  const float n = fmaxf(block_sum(sm, red), 1.0f);
  const float mean = block_sum(sa, red) / n;
  float q = 0.0f;
  for (int i = t; i < HW; i += nt) {
    const float d = (a[i] - mean) * m.at(off + i);
    a[i] = d;
    q += d * d;
  }
  const float var = block_sum(q, red) / n;
  const float inv = 1.0f / (sqrtf(fmaxf(var, 1e-20f)) * sqrtf(n));
  for (int i = t; i < HW; i += nt) a[i] *= inv;
  return 0.0f;
}

// Half-spectrum DFT X[u, v] = sum_y sum_x a[y, x] e^{-2 pi i (u y / H + v x / W)}
// for u < H, v < Wr: a row pass into (tr, ti), then a column pass into (xr, xi).
__device__ void rdft2(const float* a, float* tr, float* ti, float* xr, float* xi,
                      int H, int W, int Wr, const float* cH, const float* sH,
                      const float* cW, const float* sW) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int o = t; o < H * Wr; o += nt) {
    const int y = o / Wr, v = o - y * Wr;
    const float* row = a + (long long)y * W;
    float re = 0.0f, im = 0.0f;
    int k = 0;  // (v * x) mod W
    for (int x = 0; x < W; ++x) {
      const float val = row[x];
      re = fmaf(val, cW[k], re);
      im = fmaf(-val, sW[k], im);
      k += v;
      if (k >= W) k -= W;
    }
    tr[o] = re;
    ti[o] = im;
  }
  __syncthreads();
  for (int o = t; o < H * Wr; o += nt) {
    const int u = o / Wr, v = o - u * Wr;
    float re = 0.0f, im = 0.0f;
    int k = 0;  // (u * y) mod H
    for (int y = 0; y < H; ++y) {
      const float c = cH[k], s = sH[k];
      const float pr = tr[y * Wr + v], pi = ti[y * Wr + v];
      re = fmaf(pr, c, fmaf(pi, s, re));   // Re{(pr + i pi)(c - i s)}
      im = fmaf(pi, c, fmaf(-pr, s, im));  // Im{...}
      k += u;
      if (k >= H) k -= H;
    }
    xr[o] = re;
    xi[o] = im;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
measure_kernel(const float* __restrict__ ref, const float* __restrict__ img,
               Mask rmask, Mask imask,
               int H, int W, int mode, int nwin, int ly0, int lx0, int ny, int nx,
               const float* __restrict__ tw, const float* __restrict__ k2y,
               const float* __restrict__ k2x, float* workspace,
               float* __restrict__ c2, int* __restrict__ s0y_out,
               int* __restrict__ s0x_out) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  __shared__ int best[2];
  const Layout L = make_layout(H, W, nwin, ny, nx);
  const int Wr = L.Wr;
  const int t = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.x;
  const int HW = H * W;

  // twiddles: cos/sin(2 pi j / H), then cos/sin(2 pi j / W)
  float* cH = smem;
  float* sH = cH + H;
  float* cW = sH + H;
  float* sW = cW + W;
  for (int i = t; i < 2 * (H + W); i += nt) smem[i] = __ldg(tw + i);
  float* buf = workspace ? workspace + b * L.total : sW + W;
  float* a = buf + L.a;
  float* tr = buf + L.tr;
  float* ti = buf + L.ti;
  float* gr_ = buf + L.rr;  // ref spectrum, then G
  float* gi_ = buf + L.ri;
  float* ir_ = buf + L.ir;
  float* ii_ = buf + L.ii;

  // ---- 1-2. both sides, normalised and transformed ----
  const float p_ref = load_side(ref, rmask, b * HW, a, HW, mode, red);
  __syncthreads();
  rdft2(a, tr, ti, gr_, gi_, H, W, Wr, cH, sH, cW, sW);
  const float p_img = load_side(img, imask, b * HW, a, HW, mode, red);
  __syncthreads();
  rdft2(a, tr, ti, ir_, ii_, H, W, Wr, cH, sH, cW, sW);

  // ---- 3. cross-spectrum, in place of the ref spectrum ----
  float scale = 1.0f;
  if (mode == M_SPECTRAL)
    scale = (float)HW * rsqrtf(fmaxf(p_ref, 1e-20f)) * rsqrtf(fmaxf(p_img, 1e-20f));
  for (int o = t; o < H * Wr; o += nt) {
    const float rr = gr_[o], ri = gi_[o], xr = ir_[o], xi = ii_[o];
    float gr = xr * rr + xi * ri;
    float gi = xi * rr - xr * ri;
    if (mode == M_SPECTRAL) {
      gr *= scale;
      gi *= scale;
      if (o == 0) gr = 0.0f;  // both means removed: no DC
    }
    gr_[o] = gr;
    gi_[o] = gi;
  }
  __syncthreads();

  // ---- 4. coarse lags of the search box and their argmax ----
  for (int o = t; o < ny * Wr; o += nt) {
    const int i = o / Wr, v = o - i * Wr;
    const int step = mod(ly0 + i, H);
    float re = 0.0f, im = 0.0f;
    int k = 0;  // (u * lag) mod H
    for (int u = 0; u < H; ++u) {
      const float c = cH[k], s = sH[k], gr = gr_[u * Wr + v], gi = gi_[u * Wr + v];
      re = fmaf(c, gr, fmaf(-s, gi, re));  // Re{(c + i s)(gr + i gi)}
      im = fmaf(c, gi, fmaf(s, gr, im));
      k += step;
      if (k >= H) k -= H;
    }
    tr[o] = re;
    ti[o] = im;
  }
  __syncthreads();
  for (int o = t; o < ny * nx; o += nt) {
    const int i = o / nx, j = o - i * nx;
    const int step = mod(lx0 + j, W);
    float acc = 0.0f;
    int k = 0;  // (v * lag) mod W
    for (int v = 0; v < Wr; ++v) {
      const float wv = (v == 0 || 2 * v == W) ? 1.0f : 2.0f;  // hermitian fold
      acc = fmaf(wv, tr[i * Wr + v] * cW[k] - ti[i * Wr + v] * sW[k], acc);
      k += step;
      if (k >= W) k -= W;
    }
    a[o] = acc / (float)HW;
  }
  __syncthreads();
  if (t == 0) {
    int bi = 0;
    float bv = a[0];
    for (int o = 1; o < ny * nx; ++o) {
      const float v = a[o];
      if (!isnan(bv) && (isnan(v) || v > bv)) {
        bv = v;
        bi = o;
      }
    }
    best[0] = bi / nx + ly0;
    best[1] = bi % nx + lx0;
    s0y_out[b] = best[0];
    s0x_out[b] = best[1];
  }
  __syncthreads();
  const int sy = best[0], sx = best[1];

  // ---- 5. integer-shift phase twist G *= Dy(u) Dx(v) ----
  for (int o = t; o < H * Wr; o += nt) {
    const int u = o / Wr, v = o - u * Wr;
    const int ky = mod((long long)u * sy, H);
    const int kx = mod((long long)v * sx, W);
    const float dr = cH[ky] * cW[kx] - sH[ky] * sW[kx];
    const float di = cH[ky] * sW[kx] + sH[ky] * cW[kx];
    const float gr = gr_[o], gi = gi_[o];
    gr_[o] = gr * dr - gi * di;
    gi_[o] = gr * di + gi * dr;
  }
  __syncthreads();

  // ---- 6. upsampled window: A = K2y Gd, then C2 = Re{A K2x^T} ----
  const float* k2yr = k2y;
  const float* k2yi = k2y + (long long)nwin * H;
  const float* k2xr = k2x;
  const float* k2xi = k2x + (long long)nwin * Wr;
  for (int o = t; o < nwin * Wr; o += nt) {
    const int i = o / Wr, v = o - i * Wr;
    float re = 0.0f, im = 0.0f;
    for (int u = 0; u < H; ++u) {
      const float c = __ldg(k2yr + i * H + u), s = __ldg(k2yi + i * H + u);
      const float gr = gr_[u * Wr + v], gi = gi_[u * Wr + v];
      re = fmaf(c, gr, fmaf(-s, gi, re));
      im = fmaf(c, gi, fmaf(s, gr, im));
    }
    tr[o] = re;
    ti[o] = im;
  }
  __syncthreads();
  float* out = c2 + b * nwin * nwin;
  for (int o = t; o < nwin * nwin; o += nt) {
    const int i = o / nwin, j = o - i * nwin;
    float acc = 0.0f;
    for (int v = 0; v < Wr; ++v)
      acc = fmaf(tr[i * Wr + v], __ldg(k2xr + j * Wr + v),
                 fmaf(-ti[i * Wr + v], __ldg(k2xi + j * Wr + v), acc));
    out[o] = acc;
  }
}

// ============ two warps per pair (square 16, 32, 64 cutouts) =============

// threads that measure one pair (two warps), and pairs per block
constexpr int kPair = 64;
static_assert(kPair % 32 == 0 && kPair <= 256, "whole warps, one block");
constexpr int kPairsMax = 256 / kPair;

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n >> 1); }

__host__ __device__ constexpr int bitrev(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((v >> i) & 1);
  return r;
}

// Where a line of N keeps frequency f after fft_line: in place up to 32
// points; a 64-point line keeps f < 32 at 2f and f >= 32 at 2(f - 32) + 1.
template <int N>
__device__ __forceinline__ int slot(int f) {
  return N <= 32 ? f : 2 * (f % (N / 2)) + f / (N / 2);
}

// One radix-2 stage (half-size HS) of an in-register forward FFT of M
// points, then the next stages. Each stage is its own instantiation, so
// every register index is a compile-time constant and the arrays stay in
// registers. tc/ts hold cos/sin(2 pi j / (M * TSTEP)).
template <int M, int TSTEP, int HS>
__device__ __forceinline__ void fft_stage(float (&re)[M], float (&im)[M],
                                          const float* tc, const float* ts) {
#pragma unroll
  for (int k = 0; k < M; k += 2 * HS) {
#pragma unroll
    for (int j = 0; j < HS; ++j) {
      const float br = re[k + j + HS], bi = im[k + j + HS];
      float tr = br, ti = bi;
      if (j > 0) {  // times e^{-2 pi i j / (2 HS)} = c - i s
        const int t = j * (M / (2 * HS)) * TSTEP;
        const float c = tc[t], s = ts[t];
        tr = br * c + bi * s;
        ti = bi * c - br * s;
      }
      re[k + j + HS] = re[k + j] - tr;
      im[k + j + HS] = im[k + j] - ti;
      re[k + j] += tr;
      im[k + j] += ti;
    }
  }
  if constexpr (2 * HS < M) fft_stage<M, TSTEP, 2 * HS>(re, im, tc, ts);
}

// In-register forward FFT of M points, X[k] = sum_n x[n] e^{-2 pi i n k / M},
// from input in bit-reversed order to output in natural order.
template <int M, int TSTEP>
__device__ __forceinline__ void fft_reg(float (&re)[M], float (&im)[M],
                                        const float* tc, const float* ts) {
  fft_stage<M, TSTEP, 1>(re, im, tc, ts);
}

// Forward FFT of one line of N complex values at lr[i * es], li[i * es],
// in place (frequency f ends at slot<N>(f)). tc/ts: cos/sin(2 pi j / N).
template <int N>
__device__ __forceinline__ void fft_line(float* lr, float* li, int es,
                                         const float* tc, const float* ts) {
  if constexpr (N <= 32) {
    constexpr int kBits = ilog2(N);
    float re[N], im[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int src = bitrev(n, kBits) * es;
      re[n] = lr[src];
      im[n] = li[src];
    }
    fft_reg<N, 1>(re, im, tc, ts);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      lr[k * es] = re[k];
      li[k * es] = im[k];
    }
  } else {
    // X[k] = E[k] + w^k O[k], X[k + M] = E[k] - w^k O[k] (w = e^{-2 pi i/N})
    // with E, O the M-point FFTs of the even and odd samples: E goes to the
    // even slots while O is computed, then X[k] -> 2k, X[k + M] -> 2k + 1
    constexpr int M = N / 2, kBits = ilog2(M);
    float re[M], im[M];
#pragma unroll
    for (int n = 0; n < M; ++n) {
      const int src = 2 * bitrev(n, kBits) * es;
      re[n] = lr[src];
      im[n] = li[src];
    }
    fft_reg<M, 2>(re, im, tc, ts);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      lr[2 * k * es] = re[k];
      li[2 * k * es] = im[k];
    }
#pragma unroll
    for (int n = 0; n < M; ++n) {
      const int src = (2 * bitrev(n, kBits) + 1) * es;
      re[n] = lr[src];
      im[n] = li[src];
    }
    fft_reg<M, 2>(re, im, tc, ts);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float c = tc[k], s = ts[k];
      const float tr = re[k] * c + im[k] * s, ti = im[k] * c - re[k] * s;
      const float er = lr[2 * k * es], ei = li[2 * k * es];
      lr[2 * k * es] = er + tr;
      li[2 * k * es] = ei + ti;
      lr[(2 * k + 1) * es] = er - tr;
      li[(2 * k + 1) * es] = ei - ti;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The kPair threads that measure one pair: thread t of
// the group, its named barrier id (barrier 0 is __syncthreads') and a few
// floats of shared scratch for sums across its warps.
struct Group {
  int t, id;
  float* red;
};

__device__ __forceinline__ void group_sync(const Group& g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g.id), "r"(kPair) : "memory");
}

// Sums of the N values v over the group, in place; every thread gets them.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], const Group& g) {
  static_assert(N <= 4, "the group's scratch holds 4 values a warp");
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  group_sync(g);  // red[] may still be read from the previous call
  if ((g.t & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) g.red[4 * (g.t >> 5) + k] = v[k];
  }
  group_sync(g);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = 0.0f;
#pragma unroll
    for (int w = 0; w < kPair / 32; ++w) v[k] += g.red[4 * w + k];
  }
}

// torch.argmax's order: NaN above every number, then larger values, then
// the first index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  if (a != b) return a > b;
  return ia < ib;
}

// G[k] from Z[k] = A + iB and Zm = Z[-k]: R = (Z + conj Zm)/2 (ref),
// I = (Z - conj Zm)/2i (img), G = I conj(R), scaled.
__device__ __forceinline__ void cross(float ar, float ai, float br, float bi,
                                      float scale, float& gr, float& gi) {
  const float rr = 0.5f * (ar + br), ri = 0.5f * (ai - bi);
  const float xr = 0.5f * (ai + bi), xi = 0.5f * (br - ar);
  gr = (xr * rr + xi * ri) * scale;
  gi = (xi * rr - xr * ri) * scale;
}

// Stage 1 of the FFT kernel with f32 masks (masked NCC or CC): both
// sides of pair `off`, normalised, into zr (ref) and zi (img), row stride
// W + 1. Each thread revisits only the cells it wrote, so no barrier is
// needed between the passes.
template <int H, int W>
__device__ __forceinline__ void load_pair_f32(const float* __restrict__ ref,
                                              const float* __restrict__ img,
                                              const float* __restrict__ rm,
                                              const float* __restrict__ im,
                                              long long off, int mode, float* zr,
                                              float* zi, const Group& g) {
  constexpr int S = W + 1, HW = H * W;
  float nr = 0.0f, ni = 0.0f, sr = 0.0f, si = 0.0f;
#pragma unroll
  for (int o = g.t; o < HW; o += kPair) {
    const float mr = __ldg(rm + off + o), mi = __ldg(im + off + o);
    const float vr = __ldg(ref + off + o) * mr, vi = __ldg(img + off + o) * mi;
    const int y = o / W, x = o - y * W;
    zr[y * S + x] = vr;
    zi[y * S + x] = vi;
    nr += mr;
    ni += mi;
    sr += vr;
    si += vi;
  }
  if (mode == M_CC) return;
  float m[4] = {nr, ni, sr, si};
  group_sum(m, g);
  const float n_r = fmaxf(m[0], 1.0f), n_i = fmaxf(m[1], 1.0f);
  const float mean_r = m[2] / n_r, mean_i = m[3] / n_i;
  float qr = 0.0f, qi = 0.0f;
#pragma unroll 16
  for (int o = g.t; o < HW; o += kPair) {
    const int y = o / W, x = o - y * W;
    const float dr = (zr[y * S + x] - mean_r) * __ldg(rm + off + o);
    const float di = (zi[y * S + x] - mean_i) * __ldg(im + off + o);
    zr[y * S + x] = dr;
    zi[y * S + x] = di;
    qr += dr * dr;
    qi += di * di;
  }
  // one reciprocal per side: a division per value takes the divide's
  // slow path for every masked-out 0 and stalls the pair on it
  float q[2] = {qr, qi};
  group_sum(q, g);
  const float inv_r = 1.0f / (sqrtf(fmaxf(q[0] / n_r, 1e-20f)) * sqrtf(n_r));
  const float inv_i = 1.0f / (sqrtf(fmaxf(q[1] / n_i, 1e-20f)) * sqrtf(n_i));
#pragma unroll 16
  for (int o = g.t; o < HW; o += kPair) {
    const int y = o / W, x = o - y * W;
    zr[y * S + x] *= inv_r;
    zi[y * S + x] *= inv_i;
  }
}

// Stage 1 of the FFT kernel: both sides of pair `off`, normalised, into
// zr (ref) and zi (img), row stride W + 1. Returns the cross-spectrum's
// scale (1 but for unmasked NCC, which takes its DC-free Parseval
// powers). Without masks (MT 0) or with byte masks (MT 1) each thread loads
// 4 consecutive values at a time (a float4 of each side, a 32-bit word of
// each mask) and keeps its mask values as bits for the second pass, so the
// pair's inputs are read from device memory once, with few instructions;
// f32 masks (MT 2) take load_pair_f32. Each thread revisits only the cells
// it wrote, so no barrier is needed between the passes.
template <int H, int W, int MT>
__device__ __forceinline__ float load_pair(const float* __restrict__ ref,
                                           const float* __restrict__ img,
                                           const void* __restrict__ rmask,
    const void* __restrict__ imask,
                                           long long off, int mode, float* zr,
                                           float* zi, const Group& g) {
  if constexpr (MT == 2) {
    load_pair_f32<H, W>(ref, img, static_cast<const float*>(rmask),
                        static_cast<const float*>(imask), off, mode, zr, zi, g);
    return 1.0f;
  } else {
    constexpr int S = W + 1, HW = H * W, kVec = HW / (4 * kPair);
    constexpr int kWords = (4 * kVec + 31) / 32;  // mask bits per thread
    static_assert(HW % (4 * kPair) == 0 && W % 4 == 0, "whole float4 chunks");
    const unsigned char* __restrict__ rm = static_cast<const unsigned char*>(rmask);
    const unsigned char* __restrict__ im = static_cast<const unsigned char*>(imask);
    unsigned br[kWords], bi[kWords];
    float nr = 0.0f, ni = 0.0f, sr = 0.0f, si = 0.0f;
#pragma unroll
    for (int w = 0; w < kWords; ++w) br[w] = bi[w] = 0u;
    // batches of kBatch chunks: all of a batch's loads are issued before
    // any of its values is used
    constexpr int kBatch = kVec < 8 ? kVec : 8;
#pragma unroll
    for (int k0 = 0; k0 < kVec; k0 += kBatch) {
      float4 a[kBatch], c[kBatch];
      unsigned wr[kBatch], wi[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int o = 4 * (g.t + kPair * (k0 + q));  // the chunk's first element
        a[q] = __ldg(reinterpret_cast<const float4*>(ref + off + o));
        c[q] = __ldg(reinterpret_cast<const float4*>(img + off + o));
        wr[q] = wi[q] = 0x01010101u;
        if constexpr (MT == 1) {
          wr[q] = __ldg(reinterpret_cast<const unsigned*>(rm + off + o));
          wi[q] = __ldg(reinterpret_cast<const unsigned*>(im + off + o));
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int k = k0 + q, o = 4 * (g.t + kPair * k);
        const float va[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
        const float vc[4] = {c[q].x, c[q].y, c[q].z, c[q].w};
        const int y = o / W, x = o - y * W;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float mr = (float)((wr[q] >> (8 * t)) & 0xffu);
          const float mi = (float)((wi[q] >> (8 * t)) & 0xffu);
          const float vr = va[t] * mr, vi = vc[t] * mi;
          zr[y * S + x + t] = vr;
          zi[y * S + x + t] = vi;
          nr += mr;
          ni += mi;
          sr += vr;
          si += vi;
          const int e = 4 * k + t;
          br[e / 32] |= (mr != 0.0f ? 1u : 0u) << (e % 32);
          bi[e / 32] |= (mi != 0.0f ? 1u : 0u) << (e % 32);
        }
      }
    }
    if (mode == M_CC) return 1.0f;
    float m[4] = {nr, ni, sr, si};
    group_sum(m, g);
    const float n_r = fmaxf(m[0], 1.0f), n_i = fmaxf(m[1], 1.0f);
    const float mean_r = m[2] / n_r, mean_i = m[3] / n_i;
    float qr = 0.0f, qi = 0.0f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int o = 4 * (g.t + kPair * k), y = o / W, x = o - y * W;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = 4 * k + t;
        float dr = zr[y * S + x + t] - mean_r, di = zi[y * S + x + t] - mean_i;
        if (mode == M_NCC) {  // masked: remove the mean under the mask only
          dr *= (float)((br[e / 32] >> (e % 32)) & 1u);
          di *= (float)((bi[e / 32] >> (e % 32)) & 1u);
          zr[y * S + x + t] = dr;
          zi[y * S + x + t] = di;
        }
        qr += dr * dr;
        qi += di * di;
      }
    }
    float q[2] = {qr, qi};
    group_sum(q, g);
    if (mode == M_SPECTRAL)  // raw data kept (MT is 0: n = H*W)
      return (float)HW * rsqrtf(fmaxf((float)HW * q[0], 1e-20f)) *
             rsqrtf(fmaxf((float)HW * q[1], 1e-20f));
    const float inv_r = 1.0f / (sqrtf(fmaxf(q[0] / n_r, 1e-20f)) * sqrtf(n_r));
    const float inv_i = 1.0f / (sqrtf(fmaxf(q[1] / n_i, 1e-20f)) * sqrtf(n_i));
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int o = 4 * (g.t + kPair * k), y = o / W, x = o - y * W;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        zr[y * S + x + t] *= inv_r;
        zi[y * S + x + t] *= inv_i;
      }
    }
    return 1.0f;
  }
}

struct FftLayout {  // floats
  int consts, per_pair, trows;
};

__host__ __device__ inline FftLayout fft_layout(int H, int W, int nwin, int ny) {
  const int Wr = W / 2 + 1;
  FftLayout L;
  L.trows = ny > nwin ? ny : nwin;
  L.consts = 2 * (H + W) + 2 * nwin * (H + 1) + 2 * nwin * Wr;
  L.per_pair = 2 * H * (W + 1) + 2 * L.trows * Wr + 4 * (kPair / 32);
  return L;
}

template <int H, int W>
__global__ void __launch_bounds__(kPairsMax * kPair)
measure_fft_kernel(const float* __restrict__ ref, const float* __restrict__ img,
                    const void* __restrict__ rmask,
    const void* __restrict__ imask, int mt, int B, int ppb,
                    int mode, int nwin,
                    int ly0, int lx0, int ny, int nx,
                    const float* __restrict__ tw, const float* __restrict__ k2y,
                    const float* __restrict__ k2x, float* __restrict__ c2,
                    int* __restrict__ s0y_out, int* __restrict__ s0x_out) {
  constexpr int Wr = W / 2 + 1, S = W + 1, HW = H * W;
  extern __shared__ float smem[];
  const FftLayout L = fft_layout(H, W, nwin, ny);
  float* cH = smem;
  float* sH = cH + H;
  float* cW = sH + H;
  float* sW = cW + W;
  float* kyr = sW + W;  // (nwin, H + 1)
  float* kyi = kyr + nwin * (H + 1);
  float* kxr = kyi + nwin * (H + 1);  // (nwin, Wr)
  float* kxi = kxr + nwin * Wr;

  // ---- constants, once per block ----
  for (int i = threadIdx.x; i < 2 * (H + W); i += blockDim.x) smem[i] = __ldg(tw + i);
  for (int i = threadIdx.x; i < nwin * H; i += blockDim.x) {
    const int r = i / H, u = i - r * H;
    kyr[r * (H + 1) + u] = __ldg(k2y + i);
    kyi[r * (H + 1) + u] = __ldg(k2y + nwin * H + i);
  }
  for (int i = threadIdx.x; i < nwin * Wr; i += blockDim.x) {
    kxr[i] = __ldg(k2x + i);
    kxi[i] = __ldg(k2x + nwin * Wr + i);
  }
  const int pair = threadIdx.x / kPair;
  const long long b = (long long)blockIdx.x * ppb + pair;
  float* zr = smem + L.consts + pair * L.per_pair;  // (H, S): z = ref + i img
  float* zi = zr + H * S;
  float* tr = zi + H * S;  // (trows, Wr): coarse rows, then window rows
  float* ti = tr + L.trows * Wr;
  const Group g{(int)(threadIdx.x % kPair), 1 + pair, ti + L.trows * Wr};
  const long long off = b * HW;

  // ---- 1. both sides, normalised, into z (its loads in flight with the
  // constants', before the block's one barrier) ----
  float scale = 1.0f;
  if (b < B) {
    if (mt == 0)
      scale = load_pair<H, W, 0>(ref, img, rmask, imask, off, mode, zr, zi, g);
    else if (mt == 1)
      scale = load_pair<H, W, 1>(ref, img, rmask, imask, off, mode, zr, zi, g);
    else
      scale = load_pair<H, W, 2>(ref, img, rmask, imask, off, mode, zr, zi, g);
  }
  __syncthreads();
  if (b >= B) return;  // uniform over the group; no block barrier follows

  // ---- 2. one complex 2-D FFT: a thread per row, then per column ----
  for (int r = g.t; r < H; r += kPair) fft_line<W>(zr + r * S, zi + r * S, 1, cW, sW);
  group_sync(g);
  for (int c = g.t; c < W; c += kPair) fft_line<H>(zr + c, zi + c, S, cH, sH);
  group_sync(g);

  // ---- 3. split the half-spectra, cross-spectrum G in place (v < Wr) ----
  // Z at frequency (u, v) is needed by G(u, v) and G(-u, -v); for
  // 0 < v < W/2 the second lies in a column never written, so only the
  // self-paired columns v = 0, W/2 take u and -u together (one thread for
  // u <= H/2, none for the rest).
  for (int o = g.t; o < H * Wr; o += kPair) {
    const int u = o / Wr, v = o - u * Wr;
    const int cv = slot<W>(v), cp = slot<W>((W - v) % W);
    const int u2 = (H - u) % H;
    const int a = slot<H>(u) * S + cv, m = slot<H>(u2) * S + cp;
    float gr, gi;
    if (cv != cp) {
      cross(zr[a], zi[a], zr[m], zi[m], scale, gr, gi);
      zr[a] = gr;
      zi[a] = gi;
    } else if (u <= H / 2) {
      const float ar = zr[a], ai = zi[a], br = zr[m], bi = zi[m];
      cross(ar, ai, br, bi, scale, gr, gi);
      if (mode == M_SPECTRAL && u == 0 && v == 0) gr = 0.0f;  // no DC
      zr[a] = gr;
      zi[a] = gi;
      if (u2 != u) {
        cross(br, bi, ar, ai, scale, gr, gi);
        zr[m] = gr;
        zi[m] = gi;
      }
    }
  }
  group_sync(g);

  // ---- 4. coarse lags of the search box and their argmax ----
  for (int o = g.t; o < ny * Wr; o += kPair) {
    const int i = o / Wr, v = o - i * Wr;
    const int cv = slot<W>(v);
    const int step = mod(ly0 + i, H);
    float re = 0.0f, im = 0.0f;
    int k = 0;  // (u * lag) mod H
    for (int u = 0; u < H; ++u) {
      const int q = slot<H>(u) * S + cv;
      const float c = cH[k], s = sH[k], gr = zr[q], gi = zi[q];
      re = fmaf(c, gr, fmaf(-s, gi, re));  // Re{(c + i s)(gr + i gi)}
      im = fmaf(c, gi, fmaf(s, gr, im));
      k += step;
      if (k >= H) k -= H;
    }
    tr[o] = re;
    ti[o] = im;
  }
  group_sync(g);
  float bv = 0.0f;
  int bi = INT_MAX;  // none yet
  for (int o = g.t; o < ny * nx; o += kPair) {
    const int i = o / nx, j = o - i * nx;
    const int step = mod(lx0 + j, W);
    float acc = 0.0f;
    int k = 0;  // (v * lag) mod W
    for (int v = 0; v < Wr; ++v) {
      const float wv = (v == 0 || 2 * v == W) ? 1.0f : 2.0f;  // hermitian fold
      acc = fmaf(wv, tr[i * Wr + v] * cW[k] - ti[i * Wr + v] * sW[k], acc);
      k += step;
      if (k >= W) k -= W;
    }
    const float val = acc * (1.0f / (float)HW);  // exact: HW is a power of 2
    if (bi == INT_MAX || better(val, o, bv, bi)) {
      bv = val;
      bi = o;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (oi != INT_MAX && (bi == INT_MAX || better(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  // then across the group's warps
  group_sync(g);  // red[] may still be read by a sum
  if ((g.t & 31) == 0) {
    g.red[g.t >> 5] = bv;
    g.red[kPair / 32 + (g.t >> 5)] = __int_as_float(bi);
  }
  group_sync(g);
#pragma unroll
  for (int w = 0; w < kPair / 32; ++w) {
    const float ov = g.red[w];
    const int oi = __float_as_int(g.red[kPair / 32 + w]);
    if (oi != INT_MAX && (bi == INT_MAX || better(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  const int sy = bi / nx + ly0, sx = bi % nx + lx0;
  if (g.t == 0) {
    s0y_out[b] = sy;
    s0x_out[b] = sx;
  }

  // ---- 5. integer-shift phase twist G *= Dy(u) Dx(v) ----
  for (int o = g.t; o < H * Wr; o += kPair) {
    const int u = o / Wr, v = o - u * Wr;
    const int ky = mod((long long)u * sy, H), kx = mod((long long)v * sx, W);
    const float dr = cH[ky] * cW[kx] - sH[ky] * sW[kx];
    const float di = cH[ky] * sW[kx] + sH[ky] * cW[kx];
    const int c = slot<H>(u) * S + slot<W>(v);
    const float gr = zr[c], gi = zi[c];
    zr[c] = gr * dr - gi * di;
    zi[c] = gr * di + gi * dr;
  }
  group_sync(g);

  // ---- 6. upsampled window: A = K2y Gd, then C2 = Re{A K2x^T} ----
  for (int o = g.t; o < nwin * Wr; o += kPair) {
    const int i = o / Wr, v = o - i * Wr;
    const int cv = slot<W>(v);
    float re = 0.0f, im = 0.0f;
    for (int u = 0; u < H; ++u) {
      const float c = kyr[i * (H + 1) + u], s = kyi[i * (H + 1) + u];
      const int q = slot<H>(u) * S + cv;
      const float gr = zr[q], gi = zi[q];
      re = fmaf(c, gr, fmaf(-s, gi, re));
      im = fmaf(c, gi, fmaf(s, gr, im));
    }
    tr[o] = re;
    ti[o] = im;
  }
  group_sync(g);
  float* out = c2 + b * nwin * nwin;
  for (int o = g.t; o < nwin * nwin; o += kPair) {
    const int i = o / nwin, j = o - i * nwin;
    float acc = 0.0f;
    for (int v = 0; v < Wr; ++v)
      acc = fmaf(tr[i * Wr + v], kxr[j * Wr + v], fmaf(-ti[i * Wr + v], kxi[j * Wr + v], acc));
    out[o] = acc;
  }
}

// Pairs per block of the FFT kernel for this shape, or 0 when the shape
// takes the one-block kernel.
int fft_pairs(int H, int W, int nwin, int ny) {
  if (H != W || (H != 16 && H != 32 && H != 64)) return 0;
  const FftLayout L = fft_layout(H, W, nwin, ny);
  const long long room = (long long)(kSmemMax / sizeof(float)) - L.consts;
  long long p = room / L.per_pair;
  if (p > kPairsMax) p = kPairsMax;
  return p < 1 ? 0 : (int)p;
}

template <int N>
int launch_fft(const float* ref, const float* img, const void* rm,
                const void* im, int mt, int B,
                int ppb, int mode, int nwin, int ly0, int lx0, int ny, int nx,
                const float* tw, const float* k2y, const float* k2x, float* c2,
                int* s0y, int* s0x, cudaStream_t stream) {
  const FftLayout L = fft_layout(N, N, nwin, ny);
  const size_t bytes = sizeof(float) * ((size_t)L.consts + (size_t)ppb * L.per_pair);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        measure_fft_kernel<N, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((B + ppb - 1) / ppb);
  measure_fft_kernel<N, N><<<blocks, kPair * ppb, bytes, stream>>>(
      ref, img, rm, im, mt, B, ppb, mode, nwin, ly0, lx0, ny, nx, tw, k2y, k2x,
      c2, s0y, s0x);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when (H, W, nwin, ny) takes the FFT kernel, 0 when it takes
// the one-block-per-pair kernel.
extern "C" int measure_window_route(int H, int W, int nwin, int ny) {
  return fft_pairs(H, W, nwin, ny) > 0 ? 1 : 0;
}

// Floats of global workspace the wrapper must allocate for B pairs of
// H x W at window nwin and ny x nx coarse lags: 0 when a pair's buffers
// fit in shared memory.
extern "C" long long measure_window_workspace_floats(int B, int H, int W, int nwin,
                                                     int ny, int nx) {
  if (fft_pairs(H, W, nwin, ny) > 0) return 0;
  const Layout L = make_layout(H, W, nwin, ny, nx);
  if (smem_bytes(H, W, L.total, true) <= kSmemMax) return 0;
  return (long long)B * L.total;
}

// Measure B pairs of (H, W) f32 cutouts on `stream`. rmask / imask are
// (B, H, W) bytes (mask_f32 = 0) or f32 (mask_f32 = 1), or null (all
// ones); mode is 0 'CC', 1 masked 'NCC'/'ZNCC', 2 unmasked 'NCC'/'ZNCC';
// the coarse lags are ly0 .. ly0+ny-1 by lx0 .. lx0+nx-1. tw holds cos, sin
// of 2*pi*j/H (j < H) then of 2*pi*j/W (j < W); k2y the real then imaginary
// (nwin, H) window kernel; k2x the real then imaginary (nwin, W/2+1) one.
// workspace is null or holds measure_window_workspace_floats(B, H, W,
// nwin, ny, nx) floats. Writes c2 (B, nwin, nwin), s0y and s0x (B,).
// Returns cudaGetLastError() after the launch, or the error that
// prevented it.
extern "C" int measure_window_launch(const float* ref, const float* img,
                                     const void* __restrict__ rmask,
    const void* __restrict__ imask,
                                     int mask_f32, int B, int H, int W, int mode,
                                     int nwin, int ly0, int lx0, int ny, int nx,
                                     const float* tw, const float* k2y,
                                     const float* k2x, float* workspace,
                                     float* c2, int* s0y, int* s0x, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (H < 1 || W < 1 || nwin < 1 || ny < 1 || nx < 1 || mode < M_CC || mode > M_SPECTRAL)
    return (int)cudaErrorInvalidValue;
  const Mask rm{rmask, mask_f32}, im{imask, mask_f32};
  cudaStream_t s = (cudaStream_t)stream;
  int ppb = fft_pairs(H, W, nwin, ny);
  if (ppb > 0) {
    // fewer pairs per block while the blocks would not cover every SM
    int dev = 0, sms = 1;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    while (ppb > 1 && (B + ppb - 1) / ppb < sms) ppb /= 2;
    // both masks or none (the wrapper passes a given mask for both sides
    // or fills in the missing one)
    if ((rmask == nullptr) != (imask == nullptr)) return (int)cudaErrorInvalidValue;
    const int mt = rmask == nullptr ? 0 : (mask_f32 ? 2 : 1);
    switch (H) {
      case 16:
        return launch_fft<16>(ref, img, rmask, imask, mt, B, ppb, mode, nwin, ly0, lx0,
                               ny, nx, tw, k2y, k2x, c2, s0y, s0x, s);
      case 32:
        return launch_fft<32>(ref, img, rmask, imask, mt, B, ppb, mode, nwin, ly0, lx0,
                               ny, nx, tw, k2y, k2x, c2, s0y, s0x, s);
      default:
        return launch_fft<64>(ref, img, rmask, imask, mt, B, ppb, mode, nwin, ly0, lx0,
                               ny, nx, tw, k2y, k2x, c2, s0y, s0x, s);
    }
  }
  const Layout L = make_layout(H, W, nwin, ny, nx);
  const size_t bytes = smem_bytes(H, W, L.total, workspace == nullptr);
  if (bytes > kSmemMax && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        measure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  measure_kernel<<<(unsigned)B, kThreads, bytes, s>>>(
      ref, img, rm, im, H, W, mode, nwin, ly0, lx0, ny, nx, tw, k2y, k2x,
      workspace, c2, s0y, s0x);
  return (int)cudaGetLastError();
}
