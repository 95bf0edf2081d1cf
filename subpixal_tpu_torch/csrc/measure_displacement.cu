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
// phase is exact, as the reference's int32 reduction makes it. Both sides
// go through ONE complex 2-D FFT, z = a_ref + i*a_img, and the half-spectra
// split by hermitian symmetry, R = (Z[k] + conj Z[-k]) / 2 and
// I = (Z[k] - conj Z[-k]) / 2i.
//
// What bounds it on this card: bytes up to 48 x 48 (32 x 32: 0.2 MFLOP against
// 10 KB of inputs, below the f32 ridge of 67 TFLOP/s over 3.35 TB/s = 20
// FLOP/byte), operations from 64 x 64 up, where the direct coarse-lag and
// window sums grow as H*W*(ny + nwin). The work per pair is small and its
// stages depend on each other, so what a design loses time to is latency:
// barriers, idle SMs and threads, serial steps and bank conflicts.
//
// Two kernels, picked by shape in measure_window_plan, whose plan
// measure_window_launch carries out:
//
// * measure_fft_kernel, for square 16, 32 or 64 cutouts (the align path's
//   32 x 32 cutouts, bench.py's 64 x 64 batch): a group of kPair = 64
//   threads (two warps) per pair, several pairs per block, so a stage
//   barrier is a named barrier of the pair's 64 threads, and the per-pair
//   sums (masked count, mean, variance, Parseval power) and the argmax are
//   warp shuffles plus one exchange through shared memory. (One warp per
//   pair was slower at 32 x 32 and 64 x 64: with 512 pairs an SM holds
//   about 4 warps and every stall is exposed; four warps a pair gained
//   nothing over two.) A thread's loads of each pass are all in flight at
//   once: the mask type (none, bytes, f32) is a template parameter, so no
//   branch stands between them (a branch there made their latencies add
//   up), and a side is scaled by one reciprocal, not a division per value
//   (whose slow path every masked-out zero takes). The FFT runs one thread
//   per row and then one per column, each holding its line in registers (a
//   radix-2 FFT of up to 32 points; a 64-point line is two 32-point passes
//   joined by one radix-2 step). Shared-memory rows have a padded stride
//   (W + 1), so thread r reading row r and thread c reading column c hit
//   distinct banks. K2y and K2x are staged in shared memory once per block.
// * measure_mixed_kernel, for every other shape (48, 80, 96, 112, 128 and
//   the oversized bucket's 256; non-square and odd shapes; and, asked for,
//   the FFT kernel's): a mixed-radix FFT for any N = P * m, P the power of
//   two in N and m odd. Radix-2 decimation-in-frequency passes in shared
//   memory split each of a line's m subsequences (stride m) into blocks of
//   at most 16 points (none at 48, 80, 112; one at 96, three at 128, four
//   at 256); a thread then transforms one block in its registers (the FFT
//   kernel's radix-2 code); one direct length-m DFT pass finishes each line
//   out of place, a thread taking the m values of one frequency of the
//   blocks and giving m outputs (m_pass). At 48 x 48 a line's transform is
//   thus two shared-memory passes with one barrier between them, where
//   radix-2 passes alone took five. Rows are padded to an odd stride
//   (W + 1), so the threads of a warp, one a row, hit distinct banks. The
//   masked normalisation scales the cross-spectrum, not the data.
//   A pair is measured by one CTA of 128 threads, or by a thread-block
//   cluster of C = 2-8 CTAs (256 threads when two fit an SM, else 512):
//   CTA k holds rows [k RP, (k+1) RP) and finishes their transforms; it
//   then gathers, through distributed shared memory, the columns it owns
//   (the column pairs {v, W - v} for v in its share of the half-spectrum,
//   so the hermitian split, fused into the column pass's length-m step,
//   needs no peer), a copy in which no remote value is read twice. The
//   coarse lags and the window then run on those columns alone, and the
//   coarse surface and the window are sums over v, added across the
//   cluster in rank order (the same floats in every CTA, so every CTA takes
//   the same argmax). The integer-shift twist is folded into the window:
//   K2y times Dy before the sum over u, Dx after it; with one CTA a pair a
//   thread sums two window rows by two columns, so each value it loads
//   serves twice. C is the fewest
//   CTAs whose buffers fit two CTAs per SM (or one: 8 CTAs of 180 KB at
//   256 x 256), raised while the grid would not cover every SM: 16 pairs
//   of 256 x 256 run on 128 SMs, not 16. Shapes whose buffers fit no
//   cluster of 8 keep them in a global workspace (served by L2), indexed by
//   rank in place of the distributed shared memory. What bounds it: at
//   48 x 48 a chain of a dozen barrier-separated stages of similar cost,
//   the loads and the window sums the largest, four CTAs sharing an SM's
//   issue slots and shared memory; at 128 x 128 and up, registers (128 a
//   thread) limit an SM to two CTAs, and the loads and the exchange
//   through distributed shared memory are the largest stages.

// No tensor cores: TF32 keeps about three decimal digits, short of the
// 5e-4-of-max bar the window is held to without a 3xTF32 split. Everything
// is f32.
//
// Masks are read as bytes when the caller has bool masks (the align loop's),
// else as f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// the FFT kernel's pairs per block fill shared memory up to this many bytes
constexpr size_t kSmemMax = 100 * 1024;

enum : int { M_CC = 0, M_NCC = 1, M_SPECTRAL = 2 };

__device__ __forceinline__ int mod(long long a, int n) {
  int r = (int)(a % n);
  return r < 0 ? r + n : r;
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
// registers. tc/ts hold cos/sin(2 pi j / (M * tstep)).
template <int M, int HS>
__device__ __forceinline__ void fft_stage(float (&re)[M], float (&im)[M],
                                          const float* tc, const float* ts, int tstep) {
#pragma unroll
  for (int k = 0; k < M; k += 2 * HS) {
#pragma unroll
    for (int j = 0; j < HS; ++j) {
      const float br = re[k + j + HS], bi = im[k + j + HS];
      float tr = br, ti = bi;
      if (j > 0) {  // times e^{-2 pi i j / (2 HS)} = c - i s
        const int t = j * (M / (2 * HS)) * tstep;
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
  if constexpr (2 * HS < M) fft_stage<M, 2 * HS>(re, im, tc, ts, tstep);
}

// In-register forward FFT of M points, X[k] = sum_n x[n] e^{-2 pi i n k / M},
// from input in bit-reversed order to output in natural order; tc/ts hold
// cos/sin(2 pi j / (M * tstep)).
template <int M>
__device__ __forceinline__ void fft_reg(float (&re)[M], float (&im)[M],
                                        const float* tc, const float* ts, int tstep) {
  if constexpr (M > 1) fft_stage<M, 1>(re, im, tc, ts, tstep);
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
    fft_reg<N>(re, im, tc, ts, 1);
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
    fft_reg<M>(re, im, tc, ts, 2);
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
    fft_reg<M>(re, im, tc, ts, 2);
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
// takes the mixed-radix kernel.
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

// ========== mixed radix, a cluster of CTAs per pair (every other shape) ==========

// threads of a CTA, as measured on the H100: 128 when one CTA measures a
// pair (256 was slower at 32 x 32 and 48 x 48); in a cluster 256 when
// the cut leaves two CTAs an SM (faster than 512 at 80 x 80 to
// 128 x 128: 512 threads get 64 registers each and spill), else 512
// (faster than 256 at 256 x 256, where one CTA fills an SM). A thread
// may take 128 registers in each case.
constexpr int kSoloThreads = 128, kPairThreads = 256, kClusterThreads = 512;
constexpr int kMaxWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
// dynamic shared memory a CTA may take: at most kSmemTwo leaves room for
// two CTAs per SM; kSmemOne is the card's per-block limit
constexpr size_t kSmemTwo = 113 * 1024;
constexpr size_t kSmemOne = 227 * 1024;
// floats of the CTA's scratch: 4 partial sums a warp, then 16 slots of
// cluster sums, then (value, index) of the argmax a warp
constexpr int kRedSlots = 4 * kMaxWarps, kRedArg = kRedSlots + 16;
constexpr int kRed = kRedArg + 2 * kMaxWarps;

// How one shape is cut over a cluster: C CTAs per pair, CTA k holding rows
// [k RP, (k+1) RP) of the pair and column pairs {p, W - p} for p in
// [k PP, (k+1) PP); S floats per plane of each of its two buffers; ws 1
// when those buffers live in a global workspace, not shared memory.
struct MixPlan {
  int C, RP, PP, PPs, S, ws;
  long long smem_floats;
};

// The radix-2 passes in shared memory before the register FFTs of a line
// whose power-of-two part is P: enough to leave blocks of at most 16
// points. With blocks of 32 (64 values in registers) the one-CTA kernel
// took 255 registers a thread, so half as many CTAs fit an SM, and the
// cluster kernel, held to 128 by its 512 threads, spilled.
inline int dif_count(int P) {
  int b = 0;
  while ((P >> b) > 16) ++b;
  return b;
}

// offsets (floats) of the CTA's shared arrays
struct MixLayout {
  long long tw, k2y, k2x, cp, c2p, x, y, total;
};

__host__ __device__ inline MixLayout mix_layout(int H, int W, int nwin, int ny, int nx,
                                                int PPs, int S, int ws) {
  MixLayout L;
  L.tw = kRed;
  L.k2y = L.tw + 2LL * (H + W);
  L.k2x = L.k2y + 2LL * nwin * H;
  L.cp = L.k2x + 2LL * nwin * PPs;
  L.c2p = L.cp + (long long)ny * nx;
  L.x = L.c2p + (long long)nwin * nwin;
  L.y = L.x + (ws ? 0 : 2LL * S);
  L.total = L.y + (ws ? 0 : 2LL * S);
  return L;
}

inline MixPlan mix_cut(int H, int W, int nwin, int ny, int nx, int C, int ws) {
  MixPlan p;
  const int Wr = W / 2 + 1;
  p.C = C;
  p.RP = (H + C - 1) / C;
  p.PP = (Wr + C - 1) / C;
  p.PPs = p.PP | 1;  // odd stride: K2x rows of one CTA on distinct banks
  long long s = (long long)p.RP * (W + 1);            // rows, then
  if ((long long)H * 2 * p.PP > s) s = (long long)H * 2 * p.PP;  // columns
  if ((long long)ny * p.PP > s) s = (long long)ny * p.PP;        // coarse rows
  if ((long long)nwin * p.PP > s) s = (long long)nwin * p.PP;    // window rows
  p.S = (int)s;
  p.ws = ws;
  p.smem_floats = mix_layout(H, W, nwin, ny, nx, p.PPs, p.S, ws).total;
  return p;
}

// The cut of B pairs of H x W: the fewest CTAs per pair whose buffers fit
// two CTAs per SM, else one, else buffers in a global workspace at 8;
// then more CTAs per pair while the grid would not cover every SM.
// C = 0 when not even the constants fit.
inline MixPlan mix_plan(int B, int H, int W, int nwin, int ny, int nx, int sms) {
  const int Wr = W / 2 + 1;
  const int cmax_split = H < Wr ? H : Wr;
  MixPlan p{};
  bool found = false;
  const size_t budgets[2] = {kSmemTwo, kSmemOne};
  for (size_t budget : budgets) {
    for (int C = 1; C <= kMaxCluster && !found; C *= 2) {
      if (C > 1 && C > cmax_split) break;
      const MixPlan q = mix_cut(H, W, nwin, ny, nx, C, 0);
      if ((size_t)q.smem_floats * sizeof(float) <= budget) {
        p = q;
        found = true;
      }
    }
    if (found) break;
  }
  if (!found) {
    int C = kMaxCluster;
    while (C > 1 && C > cmax_split) C /= 2;
    p = mix_cut(H, W, nwin, ny, nx, C, 1);
    if ((size_t)p.smem_floats * sizeof(float) > kSmemOne) p.C = 0;
    return p;
  }
  while ((long long)B * p.C < sms && 2 * p.C <= kMaxCluster && 2 * p.C <= cmax_split) {
    const MixPlan q = mix_cut(H, W, nwin, ny, nx, 2 * p.C, p.ws);
    if ((size_t)q.smem_floats * sizeof(float) > kSmemOne) break;
    p = q;
  }
  return p;
}

struct MixArgs {
  const float* ref;
  const float* img;
  const void* rmask;
  const void* imask;
  int H, W, mode, nwin, ly0, lx0, ny, nx;
  int C, RP, PP, PPs, S;
  // H = PH * MH and W = PW * MW, PH and PW powers of two and MH, MW odd;
  // BH, BW radix-2 passes in shared memory leave blocks of at most 16
  // points to the register FFTs
  int PH, MH, BH, PW, MW, BW;
  const float* tw;
  const float* k2y;
  const float* k2x;
  float* ws;  // null, or 4 S floats per CTA
  float* c2;
  int* s0y;
  int* s0x;
};

template <int MT>
__device__ __forceinline__ float mask_at(const void* p, long long i) {
  if constexpr (MT == 0) {
    return 1.0f;
  } else if constexpr (MT == 1) {
    return (float)__ldg(static_cast<const unsigned char*>(p) + i);
  } else {
    return __ldg(static_cast<const float*>(p) + i);
  }
}

// A barrier of the CTA, or of the whole cluster (CL).
template <bool CL>
__device__ __forceinline__ void pair_sync(const cg::cluster_group& cl) {
  if constexpr (CL) {
    cl.sync();
  } else {
    __syncthreads();
  }
}

// p in the shared memory of the cluster's CTA r (CL), or p itself.
template <bool CL, typename T>
__device__ __forceinline__ T* peer(const cg::cluster_group& cl, T* p, int r) {
  if constexpr (CL) {
    return cl.map_shared_rank(p, r);
  } else {
    return p;
  }
}

// Sums of the N values v over every thread of the pair's CTAs, added in
// rank order, so every CTA gets the same floats; `slot` is this call's
// first of N scratch slots (each call its own: a peer may still read
// them).
template <bool CL, int N>
__device__ __forceinline__ void pair_sum(float (&v)[N], float* red, int slot,
                                         const cg::cluster_group& cl, int C) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[4 * (threadIdx.x >> 5) + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[4 * w + threadIdx.x];
    red[kRedSlots + slot + threadIdx.x] = s;
  }
  pair_sync<CL>(cl);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.0f;
    for (int r = 0; r < C; ++r) s += peer<CL>(cl, red, r)[kRedSlots + slot + k];
    v[k] = s;
  }
}

// A division-free walk over a 2-D item space (rows of C items, C fastest):
// the thread starts at item t0 and steps nt items at a time, so a loop
// costs two divisions, not two per item. An empty row (C = 0) ends it.
struct Walk {
  int r, c, dr, dc, C;
  __device__ __forceinline__ Walk(int C_, int t0, int nt) : C(C_) {
    if (C_ <= 0) {
      r = INT_MAX;
      c = dr = dc = 0;
      return;
    }
    r = t0 / C_;
    c = t0 - r * C_;
    dr = nt / C_;
    dc = nt - dr * C_;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
};

// The first b radix-2 decimation-in-frequency passes over the P-point
// subsequences (stride m) of nl lines of N = P m points, in place in
// shared memory: spans P/2 down to P/2^b, a barrier after each. Element n
// of line l is at re/im[l * ls + n * es]. Afterwards the P points of
// subsequence n2 are 2^b blocks of PS = P / 2^b, block t holding the
// PS-point sequence whose DFT gives the subsequence's frequencies
// rev_b(t) + 2^b k'. A butterfly is (line, q), q = n2 P/2 + jb, so n2 and
// jb are a shift and a mask; rows take the butterflies of a line together,
// columns (adjacent in memory) the lines of a butterfly.
__device__ void dif_passes(float* re, float* im, int nl, int ls, int es, int N, int P, int m,
                           int b, bool rows, const float* tc, const float* ts) {
  if (b == 0 || nl <= 0) return;  // uniform over the block
  const int hp = P >> 1, nq = m * hp, sh = __ffs(hp) - 1;
  for (int h = hp; h >= (P >> b); h >>= 1) {
    const int tstep = N / (2 * h);
    for (Walk it(rows ? nq : nl, threadIdx.x, blockDim.x); it.r < (rows ? nl : nq);
         it.next()) {
      const int l = rows ? it.r : it.c, q = rows ? it.c : it.r;
      const int n2 = q >> sh, jb = q & (hp - 1);
      const int j = jb & (h - 1);
      const int pa = ((jb - j) * 2 + j) * m + n2;
      const int ia = l * ls + pa * es, ib = ia + h * m * es;
      const float ar = re[ia], ai = im[ia], br = re[ib], bi = im[ib];
      const float c = tc[j * tstep], s = ts[j * tstep];
      const float dr = ar - br, di = ai - bi;
      re[ia] = ar + br;
      im[ia] = ai + bi;
      re[ib] = dr * c + di * s;  // (dr + i di)(c - i s)
      im[ib] = di * c - dr * s;
    }
    __syncthreads();
  }
}

// The PS-point DFTs of every block left by dif_passes (nb = 2^b blocks of
// each of the m subsequences of nl lines), each in one thread's registers,
// in place: afterwards the block's position j' holds its frequency j'.
// Consecutive threads take consecutive lines, so with an odd line stride
// (rows) or adjacent lines (columns) a warp's accesses fall on distinct
// banks. tstep = N / PS.
template <int PS>
__device__ __forceinline__ void sub_ffts(float* re, float* im, int nl, int ls, int es, int m,
                                         int nb, int tstep, const float* tc, const float* ts) {
  constexpr int kBits = ilog2(PS);
  const int st = m * es;
  for (Walk it(nl, threadIdx.x, blockDim.x); it.r < m * nb; it.next()) {
    const int t = it.r / m, n2 = it.r - t * m;
    float* lr = re + it.c * ls + (t * PS * m + n2) * es;
    float* li = im + (lr - re);
    float vr[PS], vi[PS];
#pragma unroll
    for (int n = 0; n < PS; ++n) {
      const int src = bitrev(n, kBits) * st;
      vr[n] = lr[src];
      vi[n] = li[src];
    }
    fft_reg<PS>(vr, vi, tc, ts, tstep);
#pragma unroll
    for (int k = 0; k < PS; ++k) {
      lr[k * st] = vr[k];
      li[k * st] = vi[k];
    }
  }
}

// A line's radix-2 part, in place: b shared-memory passes, then the
// register FFTs of PS = P / 2^b points (PS 1: nothing to do).
__device__ __forceinline__ void pow2_ffts(float* re, float* im, int nl, int ls, int es, int N,
                                          int P, int m, int b, bool rows, const float* tc,
                                          const float* ts) {
  dif_passes(re, im, nl, ls, es, N, P, m, b, rows, tc, ts);
  const int PS = P >> b, nb = 1 << b;
  switch (PS) {
    case 2: sub_ffts<2>(re, im, nl, ls, es, m, nb, N / PS, tc, ts); break;
    case 4: sub_ffts<4>(re, im, nl, ls, es, m, nb, N / PS, tc, ts); break;
    case 8: sub_ffts<8>(re, im, nl, ls, es, m, nb, N / PS, tc, ts); break;
    case 16: sub_ffts<16>(re, im, nl, ls, es, m, nb, N / PS, tc, ts); break;
    default: break;
  }
}

// Frequency k of a line after pow2_ffts: the direct length-m DFT over its
// subsequences, X[k] = sum_n2 e^{-2 pi i n2 k / N} Y_n2[g], g = k mod P,
// which lies in block rev_b(g mod 2^b) at position g >> b; the twiddle is
// indexed by the exact integer (n2 k) mod N.
__device__ __forceinline__ void mix_point(const float* sr, const float* si, int es, int k,
                                          int N, int P, int m, int b, const float* tc,
                                          const float* ts, float& xr, float& xi) {
  const int g = k & (P - 1);
  const int t = b == 0 ? 0 : (int)(__brev((unsigned)(g & ((1 << b) - 1))) >> (32 - b));
  const int base = m * ((t * (P >> b)) + (g >> b));
  float accr = 0.0f, acci = 0.0f;
  int e = 0;  // (n2 * k) mod N
  for (int n2 = 0; n2 < m; ++n2) {
    const float vr = sr[(base + n2) * es], vi = si[(base + n2) * es];
    const float c = tc[e], s = ts[e];
    accr = fmaf(vr, c, fmaf(vi, s, accr));
    acci = fmaf(vi, c, fmaf(-vr, s, acci));
    e += k;
    if (e >= N) e -= N;
  }
  xr = accr;
  xi = acci;
}

// The length-m pass of nl lines after pow2_ffts, out of place: emit(l, k,
// re, im) receives X[k] of line l for every k < N. With M = m known at
// compile time a thread takes (line l, g < P): it loads the M values
// Y_n2[g] (adjacent in memory), twists them by e^{-2 pi i n2 g / N} and
// takes their length-M DFT in registers, X[g + P t] for t < M: M loads
// give M outputs, where mix_point loads M for each. Lines are the
// fastest index of the threads.
template <int M, typename F>
__device__ __forceinline__ void m_pass(const float* sr, const float* si, int nl, int ls, int es,
                                       int N, int P, int b, const float* tc, const float* ts,
                                       F&& emit) {
  float wc[M], ws[M];  // e^{-2 pi i j / M} = table entry j P
#pragma unroll
  for (int j = 0; j < M; ++j) {
    wc[j] = tc[j * P];
    ws[j] = ts[j * P];
  }
  for (Walk it(nl, threadIdx.x, blockDim.x); it.r < P; it.next()) {
    const int l = it.c, g = it.r;
    const int t = b == 0 ? 0 : (int)(__brev((unsigned)(g & ((1 << b) - 1))) >> (32 - b));
    const long long o = l * (long long)ls + (long long)M * (t * (P >> b) + (g >> b)) * es;
    float vr[M], vi[M];
    int e = 0;  // (n2 g) mod N
#pragma unroll
    for (int n2 = 0; n2 < M; ++n2) {
      const float ar = sr[o + n2 * es], ai = si[o + n2 * es], c = tc[e], s = ts[e];
      vr[n2] = ar * c + ai * s;  // (ar + i ai)(c - i s)
      vi[n2] = ai * c - ar * s;
      e += g;
      if (e >= N) e -= N;
    }
#pragma unroll
    for (int t2 = 0; t2 < M; ++t2) {
      float xr = 0.0f, xi = 0.0f;
#pragma unroll
      for (int n2 = 0; n2 < M; ++n2) {
        const int j = (n2 * t2) % M;
        xr = fmaf(vr[n2], wc[j], fmaf(vi[n2], ws[j], xr));
        xi = fmaf(vi[n2], wc[j], fmaf(-vr[n2], ws[j], xi));
      }
      emit(l, g + P * t2, xr, xi);
    }
  }
}

// m_pass for the odd parts of the multiples of 16 up to 128 (m = 1, 3, 5,
// 7; and 256), mix_point for every other m.
template <typename F>
__device__ __forceinline__ void m_pass_any(const float* sr, const float* si, int nl, int ls,
                                           int es, int N, int P, int m, int b, const float* tc,
                                           const float* ts, F&& emit) {
  switch (m) {
    case 1: m_pass<1>(sr, si, nl, ls, es, N, P, b, tc, ts, emit); return;
    case 3: m_pass<3>(sr, si, nl, ls, es, N, P, b, tc, ts, emit); return;
    case 5: m_pass<5>(sr, si, nl, ls, es, N, P, b, tc, ts, emit); return;
    case 7: m_pass<7>(sr, si, nl, ls, es, N, P, b, tc, ts, emit); return;
    default:
      for (Walk it(nl, threadIdx.x, blockDim.x); it.r < N; it.next()) {
        float xr, xi;
        mix_point(sr + it.c * ls, si + it.c * ls, es, it.r, N, P, m, b, tc, ts, xr, xi);
        emit(it.c, it.r, xr, xi);
      }
  }
}

// CL: the pair's CTAs form a cluster (C > 1); else one CTA measures it.
// NT threads a CTA: kSoloThreads (C = 1), kPairThreads or kClusterThreads.
template <int MT, bool CL, int NT>
__global__ void __launch_bounds__(NT, 65536 / (128 * NT))
measure_mixed_kernel(const MixArgs A) {
  extern __shared__ float smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = CL ? A.C : 1, H = A.H, W = A.W, Wr = W / 2 + 1, HW = H * W, S = A.S;
  const int PP = A.PP, PPs = A.PPs, LC = 2 * PP, nwin = A.nwin, ny = A.ny, nx = A.nx;
  const int tid = threadIdx.x, nt = NT;
  const int rank = CL ? (int)cl.block_rank() : 0;
  const long long b = blockIdx.x / C;
  const int r0 = min(rank * A.RP, H), nr = min(r0 + A.RP, H) - r0;
  const int p0 = min(rank * PP, Wr), np = min(p0 + PP, Wr) - p0;
  const MixLayout L = mix_layout(H, W, nwin, ny, nx, PPs, S, A.ws != nullptr);
  float* red = smem;
  float* cH = smem + L.tw;
  float* sH = cH + H;
  float* cW = sH + H;
  float* sW = cW + W;
  float* kyr = smem + L.k2y;  // (nwin, H)
  float* kyi = kyr + nwin * H;
  float* kxr = smem + L.k2x;  // (nwin, PPs): this CTA's columns of K2x
  float* kxi = kxr + nwin * PPs;
  float* cp = smem + L.cp;    // (ny, nx) partial coarse sums
  float* c2p = smem + L.c2p;  // (nwin, nwin) partial window sums
  float* xr = A.ws ? A.ws + 4LL * S * blockIdx.x : smem + L.x;
  float* xi = xr + S;
  float* yr = A.ws ? xr + 2LL * S : smem + L.y;
  float* yi = yr + S;

  // ---- constants ----
  for (int i = tid; i < 2 * (H + W); i += nt) cH[i] = __ldg(A.tw + i);
  for (int i = tid; i < 2 * nwin * H; i += nt) kyr[i] = __ldg(A.k2y + i);
  for (Walk it(np, tid, nt); it.r < nwin; it.next()) {
    const int j = it.r, q = it.c;
    kxr[j * PPs + q] = __ldg(A.k2x + (long long)j * Wr + p0 + q);
    kxi[j * PPs + q] = __ldg(A.k2x + (long long)(nwin + j) * Wr + p0 + q);
  }

  // ---- 1. this CTA's rows of both sides, normalised: x = ref + i img,
  // rows at stride RS = W + 1 (odd for even W, so that the threads of a
  // warp, one a row in the row FFTs, hit distinct banks); the masks wait in
  // y for the second pass. Each pass walks the same cells in the same
  // order per thread, so no barrier stands between them ----
  const int RS = W + 1;
  const long long off = b * HW + (long long)r0 * W;
  float m4[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // mask counts, masked sums
  for (Walk it(W, tid, nt); it.r < nr; it.next()) {
    const int e = it.r * W + it.c, se = it.r * RS + it.c;
    const float mr = mask_at<MT>(A.rmask, off + e), mi = mask_at<MT>(A.imask, off + e);
    const float vr = __ldg(A.ref + off + e) * mr, vi = __ldg(A.img + off + e) * mi;
    xr[se] = vr;
    xi[se] = vi;
    if constexpr (MT != 0) {
      yr[se] = mr;
      yi[se] = mi;
    }
    m4[0] += mr;
    m4[1] += mi;
    m4[2] += vr;
    m4[3] += vi;
  }
  float scale = 1.0f;
  if (A.mode != M_CC) {
    pair_sum<CL>(m4, red, 0, cl, C);
    const bool spectral = A.mode == M_SPECTRAL;  // raw data kept, n = H W
    const float n_r = spectral ? (float)HW : fmaxf(m4[0], 1.0f);
    const float n_i = spectral ? (float)HW : fmaxf(m4[1], 1.0f);
    const float mean_r = m4[2] / n_r, mean_i = m4[3] / n_i;
    float q[2] = {0.0f, 0.0f};
    for (Walk it(W, tid, nt); it.r < nr; it.next()) {
      const int se = it.r * RS + it.c;
      float dr = xr[se] - mean_r, di = xi[se] - mean_i;
      if (!spectral) {  // masked: remove the mean under the mask only
        if constexpr (MT != 0) {
          dr *= yr[se];
          di *= yi[se];
        }
        xr[se] = dr;
        xi[se] = di;
      }
      q[0] += dr * dr;
      q[1] += di * di;
    }
    pair_sum<CL>(q, red, 4, cl, C);
    if (spectral) {
      scale = (float)HW * rsqrtf(fmaxf((float)HW * q[0], 1e-20f)) *
              rsqrtf(fmaxf((float)HW * q[1], 1e-20f));
    } else {
      // each side's 1 / (std sqrt(n)) scales the cross-spectrum, not the
      // data (the transforms are linear): no pass, no barrier
      const float inv_r = 1.0f / (sqrtf(fmaxf(q[0] / n_r, 1e-20f)) * sqrtf(n_r));
      const float inv_i = 1.0f / (sqrtf(fmaxf(q[1] / n_i, 1e-20f)) * sqrtf(n_i));
      scale = inv_r * inv_i;
    }
  }
  __syncthreads();

  // ---- 2. row transforms: radix-2 passes and register FFTs in place,
  // then the length-MW pass, which also moves the data to column order:
  // c[u][2q] holds column p0 + q, c[u][2q + 1] column W - p0 - q (the
  // hermitian partner). One CTA reads its own rows (x -> y); a cluster
  // finishes every row in its own CTA (x -> y) and then gathers its
  // columns from the peers' rows, a copy through distributed shared
  // memory (y -> x), so no remote value is read twice ----
  pow2_ffts(xr, xi, nr, RS, 1, W, A.PW, A.MW, A.BW, true, cW, sW);
  float *cr = yr, *ci = yi;  // the columns
  float *zr = xr, *zi = xi;  // the other buffer
  __syncthreads();
  if constexpr (CL) {
    m_pass_any(xr, xi, nr, RS, 1, W, A.PW, A.MW, A.BW, cW, sW,
               [&](int l, int k, float re, float im) {
                 yr[l * RS + k] = re;
                 yi[l * RS + k] = im;
               });
    cl.sync();  // every CTA's rows are ready
    cr = xr;
    ci = xi;
    zr = yr;
    zi = yi;
    for (int owner = 0; owner < C; ++owner) {
      const int y0 = owner * A.RP, ny0 = min(y0 + A.RP, H) - y0;
      if (ny0 <= 0) break;
      const float* sr = A.ws ? yr + 4LL * S * (owner - rank) : cl.map_shared_rank(yr, owner);
#pragma unroll 4
      for (Walk it(LC, tid, nt); it.r < ny0; it.next()) {
        const int lc = it.c, q = lc >> 1, p = p0 + q;
        const bool some = q < np && !((lc & 1) && (p == 0 || 2 * p == W));
        const int col = some ? ((lc & 1) ? W - p : p) : 0;
        const float vr = sr[it.r * RS + col], vi = sr[S + it.r * RS + col];
        cr[(y0 + it.r) * LC + lc] = some ? vr : 0.0f;
        ci[(y0 + it.r) * LC + lc] = some ? vi : 0.0f;
      }
    }
    cl.sync();  // no peer reads this CTA's rows any more
  } else {
    // column k goes to slot 2k (k <= W/2) or 2(W - k) + 1; the odd slots
    // of the self-paired columns 0 and W/2 hold zeros
    m_pass_any(xr, xi, nr, RS, 1, W, A.PW, A.MW, A.BW, cW, sW,
               [&](int l, int k, float re, float im) {
                 const int lc = 2 * k <= W ? 2 * k : 2 * (W - k) + 1;
                 if (k == 0 || 2 * k == W) {
                   yr[l * LC + lc + 1] = 0.0f;
                   yi[l * LC + lc + 1] = 0.0f;
                 }
                 yr[l * LC + lc] = re;
                 yi[l * LC + lc] = im;
               });
    __syncthreads();
  }

  // ---- 3. column transforms: radix-2 passes and register FFTs in place;
  // the length-MH pass gives Z (z), whose Z(u, v) and Z(-u, -v) split the
  // half-spectra by hermitian symmetry into G = I conj(R), G[u][q] for
  // v = p0 + q, written over the spent columns ----
  pow2_ffts(cr, ci, LC, 1, LC, H, A.PH, A.MH, A.BH, false, cH, sH);
  __syncthreads();
  m_pass_any(cr, ci, LC, 1, LC, H, A.PH, A.MH, A.BH, cH, sH,
             [&](int l, int k, float re, float im) {
               zr[k * LC + l] = re;
               zi[k * LC + l] = im;
             });
  __syncthreads();
  float* gR = cr;  // G, and the scratch rows of the stages below
  float* gI = ci;
  float* tR = zr;
  float* tI = zi;
  for (Walk it(np, tid, nt); it.r < H; it.next()) {
    const int u = it.r, q = it.c, p = p0 + q, um = u == 0 ? 0 : H - u;
    const int lm = 2 * q + ((p == 0 || 2 * p == W) ? 0 : 1);  // column -v
    float gr, gi;
    cross(zr[u * LC + 2 * q], zi[u * LC + 2 * q], zr[um * LC + lm], zi[um * LC + lm], scale, gr,
          gi);
    if (A.mode == M_SPECTRAL && u == 0 && p == 0) gr = 0.0f;  // no DC
    gR[u * PP + q] = gr;
    gI[u * PP + q] = gi;
  }
  __syncthreads();

  // ---- 4. coarse lags of the search box: T[i][q] = sum_u e^{2 pi i u
  // lag_i / H} G[u][q], then this CTA's part of the sum over v ----
  for (Walk it(np, tid, nt); it.r < ny; it.next()) {
    const int i = it.r, q = it.c;
    const int step = mod(A.ly0 + i, H);
    float re = 0.0f, im = 0.0f;
    int k = 0;  // (u * lag) mod H
#pragma unroll 4
    for (int u = 0; u < H; ++u) {
      const float c = cH[k], s = sH[k], gr = gR[u * PP + q], gi = gI[u * PP + q];
      re = fmaf(c, gr, fmaf(-s, gi, re));  // Re{(c + i s)(gr + i gi)}
      im = fmaf(c, gi, fmaf(s, gr, im));
      k += step;
      if (k >= H) k -= H;
    }
    tR[i * PP + q] = re;
    tI[i * PP + q] = im;
  }
  __syncthreads();
  float bv = 0.0f;
  int bi = INT_MAX;  // argmax: none yet
  for (Walk it(nx, tid, nt); it.r < ny; it.next()) {
    const int i = it.r;
    const int step = mod(A.lx0 + it.c, W);
    float acc = 0.0f;
    int k = mod((long long)p0 * step, W);  // (v * lag) mod W
    for (int q = 0; q < np; ++q) {
      const int v = p0 + q;
      const float wv = (v == 0 || 2 * v == W) ? 1.0f : 2.0f;  // hermitian fold
      acc = fmaf(wv, tR[i * PP + q] * cW[k] - tI[i * PP + q] * sW[k], acc);
      k += step;
      if (k >= W) k -= W;
    }
    const int o = i * nx + it.c;
    if constexpr (CL) {
      cp[o] = acc;
    } else {
      const float val = acc / (float)HW;
      if (bi == INT_MAX || better(val, o, bv, bi)) {
        bv = val;
        bi = o;
      }
    }
  }

  // ---- 5. the coarse surface (partial sums in rank order) and its
  // first-index argmax, in every CTA ----
  if constexpr (CL) {
    cl.sync();
    for (int o = tid; o < ny * nx; o += nt) {
      float acc = 0.0f;
      for (int r = 0; r < C; ++r) acc += cl.map_shared_rank(cp, r)[o];
      const float val = acc / (float)HW;
      if (bi == INT_MAX || better(val, o, bv, bi)) {
        bv = val;
        bi = o;
      }
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
  if ((tid & 31) == 0) {
    red[kRedArg + 2 * (tid >> 5)] = bv;
    red[kRedArg + 2 * (tid >> 5) + 1] = __int_as_float(bi);
  }
  __syncthreads();
  for (int w = 0; w < (nt >> 5); ++w) {
    const float ov = red[kRedArg + 2 * w];
    const int oi = __float_as_int(red[kRedArg + 2 * w + 1]);
    if (oi != INT_MAX && (bi == INT_MAX || better(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  const int sy = bi / nx + A.ly0, sx = bi % nx + A.lx0;
  if (rank == 0 && tid == 0) {
    A.s0y[b] = sy;
    A.s0x[b] = sx;
  }

  // ---- 6. the integer-shift twist G *= Dy(u) Dx(v) folded into the
  // window: K2y[i][u] *= e^{2 pi i u s0y / H} here, e^{2 pi i v s0x / W}
  // after the sum over u ----
  for (Walk it(H, tid, nt); it.r < nwin; it.next()) {
    const int k = mod((long long)it.c * sy, H), o = it.r * H + it.c;
    const float c = kyr[o], s = kyi[o];
    kyr[o] = c * cH[k] - s * sH[k];
    kyi[o] = c * sH[k] + s * cH[k];
  }
  __syncthreads();

  // ---- 7. upsampled window: A = K2y Gd on this CTA's columns, then its
  // part of C2 = Re{A K2x^T}; the parts are added in rank order. One CTA
  // a pair: a thread takes rows i, i + nh and columns q, q + qh, so each
  // value of G and of K2y it loads serves two sums (in a cluster, which
  // holds fewer columns a CTA, that left too few threads busy) ----
  constexpr int BB = CL ? 1 : 2;
  const int nh = (nwin + BB - 1) / BB, qh = (np + BB - 1) / BB;
  for (Walk it(qh, tid, nt); it.r < nh; it.next()) {
    int ii[BB], qq[BB];
#pragma unroll
    for (int a = 0; a < BB; ++a) {
      ii[a] = min(it.r + a * nh, nwin - 1);
      qq[a] = min(it.c + a * qh, np - 1);
    }
    float re[BB][BB], im[BB][BB];  // (row, column)
#pragma unroll
    for (int a = 0; a < BB; ++a) {
#pragma unroll
      for (int d = 0; d < BB; ++d) re[a][d] = im[a][d] = 0.0f;
    }
#pragma unroll 4
    for (int u = 0; u < H; ++u) {
      float gr[BB], gi[BB], c[BB], s[BB];
#pragma unroll
      for (int a = 0; a < BB; ++a) {
        gr[a] = gR[u * PP + qq[a]];
        gi[a] = gI[u * PP + qq[a]];
        c[a] = kyr[ii[a] * H + u];
        s[a] = kyi[ii[a] * H + u];
      }
#pragma unroll
      for (int a = 0; a < BB; ++a) {
#pragma unroll
        for (int d = 0; d < BB; ++d) {
          re[a][d] = fmaf(c[a], gr[d], fmaf(-s[a], gi[d], re[a][d]));
          im[a][d] = fmaf(c[a], gi[d], fmaf(s[a], gr[d], im[a][d]));
        }
      }
    }
#pragma unroll
    for (int d = 0; d < BB; ++d) {
      if (it.c + d * qh >= np) continue;
      const int k = mod((long long)(p0 + qq[d]) * sx, W);
#pragma unroll
      for (int a = 0; a < BB; ++a) {
        if (it.r + a * nh >= nwin) continue;
        tR[ii[a] * PP + qq[d]] = re[a][d] * cW[k] - im[a][d] * sW[k];
        tI[ii[a] * PP + qq[d]] = re[a][d] * sW[k] + im[a][d] * cW[k];
      }
    }
  }
  __syncthreads();
  float* out = A.c2 + b * nwin * nwin;
  for (Walk it(nwin, tid, nt); it.r < nwin; it.next()) {
    const int i = it.r, j = it.c;
    float acc = 0.0f;
    for (int q = 0; q < np; ++q)
      acc = fmaf(tR[i * PP + q], kxr[j * PPs + q], fmaf(-tI[i * PP + q], kxi[j * PPs + q], acc));
    if constexpr (CL) {
      c2p[i * nwin + j] = acc;
    } else {
      out[i * nwin + j] = acc;
    }
  }
  if constexpr (CL) {
    cl.sync();
    for (int o = rank * nt + tid; o < nwin * nwin; o += C * nt) {
      float acc = 0.0f;
      for (int r = 0; r < C; ++r) acc += cl.map_shared_rank(c2p, r)[o];
      out[o] = acc;
    }
    cl.sync();  // peers may still read this CTA's partial sums
  }
}

template <int MT, bool CL, int NT>
int launch_mixed(const MixPlan& p, MixArgs a, int B, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)p.smem_floats;
  cudaError_t e = cudaFuncSetAttribute(measure_mixed_kernel<MT, CL, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * p.C));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, measure_mixed_kernel<MT, CL, NT>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int MT>
int launch_mixed_route(const MixPlan& p, const MixArgs& a, int B, cudaStream_t stream) {
  if (p.C == 1) return launch_mixed<MT, false, kSoloThreads>(p, a, B, stream);
  if ((size_t)p.smem_floats * sizeof(float) <= kSmemTwo)
    return launch_mixed<MT, true, kPairThreads>(p, a, B, stream);
  return launch_mixed<MT, true, kClusterThreads>(p, a, B, stream);
}

int sm_count() {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// How B pairs of H x W at window nwin and ny x nx coarse lags are measured,
// written to plan[4]: plan[0] = 0 for the FFT kernel, 1 for the mixed-radix
// kernel; plan[1] = its CTAs per pair (the cluster; 1 for the FFT kernel);
// plan[2] = 1 when the mixed kernel's buffers live in a global workspace;
// plan[3] = the FFT kernel's pairs per block. `kernel` -1 picks by shape
// (the FFT kernel where it takes the shape), 0 or 1 asks for that kernel.
// Returns the floats of workspace the launch needs (0 for none), or -1
// when the kernel asked for (or none) takes the shape.
extern "C" long long measure_window_plan(int B, int H, int W, int nwin, int ny, int nx,
                                         int kernel, int* plan) {
  plan[0] = 0;
  plan[1] = 1;
  plan[2] = 0;
  plan[3] = 0;
  const int sms = sm_count();
  int ppb = kernel == 1 ? 0 : fft_pairs(H, W, nwin, ny);
  if (ppb > 0) {
    // fewer pairs per block while the blocks would not cover every SM
    while (ppb > 1 && (B + ppb - 1) / ppb < sms) ppb /= 2;
    plan[3] = ppb;
    return 0;
  }
  if (kernel == 0) return -1;
  const MixPlan p = mix_plan(B, H, W, nwin, ny, nx, sms);
  if (p.C == 0) return -1;
  plan[0] = 1;
  plan[1] = p.C;
  plan[2] = p.ws;
  return p.ws ? 4LL * p.S * p.C * (long long)B : 0;
}

// Measure B pairs of (H, W) f32 cutouts on `stream`. rmask / imask are
// (B, H, W) bytes (mask_f32 = 0) or f32 (mask_f32 = 1), or both null (all
// ones); mode is 0 'CC', 1 masked 'NCC'/'ZNCC', 2 unmasked 'NCC'/'ZNCC';
// the coarse lags are ly0 .. ly0+ny-1 by lx0 .. lx0+nx-1. tw holds cos, sin
// of 2*pi*j/H (j < H) then of 2*pi*j/W (j < W); k2y the real then imaginary
// (nwin, H) window kernel; k2x the real then imaginary (nwin, W/2+1) one.
// plan is what measure_window_plan(...) wrote for these arguments, and
// workspace null or the floats it returned. Writes c2 (B, nwin, nwin), s0y
// and s0x (B,). Returns cudaGetLastError() after the launch, or the error
// that prevented it.
extern "C" int measure_window_launch(const float* ref, const float* img,
                                     const void* __restrict__ rmask,
                                     const void* __restrict__ imask, int mask_f32, int B,
                                     int H, int W, int mode, int nwin, int ly0, int lx0,
                                     int ny, int nx, const float* tw, const float* k2y,
                                     const float* k2x, const int* plan, float* workspace,
                                     float* c2, int* s0y, int* s0x, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (H < 1 || W < 1 || nwin < 1 || ny < 1 || nx < 1 || mode < M_CC || mode > M_SPECTRAL)
    return (int)cudaErrorInvalidValue;
  // both masks or none (the wrapper passes a given mask for both sides or
  // fills in the missing one)
  if ((rmask == nullptr) != (imask == nullptr)) return (int)cudaErrorInvalidValue;
  const int mt = rmask == nullptr ? 0 : (mask_f32 ? 2 : 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (plan[0] == 0) {
    const int ppb = plan[3];
    if (ppb < 1 || ppb > fft_pairs(H, W, nwin, ny)) return (int)cudaErrorInvalidValue;
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
  const int C = plan[1];
  if (plan[0] != 1 || C < 1 || C > kMaxCluster || (C & (C - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const MixPlan p = mix_cut(H, W, nwin, ny, nx, C, plan[2] != 0);
  if ((size_t)p.smem_floats * sizeof(float) > kSmemOne || (p.ws && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  MixArgs a;
  a.ref = ref;
  a.img = img;
  a.rmask = rmask;
  a.imask = imask;
  a.H = H;
  a.W = W;
  a.mode = mode;
  a.nwin = nwin;
  a.ly0 = ly0;
  a.lx0 = lx0;
  a.ny = ny;
  a.nx = nx;
  a.C = p.C;
  a.RP = p.RP;
  a.PP = p.PP;
  a.PPs = p.PPs;
  a.S = p.S;
  a.PH = H & -H;
  a.MH = H / a.PH;
  a.BH = dif_count(a.PH);
  a.PW = W & -W;
  a.MW = W / a.PW;
  a.BW = dif_count(a.PW);
  a.tw = tw;
  a.k2y = k2y;
  a.k2x = k2x;
  a.ws = p.ws ? workspace : nullptr;
  a.c2 = c2;
  a.s0y = s0y;
  a.s0x = s0x;
  if (mt == 0) return launch_mixed_route<0>(p, a, B, s);
  if (mt == 1) return launch_mixed_route<1>(p, a, B, s);
  return launch_mixed_route<2>(p, a, B, s);
}
