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
// Design: one thread block per cutout pair, 256 threads. For pair b:
//   1. normalise each side (ops/correlate.py · _normalize): 'CC' takes the
//      masked data; masked 'NCC'/'ZNCC' remove the masked mean and divide
//      by the masked std times sqrt(n); unmasked 'NCC'/'ZNCC' keep the raw
//      data and take the DC-free power H*W*sum((x - mean)^2), which equals
//      the spectral Parseval power of _spectral_ncc_product;
//   2. forward half-spectrum DFT of both sides as a direct separable sum
//      (rows, then columns), with twiddles read from cos/sin(2*pi*j/N)
//      tables built in float64 and cast to f32, indexed by (k*n) mod N so
//      the integer part of every phase is exact;
//   3. cross-spectrum G = F(img) * conj(F(ref)); unmasked NCC scales it by
//      n / sqrt(P_ref * P_img) and zeroes the DC bin;
//   4. the correlation at the ny x nx integer lags of the search box, a
//      direct half-spectrum DFT with the hermitian fold weights, divided by
//      H*W, and its first-index argmax in row-major (ny, nx) order (the
//      order torch.argmax takes; NaN counts as the largest value);
//   5. the integer-shift phase twist Dy(u) Dx(v), again by table lookup of
//      (u*s0) mod N;
//   6. the usfac-upsampled nwin x nwin window as the separable product
//      (K2y) Gd (K2x)^T, with K2y, K2x (float64-built, fold weights and
//      1/(H*W) in K2x) read from global memory, shared by the whole batch.
// Everything is f32; no tensor cores.
//
// Memory: the per-pair working set (normalised side, row-pass spectrum,
// both half-spectra; make_layout) is 4*(H*W + 2*max(H, nwin)*Wr + 4*H*Wr)
// bytes at the search boxes the align path uses: 17 KB
// at 32x32 and 67 KB at 64x64, which live in shared memory. Above
// kSmemMax (the 256x256 oversized-footprint bucket needs 1 MB) the wrapper
// allocates a global workspace of that size per pair and the block works
// there, served by L2. The twiddle tables are always in shared memory.
//
// What bounds it on this card: operations. A 32x32 pair needs about
// 0.56 MFLOP as direct DFTs against 16 KB of inputs, far above the card's
// f32 ridge point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). The design
// keeps every stage's intermediates on chip so device memory is read once
// (inputs) and written once (window and shifts); replacing the direct DFTs
// by FFTs or tensor-core products is the later step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// per-pair buffers go to shared memory up to this many bytes
constexpr size_t kSmemMax = 100 * 1024;

enum : int { M_CC = 0, M_NCC = 1, M_SPECTRAL = 2 };

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
__device__ float load_side(const float* __restrict__ x, const float* __restrict__ m,
                           float* a, int HW, int mode, float* red) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (mode == M_SPECTRAL) {
    float s = 0.0f;
    for (int i = t; i < HW; i += nt) {
      const float v = __ldg(x + i);
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
    const float mi = m ? __ldg(m + i) : 1.0f;
    const float v = __ldg(x + i) * mi;
    a[i] = v;
    sm += mi;
    sa += v;
  }
  if (mode == M_CC) return 0.0f;
  const float n = fmaxf(block_sum(sm, red), 1.0f);
  const float mean = block_sum(sa, red) / n;
  float q = 0.0f;
  for (int i = t; i < HW; i += nt) {
    const float mi = m ? __ldg(m + i) : 1.0f;
    const float d = (a[i] - mean) * mi;
    a[i] = d;
    q += d * d;
  }
  const float var = block_sum(q, red) / n;
  const float den = sqrtf(fmaxf(var, 1e-20f)) * sqrtf(n);
  for (int i = t; i < HW; i += nt) a[i] = a[i] / den;
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
               const float* __restrict__ rmask, const float* __restrict__ imask,
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
  const float p_ref = load_side(ref + b * HW, rmask ? rmask + b * HW : nullptr,
                                a, HW, mode, red);
  __syncthreads();
  rdft2(a, tr, ti, gr_, gi_, H, W, Wr, cH, sH, cW, sW);
  const float p_img = load_side(img + b * HW, imask ? imask + b * HW : nullptr,
                                a, HW, mode, red);
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
    int step = (ly0 + i) % H;
    if (step < 0) step += H;
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
    int step = (lx0 + j) % W;
    if (step < 0) step += W;
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
    int ky = (int)(((long long)u * sy) % H);
    if (ky < 0) ky += H;
    int kx = (int)(((long long)v * sx) % W);
    if (kx < 0) kx += W;
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

}  // namespace

// Floats of global workspace the wrapper must allocate for B pairs of
// H x W at window nwin and ny x nx coarse lags: 0 when a pair's buffers
// fit in shared memory.
extern "C" long long measure_window_workspace_floats(int B, int H, int W, int nwin,
                                                     int ny, int nx) {
  const Layout L = make_layout(H, W, nwin, ny, nx);
  if (smem_bytes(H, W, L.total, true) <= kSmemMax) return 0;
  return (long long)B * L.total;
}

// Measure B pairs of (H, W) f32 cutouts on `stream`. rmask / imask are f32
// (B, H, W) or null (all ones); mode is 0 'CC', 1 masked 'NCC'/'ZNCC',
// 2 unmasked 'NCC'/'ZNCC'; the coarse lags are ly0 .. ly0+ny-1 by
// lx0 .. lx0+nx-1. tw holds cos, sin of 2*pi*j/H (j < H) then of
// 2*pi*j/W (j < W); k2y the real then imaginary (nwin, H) window kernel;
// k2x the real then imaginary (nwin, W/2+1) one. workspace is null or holds
// measure_window_workspace_floats(B, H, W, nwin, ny, nx) floats. Writes c2
// (B, nwin, nwin), s0y and s0x (B,). Returns cudaGetLastError() after the
// launch, or the error that prevented it.
extern "C" int measure_window_launch(const float* ref, const float* img,
                                     const float* rmask, const float* imask,
                                     int B, int H, int W, int mode, int nwin,
                                     int ly0, int lx0, int ny, int nx,
                                     const float* tw, const float* k2y,
                                     const float* k2x, float* workspace,
                                     float* c2, int* s0y, int* s0x, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (H < 1 || W < 1 || nwin < 1 || ny < 1 || nx < 1 || mode < M_CC || mode > M_SPECTRAL)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(H, W, nwin, ny, nx);
  const size_t bytes = smem_bytes(H, W, L.total, workspace == nullptr);
  if (bytes > kSmemMax && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        measure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  measure_kernel<<<(unsigned)B, kThreads, bytes, (cudaStream_t)stream>>>(
      ref, img, rmask, imask, H, W, mode, nwin, ly0, lx0, ny, nx, tw, k2y, k2x,
      workspace, c2, s0y, s0x);
  return (int)cudaGetLastError();
}
