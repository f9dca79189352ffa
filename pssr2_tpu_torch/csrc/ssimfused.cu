// Single-scale SSIM for Hopper, forward and backward, f32 throughout.
//
// For each image b of x, y (B, H, W) and the 11-tap Gaussian window g,
// with Blur the separable VALID blur (output (H-10, W-10)):
//
//   mu1 = Blur(x), mu2 = Blur(y), xx = Blur(x*x), yy = Blur(y*y), xy = Blur(x*y)
//   cs_map   = (2 (xy - mu1 mu2) + c2) / ((xx - mu1^2) + (yy - mu2^2) + c2)
//   ssim_map = ((2 mu1 mu2 + c1) / (mu1^2 + mu2^2 + c1)) * cs_map
//   s[b] = sum ssim_map, cs[b] = sum cs_map     (the wrapper scales by 1/n)
//
// Backward, given the cotangents gs[b], gcs[b] of the means: launch 1
// recomputes the moments and writes four maps on the VALID grid,
// g_mu1, g_mu2, db2 and 2*da2 (the chain of ops/ssim.py's analytic VJP);
// launch 2 applies the transposed blur (a full correlation, zero outside
// the VALID grid) to each, giving t1..t4, and forms
//   gx = t1 + 2x t3 + y t4,  gy = t2 + 2y t3 + x t4.
//
// Replaces the TPU kernels pssr2_tpu/ops/pallas/ssimfused.py:_fwd_kernel
// and _bwd_kernel (reached through _fused_fn).  Those hold one whole image
// in VMEM per grid step and blur with band-chunked MXU dots; here a block
// owns a tile of the output with a 10-pixel halo in shared memory and
// blurs with the 11 taps directly on the CUDA cores.
//
// Numerics: true f32.  Products, the map arithmetic and the divisions use
// the round-to-nearest intrinsics, so nvcc fuses no multiply-add into the
// variance terms (E[x^2] - E[x]^2 cancels) and no division is approximate.
// The blur sums use fused multiply-adds, as a matrix product does.  The
// per-image sums meet with atomicAdd, so their order changes from run to
// run.
//
// What bounds it on an H100 SXM: per VALID pixel the forward does about
// 250 f32 operations (five maps, 22 taps, the map arithmetic) on 8 bytes of
// input, so operations (67 TFLOP/s f32) bound it, with bytes (3.35 TB/s)
// close behind; the backward does about twice the operations and moves
// x, y, gx and gy once each.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 11;          // window taps (the loss's win_size)
constexpr int R = WIN - 1;       // halo
constexpr int THREADS = 256;
// moments pass (forward and backward launch 1): a VALID-grid output tile
constexpr int OT_H = 32, OT_W = 32;
constexpr int IN_H = OT_H + R, IN_W = OT_W + R;
// transposed pass (backward launch 2): an output tile of gx, gy
constexpr int TT_H = 16, TT_W = 32;
constexpr int TIN_H = TT_H + R, TIN_W = TT_W + R;

struct Window {
  float g[WIN];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) t += scratch[i];
  return t;  // valid in thread 0
}

// MAPS = false: per-image (ssim, cs) sums into s_sum, cs_sum.
// MAPS = true: the backward's four VALID-grid maps into maps (4, B, Hp, Wp).
template <bool MAPS>
__global__ void __launch_bounds__(THREADS)
ssim_moments_kernel(const float* __restrict__ x, const float* __restrict__ y, Window win, int H,
                    int W, int tiles_w, float c1, float c2, float* __restrict__ s_sum,
                    float* __restrict__ cs_sum, const float* __restrict__ g_s,
                    const float* __restrict__ g_cs, float inv_n, float* __restrict__ maps) {
  __shared__ float xs[IN_H][IN_W + 1];
  __shared__ float ys[IN_H][IN_W + 1];
  __shared__ float hb[5][IN_H][OT_W];
  __shared__ float scratch[THREADS / 32];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_w) * OT_H;
  const int j0 = (blockIdx.x % tiles_w) * OT_W;
  const int Hp = H - R, Wp = W - R;
  const long long img = (long long)b * H * W;

  for (int e = tid; e < IN_H * IN_W; e += THREADS) {
    const int r = e / IN_W, c = e % IN_W;
    const int i = i0 + r, j = j0 + c;
    const bool in = i < H && j < W;
    xs[r][c] = in ? x[img + (long long)i * W + j] : 0.f;
    ys[r][c] = in ? y[img + (long long)i * W + j] : 0.f;
  }
  __syncthreads();

  // horizontal pass over every row of the halo tile
  for (int e = tid; e < IN_H * OT_W; e += THREADS) {
    const int r = e / OT_W, c = e % OT_W;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f;
#pragma unroll
    for (int u = 0; u < WIN; ++u) {
      const float xv = xs[r][c + u], yv = ys[r][c + u], g = win.g[u];
      m0 = fmaf(g, xv, m0);
      m1 = fmaf(g, yv, m1);
      m2 = fmaf(g, mul(xv, xv), m2);
      m3 = fmaf(g, mul(yv, yv), m3);
      m4 = fmaf(g, mul(xv, yv), m4);
    }
    hb[0][r][c] = m0;
    hb[1][r][c] = m1;
    hb[2][r][c] = m2;
    hb[3][r][c] = m3;
    hb[4][r][c] = m4;
  }
  __syncthreads();

  float gs = 0.f, gcs = 0.f;
  if (MAPS) {
    gs = mul(g_s[b], inv_n);
    gcs = mul(g_cs[b], inv_n);
  }
  const long long plane = (long long)gridDim.y * Hp * Wp;  // one of the four maps
  float acc_s = 0.f, acc_cs = 0.f;
  for (int e = tid; e < OT_H * OT_W; e += THREADS) {
    const int r = e / OT_W, c = e % OT_W;
    const int i = i0 + r, j = j0 + c;
    if (i >= Hp || j >= Wp) continue;
    float mu1 = 0.f, mu2 = 0.f, xx = 0.f, yy = 0.f, xy = 0.f;
#pragma unroll
    for (int t = 0; t < WIN; ++t) {
      const float g = win.g[t];
      mu1 = fmaf(g, hb[0][r + t][c], mu1);
      mu2 = fmaf(g, hb[1][r + t][c], mu2);
      xx = fmaf(g, hb[2][r + t][c], xx);
      yy = fmaf(g, hb[3][r + t][c], yy);
      xy = fmaf(g, hb[4][r + t][c], xy);
    }
    const float mu1_sq = mul(mu1, mu1), mu2_sq = mul(mu2, mu2), mu1_mu2 = mul(mu1, mu2);
    const float a1 = add(2.f * mu1_mu2, c1);
    const float b1 = add(add(mu1_sq, mu2_sq), c1);
    const float a2 = add(2.f * sub(xy, mu1_mu2), c2);
    const float b2 = add(add(sub(xx, mu1_sq), sub(yy, mu2_sq)), c2);
    if (!MAPS) {
      const float cs = div(a2, b2);
      acc_cs += cs;
      acc_s += mul(div(a1, b1), cs);
    } else {
      const float rr = div(a1, b1);
      const float s = div(a2, b2);
      const float t = add(mul(gs, rr), gcs);
      const float da1 = div(mul(gs, s), b1);
      const float db1 = -mul(da1, rr);
      const float da2 = div(t, b2);
      const float db2 = -mul(da2, s);
      const float u = sub(da1, da2);
      const float v = sub(db1, db2);
      const long long o = ((long long)b * Hp + i) * Wp + j;
      maps[o] = 2.f * add(mul(mu2, u), mul(mu1, v));
      maps[plane + o] = 2.f * add(mul(mu1, u), mul(mu2, v));
      maps[2 * plane + o] = db2;
      maps[3 * plane + o] = 2.f * da2;
    }
  }
  if (!MAPS) {
    const float ts = block_sum(acc_s, scratch);
    const float tcs = block_sum(acc_cs, scratch);
    if (tid == 0) {
      atomicAdd(&s_sum[b], ts);
      atomicAdd(&cs_sum[b], tcs);
    }
  }
}

// Backward launch 2: transposed blur of the four maps, then gx and gy.
__global__ void __launch_bounds__(THREADS)
ssim_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ maps, Window win, int H, int W, int tiles_w,
                 float* __restrict__ gx, float* __restrict__ gy) {
  __shared__ float ms[4][TIN_H][TIN_W + 1];
  __shared__ float hs[4][TIN_H][TT_W];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_w) * TT_H;
  const int j0 = (blockIdx.x % tiles_w) * TT_W;
  const int Hp = H - R, Wp = W - R;
  const long long plane = (long long)gridDim.y * Hp * Wp;

  // the maps over rows i0-R .. i0+TT_H-1 and columns j0-R .. j0+TT_W-1,
  // zero outside the VALID grid
  for (int e = tid; e < TIN_H * TIN_W; e += THREADS) {
    const int r = e / TIN_W, c = e % TIN_W;
    const int a = i0 - R + r, bb = j0 - R + c;
    const bool in = a >= 0 && a < Hp && bb >= 0 && bb < Wp;
    const long long o = ((long long)b * Hp + a) * Wp + bb;
#pragma unroll
    for (int k = 0; k < 4; ++k) ms[k][r][c] = in ? maps[k * plane + o] : 0.f;
  }
  __syncthreads();

  // t(h, w) = sum_t sum_u g[t] g[u] map[h - t][w - u]: columns first
  for (int e = tid; e < TIN_H * TT_W; e += THREADS) {
    const int r = e / TT_W, c = e % TT_W;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < WIN; ++u) s = fmaf(win.g[u], ms[k][r][c + R - u], s);
      hs[k][r][c] = s;
    }
  }
  __syncthreads();

  const long long img = (long long)b * H * W;
  for (int e = tid; e < TT_H * TT_W; e += THREADS) {
    const int r = e / TT_W, c = e % TT_W;
    const int i = i0 + r, j = j0 + c;
    if (i >= H || j >= W) continue;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < WIN; ++q) s = fmaf(win.g[q], hs[k][r + R - q][c], s);
      t[k] = s;
    }
    const long long o = img + (long long)i * W + j;
    const float xv = x[o], yv = y[o];
    gx[o] = add(add(t[0], mul(2.f * xv, t[2])), mul(yv, t[3]));
    gy[o] = add(add(t[1], mul(2.f * yv, t[2])), mul(xv, t[3]));
  }
}

Window window(const float* g) {
  Window w;
  for (int i = 0; i < WIN; ++i) w.g[i] = g[i];
  return w;
}

int check(int b, int h, int w, int win_size) {
  if (b <= 0 || b > 65535 || win_size != WIN || h < WIN || w < WIN)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// All pointers are device pointers except `g`, the 11 window taps on the
// host.  Launches go on `stream` and do not synchronise; each function
// returns the first nonzero cudaGetLastError() code (0 on success).

// s_sum, cs_sum (B) must be zeroed before the call.
extern "C" int ssim_fwd(const void* x, const void* y, const float* g, int win_size, float c1,
                        float c2, void* s_sum, void* cs_sum, int b, int h, int w, void* stream) {
  if (int err = check(b, h, w, win_size)) return err;
  const int tiles_w = (w - R + OT_W - 1) / OT_W;
  const int tiles_h = (h - R + OT_H - 1) / OT_H;
  ssim_moments_kernel<false><<<dim3(tiles_w * tiles_h, b), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), window(g), h, w, tiles_w, c1,
      c2, static_cast<float*>(s_sum), static_cast<float*>(cs_sum), nullptr, nullptr, 0.f,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

// maps: scratch of 4 * B * (H-10) * (W-10) floats; gx, gy (B, H, W).
extern "C" int ssim_bwd(const void* x, const void* y, const void* g_s, const void* g_cs,
                        const float* g, int win_size, float c1, float c2, float inv_n, void* maps,
                        void* gx, void* gy, int b, int h, int w, void* stream) {
  if (int err = check(b, h, w, win_size)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Window wnd = window(g);
  const int tiles_w = (w - R + OT_W - 1) / OT_W;
  const int tiles_h = (h - R + OT_H - 1) / OT_H;
  ssim_moments_kernel<true><<<dim3(tiles_w * tiles_h, b), THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), wnd, h, w, tiles_w, c1, c2,
      nullptr, nullptr, static_cast<const float*>(g_s), static_cast<const float*>(g_cs), inv_n,
      static_cast<float*>(maps));
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const int ttiles_w = (w + TT_W - 1) / TT_W;
  const int ttiles_h = (h + TT_H - 1) / TT_H;
  ssim_grad_kernel<<<dim3(ttiles_w * ttiles_h, b), THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(maps),
      wnd, h, w, ttiles_w, static_cast<float*>(gx), static_cast<float*>(gy));
  return static_cast<int>(cudaGetLastError());
}
