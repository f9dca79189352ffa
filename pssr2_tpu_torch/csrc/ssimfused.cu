// SSIM statistics for Hopper, forward and backward, f32 throughout: the
// single-scale level, the middle MS-SSIM levels (with the 2x2 pool that
// feeds the next level) and MS-SSIM level 0 of the mixed loss (with the
// divide by the image range, the Gaussian-windowed L1 sum and the pool).
//
// For each image b of x, y (B, H, W), an odd window of K taps g (K <= 31),
// and Blur the separable VALID blur (output (H-K+1, W-K+1)):
//
//   mu1 = Blur(x), mu2 = Blur(y), xx = Blur(x*x), yy = Blur(y*y), xy = Blur(x*y)
//   cs_map   = (2 (xy - mu1 mu2) + c2) / ((xx - mu1^2) + (yy - mu2^2) + c2)
//   ssim_map = ((2 mu1 mu2 + c1) / (mu1^2 + mu2^2 + c1)) * cs_map
//   s[b] = sum ssim_map, cs[b] = sum cs_map     (the wrapper scales by 1/n)
//
// Optional parts of the same pass, each selected by a non-null pointer:
//   divisor != 1: x and y are first divided by it (an exact f32 divide);
//   xp, yp:  the 2x2 mean pool of x and y, (B, H/2, W/2), H and W even;
//   l1_sum:  sum over all pixels of SameBlur(|x - y|), the zero-padded
//            same-size blur.  Summed over the image, that blur gives
//            pixel (i, j) the weight eH[i] * eW[j], where eH[i] is the sum
//            of the taps that land inside the image from row i (1 in the
//            interior, less within K/2 of a border), so the kernel sums
//            |x - y| * eH * eW and never forms the blurred map.
//
// Backward, given the cotangents gs[b], gcs[b] of the means: launch 1
// recomputes the moments and writes four maps on the VALID grid,
// g_mu1, g_mu2, db2 and 2*da2 (the chain of ops/ssim.py's analytic VJP);
// launch 2 applies the transposed blur (a full correlation, zero outside
// the VALID grid) to each, giving t1..t4, and forms
//   gx = t1 + 2x t3 + y t4 [+ l1g] [+ gxp/4 of the pixel's parent]  [/ divisor]
//   gy = t2 + 2y t3 + x t4 [- l1g] [+ gyp/4 of the pixel's parent]  [/ divisor]
// with l1g = gl1[b]/(H W) * eH[i] * eW[j] * sign(x - y), sign(0) = 0.
//
// Replaces the TPU kernels of pssr2_tpu/ops/pallas/ssimfused.py:
// _fwd_kernel / _bwd_kernel (via _fused_fn), _fwd_pool_kernel /
// _bwd_pool_kernel (via _fused_pool_fn) and _fwd_l0_kernel / _bwd_l0_kernel
// (via _fused_l0_fn).  Those hold one whole image in VMEM per grid step
// and blur, pool and sum with band-chunked MXU dots; here a block owns a
// tile of the output with a (K-1)-pixel halo in shared memory and applies
// the taps directly on the CUDA cores.  The window code is shared: one
// moments kernel (sums, or the backward's maps) and one transposed kernel.
//
// Numerics: true f32.  Products, the map arithmetic and the divisions use
// the round-to-nearest intrinsics, so nvcc fuses no multiply-add into the
// variance terms (E[x^2] - E[x]^2 cancels) and no division is approximate.
// The blur sums use fused multiply-adds, as a matrix product does.  The
// pool is 0.5 (0.5 a + 0.5 c) + 0.5 (0.5 b + 0.5 d), rows first, as the
// TPU kernel's two pool matrices order it.  The per-image sums meet with
// atomicAdd, so their order changes from run to run.
//
// What bounds it on an H100 SXM: per VALID pixel the forward does about
// 250 f32 operations (five maps, 2K taps, the map arithmetic) on 8 bytes
// of input, so operations (67 TFLOP/s f32) bound it, with bytes (3.35 TB/s)
// close behind; the backward does about twice the operations and moves
// x, y, gx and gy once each.  The pool and the L1 add a few operations and
// the pooled bytes.
//
// The window is a runtime argument up to MAX_WIN taps; the loss's default
// of 11 taps is also compiled with the count fixed, so its loops unroll.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_WIN = 31;
constexpr int THREADS = 256;
// moments pass (forward and backward launch 1): a VALID-grid output tile
constexpr int OT_H = 32, OT_W = 32;
// transposed pass (backward launch 2): an output tile of gx, gy
constexpr int TT_H = 16, TT_W = 32;
constexpr int STATIC_SMEM = 48 * 1024;  // above this a launch needs the opt-in

struct Window {
  float g[MAX_WIN];
  int n;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

template <int KW>
__device__ __forceinline__ int taps(const Window& w) {
  return KW > 0 ? KW : w.n;
}

// The weight of pixel i (of n along one axis) in the sum of the zero-padded
// same-size blur: the taps t with 0 <= i + K/2 - t <= n - 1.
__device__ __forceinline__ float edge_weight(const Window& w, int k, int n, int i) {
  const int pad = (k - 1) / 2;
  const int lo = max(0, i + pad - (n - 1));
  const int hi = min(k - 1, i + pad);
  float s = 0.f;
  for (int t = lo; t <= hi; ++t) s = add(s, w.g[t]);
  return s;
}

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

struct MomentArgs {
  const float* x;
  const float* y;
  int H, W, tiles_w;
  float c1, c2, divisor;
  // forward: per-image sums (zeroed by the caller); l1_sum, xp, yp optional
  float* s_sum;
  float* cs_sum;
  float* l1_sum;
  float* xp;
  float* yp;
  // backward launch 1: the cotangents of the means and the four maps
  const float* g_s;
  const float* g_cs;
  float inv_n;
  float* maps;
};

__host__ __device__ inline int moments_smem_floats(int r) {
  const int ih = OT_H + r, iw = OT_W + r;
  return 2 * ih * (iw + 1) + 5 * ih * OT_W + ih + iw;
}

// MAPS = false: per-image (ssim, cs) sums, and the optional pool and L1 sum.
// MAPS = true: the backward's four VALID-grid maps into maps (4, B, Hp, Wp).
template <int KW, bool MAPS>
__global__ void __launch_bounds__(THREADS) ssim_moments_kernel(MomentArgs a, Window win) {
  extern __shared__ float smem[];
  __shared__ float scratch[THREADS / 32];
  const int K = taps<KW>(win);
  const int R = K - 1;
  const int IH = OT_H + R, IW = OT_W + R, LD = IW + 1, HB = IH * OT_W;
  float* xs = smem;             // IH x LD
  float* ys = xs + IH * LD;     // IH x LD
  float* hb = ys + IH * LD;     // 5 planes of IH x OT_W
  float* wr = hb + 5 * HB;      // IH row weights of the L1 sum
  float* wc = wr + IH;          // IW column weights

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int H = a.H, W = a.W;
  const int i0 = (blockIdx.x / a.tiles_w) * OT_H;
  const int j0 = (blockIdx.x % a.tiles_w) * OT_W;
  const int Hp = H - R, Wp = W - R;
  const long long img = (long long)b * H * W;
  const bool scale = a.divisor != 1.f;

  for (int e = tid; e < IH * IW; e += THREADS) {
    const int r = e / IW, c = e % IW;
    const int i = i0 + r, j = j0 + c;
    float xv = 0.f, yv = 0.f;
    if (i < H && j < W) {
      xv = a.x[img + (long long)i * W + j];
      yv = a.y[img + (long long)i * W + j];
      if (scale) {
        xv = div(xv, a.divisor);
        yv = div(yv, a.divisor);
      }
    }
    xs[r * LD + c] = xv;
    ys[r * LD + c] = yv;
  }
  // The pixels this block owns for the pool and the L1 sum: its VALID rows
  // and columns, and in the last tile of a row or column also the K-1 that
  // no VALID output starts at.  They all lie inside the loaded tile.
  const int i_end = i0 + OT_H >= Hp ? H : i0 + OT_H;
  const int j_end = j0 + OT_W >= Wp ? W : j0 + OT_W;
  const int own_h = i_end - i0, own_w = j_end - j0;
  if (!MAPS && a.l1_sum != nullptr) {
    for (int e = tid; e < own_h + own_w; e += THREADS)
      if (e < own_h)
        wr[e] = edge_weight(win, K, H, i0 + e);
      else
        wc[e - own_h] = edge_weight(win, K, W, j0 + e - own_h);
  }
  __syncthreads();

  // horizontal pass over every row of the halo tile
  for (int e = tid; e < IH * OT_W; e += THREADS) {
    const int r = e / OT_W, c = e % OT_W;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const float xv = xs[r * LD + c + u], yv = ys[r * LD + c + u], g = win.g[u];
      m0 = fmaf(g, xv, m0);
      m1 = fmaf(g, yv, m1);
      m2 = fmaf(g, mul(xv, xv), m2);
      m3 = fmaf(g, mul(yv, yv), m3);
      m4 = fmaf(g, mul(xv, yv), m4);
    }
    const int o = r * OT_W + c;
    hb[o] = m0;
    hb[HB + o] = m1;
    hb[2 * HB + o] = m2;
    hb[3 * HB + o] = m3;
    hb[4 * HB + o] = m4;
  }
  __syncthreads();

  float gs = 0.f, gcs = 0.f;
  if (MAPS) {
    gs = mul(a.g_s[b], a.inv_n);
    gcs = mul(a.g_cs[b], a.inv_n);
  }
  const long long plane = (long long)gridDim.y * Hp * Wp;  // one of the four maps
  float acc_s = 0.f, acc_cs = 0.f;
  for (int e = tid; e < OT_H * OT_W; e += THREADS) {
    const int r = e / OT_W, c = e % OT_W;
    const int i = i0 + r, j = j0 + c;
    if (i >= Hp || j >= Wp) continue;
    float mu1 = 0.f, mu2 = 0.f, xx = 0.f, yy = 0.f, xy = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float g = win.g[t];
      const int o = (r + t) * OT_W + c;
      mu1 = fmaf(g, hb[o], mu1);
      mu2 = fmaf(g, hb[HB + o], mu2);
      xx = fmaf(g, hb[2 * HB + o], xx);
      yy = fmaf(g, hb[3 * HB + o], yy);
      xy = fmaf(g, hb[4 * HB + o], xy);
    }
    const float mu1_sq = mul(mu1, mu1), mu2_sq = mul(mu2, mu2), mu1_mu2 = mul(mu1, mu2);
    const float a1 = add(2.f * mu1_mu2, a.c1);
    const float b1 = add(add(mu1_sq, mu2_sq), a.c1);
    const float a2 = add(2.f * sub(xy, mu1_mu2), a.c2);
    const float b2 = add(add(sub(xx, mu1_sq), sub(yy, mu2_sq)), a.c2);
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
      a.maps[o] = 2.f * add(mul(mu2, u), mul(mu1, v));
      a.maps[plane + o] = 2.f * add(mul(mu1, u), mul(mu2, v));
      a.maps[2 * plane + o] = db2;
      a.maps[3 * plane + o] = 2.f * da2;
    }
  }
  if (MAPS) return;

  if (a.xp != nullptr) {
    const int ph = own_h / 2, pw = own_w / 2, Wh = W / 2;
    const long long pimg = (long long)b * (H / 2) * Wh;
    for (int e = tid; e < ph * pw; e += THREADS) {
      const int r = 2 * (e / pw), c = 2 * (e % pw);
      const long long o = pimg + (long long)(i0 / 2 + r / 2) * Wh + j0 / 2 + c / 2;
      const float* t = xs + r * LD + c;
      a.xp[o] = add(mul(0.5f, add(mul(0.5f, t[0]), mul(0.5f, t[LD]))),
                    mul(0.5f, add(mul(0.5f, t[1]), mul(0.5f, t[LD + 1]))));
      t = ys + r * LD + c;
      a.yp[o] = add(mul(0.5f, add(mul(0.5f, t[0]), mul(0.5f, t[LD]))),
                    mul(0.5f, add(mul(0.5f, t[1]), mul(0.5f, t[LD + 1]))));
    }
  }
  float acc_l1 = 0.f;
  if (a.l1_sum != nullptr) {
    for (int e = tid; e < own_h * own_w; e += THREADS) {
      const int r = e / own_w, c = e % own_w;
      const float d = fabsf(sub(xs[r * LD + c], ys[r * LD + c]));
      acc_l1 += mul(mul(d, wr[r]), wc[c]);
    }
  }

  const float ts = block_sum(acc_s, scratch);
  const float tcs = block_sum(acc_cs, scratch);
  if (tid == 0) {
    atomicAdd(&a.s_sum[b], ts);
    atomicAdd(&a.cs_sum[b], tcs);
  }
  if (a.l1_sum != nullptr) {
    const float tl1 = block_sum(acc_l1, scratch);
    if (tid == 0) atomicAdd(&a.l1_sum[b], tl1);
  }
}

struct GradArgs {
  const float* x;
  const float* y;
  const float* maps;
  int H, W, tiles_w;
  float divisor;
  const float* gxp;   // (B, H/2, W/2) or null: cotangents of the pooled x, y
  const float* gyp;
  const float* g_l1;  // (B) or null: cotangent of the L1 mean
  float* gx;
  float* gy;
};

__host__ __device__ inline int grad_smem_floats(int r) {
  const int ih = TT_H + r, iw = TT_W + r;
  return 4 * ih * (iw + 1) + 4 * ih * TT_W + TT_H + TT_W;
}

// Backward launch 2: transposed blur of the four maps, then gx and gy.
template <int KW>
__global__ void __launch_bounds__(THREADS) ssim_grad_kernel(GradArgs a, Window win) {
  extern __shared__ float smem[];
  const int K = taps<KW>(win);
  const int R = K - 1;
  const int IH = TT_H + R, IW = TT_W + R, LD = IW + 1;
  const int MP = IH * LD, HP = IH * TT_W;
  float* ms = smem;          // 4 planes of IH x LD
  float* hs = ms + 4 * MP;   // 4 planes of IH x TT_W
  float* wr = hs + 4 * HP;   // TT_H row weights of the L1 gradient
  float* wc = wr + TT_H;     // TT_W column weights

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int H = a.H, W = a.W;
  const int i0 = (blockIdx.x / a.tiles_w) * TT_H;
  const int j0 = (blockIdx.x % a.tiles_w) * TT_W;
  const int Hp = H - R, Wp = W - R;
  const long long plane = (long long)gridDim.y * Hp * Wp;

  // the maps over rows i0-R .. i0+TT_H-1 and columns j0-R .. j0+TT_W-1,
  // zero outside the VALID grid
  for (int e = tid; e < IH * IW; e += THREADS) {
    const int r = e / IW, c = e % IW;
    const int p = i0 - R + r, q = j0 - R + c;
    const bool in = p >= 0 && p < Hp && q >= 0 && q < Wp;
    const long long o = ((long long)b * Hp + p) * Wp + q;
#pragma unroll
    for (int k = 0; k < 4; ++k) ms[k * MP + r * LD + c] = in ? a.maps[k * plane + o] : 0.f;
  }
  if (a.g_l1 != nullptr) {
    for (int e = tid; e < TT_H + TT_W; e += THREADS)
      if (e < TT_H)
        wr[e] = i0 + e < H ? edge_weight(win, K, H, i0 + e) : 0.f;
      else
        wc[e - TT_H] = j0 + e - TT_H < W ? edge_weight(win, K, W, j0 + e - TT_H) : 0.f;
  }
  __syncthreads();

  // t(h, w) = sum_t sum_u g[t] g[u] map[h - t][w - u]: columns first
  for (int e = tid; e < IH * TT_W; e += THREADS) {
    const int r = e / TT_W, c = e % TT_W;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < K; ++u) s = fmaf(win.g[u], ms[k * MP + r * LD + c + R - u], s);
      hs[k * HP + r * TT_W + c] = s;
    }
  }
  __syncthreads();

  const long long img = (long long)b * H * W;
  const float gl1 = a.g_l1 != nullptr ? div(a.g_l1[b], (float)H * (float)W) : 0.f;
  const bool scale = a.divisor != 1.f;
  for (int e = tid; e < TT_H * TT_W; e += THREADS) {
    const int r = e / TT_W, c = e % TT_W;
    const int i = i0 + r, j = j0 + c;
    if (i >= H || j >= W) continue;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < K; ++q) s = fmaf(win.g[q], hs[k * HP + (r + R - q) * TT_W + c], s);
      t[k] = s;
    }
    const long long o = img + (long long)i * W + j;
    float xv = a.x[o], yv = a.y[o];
    if (scale) {
      xv = div(xv, a.divisor);
      yv = div(yv, a.divisor);
    }
    float gx = add(add(t[0], mul(2.f * xv, t[2])), mul(yv, t[3]));
    float gy = add(add(t[1], mul(2.f * yv, t[2])), mul(xv, t[3]));
    if (a.g_l1 != nullptr) {
      const float d = sub(xv, yv);
      const float sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
      const float l1g = mul(mul(mul(gl1, wr[r]), wc[c]), sign);
      gx = add(gx, l1g);
      gy = sub(gy, l1g);
    }
    if (a.gxp != nullptr) {
      const long long p = ((long long)b * (H / 2) + i / 2) * (W / 2) + j / 2;
      gx = add(gx, mul(0.25f, a.gxp[p]));
      gy = add(gy, mul(0.25f, a.gyp[p]));
    }
    if (scale) {
      gx = div(gx, a.divisor);
      gy = div(gy, a.divisor);
    }
    a.gx[o] = gx;
    a.gy[o] = gy;
  }
}

Window window(const float* g, int k) {
  Window w = {};
  for (int i = 0; i < k; ++i) w.g[i] = g[i];
  w.n = k;
  return w;
}

int check(int b, int h, int w, int k, bool pool) {
  if (b <= 0 || b > 65535 || k < 1 || k > MAX_WIN || k % 2 == 0 || h < k || w < k)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool && (h % 2 != 0 || w % 2 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Launch with `floats` of dynamic shared memory, opting in above 48 KB.
template <typename Kernel, typename Args>
int launch(Kernel kernel, int floats, dim3 grid, cudaStream_t stream, const Args& args,
           const Window& win) {
  const size_t bytes = sizeof(float) * floats;
  if (bytes > STATIC_SMEM) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, THREADS, bytes, stream>>>(args, win);
  return static_cast<int>(cudaGetLastError());
}

template <bool MAPS>
int launch_moments(const MomentArgs& args, const Window& win, int b, cudaStream_t stream) {
  const int r = win.n - 1;
  const int tiles_w = (args.W - r + OT_W - 1) / OT_W;
  const int tiles_h = (args.H - r + OT_H - 1) / OT_H;
  MomentArgs a = args;
  a.tiles_w = tiles_w;
  const dim3 grid(tiles_w * tiles_h, b);
  if (win.n == 11)
    return launch(ssim_moments_kernel<11, MAPS>, moments_smem_floats(r), grid, stream, a, win);
  return launch(ssim_moments_kernel<0, MAPS>, moments_smem_floats(r), grid, stream, a, win);
}

}  // namespace

// All pointers are device pointers except `g`, the win_size window taps on
// the host; the optional ones may be null.  Launches go on `stream` and do
// not synchronise; each function returns the first nonzero CUDA error code
// (0 on success), or cudaErrorInvalidValue for sizes it does not take.

// s_sum, cs_sum and l1_sum (B) must be zeroed before the call; xp, yp are
// (B, H/2, W/2) and need H, W even.
extern "C" int ssim_fwd(const void* x, const void* y, const float* g, int win_size, float c1,
                        float c2, float divisor, void* s_sum, void* cs_sum, void* l1_sum,
                        void* xp, void* yp, int b, int h, int w, void* stream) {
  if (int err = check(b, h, w, win_size, xp != nullptr)) return err;
  MomentArgs a = {};
  a.x = static_cast<const float*>(x);
  a.y = static_cast<const float*>(y);
  a.H = h;
  a.W = w;
  a.c1 = c1;
  a.c2 = c2;
  a.divisor = divisor;
  a.s_sum = static_cast<float*>(s_sum);
  a.cs_sum = static_cast<float*>(cs_sum);
  a.l1_sum = static_cast<float*>(l1_sum);
  a.xp = static_cast<float*>(xp);
  a.yp = static_cast<float*>(yp);
  return launch_moments<false>(a, window(g, win_size), b, static_cast<cudaStream_t>(stream));
}

// maps: scratch of 4 * B * (H-K+1) * (W-K+1) floats; gx, gy (B, H, W);
// g_l1 (B), gxp and gyp (B, H/2, W/2) optional.
extern "C" int ssim_bwd(const void* x, const void* y, const void* g_s, const void* g_cs,
                        const void* g_l1, const void* gxp, const void* gyp, const float* g,
                        int win_size, float c1, float c2, float divisor, float inv_n, void* maps,
                        void* gx, void* gy, int b, int h, int w, void* stream) {
  if (int err = check(b, h, w, win_size, gxp != nullptr)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Window wnd = window(g, win_size);
  MomentArgs m = {};
  m.x = static_cast<const float*>(x);
  m.y = static_cast<const float*>(y);
  m.H = h;
  m.W = w;
  m.c1 = c1;
  m.c2 = c2;
  m.divisor = divisor;
  m.g_s = static_cast<const float*>(g_s);
  m.g_cs = static_cast<const float*>(g_cs);
  m.inv_n = inv_n;
  m.maps = static_cast<float*>(maps);
  if (int err = launch_moments<true>(m, wnd, b, s)) return err;

  GradArgs a = {};
  a.x = m.x;
  a.y = m.y;
  a.maps = m.maps;
  a.H = h;
  a.W = w;
  a.tiles_w = (w + TT_W - 1) / TT_W;
  a.divisor = divisor;
  a.gxp = static_cast<const float*>(gxp);
  a.gyp = static_cast<const float*>(gyp);
  a.g_l1 = static_cast<const float*>(g_l1);
  a.gx = static_cast<float*>(gx);
  a.gy = static_cast<float*>(gy);
  const dim3 grid(a.tiles_w * ((h + TT_H - 1) / TT_H), b);
  const int floats = grad_smem_floats(win_size - 1);
  if (win_size == 11) return launch(ssim_grad_kernel<11>, floats, grid, s, a, wnd);
  return launch(ssim_grad_kernel<0>, floats, grid, s, a, wnd);
}
