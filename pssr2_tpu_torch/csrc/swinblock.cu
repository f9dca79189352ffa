// The whole Swin transformer block for Hopper, forward and backward, and the
// window attention of the per-block path.
//
// Block (T is float or bfloat16; every T(...) a rounding to T):
//
//   h1  = LN1(x)                      f32 statistics, fast variance, rounded
//   qkv = T(T(h1 Wqkv) + bqkv)        f32 accumulation; the q scale is folded
//   s   = q k^T + bias [-100 between group labels when shifted]      (f32)
//   p   = T(exp(s) * (1 / sum exp(s)))                      no-max softmax
//   att = T(p v)
//   y   = T(x + T(T(T(att Wp) + bp) * s1))        s1, s2: DropPath scales
//   h2  = LN2(y); z1 = T(T(h2 W1) + b1); zg = T(GELU(z1))
//   out = T(y + T(T(T(zg W2) + b2) * s2))
//
// on (B, H, W, C) channels-last tensors.  The windows are ws x ws tiles of
// the image rolled by -shift: a block reads token (r, c) of its window at
// ((r + shift) mod H, (c + shift) mod W) and writes it back there, so input
// and output stay in the canonical layout.  GELU: the erf rational for f32,
// the polynomial of swinblock._gelu_fast for bf16.  Replaces the TPU kernels
// pssr2_tpu/ops/pallas/swinblock.py:_block_kernel (forward, reached through
// _pallas_block) and _block_bwd_kernel (backward, _pallas_block_bwd).
//
// The window attention (softmax(q k^T * scale + bias [+ mask]) v with a
// max-subtracted softmax, q, k, v from a (B, H, W, 3C) image read in place)
// replaces pssr2_tpu/ops/pallas/winattn.py:_attn_kernel(_masked) and
// _attn_kernel_2d(_masked) (reached through _pallas_window_attention and
// _pallas_window_attention_2d).
//
// What bounds them on an H100 SXM: per token a block does about
// 2 C 3C + 4 n C + 2 C^2 + 4 C hidden operations forward (172 k at C 96,
// n 64, hidden 192) and about twice that more backward, against 989 TFLOP/s
// (bf16 tensor cores) or 67 TFLOP/s (f32 CUDA cores); the bytes are x and the
// output once each.  The operations bound it.
//
// Two routes (ops/swinblock.py:route).  bfloat16 blocks with 8 x 8
// windows, C a multiple of 16 up to 192, heads of 16 or 32 channels and an
// MLP width a multiple of 16 up to 384 run on the tensor cores (wgmma):
// csrc/swinblock_tc.cuh, entry points swin_tc_fwd (one launch) and
// swin_tc_bwd (two), whose header gives that design.  float32 and every
// other bfloat16 shape run on the CUDA cores in f32 (bf16 values are exact
// in f32), as set out below; the window attention runs there too.
//
// CUDA-core route.
//
// Forward, one launch: one thread block of 256 threads per window, every
// value between x and the output in shared memory as f32 copies of the T
// values, "k-major" (element (channel c, token t) at c * 64 + t).  LN1 -> h
// (buffer A); qkv (buffer Q, 3C rows); per head the scores and probabilities
// (A) and the head's output over its q rows; proj -> y (A); LN2 -> h2 (Q);
// fc1 and GELU -> zg (Q, after h2); fc2 -> the output, written to global.
// The weights stream through shared memory in 16-row slices, the next one
// prefetched into registers; each thread holds a 4 x 4 tile of a 64 x 64
// output chunk.
//
// Backward, thirteen launches (tiled by ops/swinblock.py:f32_plan).  Only
// the attention core depends on the windows and the roll: LayerNorm and
// every product with W_qkv, W_proj, W_fc1 and W_fc2 act token by token, so
// they run as whole-batch products over the M = B H W canonical rows on the
// register-tiled f32 mainloop of csrc/f32gemm.cuh (128-row tiles, the
// weights read as they lie and shared by every tile), and the attention
// kernels gather a window's tokens through token_at.  The chain, every
// intermediate an f32 scratch row (M rows):
//  (1) LN1: h1 = T(LN1(x)), the row statistics;
//  (2) qkv = T(T(h1 Wqkv) + bqkv);
//  (3) the attention forward per (window, head): att = T(p v);
//  (4) proj: y = T(x + T(T(T(att Wp) + bp) s1[b])), b the row's sample;
//  (5) LN2: h2 = T(LN2(y)), the row statistics, gmlp = T(g s2[b]) and db2;
//  (6) the MLP rows (blockmath.cuh:mlp_rows_tile): zg = T(GELU(z1)), z1 =
//      T(T(h2 W1) + b1); dz1 = T(T(gmlp W2^T) GELU'(z1)); db1;
//  (7) dh2 = T(dz1 W1^T);
//  (8) the LN2 backward: dy1 = T(g + T(LN2'(dh2))), gproj = T(dy1 s1[b]);
//      dln2_s, dln2_b, dbproj;
//  (9) datt = T(gproj Wp^T);
// (10) the attention backward per (window, head): dq, dk, dv into dqkv, the
//      bias map's gradient summed over a block's windows in shared memory;
// (11) dh1 = T(dqkv Wqkv^T);
// (12) the LN1 backward: dx = T(dy1 + T(LN1'(dh1))); dln1_s, dln1_b, dbqkv;
// (13) one launch of dWqkv = h1^T dqkv, dWp = att^T gproj, dW1 = h2^T dz1,
//      dW2 = zg^T gmlp, K = M split in shares met by atomicAdd.
// At the default SwinIR's blocks (C 96, hidden 192) the scratch rows take
// about 63 C f32 values a token written or read, some 6.3 GB a block at
// batch 16 (1.9 ms at 3.35 TB/s), beside 2.165 TFLOP over 16 blocks.  The
// atomics make the order of the parameter gradients' f32 sums change from
// run to run.
//
// The window attention: one block per window, one head at a time: q, k, v
// of the head (d <= 32 channels) and its probabilities in shared memory.

#include "blockmath.cuh"
#include "convchain_tc.cuh"
#include "f32gemm.cuh"
#include "rdtail_tc.cuh"
#include "swinblock_tc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NT = 64;   // token rows of a window tile: ws * ws <= 64
constexpr int KC = 16;   // rows of a streamed operand slice
constexpr int NC = 64;   // output columns of a product chunk
constexpr int DMAX = 32; // channels of a head
constexpr int SMEM_MAX = 232448;
constexpr float NEG = -100.f;  // the shift mask's value

// Sum and max over the 16 lanes of a half warp (the column groups of a row
// group in the 64 x 64 tile layout).
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// ---- the window a block owns

struct Geo {
  int B, H, W, C, heads, ws, shift, hidden;
};

// The canonical row (b H + r) W + c of token t < n of window `win`, read at
// the rolled coordinates, and its group label in the rolled image: region
// 0 / 1 / 2 of rows [0, H - ws), [H - ws, H - shift), [H - shift, H), times
// 3, plus that of the columns (pssr2_tpu/ops/pallas/swinblock.py:_window_group_labels).
__device__ __forceinline__ void token_at(const Geo& g, int win, int t, long long& row, int& lab) {
  const int nwx = g.W / g.ws, nwy = g.H / g.ws;
  const int b = win / (nwy * nwx), wy = (win / nwx) % nwy, wx = win % nwx;
  const int rr = wy * g.ws + t / g.ws, cr = wx * g.ws + t % g.ws;
  const int r = (rr + g.shift) % g.H, c = (cr + g.shift) % g.W;
  row = ((long long)b * g.H + r) * g.W + c;
  const int lr = rr < g.H - g.ws ? 0 : (rr < g.H - g.shift ? 1 : 2);
  const int lc = cr < g.W - g.ws ? 0 : (cr < g.W - g.shift ? 1 : 2);
  lab = lr * 3 + lc;
}

// token_at for each token of window `win` into tok and lab (-1 past n)
__device__ void window_tokens(const Geo& g, int win, long long* tok, int* lab) {
  const int n = g.ws * g.ws;
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    if (t < n) {
      token_at(g, win, t, tok[t], lab[t]);
    } else {
      tok[t] = -1;
      lab[t] = -1;
    }
  }
  __syncthreads();
}

// ---- per-token sums over the C channels of the tile: 4 threads a token,
// each a quarter of the channels; f(t, c, a, b) adds to a and b.  -> sa[t],
// sb[t] (zeros past n).  red: 8 x 64 floats of scratch.
template <typename F>
__device__ void token_sums(F f, int n, int C, float* sa, float* sb, float* red) {
  const int t = threadIdx.x & (NT - 1), part = threadIdx.x >> 6;
  const int cq = (C + 3) / 4, cb = part * cq, ce = min(C, cb + cq);
  float a = 0.f, b = 0.f;
  if (t < n)
    for (int c = cb; c < ce; ++c) f(t, c, a, b);
  red[part * NT + t] = a;
  red[(4 + part) * NT + t] = b;
  __syncthreads();
  if (threadIdx.x < NT) {
    sa[t] = (red[t] + red[NT + t]) + (red[2 * NT + t] + red[3 * NT + t]);
    sb[t] = (red[4 * NT + t] + red[5 * NT + t]) + (red[6 * NT + t] + red[7 * NT + t]);
  }
  __syncthreads();
}

// LayerNorm statistics of the tile's tokens, val(t, c) their f32 values:
// mu[t] and rstd[t] = 1 / sqrt(max(0, E[x^2] - mu^2) + eps).
template <typename F>
__device__ void ln_stats(F val, int n, int C, float eps, float* mu, float* rstd, float* red) {
  token_sums([&](int t, int c, float& a, float& b) {
    const float v = val(t, c);
    a += v;
    b = fmaf(v, v, b);
  }, n, C, mu, rstd, red);
  if (threadIdx.x < NT) {
    const int t = threadIdx.x;
    const float m = __fdiv_rn(mu[t], (float)C);
    const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(rstd[t], (float)C), __fmul_rn(m, m)));
    mu[t] = m;
    rstd[t] = t < n ? __frsqrt_rn(__fadd_rn(var, eps)) : 0.f;
  }
  __syncthreads();
}

// h = T((x - mu) (rstd gamma) + beta) into outT (k-major; zeros past n).
template <typename T, typename F>
__device__ void ln_apply(F val, int n, int C, const T* gam, const T* bet, const float* mu,
                         const float* rstd, float* outT) {
  for (int e = threadIdx.x; e < NT * C; e += THREADS) {
    const int t = e & (NT - 1), c = e >> 6;
    float h = 0.f;
    if (t < n) {
      const float mul = __fmul_rn(rstd[t], to_f32(gam[c]));
      h = round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(val(t, c), mu[t]), mul), to_f32(bet[c])));
    }
    outT[c * NT + t] = h;
  }
  __syncthreads();
}

// ---- products on the 64-token tile

// 64 x N = A (64 x K) B (K x N, row-major in global, T), in 64-column chunks:
// thread (rg, cg) = (tid / 16, tid % 16) holds rows 4rg.. and the chunk's
// columns 4cg..; epi(n0, rg, cg, acc) consumes each chunk.  A is k-major in
// shared memory (a_smem[k * 64 + row]); B streams through `bs` in 16-row
// slices, the next slice prefetched.
template <typename T, typename Epi>
__device__ void gemm(const float* a_smem, int K, const T* __restrict__ b, int N, float* bs, Epi epi) {
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float rb[4];
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = tid + THREADS * q;
        const int k = k0 + (e >> 6), col = n0 + (e & 63);
        rb[q] = (k < K && col < N) ? to_f32(b[(long long)k * N + col]) : 0.f;
      }
    };
    load(0);
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // the previous slice is consumed
#pragma unroll
      for (int q = 0; q < 4; ++q) bs[tid + THREADS * q] = rb[q];
      __syncthreads();
      if (k0 + KC < K) load(k0 + KC);
      const int kc = min(KC, K - k0);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < kc) {
          const float4 av = *reinterpret_cast<const float4*>(a_smem + (k0 + k) * NT + 4 * rg);
          const float4 bv = *reinterpret_cast<const float4*>(bs + k * NC + 4 * cg);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
      }
    }
    epi(n0, rg, cg, acc);
  }
  __syncthreads();
}

// out[i][j] = sum_dd at[dd][i] bt[dd][j] on the (rg, cg) 4 x 4 tile; at, bt
// k-major with d rows.
__device__ __forceinline__ void prod_ij(const float* at, const float* bt, int d, float (&out)[4][4]) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    const float4 av = *reinterpret_cast<const float4*>(at + dd * NT + 4 * rg);
    const float4 bv = *reinterpret_cast<const float4*>(bt + dd * NT + 4 * cg);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(ar[i], br[j], out[i][j]);
  }
}

// out[r][dd] = sum_{k < n} a[k][r] bt[dd][k] for rows r = 4 ig.. (ig = tid %
// 16) and channels dd = dg, dg + 16 (dg = tid / 16) below d: a k-major 64 x
// 64, bt k-major with d rows.
__device__ __forceinline__ void prod_kd(const float* a, const float* bt, int d, int n, float (&out)[4][2]) {
  const int ig = threadIdx.x & 15, dg = threadIdx.x >> 4;
  const bool c0 = dg < d, c1 = dg + 16 < d;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i][0] = out[i][1] = 0.f;
  for (int k = 0; k < n; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * NT + 4 * ig);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float b0 = c0 ? bt[dg * NT + k] : 0.f;
    const float b1 = c1 ? bt[(dg + 16) * NT + k] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i][0] = fmaf(ar[i], b0, out[i][0]);
      out[i][1] = fmaf(ar[i], b1, out[i][1]);
    }
  }
}

// Store prod_kd's result, rounded to T, k-major over its d rows of dst.
template <typename T>
__device__ __forceinline__ void store_kd(float* dst, int d, const float (&o)[4][2]) {
  const int ig = threadIdx.x & 15, dg = threadIdx.x >> 4;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int dd = dg + 16 * q;
    if (dd < d) {
      const float v[4] = {round_to<T>(o[0][q]), round_to<T>(o[1][q]), round_to<T>(o[2][q]), round_to<T>(o[3][q])};
      store4(dst + dd * NT + 4 * ig, v);
    }
  }
}

// The f32 probabilities of one head on the (rg, cg) tile: s = q k^T (d
// channels, k-major), times `scale` when SCALED, plus the head's bias map
// (n x n, global), plus -100 between different group labels (lab) or the
// window's mask map (mask_w); then MAXSUB ? exp(s - max) / sum : exp(s) *
// (1 / sum).  Zeros outside the n x n block.
template <bool MAXSUB, bool SCALED>
__device__ void head_probs(const float* qT, const float* kT, int d, int n, const float* __restrict__ bias_h,
                           const int* lab, const float* __restrict__ mask_w, float scale, float (&p)[4][4]) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  prod_ij(qT, kT, d, p);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = 4 * rg + ii;
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * cg + jj;
      float v = SCALED ? __fmul_rn(p[ii][jj], scale) : p[ii][jj];
      if (i < n && j < n) {
        v = __fadd_rn(v, bias_h[i * n + j]);
        if (lab != nullptr && lab[i] != lab[j]) v = __fadd_rn(v, NEG);
        if (mask_w != nullptr) v = __fadd_rn(v, mask_w[i * n + j]);
        m = fmaxf(m, v);
      }
      p[ii][jj] = v;
    }
    if (MAXSUB) m = half_max(m);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * cg + jj;
      const float e = (i < n && j < n) ? expf(MAXSUB ? __fsub_rn(p[ii][jj], m) : p[ii][jj]) : 0.f;
      p[ii][jj] = e;
      sum += e;
    }
    sum = half_sum(sum);
    const float inv = MAXSUB ? 0.f : __fdiv_rn(1.f, sum);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float e = p[ii][jj];
      p[ii][jj] = i >= n ? 0.f : (MAXSUB ? __fdiv_rn(e, sum) : __fmul_rn(e, inv));
    }
  }
}

// Store the (rg, cg) tile, rounded to T, transposed (k-major over columns:
// dst[j * 64 + i]).
template <typename T>
__device__ __forceinline__ void store_tile_t(float* dst, const float (&p)[4][4]) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float v[4] = {round_to<T>(p[0][jj]), round_to<T>(p[1][jj]), round_to<T>(p[2][jj]), round_to<T>(p[3][jj])};
    store4(dst + (4 * cg + jj) * NT + 4 * rg, v);
  }
}
// The epilogue that rounds a product chunk to T, adds the bias in T and
// stores it k-major at dst rows n0..: qkv.
template <typename T> struct StoreBiased {
  float* dst;
  const T* bias;
  int N;
  __device__ void operator()(int n0, int rg, int cg, float (&acc)[4][4]) const {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 4 * cg + jj;
      if (col >= N) continue;
      const float bv = to_f32(bias[col]);
      float v[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) v[ii] = round_to<T>(round_to<T>(acc[ii][jj]) + bv);
      store4(dst + col * NT + 4 * rg, v);
    }
  }
};

// ---------------------------------------------------------------- forward

template <typename T> struct FwdArgs {
  const T* x;
  T* out;
  const T *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj, *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
  const float* bias;  // (heads, n, n)
  const float *s1, *s2;  // (B,) keep-scales, or null
  Geo g;
  float eps;
};

__host__ __device__ inline size_t fwd_floats(int C, int hidden) {
  return (size_t)(imax(C, NT) + imax(3 * C, C + hidden)) * NT + KC * NC + 10 * NT;
}
__host__ __device__ inline size_t fwd_smem(int C, int hidden) {
  return sizeof(float) * fwd_floats(C, hidden) + (sizeof(long long) + sizeof(int)) * NT;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) swin_fwd_kernel(const FwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const Geo& g = a.g;
  const int C = g.C, hid = g.hidden, n = g.ws * g.ws, d = C / g.heads;
  float* ra = smem;                                // [max(C, 64)][64]: h, p, y
  float* r1 = ra + imax(C, NT) * NT;               // [max(3C, C + hidden)][64]: qkv; att; h2, zg
  float* bs = r1 + imax(3 * C, C + hid) * NT;      // [16][64]
  float* red = bs + KC * NC;                       // [8][64]
  float* mu = red + 8 * NT;
  float* rstd = mu + NT;
  long long* tok = reinterpret_cast<long long*>(smem + fwd_floats(C, hid));
  int* lab = reinterpret_cast<int*>(tok + NT);
  const int win = blockIdx.x;
  window_tokens(g, win, tok, lab);
  const int b = win / ((g.H / g.ws) * (g.W / g.ws));
  const bool scaled = a.s1 != nullptr;
  const float s1 = scaled ? round_to<T>(a.s1[b]) : 1.f, s2 = scaled ? round_to<T>(a.s2[b]) : 1.f;
  auto xval = [&](int t, int c) { return to_f32(a.x[tok[t] * C + c]); };

  ln_stats(xval, n, C, a.eps, mu, rstd, red);
  ln_apply<T>(xval, n, C, a.ln1_s, a.ln1_b, mu, rstd, ra);
  gemm<T>(ra, C, a.wqkv, 3 * C, bs, StoreBiased<T>{r1, a.bqkv, 3 * C});

  // attention, head by head; the head's output over its q rows
  for (int h = 0; h < g.heads; ++h) {
    float p[4][4];
    head_probs<false, false>(r1 + h * d * NT, r1 + (C + h * d) * NT, d, n, a.bias + (size_t)h * n * n,
                             g.shift ? lab : nullptr, nullptr, 1.f, p);
    store_tile_t<T>(ra, p);  // p^T: k-major over the keys
    __syncthreads();
    float o[4][2];
    prod_kd(ra, r1 + (2 * C + h * d) * NT, d, n, o);
    store_kd<T>(r1 + h * d * NT, d, o);
    __syncthreads();
  }

  // y = T(x + T(T(T(att Wp) + bp) s1)) into ra
  gemm<T>(r1, C, a.wproj, C, bs, [&](int n0, int rg, int cg, float (&acc)[4][4]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 4 * cg + jj;
      if (col >= C) continue;
      const float bv = to_f32(a.bproj[col]);
      float v[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = 4 * rg + ii;
        float pv = round_to<T>(round_to<T>(acc[ii][jj]) + bv);
        if (scaled) pv = round_to<T>(__fmul_rn(pv, s1));
        v[ii] = row < n ? round_to<T>(xval(row, col) + pv) : 0.f;
      }
      store4(ra + col * NT + 4 * rg, v);
    }
  });

  auto yval = [&](int t, int c) { return ra[c * NT + t]; };
  ln_stats(yval, n, C, a.eps, mu, rstd, red);
  ln_apply<T>(yval, n, C, a.ln2_s, a.ln2_b, mu, rstd, r1);

  // zg = T(GELU(T(T(h2 W1) + b1))) into r1 rows [C, C + hidden)
  gemm<T>(r1, C, a.w1, hid, bs, [&](int n0, int rg, int cg, float (&acc)[4][4]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 4 * cg + jj;
      if (col >= hid) continue;
      const float bv = to_f32(a.b1[col]);
      float v[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) v[ii] = round_to<T>(gelu<T>(round_to<T>(round_to<T>(acc[ii][jj]) + bv)));
      store4(r1 + (C + col) * NT + 4 * rg, v);
    }
  });

  // out = T(y + T(T(T(zg W2) + b2) s2))
  gemm<T>(r1 + C * NT, hid, a.w2, C, bs, [&](int n0, int rg, int cg, float (&acc)[4][4]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 4 * cg + jj;
      if (col >= C) continue;
      const float bv = to_f32(a.b2[col]);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = 4 * rg + ii;
        if (row >= n) continue;
        float mv = round_to<T>(round_to<T>(acc[ii][jj]) + bv);
        if (scaled) mv = round_to<T>(__fmul_rn(mv, s2));
        a.out[tok[row] * C + col] = from_f32<T>(ra[col * NT + row] + mv);
      }
    }
  });
}

// ------------------------------------------------ backward, CUDA cores

// Every tensor f32 in device memory (a bfloat16 caller's values converted
// exactly by the wrapper); T is the type whose rounding points the plain
// version keeps.  Rows are the canonical tokens (B H W of them); a window's
// tokens are gathered through token_at.
constexpr int LN_ROWS = 32;     // rows a block of the row kernels: 8 warps x 4
constexpr int TOK_STAGES = 3;   // ring slots of the token products
constexpr int JOBS_STAGES = 3;  // ring slots of the weight-gradient launch

__host__ __device__ inline int windows(const Geo& g) { return g.B * (g.H / g.ws) * (g.W / g.ws); }

// Column work over a block's `rows` rows with all its threads: the rows in
// `parts` = THREADS / C runs (one where C > THREADS), thread e of parts x
// C taking column e % C of run e / C.  f(c, r0, r1) walks rows [r0, r1).
template <typename F> __device__ __forceinline__ void column_runs(int C, int rows, F f) {
  const int parts = max(1, f32g::THREADS / C), run = (rows + parts - 1) / parts;
  for (int e = threadIdx.x; e < parts * C; e += f32g::THREADS) {
    const int c = e % C, r0 = (e / C) * run;
    f(c, r0, min(rows, r0 + run));
  }
}

// (1), (5): h = T(LN(src)) and each row's mean and 1/std; where cot is not
// null, cot' = T(cot s[b]) (cot itself where s is null) into cot_out (when
// not null) and its column sums into dsum.
struct LnArgs {
  const float *src, *gamma, *beta, *cot, *s;
  float *h, *mu, *rstd, *cot_out, *dsum;
  int M, C, hw;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(f32g::THREADS) swin_f32_ln_kernel(const LnArgs p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = blockIdx.x * LN_ROWS, C = p.C;
  const int rows = min(LN_ROWS, p.M - row0);
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r >= rows) break;
    const long long o = static_cast<long long>(row0 + r) * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = p.src[o + c];
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = __fdiv_rn(s, (float)C);
    const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mu, mu)));
    const float rstd = __frsqrt_rn(__fadd_rn(var, p.eps));
    if (lane == 0) {
      p.mu[row0 + r] = mu;
      p.rstd[row0 + r] = rstd;
    }
    for (int c = lane; c < C; c += 32)
      p.h[o + c] = round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(p.src[o + c], mu), __fmul_rn(rstd, p.gamma[c])), p.beta[c]));
  }
  if (p.cot == nullptr) return;
  column_runs(C, rows, [&](int c, int r0, int r1) {
    float sum = 0.f;
    for (int r = r0; r < r1; ++r) {
      const int row = row0 + r;
      const long long o = static_cast<long long>(row) * C + c;
      float v = p.cot[o];
      if (p.s != nullptr) v = round_to<T>(__fmul_rn(v, round_to<T>(p.s[row / p.hw])));
      if (p.cot_out != nullptr) p.cot_out[o] = v;
      sum += v;
    }
    atomicAdd(p.dsum + c, sum);
  });
}

// (2), (4), (7), (9), (11): the token products out (M, N) = A (M, K) W, A's
// rows K-contiguous, W as it lies (K-contiguous where KB: W^T of a (N, K)
// weight), 128 x BN tiles on the f32 mainloop, then the epilogue:
// EPI_BIAS out = T(T(acc) + bias); EPI_RESID out = T(resid + T(T(T(acc) +
// bias) s[b])) (s null: no scale); EPI_ROUND out = T(acc).
enum { EPI_BIAS, EPI_RESID, EPI_ROUND };

struct TokArgs {
  const float *a, *w, *bias, *resid, *s;
  float* out;
  int M, K, N, hw, w_ld, w_vec;
};

template <typename T, int BN, bool KB, int EPI>
__global__ void __launch_bounds__(f32g::THREADS, 2) swin_f32_tok_kernel(const TokArgs p) {
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * f32g::BM, n0 = blockIdx.y * BN;
  const f32g::Pos t;
  float acc[8][TN];
  f32g::zero(acc);
  f32g::gemm<BN, TOK_STAGES, true, KB>(smem, f32g::Operand{p.a, p.K, p.M, 0}, f32g::Operand{p.w, p.w_ld, p.N, p.w_vec},
                                       m0, n0, 0, p.K, acc, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + t.row(i);
    if (r >= p.M) continue;
    const float sc = EPI == EPI_RESID && p.s != nullptr ? round_to<T>(p.s[r / p.hw]) : 1.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + f32g::col<TN>(t.tx, j);
      if (c >= p.N) continue;
      const long long o = static_cast<long long>(r) * p.N + c;
      float v = round_to<T>(acc[i][j]);
      if (EPI != EPI_ROUND) v = round_to<T>(v + p.bias[c]);
      if (EPI == EPI_RESID) {
        if (p.s != nullptr) v = round_to<T>(__fmul_rn(v, sc));
        v = round_to<T>(p.resid[o] + v);
      }
      p.out[o] = v;
    }
  }
}

// (3), (10): the attention core of one head over the windows.  Block (x,
// h) takes head h of windows x, x + gridDim.x, ...; its 128 threads split
// each query row i in two halves of the keys, thread t taking row t % 64
// and keys [32 hf, 32 hf + 32), hf = t / 64 (as a column, it sums over
// those rows), so that a warp's shared-memory reads are one broadcast or
// 32 consecutive words; the halves meet through shared memory.  A window's
// head slices of q, k, v (and do) come in, and its results go out, through
// shared memory by the whole block, a warp's accesses running along the
// tokens' rows (a thread a row would touch 32 rows an access).  The head's
// bias map sits in shared memory, transposed, for all the block's windows.
// Per window, f32: s = q k^T + bias [-100 between group labels when
// shifted], p32 = exp(s) (1 / sum), p = T(p32).  Forward: att = T(p v).
// Backward, with do the attention output's cotangent: dp = do v^T, ds =
// p32 (dp - rowsum(dp p32)), dv = T(p^T do), dq = T(T(ds) k), dk =
// T(T(ds)^T q), and the bias map's gradient, the sum of ds over the
// block's windows, in shared memory, added to dbias once a block.  DP: the
// head's channels rounded up to 16 or 32.
constexpr int ATT_THREADS = 2 * NT;
constexpr int HALF = NT / 2;  // keys (or rows) of a thread

struct AttnArgs {
  const float *qkv, *bias, *dout;  // dout: the backward's cotangent (M, C)
  float *out, *dbias;              // forward: att (M, C); backward: dqkv (M, 3C)
  Geo g;
};

// Shared memory (floats) of the forward: q (then the outputs), k, v; the
// bias map; the halves' row sums; and of the backward: q, k, v, do (then
// dk, dv, dq); p, then T(ds); the bias-map sums; the bias map; two
// partial-sum tiles; two pairs of row sums.  Both end with the window's
// token rows (long long) and group labels (int).
template <int DP> struct AttnSmem {
  static constexpr int FWD = 3 * NT * DP + NT * NT + 2 * NT;
  static constexpr int BWD = 4 * NT * DP + 2 * NT * (NT + 1) + NT * NT + 2 * NT * DP + 4 * NT;
  static constexpr int TOKENS = NT * (8 + 4);
  static constexpr int BWD_BYTES = BWD * 4 + TOKENS;
};

template <int DP> __device__ __forceinline__ void get_row(const float* src, float (&r)[DP]) {
#pragma unroll
  for (int q = 0; q < DP / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    r[4 * q] = v.x, r[4 * q + 1] = v.y, r[4 * q + 2] = v.z, r[4 * q + 3] = v.w;
  }
}
template <int DP> __device__ __forceinline__ void put_row(float* dst, const float (&r)[DP]) {
#pragma unroll
  for (int q = 0; q < DP / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}
template <int DP> __device__ __forceinline__ void add_row(float (&r)[DP], const float* src) {
#pragma unroll
  for (int q = 0; q < DP / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    r[4 * q] += v.x, r[4 * q + 1] += v.y, r[4 * q + 2] += v.z, r[4 * q + 3] += v.w;
  }
}
// a . row, in four partial sums
template <int DP> __device__ __forceinline__ float dot_row(const float (&a)[DP], const float* row) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < DP / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    s[0] = fmaf(a[4 * q], v.x, s[0]);
    s[1] = fmaf(a[4 * q + 1], v.y, s[1]);
    s[2] = fmaf(a[4 * q + 2], v.z, s[2]);
    s[3] = fmaf(a[4 * q + 3], v.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}
template <int DP> __device__ __forceinline__ void axpy_row(float (&acc)[DP], float a, const float* row) {
#pragma unroll
  for (int q = 0; q < DP / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    acc[4 * q] = fmaf(a, v.x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(a, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a, v.w, acc[4 * q + 3]);
  }
}
// r rounded to T
template <typename T, int DP> __device__ __forceinline__ void round_row(float (&r)[DP]) {
#pragma unroll
  for (int dd = 0; dd < DP; ++dd) r[dd] = round_to<T>(r[dd]);
}
template <int DP> __device__ __forceinline__ void zero_row(float (&r)[DP]) {
#pragma unroll
  for (int dd = 0; dd < DP; ++dd) r[dd] = 0.f;
}

// The head's (n, n) bias map into bt, transposed (bt[j * NT + i])
__device__ __forceinline__ void load_bias_t(const float* __restrict__ bias_h, int n, float* bt) {
  for (int e = threadIdx.x; e < n * n; e += ATT_THREADS) {
    const int j = e / n, i = e % n;
    bt[j * NT + i] = bias_h[i * n + j];
  }
}

// The canonical rows and group labels of window win's tokens into rows,
// labs (thread t < n: token t), then a barrier.
__device__ __forceinline__ void window_rows(const Geo& g, int win, int n, long long* rows, int* labs) {
  if (threadIdx.x < n) token_at(g, win, threadIdx.x, rows[threadIdx.x], labs[threadIdx.x]);
  __syncthreads();
}

// Copies between a window's rows (row stride ld floats, the head's d
// channels at column col0 + part * part_ld) and `parts` [NT][DP] tiles at
// tile[part]: consecutive threads take consecutive channels of a row, and
// a thread issues eight loads before it stores any.  LOAD: global ->
// shared (zeros past n and d); else shared -> global (rounded already).
template <bool LOAD, int DP, int PARTS>
__device__ __forceinline__ void window_copy(float* const (&tile)[PARTS], const float* src, float* dst,
                                            const long long* rows, int n, int d, long long ld, int col0,
                                            int part_ld) {
  constexpr int ITER = NT * PARTS * DP / ATT_THREADS, UNROLL = 8;
  static_assert(ITER % UNROLL == 0, "whole runs of eight copies a thread");
#pragma unroll 1
  for (int it = 0; it < ITER; it += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = threadIdx.x + (it + u) * ATT_THREADS;
      const int t = e / (PARTS * DP), rest = e - t * PARTS * DP, part = rest / DP, dd = rest - part * DP;
      const bool ok = t < n && dd < d;
      const long long at = ok ? rows[t] * ld + col0 + part * part_ld + dd : 0;
      if (LOAD)
        v[u] = ok ? src[at] : 0.f;
      else if (ok)
        dst[at] = tile[part][t * DP + dd];
    }
    if (LOAD) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = threadIdx.x + (it + u) * ATT_THREADS;
        const int t = e / (PARTS * DP), rest = e - t * PARTS * DP, part = rest / DP;
        tile[part][e - t * PARTS * DP - part * DP + t * DP] = v[u];
      }
    }
  }
}

// exp(s) of row i over the thread's keys j = j0 + jj (zeros past n), and
// their sum: q in registers, k rows in ks (stride DP)
template <int DP>
__device__ __forceinline__ float exp_scores(const float (&q)[DP], const float* ks, const float* bt, const int* labs,
                                           int lab, int i, int j0, int n, bool shifted, float (&pr)[HALF]) {
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < HALF; ++jj) {
    const int j = j0 + jj;
    pr[jj] = 0.f;
    if (j < n) {
      float v = __fadd_rn(dot_row(q, ks + j * DP), bt[j * NT + i]);
      if (shifted && labs[j] != lab) v = __fadd_rn(v, NEG);
      pr[jj] = expf(v);
      sum += pr[jj];
    }
  }
  return sum;
}

template <typename T, int DP>
__global__ void __launch_bounds__(ATT_THREADS) swin_f32_attn_fwd_kernel(const AttnArgs p) {
  using S = AttnSmem<DP>;
  __shared__ __align__(16) float smem[S::FWD];
  __shared__ long long rows[NT];
  __shared__ int labs[NT];
  float* qs = smem;  // q, then the outputs
  float* ks = qs + NT * DP;
  float* vs = ks + NT * DP;
  float* bt = vs + NT * DP;
  float* red = bt + NT * NT;
  float* const qkv_tiles[3] = {qs, ks, vs};
  float* const out_tile[1] = {qs};
  const Geo& g = p.g;
  const int n = g.ws * g.ws, C = g.C, d = C / g.heads, h = blockIdx.y, nwin = windows(g);
  const int i = threadIdx.x % NT, hf = threadIdx.x / NT, j0 = hf * HALF;
  load_bias_t(p.bias + static_cast<size_t>(h) * n * n, n, bt);
  for (int win = blockIdx.x; win < nwin; win += gridDim.x) {
    window_rows(g, win, n, rows, labs);
    window_copy<true, DP, 3>(qkv_tiles, p.qkv, nullptr, rows, n, d, 3LL * C, h * d, C);
    __syncthreads();
    float q[DP], r[DP], pr[HALF];
    if (i < n) {
      get_row(qs + i * DP, q);
      red[hf * NT + i] = exp_scores(q, ks, bt, labs, labs[i], i, j0, n, g.shift > 0, pr);
    }
    __syncthreads();  // the row sums are in; q is read
    if (i < n) {
      const float inv = __fdiv_rn(1.f, red[i] + red[NT + i]);
      zero_row(r);
#pragma unroll
      for (int jj = 0; jj < HALF; ++jj)
        if (j0 + jj < n) axpy_row(r, round_to<T>(__fmul_rn(pr[jj], inv)), vs + (j0 + jj) * DP);
      if (hf == 1) put_row(qs + i * DP, r);
    }
    __syncthreads();
    if (i < n && hf == 0) {
      add_row(r, qs + i * DP);
      round_row<T>(r);
      put_row(qs + i * DP, r);
    }
    __syncthreads();
    window_copy<false, DP, 1>(out_tile, nullptr, p.out, rows, n, d, C, h * d, 0);
    __syncthreads();  // rows, labs and the tiles are free for the next window
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(ATT_THREADS) swin_f32_attn_bwd_kernel(const AttnArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + NT * DP;  // k, then dk
  float* vs = ks + NT * DP;  // v, then dv
  float* dos = vs + NT * DP;  // do, then dq
  float* buf = dos + NT * DP;  // [NT][NT + 1]: p, then T(ds)
  float* db = buf + NT * (NT + 1);
  float* bt = db + NT * (NT + 1);
  float* xa = bt + NT * NT;  // the second half's partial dv, then dk
  float* xb = xa + NT * DP;  // and dq
  float* red = xb + NT * DP;  // the halves' sums of exp(s), then of dp p32
  long long* rows = reinterpret_cast<long long*>(red + 4 * NT);
  int* labs = reinterpret_cast<int*>(rows + NT);
  // the results leave from the tiles whose inputs are spent: dq from dos,
  // dk from ks, dv from vs
  float* const in_tiles[3] = {qs, ks, vs};
  float* const out_tiles[3] = {dos, ks, vs};
  float* const do_tile[1] = {dos};
  const Geo& g = p.g;
  const int n = g.ws * g.ws, C = g.C, d = C / g.heads, h = blockIdx.y, nwin = windows(g);
  const int i = threadIdx.x % NT, hf = threadIdx.x / NT, j0 = hf * HALF;
  load_bias_t(p.bias + static_cast<size_t>(h) * n * n, n, bt);
  float* dbi = db + i * (NT + 1) + j0;  // this thread's bias-map sums
#pragma unroll
  for (int jj = 0; jj < HALF; ++jj) dbi[jj] = 0.f;
  for (int win = blockIdx.x; win < nwin; win += gridDim.x) {
    window_rows(g, win, n, rows, labs);
    window_copy<true, DP, 3>(in_tiles, p.qkv, nullptr, rows, n, d, 3LL * C, h * d, C);
    window_copy<true, DP, 1>(do_tile, p.dout, nullptr, rows, n, d, C, h * d, 0);
    __syncthreads();
    float q[DP], dout[DP], r[DP], pr[HALF], dp[HALF];
    if (i < n) {
      get_row(qs + i * DP, q);
      get_row(dos + i * DP, dout);
      red[hf * NT + i] = exp_scores(q, ks, bt, labs, labs[i], i, j0, n, g.shift > 0, pr);
    }
    __syncthreads();
    if (i < n) {  // row i: p32, dp, the half's sum of dp p32, p
      const float inv = __fdiv_rn(1.f, red[i] + red[NT + i]);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < HALF; ++jj) {
        pr[jj] = __fmul_rn(pr[jj], inv);
        dp[jj] = 0.f;
        if (j0 + jj < n) {
          dp[jj] = dot_row(dout, vs + (j0 + jj) * DP);
          rs += __fmul_rn(dp[jj], pr[jj]);
          buf[i * (NT + 1) + j0 + jj] = round_to<T>(pr[jj]);
        }
      }
      red[(2 + hf) * NT + i] = rs;
    }
    __syncthreads();
    if (i < n) {  // column i over the half's rows: dv = T(p^T do)
      zero_row(r);
      for (int k = j0; k < min(n, j0 + HALF); ++k) axpy_row(r, buf[k * (NT + 1) + i], dos + k * DP);
      if (hf == 1) put_row(xa + i * DP, r);
    }
    __syncthreads();
    if (i < n) {
      if (hf == 0) {  // vs is spent (dp is in registers)
        add_row(r, xa + i * DP);
        round_row<T>(r);
        put_row(vs + i * DP, r);
      }
      // row i over the half's keys: ds, its bias-map sums, T(ds), dq = T(T(ds) k)
      const float rs = red[2 * NT + i] + red[3 * NT + i];
      zero_row(r);
#pragma unroll
      for (int jj = 0; jj < HALF; ++jj)
        if (j0 + jj < n) {
          const int j = j0 + jj;
          const float ds = __fmul_rn(pr[jj], __fsub_rn(dp[jj], rs));
          dbi[jj] += ds;
          const float dsc = round_to<T>(ds);
          buf[i * (NT + 1) + j] = dsc;
          axpy_row(r, dsc, ks + j * DP);
        }
      if (hf == 1) put_row(xb + i * DP, r);
    }
    __syncthreads();
    if (i < n) {
      if (hf == 0) {  // dos is spent
        add_row(r, xb + i * DP);
        round_row<T>(r);
        put_row(dos + i * DP, r);
      }
      // column i over the half's rows: dk = T(T(ds)^T q)
      zero_row(r);
      for (int k = j0; k < min(n, j0 + HALF); ++k) axpy_row(r, buf[k * (NT + 1) + i], qs + k * DP);
      if (hf == 1) put_row(xa + i * DP, r);
    }
    __syncthreads();
    if (i < n && hf == 0) {  // ks is spent
      add_row(r, xa + i * DP);
      round_row<T>(r);
      put_row(ks + i * DP, r);
    }
    __syncthreads();
    window_copy<false, DP, 3>(out_tiles, nullptr, p.out, rows, n, d, 3LL * C, h * d, C);
    __syncthreads();  // rows, labs and the tiles are free for the next window
  }
  for (int e = threadIdx.x; e < n * n; e += ATT_THREADS)
    atomicAdd(p.dbias + static_cast<size_t>(h) * n * n + e, db[(e / n) * (NT + 1) + e % n]);
}

// (6): the MLP rows, blockmath.cuh:mlp_rows_tile with I = hidden and G = C
template <typename T, int BN>
__global__ void __launch_bounds__(f32g::THREADS, 2) swin_f32_mlp_kernel(const MlpRowsArgs p) {
  mlp_rows_tile<T, BN>(p);
}

// (8), (12): the LayerNorm backward of the rows, dh already T-rounded: per
// row m1 = mean(dh gamma), m2 = mean(dh gamma xhat); out = T(res + T(rstd
// (dh gamma - m1 - xhat m2))), and T(out s[b]) into out2 where s and out2
// are not null; dgamma, dbeta, the column sums of out (or out2) into osum
// (when not null), and those of the (M, ew) rows `extra` into esum (when
// not null).
struct LnBwdArgs {
  const float *src, *mu, *rstd, *gamma, *dh, *res, *s, *extra;
  float *out, *out2, *dgamma, *dbeta, *osum, *esum;
  int M, C, hw, ew;
};

template <typename T>
__global__ void __launch_bounds__(f32g::THREADS) swin_f32_ln_bwd_kernel(const LnBwdArgs p) {
  __shared__ float row_mu[LN_ROWS], row_rstd[LN_ROWS], row_m1[LN_ROWS], row_m2[LN_ROWS], row_s[LN_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = blockIdx.x * LN_ROWS, C = p.C;
  const int rows = min(LN_ROWS, p.M - row0);
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r >= rows) break;
    const long long o = static_cast<long long>(row0 + r) * C;
    const float m = p.mu[row0 + r], rs = p.rstd[row0 + r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = __fmul_rn(__fsub_rn(p.src[o + c], m), rs);
      const float dxhat = __fmul_rn(p.dh[o + c], p.gamma[c]);
      s1 += dxhat;
      s2 = fmaf(dxhat, xhat, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      row_mu[r] = m;
      row_rstd[r] = rs;
      row_m1[r] = __fdiv_rn(s1, (float)C);
      row_m2[r] = __fdiv_rn(s2, (float)C);
      row_s[r] = p.s != nullptr ? round_to<T>(p.s[(row0 + r) / p.hw]) : 1.f;
    }
  }
  __syncthreads();
  column_runs(C, rows, [&](int c, int r0, int r1) {
    const float gf = p.gamma[c];
    float dg = 0.f, db = 0.f, os = 0.f;
    for (int r = r0; r < r1; ++r) {
      const long long o = static_cast<long long>(row0 + r) * C + c;
      const float xhat = __fmul_rn(__fsub_rn(p.src[o], row_mu[r]), row_rstd[r]);
      const float dh = p.dh[o];
      dg = fmaf(dh, xhat, dg);
      db += dh;
      const float dxhat = __fmul_rn(dh, gf);
      const float dl =
          round_to<T>(__fmul_rn(row_rstd[r], __fsub_rn(__fsub_rn(dxhat, row_m1[r]), __fmul_rn(xhat, row_m2[r]))));
      float v = round_to<T>(p.res[o] + dl);
      p.out[o] = v;
      if (p.out2 != nullptr) {
        v = round_to<T>(__fmul_rn(v, row_s[r]));
        p.out2[o] = v;
      }
      os += v;
    }
    atomicAdd(p.dgamma + c, dg);
    atomicAdd(p.dbeta + c, db);
    if (p.osum != nullptr) atomicAdd(p.osum + c, os);
  });
  if (p.extra == nullptr) return;
  column_runs(p.ew, rows, [&](int c, int r0, int r1) {
    float sum = 0.f;
    for (int r = r0; r < r1; ++r) sum += p.extra[static_cast<long long>(row0 + r) * p.ew + c];
    atomicAdd(p.esum + c, sum);
  });
}

// (13): dWqkv = LN1(x)^T dqkv, dWp = att^T gproj, dW1 = LN2(y)^T dz1, dW2 =
// GELU(z1)^T gmlp (K = M, both operands K-major): f32g::gemm_jobs_kernel.

// ------------------------------------------------------- window attention

template <typename T>
__global__ void __launch_bounds__(THREADS)
swin_winattn_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
                    T* __restrict__ out, int H, int W, int C, int heads, int wh, int ww, int nmask, float scale) {
  __shared__ __align__(16) float qT[DMAX * NT];
  __shared__ __align__(16) float kT[DMAX * NT];
  __shared__ __align__(16) float vT[DMAX * NT];
  __shared__ __align__(16) float pT[NT * NT];
  __shared__ long long tok[NT];
  const int n = wh * ww, d = C / heads, win = blockIdx.x;
  const int nwx = W / ww, nwy = H / wh;
  const int b = win / (nwy * nwx), wy = (win / nwx) % nwy, wx = win % nwx;
  for (int t = threadIdx.x; t < NT; t += THREADS)
    tok[t] = t < n ? ((long long)b * H + wy * wh + t / ww) * W + wx * ww + t % ww : -1;
  const float* mask_w = mask == nullptr ? nullptr : mask + (size_t)(win % nmask) * n * n;
  __syncthreads();
  for (int h = 0; h < heads; ++h) {
    for (int e = threadIdx.x; e < 3 * d * NT; e += THREADS) {
      const int t = e & (NT - 1), r = e >> 6, part = r / d, dd = r % d;
      const float v = t < n ? to_f32(qkv[tok[t] * 3 * C + part * C + h * d + dd]) : 0.f;
      (part == 0 ? qT : part == 1 ? kT : vT)[dd * NT + t] = v;
    }
    __syncthreads();
    float p[4][4];
    head_probs<true, true>(qT, kT, d, n, bias + (size_t)h * n * n, nullptr, mask_w, scale, p);
    store_tile_t<T>(pT, p);
    __syncthreads();
    float o[4][2];
    prod_kd(pT, vT, d, n, o);
    const int ig = threadIdx.x & 15, dg = threadIdx.x >> 4;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = 4 * ig + ii, dd = dg + 16 * q;
        if (row < n && dd < d) out[tok[row] * C + h * d + dd] = from_f32<T>(o[ii][q]);
      }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- host

template <typename Kernel> int opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

bool valid_geo(const Geo& g) {
  return g.B > 0 && g.ws > 0 && g.ws * g.ws <= NT && g.H > 0 && g.W > 0 && g.H % g.ws == 0 &&
         g.W % g.ws == 0 && g.heads > 0 && g.C > 0 && g.C % g.heads == 0 && g.C / g.heads <= DMAX &&
         g.hidden > 0 && g.shift >= 0 && g.shift < g.ws && fwd_smem(g.C, g.hidden) <= SMEM_MAX &&
         static_cast<long long>(g.B) * g.H * g.W < (1ll << 31);
}

template <typename T> const T* cp(void* const* p, int i) { return static_cast<const T*>(p[i]); }

template <typename T>
int launch_fwd(void* const* p, const Geo& g, float eps, cudaStream_t stream) {
  FwdArgs<T> a{cp<T>(p, 0), static_cast<T*>(p[1]),
               cp<T>(p, 2), cp<T>(p, 3), cp<T>(p, 4), cp<T>(p, 5), cp<T>(p, 6), cp<T>(p, 7),
               cp<T>(p, 8), cp<T>(p, 9), cp<T>(p, 10), cp<T>(p, 11), cp<T>(p, 12), cp<T>(p, 13),
               cp<float>(p, 14), cp<float>(p, 15), cp<float>(p, 16), g, eps};
  const size_t bytes = fwd_smem(g.C, g.hidden);
  if (int err = opt_in(swin_fwd_kernel<T>, bytes)) return err;
  swin_fwd_kernel<T><<<windows(g), THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core backward's tiling (ops/swinblock.py:f32_plan), in the order
// of the int array swin_block_bwd takes: the column tile (128 or 64) of the
// token products qkv, proj, the MLP rows, dh2, datt, dh1; the attention
// kernels' blocks a head, forward and backward; the weight-gradient
// launch's column tiles and K shares (multiples of 16) of dWqkv, dWp, dW1,
// dW2.
enum { T_QKV, T_PROJ, T_MLP, T_DH2, T_DATT, T_DH1, T_ATT_FWD, T_ATT_BWD, T_JOB_BN, T_JOB_KPS = T_JOB_BN + 4, T_COUNT = T_JOB_KPS + 4 };

struct F32Bwd {
  const float *x, *g, *w[12], *bias, *s1, *s2;
  float *dx, *h1, *qkv, *att, *y, *h2, *gmlp, *zg, *dz1, *dh, *dy1, *gproj, *dqkv, *stats, *grad[13];
  Geo geo;
  int tiling[T_COUNT];
  float eps;
};
enum { LN1_S, LN1_B, WQKV, BQKV, WP, BP, LN2_S, LN2_B, W1, B1, W2, B2 };

template <typename T, int BN, bool KB, int EPI>
int launch_tok_bn(const TokArgs& p, cudaStream_t s) {
  static int raised = 0;
  constexpr int bytes = f32g::gemm_smem_bytes<BN, TOK_STAGES>();
  if (int err = f32g::opt_in(swin_f32_tok_kernel<T, BN, KB, EPI>, bytes, raised)) return err;
  const dim3 grid((p.M + f32g::BM - 1) / f32g::BM, (p.N + BN - 1) / BN);
  swin_f32_tok_kernel<T, BN, KB, EPI><<<grid, f32g::THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = a (M, K) W, W (K, N) as it lies (KB: W is (N, K), its
// transpose taken)
template <typename T, bool KB, int EPI>
int launch_tok(int bn, const float* a, const float* w, float* out, int m, int k, int n, const float* bias,
               const float* resid, const float* sc, int hw, cudaStream_t s) {
  const TokArgs p{a, w, bias, resid, sc, out, m, k, n, hw, KB ? k : n, f32g::operand(w, n, n, KB).vec};
  return bn == 128 ? launch_tok_bn<T, 128, KB, EPI>(p, s) : launch_tok_bn<T, 64, KB, EPI>(p, s);
}

template <typename T, int DP> int launch_attn(const F32Bwd& a, bool bwd, cudaStream_t s) {
  const AttnArgs p{a.qkv, a.bias, a.dh, bwd ? a.dqkv : a.att, a.grad[12], a.geo};
  const dim3 grid(a.tiling[bwd ? T_ATT_BWD : T_ATT_FWD], a.geo.heads);
  if (!bwd) {
    swin_f32_attn_fwd_kernel<T, DP><<<grid, ATT_THREADS, 0, s>>>(p);
  } else {
    static int raised = 0;
    constexpr int bytes = AttnSmem<DP>::BWD_BYTES;
    if (int err = f32g::opt_in(swin_f32_attn_bwd_kernel<T, DP>, bytes, raised)) return err;
    swin_f32_attn_bwd_kernel<T, DP><<<grid, ATT_THREADS, bytes, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T> int launch_attn(const F32Bwd& a, bool bwd, cudaStream_t s) {
  return a.geo.C / a.geo.heads <= 16 ? launch_attn<T, 16>(a, bwd, s) : launch_attn<T, 32>(a, bwd, s);
}

template <typename T, int BN> int launch_mlp(const F32Bwd& a, const float* gm, cudaStream_t s) {
  static int raised = 0;
  constexpr int bytes = MlpRowsSmem<BN>::BYTES;
  if (int err = f32g::opt_in(swin_f32_mlp_kernel<T, BN>, bytes, raised)) return err;
  const int m = a.geo.B * a.geo.H * a.geo.W, c = a.geo.C, hid = a.geo.hidden;
  const MlpRowsArgs p{a.h2, a.w[W1], a.w[B1], gm, a.w[W2], a.zg, a.dz1, nullptr, a.grad[B1], m, c, hid, c,
                      f32g::operand(a.w[W1], hid, hid, false).vec, 0};
  const dim3 grid((m + f32g::BM - 1) / f32g::BM, (hid + BN - 1) / BN);
  swin_f32_mlp_kernel<T, BN><<<grid, f32g::THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The thirteen launches, in the order of ops/swinblock.py:f32_plan's
// "launches".
template <typename T> int launch_bwd(const F32Bwd& a, cudaStream_t s) {
  const Geo& g = a.geo;
  const int m = g.B * g.H * g.W, c = g.C, hid = g.hidden, hw = g.H * g.W, lnb = (m + LN_ROWS - 1) / LN_ROWS;
  const int* t = a.tiling;
  float *mu1 = a.stats, *rstd1 = mu1 + m, *mu2 = rstd1 + m, *rstd2 = mu2 + m;
  const float* gm = a.s2 != nullptr ? a.gmlp : a.g;      // T(g s2)
  const float* gp = a.s1 != nullptr ? a.gproj : a.dy1;  // T(dy1 s1)
  int err = 0;
  auto step = [&](int e) {
    if (!err) err = e ? e : static_cast<int>(cudaGetLastError());
  };
  // the forward again
  swin_f32_ln_kernel<T><<<lnb, f32g::THREADS, 0, s>>>(
      LnArgs{a.x, a.w[LN1_S], a.w[LN1_B], nullptr, nullptr, a.h1, mu1, rstd1, nullptr, nullptr, m, c, hw, a.eps});
  step(0);
  if (!err) step(launch_tok<T, false, EPI_BIAS>(t[T_QKV], a.h1, a.w[WQKV], a.qkv, m, c, 3 * c, a.w[BQKV], nullptr,
                                                nullptr, hw, s));
  if (!err) step(launch_attn<T>(a, false, s));
  if (!err) step(launch_tok<T, false, EPI_RESID>(t[T_PROJ], a.att, a.w[WP], a.y, m, c, c, a.w[BP], a.x, a.s1, hw, s));
  if (!err) {
    swin_f32_ln_kernel<T><<<lnb, f32g::THREADS, 0, s>>>(LnArgs{a.y, a.w[LN2_S], a.w[LN2_B], a.g, a.s2, a.h2, mu2,
                                                               rstd2, a.s2 != nullptr ? a.gmlp : nullptr,
                                                               a.grad[B2], m, c, hw, a.eps});
    step(0);
  }
  // the chain back
  if (!err) step(t[T_MLP] == 128 ? launch_mlp<T, 128>(a, gm, s) : launch_mlp<T, 64>(a, gm, s));
  if (!err) step(launch_tok<T, true, EPI_ROUND>(t[T_DH2], a.dz1, a.w[W1], a.dh, m, hid, c, nullptr, nullptr, nullptr,
                                                hw, s));
  if (!err) {
    swin_f32_ln_bwd_kernel<T><<<lnb, f32g::THREADS, 0, s>>>(
        LnBwdArgs{a.y, mu2, rstd2, a.w[LN2_S], a.dh, a.g, a.s1, nullptr, a.dy1, a.s1 != nullptr ? a.gproj : nullptr,
                  a.grad[LN2_S], a.grad[LN2_B], a.grad[BP], nullptr, m, c, hw, 0});
    step(0);
  }
  if (!err) step(launch_tok<T, true, EPI_ROUND>(t[T_DATT], gp, a.w[WP], a.dh, m, c, c, nullptr, nullptr, nullptr, hw,
                                                s));
  if (!err) step(launch_attn<T>(a, true, s));
  if (!err) step(launch_tok<T, true, EPI_ROUND>(t[T_DH1], a.dqkv, a.w[WQKV], a.dh, m, 3 * c, c, nullptr, nullptr,
                                                nullptr, hw, s));
  if (!err) {
    swin_f32_ln_bwd_kernel<T><<<lnb, f32g::THREADS, 0, s>>>(
        LnBwdArgs{a.x, mu1, rstd1, a.w[LN1_S], a.dh, a.dy1, nullptr, a.dqkv, a.dx, nullptr, a.grad[LN1_S],
                  a.grad[LN1_B], nullptr, a.grad[BQKV], m, c, hw, 3 * c});
    step(0);
  }
  if (err) return err;
  // the weight gradients, K = M, both operands K-major
  static int raised = 0;
  using f32g::job;
  using f32g::operand;
  auto dw = [&](int i, const float* x, int xw, const float* y, int yw, float* out) {
    return job(operand(x, xw, xw, false), operand(y, yw, yw, false), out, xw, yw, m, t[T_JOB_BN + i],
               t[T_JOB_KPS + i], false);
  };
  f32g::Jobs p{};
  p.j0 = dw(0, a.h1, c, a.dqkv, 3 * c, a.grad[WQKV]);
  p.j1 = dw(1, a.att, c, gp, c, a.grad[WP]);
  p.j2 = dw(2, a.h2, c, a.dz1, hid, a.grad[W1]);
  p.j3 = dw(3, a.zg, hid, gm, c, a.grad[W2]);
  return f32g::launch_jobs<JOBS_STAGES>(p, raised, s);
}

Geo make_geo(int b, int h, int w, int c, int heads, int ws, int shift, int hidden) {
  return Geo{b, h, w, c, heads, ws, shift, hidden};
}

}  // namespace

// ptrs: x, out, ln1_s, ln1_b, W_qkv (C, 3C), b_qkv, W_proj (C, C), b_proj,
// ln2_s, ln2_b, W_fc1 (C, hidden), b_fc1, W_fc2 (hidden, C), b_fc2 in the
// dtype; the (heads, n, n) bias map, s1 and s2 ((B,) or both null) in f32.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaGetLastError() code
// after the launch (0 on success); the launch goes on `stream` and does not
// synchronise.
extern "C" int swin_block_fwd(void* const* ptrs, int b, int h, int w, int c, int heads, int ws, int shift,
                              int hidden, int dtype, float eps, void* stream) {
  const Geo g = make_geo(b, h, w, c, heads, ws, shift, hidden);
  if (!valid_geo(g) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fwd<float>(ptrs, g, eps, s) : launch_fwd<__nv_bfloat16>(ptrs, g, eps, s);
}

// The CUDA-core backward, thirteen launches.  Every tensor is f32 (a
// bfloat16 caller's converted, exactly); dtype (0 = float32, 1 = bfloat16)
// is the type whose rounding the results keep.  ptrs: x, g (the output's
// cotangent), dx, the 12 parameters as for swin_block_fwd (the weights read
// as they lie), the bias map, s1, s2 ((B,) or both null); scratch of M = B
// H W rows: LN1(x) C, qkv 3C, att C, y C, LN2(y) C, gmlp = T(g s2) C (null
// without s2), GELU(z1) hidden, dz1 hidden, dh C (dh2, then datt, then dh1),
// dy1 C, gproj = T(dy1 s1) C (null without s1), dqkv 3C wide, the row
// statistics 4 M; then the 13 f32 gradients (ln1_s, ln1_b, W_qkv, b_qkv,
// W_proj, b_proj, ln2_s, ln2_b, W_fc1, b_fc1, W_fc2, b_fc2, bias map),
// zeroed before the call.  tiling: T_COUNT ints (ops/swinblock.py:f32_plan).
// Returns the first nonzero cudaGetLastError() code (0 on success).
extern "C" int swin_block_bwd(void* const* ptrs, const int* tiling, int b, int h, int w, int c, int heads, int ws,
                              int shift, int hidden, int dtype, float eps, void* stream) {
  const Geo g = make_geo(b, h, w, c, heads, ws, shift, hidden);
  if (!valid_geo(g) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < T_COUNT; ++i) {
    const int v = tiling[i];
    const bool ok = i == T_ATT_FWD || i == T_ATT_BWD ? v > 0 && v <= windows(g)
                    : i >= T_JOB_KPS                ? v > 0 && v % f32g::BK == 0
                                                    : v == 128 || v == 64;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  F32Bwd a{};
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto o = [&](int i) { return static_cast<float*>(ptrs[i]); };
  a.x = f(0);
  a.g = f(1);
  a.dx = o(2);
  for (int i = 0; i < 12; ++i) a.w[i] = f(3 + i);
  a.bias = f(15);
  a.s1 = f(16);
  a.s2 = f(17);
  float** scratch[13] = {&a.h1, &a.qkv, &a.att, &a.y, &a.h2, &a.gmlp, &a.zg, &a.dz1, &a.dh, &a.dy1, &a.gproj,
                         &a.dqkv, &a.stats};
  for (int i = 0; i < 13; ++i) *scratch[i] = o(18 + i);
  for (int i = 0; i < 13; ++i) a.grad[i] = o(31 + i);
  a.geo = g;
  for (int i = 0; i < T_COUNT; ++i) a.tiling[i] = tiling[i];
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<float>(a, s) : launch_bwd<__nv_bfloat16>(a, s);
}

// Window attention on the wh x ww windows of the (B, H, W, 3C) image qkv
// (features q | k | v, heads of C / heads channels); bias (heads, n, n) f32;
// mask (nmask, n, n) f32 or null, window w taking mask[w % nmask]; out (B, H,
// W, C).  dtype as above.
extern "C" int swin_winattn(const void* qkv, const void* bias, const void* mask, void* out, int b, int h, int w,
                            int c, int heads, int wh, int ww, int nmask, int dtype, float scale, void* stream) {
  const int n = wh * ww;
  if (b <= 0 || wh <= 0 || ww <= 0 || n > NT || h % wh || w % ww || heads <= 0 || c % heads ||
      c / heads > DMAX || (mask != nullptr && nmask <= 0) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwin = b * (h / wh) * (w / ww);
  const float* bf = static_cast<const float*>(bias);
  const float* mf = static_cast<const float*>(mask);
  if (dtype == 0)
    swin_winattn_kernel<float><<<nwin, THREADS, 0, s>>>(static_cast<const float*>(qkv), bf, mf,
                                                       static_cast<float*>(out), h, w, c, heads, wh, ww, nmask,
                                                       scale);
  else
    swin_winattn_kernel<__nv_bfloat16><<<nwin, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), bf, mf, static_cast<__nv_bfloat16*>(out), h, w, c, heads, wh, ww,
        nmask, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- the tensor-core route

namespace {

bool valid_tc(int b, int h, int w, int c, int heads, int shift, int hidden, int wg, int nring, int grid, int bwd) {
  const int d = heads > 0 ? c / heads : 0;
  const int nwin = b * (h / 8) * (w / 8);
  return b > 0 && h > 0 && w > 0 && h % 8 == 0 && w % 8 == 0 && static_cast<long long>(b) * h * w < (1ll << 31) &&
         c > 0 && c % 16 == 0 && c <= 192 && heads > 0 &&
         c % heads == 0 && (d == 16 || d == 32) && hidden > 0 && hidden % 16 == 0 && hidden <= 384 && shift >= 0 &&
         shift < 8 && (wg == 1 || wg == 2) && (nring == 2 || nring == 3) && grid > 0 &&
         grid <= (nwin + wg - 1) / wg && swtc::smem_bytes(c, hidden, wg, nring, bwd) <= swtc::SMEM_LIMIT &&
         swtc::slab_count(c, hidden, bwd) <= swtc::MAX_SLABS;
}

swtc::Args tc_args(void* const* p, int b, int h, int w, int c, int heads, int shift, int hidden, int wg, int nring,
                   float eps) {
  swtc::Args a = {};
  a.x = static_cast<const swtc::bf16*>(p[0]);
  a.B = b;
  a.H = h;
  a.W = w;
  a.C = c;
  a.heads = heads;
  a.shift = shift;
  a.hidden = hidden;
  a.nwin = b * (h / 8) * (w / 8);
  a.wg = wg;
  a.ngroups = (a.nwin + wg - 1) / wg;
  a.nring = nring;
  a.eps = eps;
  return a;
}

template <bool BWD>
cudaError_t launch_tc(const swtc::Args& a, int grid, cudaStream_t s) {
  const int bytes = swtc::smem_bytes(a.C, a.hidden, a.wg, a.nring, BWD);
  const int cs = (a.C + 63) / 64, d = a.C / a.heads;
#define SWTC_CASE(CS, D)                                                                              \
  if (cs == CS && d == D)                                                                             \
    return BWD ? swtc::launch_rows<CS, D>(a, grid, bytes, s) : swtc::launch_fwd<CS, D>(a, grid, bytes, s);
  SWTC_CASE(1, 16)
  SWTC_CASE(1, 32)
  SWTC_CASE(2, 16)
  SWTC_CASE(2, 32)
  SWTC_CASE(3, 16)
  SWTC_CASE(3, 32)
#undef SWTC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// bfloat16 on the tensor cores (csrc/swinblock_tc.cuh), one launch.  ptrs
// as for swin_block_fwd (x, out, the 12 parameters in bf16, the f32 bias
// map, s1, s2); 8 x 8 windows; `wg` windows (warpgroups) a block, `nring`
// weight stages, `grid` persistent blocks (ops/swinblock.py:tc_plan).
// Returns the cudaGetLastError() code after the launch (0 on success).
extern "C" int swin_tc_fwd(void* const* ptrs, int b, int h, int w, int c, int heads, int shift, int hidden, int wg,
                           int nring, int grid, float eps, void* stream) {
  if (!valid_tc(b, h, w, c, heads, shift, hidden, wg, nring, grid, 0)) return static_cast<int>(cudaErrorInvalidValue);
  using swtc::bf16;
  swtc::Args a = tc_args(ptrs, b, h, w, c, heads, shift, hidden, wg, nring, eps);
  a.out = static_cast<bf16*>(ptrs[1]);
  const bf16** params[12] = {&a.ln1_s, &a.ln1_b, &a.wqkv, &a.bqkv, &a.wproj, &a.bproj,
                             &a.ln2_s, &a.ln2_b, &a.w1,   &a.b1,   &a.w2,    &a.b2};
  for (int i = 0; i < 12; ++i) *params[i] = static_cast<const bf16*>(ptrs[2 + i]);
  a.bias = static_cast<const float*>(ptrs[14]);
  a.s1 = static_cast<const float*>(ptrs[15]);
  a.s2 = static_cast<const float*>(ptrs[16]);
  return static_cast<int>(launch_tc<false>(a, grid, static_cast<cudaStream_t>(stream)));
}

// bfloat16 on the tensor cores, two launches: the rows kernel (the forward
// again and the chain back per window: dx, the bias map's, the LayerNorms'
// and the biases' gradients) and the weight gradients (rows split in shares
// of `dw_rows`, a multiple of 64).  ptrs: x, g, dx, the 12 parameters, the
// bias map, s1, s2; bf16 scratch of M rows: LN1(x) C, att C, LN2(y) C,
// GELU(z1) hidden, gmlp C, dz1 hidden, gproj C, dqkv 3C wide; then the 13
// f32 gradients as for swin_block_bwd, zeroed before the call.  Returns
// the first nonzero cudaGetLastError() code (0 on success).
extern "C" int swin_tc_bwd(void* const* ptrs, int b, int h, int w, int c, int heads, int shift, int hidden, int wg,
                           int nring, int grid, int dw_rows, float eps, void* stream) {
  if (!valid_tc(b, h, w, c, heads, shift, hidden, wg, nring, grid, 1) || dw_rows <= 0 || dw_rows % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  using swtc::bf16;
  swtc::Args a = tc_args(ptrs, b, h, w, c, heads, shift, hidden, wg, nring, eps);
  a.gout = static_cast<const bf16*>(ptrs[1]);
  a.out = static_cast<bf16*>(ptrs[2]);
  const bf16** params[12] = {&a.ln1_s, &a.ln1_b, &a.wqkv, &a.bqkv, &a.wproj, &a.bproj,
                             &a.ln2_s, &a.ln2_b, &a.w1,   &a.b1,   &a.w2,    &a.b2};
  for (int i = 0; i < 12; ++i) *params[i] = static_cast<const bf16*>(ptrs[3 + i]);
  a.bias = static_cast<const float*>(ptrs[15]);
  a.s1 = static_cast<const float*>(ptrs[16]);
  a.s2 = static_cast<const float*>(ptrs[17]);
  bf16** scratch[8] = {&a.h1s, &a.atts, &a.h2s, &a.zgs, &a.gmlps, &a.dz1s, &a.gprojs, &a.dqkvs};
  for (int i = 0; i < 8; ++i) *scratch[i] = static_cast<bf16*>(ptrs[18 + i]);
  float* grads[13];
  for (int i = 0; i < 13; ++i) grads[i] = static_cast<float*>(ptrs[26 + i]);
  a.dln1_s = grads[0];
  a.dln1_b = grads[1];
  a.dbqkv = grads[3];
  a.dbproj = grads[5];
  a.dln2_s = grads[6];
  a.dln2_b = grads[7];
  a.db1 = grads[9];
  a.db2 = grads[11];
  a.dbias = grads[12];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaError_t err = launch_tc<true>(a, grid, s)) return static_cast<int>(err);
  const int m = a.nwin * 64;
  swtc::DwArgs4 r{{rdtc::dw_job(a.h1s, a.dqkvs, grads[2], c, 3 * c), rdtc::dw_job(a.atts, a.gprojs, grads[4], c, c),
                   rdtc::dw_job(a.h2s, a.dz1s, grads[8], c, hidden), rdtc::dw_job(a.zgs, a.gmlps, grads[10], hidden, c)},
                  m, dw_rows};
  return static_cast<int>(swtc::launch_dw(r, s));
}
