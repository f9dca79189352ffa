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
// Backward, two launches.  (1) One block per window recomputes the forward
// and runs the chain back: gmlp = T(g s2); dz1 = T(T(gmlp W2^T) GELU'(z1));
// dh2 = T(dz1 W1^T); the LN2 backward gives dy1 = T(g + LN2'); gproj =
// T(dy1 s1); datt = T(gproj Wp^T); per head the attention backward (dp =
// datt v^T, ds = p32 (dp - rowsum(dp p32)), dv = T(p^T datt), dq = T(T(ds)
// k), dk = T(T(ds)^T q)); dh1 = T(dqkv Wqkv^T); the LN1 backward, dx = T(dy1
// + LN1').  It writes dx, the rows that the weight gradients need (LN1(x),
// att, LN2(y), GELU(z1), gmlp, dz1, gproj, dqkv) and each window's bias-map
// gradient ds as scratch, and adds the bias and LayerNorm gradients'
// per-window column sums with atomicAdd.  The values it must re-read in
// another thread layout (att, LN2(y), gmlp, dz1, gproj) it reads back from
// that scratch; y waits in dx until dy1 replaces it.  (2) dWqkv = LN1(x)^T
// dqkv, dWp = att^T gproj, dW1 = LN2(y)^T dz1, dW2 = GELU(z1)^T gmlp in 64 x
// 64 tiles with the rows split over blocks, and the bias map's sum over the
// windows, all added with atomicAdd.  The atomics make the order of those
// f32 sums change from run to run.
//
// The window attention: one block per window, one head at a time: q, k, v
// of the head (d <= 32 channels) and its probabilities in shared memory.

#include "blockmath.cuh"
#include "convchain_tc.cuh"
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

// The canonical row (b H + r) W + c of each token t < n of window `win`, read
// at the rolled coordinates, and its group label in the rolled image:
// region 0 / 1 / 2 of rows [0, H - ws), [H - ws, H - shift), [H - shift, H),
// times 3, plus that of the columns (pssr2_tpu/ops/pallas/swinblock.py:_window_group_labels).
__device__ void window_tokens(const Geo& g, int win, long long* tok, int* lab) {
  const int nwx = g.W / g.ws, nwy = g.H / g.ws, n = g.ws * g.ws;
  const int b = win / (nwy * nwx), wy = (win / nwx) % nwy, wx = win % nwx;
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    if (t < n) {
      const int rr = wy * g.ws + t / g.ws, cr = wx * g.ws + t % g.ws;
      const int r = (rr + g.shift) % g.H, c = (cr + g.shift) % g.W;
      tok[t] = ((long long)b * g.H + r) * g.W + c;
      const int lr = rr < g.H - g.ws ? 0 : (rr < g.H - g.shift ? 1 : 2);
      const int lc = cr < g.W - g.ws ? 0 : (cr < g.W - g.shift ? 1 : 2);
      lab[t] = lr * 3 + lc;
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

// h = T((x - mu) (rstd gamma) + beta) into outT (k-major; zeros past n) and,
// when rows is not null, into rows[t * C + c].
template <typename T, typename F>
__device__ void ln_apply(F val, int n, int C, const T* gam, const T* bet, const float* mu,
                         const float* rstd, float* outT, T* rows) {
  for (int e = threadIdx.x; e < NT * C; e += THREADS) {
    const int t = e & (NT - 1), c = e >> 6;
    float h = 0.f;
    if (t < n) {
      const float mul = __fmul_rn(rstd[t], to_f32(gam[c]));
      const T ht = from_f32<T>(__fadd_rn(__fmul_rn(__fsub_rn(val(t, c), mu[t]), mul), to_f32(bet[c])));
      h = to_f32(ht);
      if (rows != nullptr) rows[(long long)t * C + c] = ht;
    }
    if (outT != nullptr) outT[c * NT + t] = h;
  }
  __syncthreads();
}

// ---- products on the 64-token tile

// The XOR swizzle of the streamed A slice: row groups of 4 stay whole.
__device__ __forceinline__ int swz(int k) { return (k & 7) << 2; }

// 64 x N = A (64 x K) B (K x N, row-major in global, T), in 64-column chunks:
// thread (rg, cg) = (tid / 16, tid % 16) holds rows 4rg.. and the chunk's
// columns 4cg..; epi(n0, rg, cg, acc) consumes each chunk.  A is k-major in
// shared memory (a_smem[k * 64 + row]) or, with A_ROWS, row-major in global
// (a_rows[row * K + k], rows past n read as zeros) streamed through `as`.
// B streams through `bs` in 16-row slices, the next slice prefetched.
template <typename T, bool A_ROWS, typename Epi>
__device__ void gemm(const float* a_smem, const T* a_rows, int n, int K, const T* __restrict__ b, int N,
                     float* bs, float* as, Epi epi) {
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float rb[4], ra[4];
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = tid + THREADS * q;
        const int k = k0 + (e >> 6), col = n0 + (e & 63);
        rb[q] = (k < K && col < N) ? to_f32(b[(long long)k * N + col]) : 0.f;
        if (A_ROWS) {
          const int row = e >> 4, ka = k0 + (e & 15);
          ra[q] = (row < n && ka < K) ? to_f32(a_rows[(long long)row * K + ka]) : 0.f;
        }
      }
    };
    load(0);
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // the previous slice is consumed
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = tid + THREADS * q;
        bs[e] = rb[q];
        if (A_ROWS) {
          const int k = e & 15;
          as[k * NT + ((e >> 4) ^ swz(k))] = ra[q];
        }
      }
      __syncthreads();
      if (k0 + KC < K) load(k0 + KC);
      const int kc = min(KC, K - k0);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < kc) {
          const float4 av = A_ROWS ? *reinterpret_cast<const float4*>(as + k * NT + ((4 * rg) ^ swz(k)))
                                   : *reinterpret_cast<const float4*>(a_smem + (k0 + k) * NT + 4 * rg);
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
// dst[j * 64 + i]) or as it is (dst[i * 64 + j]).
template <typename T>
__device__ __forceinline__ void store_tile_t(float* dst, const float (&p)[4][4]) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float v[4] = {round_to<T>(p[0][jj]), round_to<T>(p[1][jj]), round_to<T>(p[2][jj]), round_to<T>(p[3][jj])};
    store4(dst + (4 * cg + jj) * NT + 4 * rg, v);
  }
}
template <typename T>
__device__ __forceinline__ void store_tile(float* dst, const float (&p)[4][4]) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float v[4] = {round_to<T>(p[ii][0]), round_to<T>(p[ii][1]), round_to<T>(p[ii][2]), round_to<T>(p[ii][3])};
    store4(dst + (4 * rg + ii) * NT + 4 * cg, v);
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
      const float bv = bias == nullptr ? 0.f : to_f32(bias[col]);
      float v[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        v[ii] = bias == nullptr ? round_to<T>(acc[ii][jj]) : round_to<T>(round_to<T>(acc[ii][jj]) + bv);
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
  ln_apply<T>(xval, n, C, a.ln1_s, a.ln1_b, mu, rstd, ra, (T*)nullptr);
  gemm<T, false>(ra, (const T*)nullptr, n, C, a.wqkv, 3 * C, bs, nullptr, StoreBiased<T>{r1, a.bqkv, 3 * C});

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
  gemm<T, false>(r1, (const T*)nullptr, n, C, a.wproj, C, bs, nullptr,
                 [&](int n0, int rg, int cg, float (&acc)[4][4]) {
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
  ln_apply<T>(yval, n, C, a.ln2_s, a.ln2_b, mu, rstd, r1, (T*)nullptr);

  // zg = T(GELU(T(T(h2 W1) + b1))) into r1 rows [C, C + hidden)
  gemm<T, false>(r1, (const T*)nullptr, n, C, a.w1, hid, bs, nullptr,
                 [&](int n0, int rg, int cg, float (&acc)[4][4]) {
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
  gemm<T, false>(r1 + C * NT, (const T*)nullptr, n, hid, a.w2, C, bs, nullptr,
                 [&](int n0, int rg, int cg, float (&acc)[4][4]) {
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

// ------------------------------------------------------- backward, windows

template <typename T> struct BwdArgs {
  const T *x, *gout;
  T* dx;  // holds y, then dy1, then dx
  const T *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj, *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
  const float* bias;
  const T *wqkv_t, *wproj_t, *w1_t, *w2_t;  // (3C, C), (C, C), (hidden, C), (C, hidden)
  const float *s1, *s2;
  // scratch rows, window by window (row win * n + t)
  T *h1s, *atts, *h2s, *z1s, *zgs, *gmlps, *dz1s, *gprojs, *dqkvs;
  float* dss;  // (windows, heads * n * n)
  float *dln1_s, *dln1_b, *dwqkv, *dbqkv, *dwproj, *dbproj, *dln2_s, *dln2_b, *dw1, *db1, *dw2, *db2, *dbias;
  Geo g;
  float eps;
};

__host__ __device__ inline size_t bwd_floats(int C) {
  return (size_t)(3 * C + imax(C, NT) + 2 * NT) * NT + 6 * NT;
}
__host__ __device__ inline size_t bwd_smem(int C) {
  return sizeof(float) * bwd_floats(C) + (sizeof(long long) + sizeof(int)) * NT;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) swin_bwd_rows_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const Geo& g = a.g;
  const int C = g.C, hid = g.hidden, n = g.ws * g.ws, d = C / g.heads, lane = threadIdx.x & 31;
  float* r1 = smem;                      // [3C][64]: qkv, then dqkv
  float* ra = r1 + 3 * C * NT;           // [max(C, 64)][64]: h1, y, dh2, datt, dh1
  float* pa = ra + imax(C, NT) * NT;     // [64][64]: p^T, p, ds; the LayerNorm sums
  float* pb = pa + NT * NT;              // [64][64]: ds^T; the product slices
  float* bs = pb;
  float* as = pb + KC * NC;
  float* red = pa;
  float* mu1 = pb + NT * NT;
  float* rstd1 = mu1 + NT;
  float* mu2 = rstd1 + NT;
  float* rstd2 = mu2 + NT;
  float* m1 = rstd2 + NT;
  float* m2 = m1 + NT;
  long long* tok = reinterpret_cast<long long*>(smem + bwd_floats(C));
  int* lab = reinterpret_cast<int*>(tok + NT);
  const int win = blockIdx.x;
  window_tokens(g, win, tok, lab);
  const int b = win / ((g.H / g.ws) * (g.W / g.ws));
  const bool scaled = a.s1 != nullptr;
  const float s1 = scaled ? round_to<T>(a.s1[b]) : 1.f, s2 = scaled ? round_to<T>(a.s2[b]) : 1.f;
  const long long m0 = (long long)win * n;
  T* h1s = a.h1s + m0 * C;
  T* atts = a.atts + m0 * C;
  T* h2s = a.h2s + m0 * C;
  T* z1s = a.z1s + m0 * hid;
  T* zgs = a.zgs + m0 * hid;
  T* gmlps = a.gmlps + m0 * C;
  T* dz1s = a.dz1s + m0 * hid;
  T* gprojs = a.gprojs + m0 * C;
  T* dqkvs = a.dqkvs + m0 * 3 * C;
  auto xval = [&](int t, int c) { return to_f32(a.x[tok[t] * C + c]); };
  auto dxval = [&](int t, int c) { return to_f32(a.dx[tok[t] * C + c]); };
  auto gval = [&](int t, int c) { return to_f32(a.gout[tok[t] * C + c]); };

  // ---- the forward, recomputed
  ln_stats(xval, n, C, a.eps, mu1, rstd1, red);
  ln_apply<T>(xval, n, C, a.ln1_s, a.ln1_b, mu1, rstd1, ra, h1s);
  gemm<T, false>(ra, (const T*)nullptr, n, C, a.wqkv, 3 * C, bs, as, StoreBiased<T>{r1, a.bqkv, 3 * C});
  for (int h = 0; h < g.heads; ++h) {
    float p[4][4];
    head_probs<false, false>(r1 + h * d * NT, r1 + (C + h * d) * NT, d, n, a.bias + (size_t)h * n * n,
                             g.shift ? lab : nullptr, nullptr, 1.f, p);
    store_tile_t<T>(pa, p);
    __syncthreads();
    float o[4][2];
    prod_kd(pa, r1 + (2 * C + h * d) * NT, d, n, o);
    const int ig = threadIdx.x & 15, dg = threadIdx.x >> 4;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = 4 * ig + ii, dd = dg + 16 * q;
        if (row < n && dd < d) atts[(long long)row * C + h * d + dd] = from_f32<T>(o[ii][q]);
      }
    __syncthreads();
  }
  // y = T(x + T(T(T(att Wp) + bp) s1)): k-major into ra, and into dx
  gemm<T, true>(nullptr, atts, n, C, a.wproj, C, bs, as, [&](int n0, int rg, int cg, float (&acc)[4][4]) {
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
        v[ii] = 0.f;
        if (row < n) {
          const T y = from_f32<T>(xval(row, col) + pv);
          a.dx[tok[row] * C + col] = y;
          v[ii] = to_f32(y);
        }
      }
      store4(ra + col * NT + 4 * rg, v);
    }
  });
  auto yval = [&](int t, int c) { return ra[c * NT + t]; };
  ln_stats(yval, n, C, a.eps, mu2, rstd2, red);
  ln_apply<T>(yval, n, C, a.ln2_s, a.ln2_b, mu2, rstd2, nullptr, h2s);
  // z1 = T(T(h2 W1) + b1) and GELU(z1) to scratch
  gemm<T, true>(nullptr, h2s, n, C, a.w1, hid, bs, as, [&](int n0, int rg, int cg, float (&acc)[4][4]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 4 * cg + jj;
      if (col >= hid) continue;
      const float bv = to_f32(a.b1[col]);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = 4 * rg + ii;
        if (row >= n) continue;
        const float z = round_to<T>(round_to<T>(acc[ii][jj]) + bv);
        z1s[(long long)row * hid + col] = from_f32<T>(z);
        zgs[(long long)row * hid + col] = from_f32<T>(gelu<T>(z));
      }
    }
  });

  // ---- the chain back
  // gmlp = T(g s2); db2
  for (int e = threadIdx.x; e < NT * C; e += THREADS) {
    const int t = e & (NT - 1), c = e >> 6;
    float v = 0.f;
    if (t < n) {
      v = gval(t, c);
      if (scaled) v = round_to<T>(__fmul_rn(v, s2));
      gmlps[(long long)t * C + c] = from_f32<T>(v);
    }
    v = warp_sum(v);
    if (lane == 0) atomicAdd(a.db2 + c, v);
  }
  __syncthreads();
  // dz1 = T(T(gmlp W2^T) GELU'(z1)); db1
  gemm<T, true>(nullptr, gmlps, n, C, a.w2_t, hid, bs, as, [&](int n0, int rg, int cg, float (&acc)[4][4]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 4 * cg + jj;
      float cs = 0.f;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = 4 * rg + ii;
        if (row >= n || col >= hid) continue;
        const float z = to_f32(z1s[(long long)row * hid + col]);
        const T dz = from_f32<T>(__fmul_rn(round_to<T>(acc[ii][jj]), dgelu<T>(z)));
        dz1s[(long long)row * hid + col] = dz;
        cs += to_f32(dz);
      }
      cs += __shfl_xor_sync(0xffffffffu, cs, 16);
      if (lane < 16 && col < hid) atomicAdd(a.db1 + col, cs);
    }
  });
  // dh2 = T(dz1 W1^T) into ra
  gemm<T, true>(nullptr, dz1s, n, hid, a.w1_t, C, bs, as, StoreBiased<T>{ra, nullptr, C});
  // LN2 backward with y (in dx): dy1 = T(g + LN2'(dh2)) into dx; gproj =
  // T(dy1 s1); dln2_s, dln2_b, dbproj
  auto xhat2 = [&](int t, int c) { return __fmul_rn(__fsub_rn(dxval(t, c), mu2[t]), rstd2[t]); };
  token_sums([&](int t, int c, float& s, float& s2v) {
    const float dxh = __fmul_rn(ra[c * NT + t], to_f32(a.ln2_s[c]));
    s += dxh;
    s2v = fmaf(dxh, xhat2(t, c), s2v);
  }, n, C, m1, m2, red);
  for (int e = threadIdx.x; e < NT * C; e += THREADS) {
    const int t = e & (NT - 1), c = e >> 6;
    float gp = 0.f, dg = 0.f, db = 0.f;
    if (t < n) {
      const float xh = xhat2(t, c), dh = ra[c * NT + t];
      const float dxh = __fmul_rn(dh, to_f32(a.ln2_s[c]));
      const float mm1 = __fdiv_rn(m1[t], (float)C), mm2 = __fdiv_rn(m2[t], (float)C);
      const float dyln = round_to<T>(__fmul_rn(rstd2[t], __fsub_rn(__fsub_rn(dxh, mm1), __fmul_rn(xh, mm2))));
      const float dy1 = round_to<T>(gval(t, c) + dyln);
      a.dx[tok[t] * C + c] = from_f32<T>(dy1);
      gp = scaled ? round_to<T>(__fmul_rn(dy1, s1)) : dy1;
      gprojs[(long long)t * C + c] = from_f32<T>(gp);
      dg = __fmul_rn(dh, xh);
      db = dh;
    }
    gp = warp_sum(gp);
    dg = warp_sum(dg);
    db = warp_sum(db);
    if (lane == 0) {
      atomicAdd(a.dbproj + c, gp);
      atomicAdd(a.dln2_s + c, dg);
      atomicAdd(a.dln2_b + c, db);
    }
  }
  __syncthreads();
  // datt = T(gproj Wp^T) into ra
  gemm<T, true>(nullptr, gprojs, n, C, a.wproj_t, C, bs, as, StoreBiased<T>{ra, nullptr, C});

  // attention backward, head by head: dq, dk, dv over q, k, v
  for (int h = 0; h < g.heads; ++h) {
    float* qT = r1 + h * d * NT;
    float* kT = r1 + (C + h * d) * NT;
    float* vT = r1 + (2 * C + h * d) * NT;
    const float* doT = ra + h * d * NT;
    float p[4][4], dp[4][4];
    head_probs<false, false>(qT, kT, d, n, a.bias + (size_t)h * n * n, g.shift ? lab : nullptr, nullptr, 1.f, p);
    store_tile<T>(pa, p);  // p as it is: k-major over the queries
    prod_ij(doT, vT, d, dp);
    const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) rs += __fmul_rn(dp[ii][jj], p[ii][jj]);
      rs = half_sum(rs);
      const int i = 4 * rg + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * cg + jj;
        dp[ii][jj] = __fmul_rn(p[ii][jj], __fsub_rn(dp[ii][jj], rs));  // ds
        if (i < n && j < n) a.dss[((size_t)win * g.heads + h) * n * n + i * n + j] = dp[ii][jj];
      }
    }
    __syncthreads();
    float dv[4][2];
    prod_kd(pa, doT, d, n, dv);
    __syncthreads();
    store_tile<T>(pa, dp);    // ds rounded, k-major over the queries
    store_tile_t<T>(pb, dp);  // and over the keys
    __syncthreads();
    float dq[4][2], dk[4][2];
    prod_kd(pb, kT, d, n, dq);
    prod_kd(pa, qT, d, n, dk);
    __syncthreads();
    store_kd<T>(qT, d, dq);
    store_kd<T>(kT, d, dk);
    store_kd<T>(vT, d, dv);
    __syncthreads();
  }
  // dqkv rows to scratch; dbqkv
  for (int e = threadIdx.x; e < NT * 3 * C; e += THREADS) {
    const int t = e & (NT - 1), c = e >> 6;
    const float v = t < n ? r1[c * NT + t] : 0.f;
    if (t < n) dqkvs[(long long)t * 3 * C + c] = from_f32<T>(v);
    const float s = warp_sum(v);
    if (lane == 0) atomicAdd(a.dbqkv + c, s);
  }
  // dh1 = T(dqkv Wqkv^T) into ra
  gemm<T, false>(r1, (const T*)nullptr, n, 3 * C, a.wqkv_t, C, bs, as, StoreBiased<T>{ra, nullptr, C});
  // LN1 backward: dx = T(dy1 + T(LN1'(dh1))); dln1_s, dln1_b
  auto xhat1 = [&](int t, int c) { return __fmul_rn(__fsub_rn(xval(t, c), mu1[t]), rstd1[t]); };
  token_sums([&](int t, int c, float& s, float& s2v) {
    const float dxh = __fmul_rn(ra[c * NT + t], to_f32(a.ln1_s[c]));
    s += dxh;
    s2v = fmaf(dxh, xhat1(t, c), s2v);
  }, n, C, m1, m2, red);
  for (int e = threadIdx.x; e < NT * C; e += THREADS) {
    const int t = e & (NT - 1), c = e >> 6;
    float dg = 0.f, db = 0.f;
    if (t < n) {
      const float xh = xhat1(t, c), dh = ra[c * NT + t];
      const float dxh = __fmul_rn(dh, to_f32(a.ln1_s[c]));
      const float mm1 = __fdiv_rn(m1[t], (float)C), mm2 = __fdiv_rn(m2[t], (float)C);
      const float dxln = round_to<T>(__fmul_rn(rstd1[t], __fsub_rn(__fsub_rn(dxh, mm1), __fmul_rn(xh, mm2))));
      a.dx[tok[t] * C + c] = from_f32<T>(dxval(t, c) + dxln);
      dg = __fmul_rn(dh, xh);
      db = dh;
    }
    dg = warp_sum(dg);
    db = warp_sum(db);
    if (lane == 0) {
      atomicAdd(a.dln1_s + c, dg);
      atomicAdd(a.dln1_b + c, db);
    }
  }
}

// ------------------------------------------ backward, weight gradients

template <typename T> struct ReduceArgs {
  DwJob<T> job[4];
  const float* ds;  // (windows, nbias)
  float* dbias;
  int M, rows_per_split, windows, wins_per_split, nbias;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) swin_reduce_kernel(const ReduceArgs<T> r) {
  static_assert(THREADS == DW_THREADS, "dw_tile runs on DW_THREADS threads");
  const int tid = threadIdx.x;
  int tile = blockIdx.x, j = 0;
  while (j < 4 && tile >= r.job[j].tiles) tile -= r.job[j++].tiles;
  if (j == 4) {  // the bias map: column sums of ds over this split's windows
    const int col = tile * THREADS + tid;
    const int w0 = blockIdx.y * r.wins_per_split, w1 = min(r.windows, w0 + r.wins_per_split);
    if (col >= r.nbias || w0 >= w1) return;
    float s = 0.f;
    for (int w = w0; w < w1; ++w) s += r.ds[(size_t)w * r.nbias + col];
    atomicAdd(r.dbias + col, s);
    return;
  }
  const int k_begin = blockIdx.y * r.rows_per_split;
  dw_tile(r.job[j], tile, k_begin, min(r.M, k_begin + r.rows_per_split));
}

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
         bwd_smem(g.C) <= SMEM_MAX;
}

int windows(const Geo& g) { return g.B * (g.H / g.ws) * (g.W / g.ws); }

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

template <typename T>
int launch_bwd(void* const* p, const Geo& g, int splits, float eps, cudaStream_t stream) {
  BwdArgs<T> a;
  a.x = cp<T>(p, 0);
  a.gout = cp<T>(p, 1);
  a.dx = static_cast<T*>(p[2]);
  const T** params[12] = {&a.ln1_s, &a.ln1_b, &a.wqkv, &a.bqkv, &a.wproj, &a.bproj,
                          &a.ln2_s, &a.ln2_b, &a.w1,   &a.b1,   &a.w2,    &a.b2};
  for (int i = 0; i < 12; ++i) *params[i] = cp<T>(p, 3 + i);
  a.bias = cp<float>(p, 15);
  a.wqkv_t = cp<T>(p, 16);
  a.wproj_t = cp<T>(p, 17);
  a.w1_t = cp<T>(p, 18);
  a.w2_t = cp<T>(p, 19);
  a.s1 = cp<float>(p, 20);
  a.s2 = cp<float>(p, 21);
  T** scratch[9] = {&a.h1s, &a.atts, &a.h2s, &a.z1s, &a.zgs, &a.gmlps, &a.dz1s, &a.gprojs, &a.dqkvs};
  for (int i = 0; i < 9; ++i) *scratch[i] = static_cast<T*>(p[22 + i]);
  a.dss = static_cast<float*>(p[31]);
  float** grads[13] = {&a.dln1_s, &a.dln1_b, &a.dwqkv, &a.dbqkv, &a.dwproj, &a.dbproj, &a.dln2_s,
                       &a.dln2_b, &a.dw1,    &a.db1,   &a.dw2,   &a.db2,    &a.dbias};
  for (int i = 0; i < 13; ++i) *grads[i] = static_cast<float*>(p[32 + i]);
  a.g = g;
  a.eps = eps;
  const size_t bytes = bwd_smem(g.C);
  if (int err = opt_in(swin_bwd_rows_kernel<T>, bytes)) return err;
  const int nwin = windows(g);
  swin_bwd_rows_kernel<T><<<nwin, THREADS, bytes, stream>>>(a);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  const int C = g.C, hid = g.hidden, n = g.ws * g.ws;
  ReduceArgs<T> r;
  const T* pairs[4][2] = {{a.h1s, a.dqkvs}, {a.atts, a.gprojs}, {a.h2s, a.dz1s}, {a.zgs, a.gmlps}};
  float* outs[4] = {a.dwqkv, a.dwproj, a.dw1, a.dw2};
  const int dims[4][2] = {{C, 3 * C}, {C, C}, {C, hid}, {hid, C}};
  int tiles = 0;
  for (int i = 0; i < 4; ++i) {
    const int tn = (dims[i][1] + DW - 1) / DW;
    r.job[i] = DwJob<T>{pairs[i][0], pairs[i][1], outs[i], dims[i][0], dims[i][1], tn,
                        ((dims[i][0] + DW - 1) / DW) * tn};
    tiles += r.job[i].tiles;
  }
  r.ds = a.dss;
  r.dbias = a.dbias;
  r.M = nwin * n;
  r.rows_per_split = round_up((r.M + splits - 1) / splits, KC);
  r.windows = nwin;
  r.wins_per_split = (nwin + splits - 1) / splits;
  r.nbias = g.heads * n * n;
  const dim3 grid(tiles + (r.nbias + THREADS - 1) / THREADS, splits);
  swin_reduce_kernel<T><<<grid, THREADS, 0, stream>>>(r);
  return static_cast<int>(cudaGetLastError());
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

// Two launches.  ptrs: x, g (the output's cotangent), dx, the 12 parameters
// and the bias map as for swin_block_fwd, W_qkv^T (3C, C), W_proj^T,
// W_fc1^T (hidden, C), W_fc2^T (C, hidden), s1, s2; scratch (M rows, the
// dtype): LN1(x) C, att C, LN2(y) C, z1 hidden, GELU(z1) hidden, gmlp C,
// dz1 hidden, gproj C, dqkv 3C wide; the bias-map scratch (windows, heads n
// n) f32; then the 13 f32 gradients (ln1_s, ln1_b, W_qkv, b_qkv, W_proj,
// b_proj, ln2_s, ln2_b, W_fc1, b_fc1, W_fc2, b_fc2, bias map), zeroed before
// the call.  `splits`: the blocks that share each row reduction.  Returns
// the first nonzero cudaGetLastError() code (0 on success).
extern "C" int swin_block_bwd(void* const* ptrs, int b, int h, int w, int c, int heads, int ws, int shift,
                              int hidden, int dtype, int splits, float eps, void* stream) {
  const Geo g = make_geo(b, h, w, c, heads, ws, shift, hidden);
  if (!valid_geo(g) || (dtype != 0 && dtype != 1) || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<float>(ptrs, g, splits, eps, s)
                    : launch_bwd<__nv_bfloat16>(ptrs, g, splits, eps, s);
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
