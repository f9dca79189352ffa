// The RDNet block tail for Hopper, forward and backward, on flattened rows:
//
//   h   = LN(x)                    f32 statistics, fast variance
//                                  max(0, E[x^2] - mu^2), rounded to T
//   z1  = T(T(h W1) + b1)          f32 accumulation, rounded, bias added in T
//   zg  = T(GELU(z1))              exact (erf rational) for f32, the
//                                  polynomial of swinblock._gelu_fast for bf16
//   out = T(T(zg W2) + b2)
//
// x (M, C), W1 (C, I), W2 (I, G); T is float or bfloat16.  Replaces the TPU
// kernels pssr2_tpu/ops/pallas/rdtail.py:_tail_kernel (forward, reached
// through _pallas_tail) and _tail_bwd_kernel (backward, _pallas_tail_bwd).
//
// What bounds it on an H100 SXM: 2*M*I*(C + G) operations forward and three
// times that backward, against 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s
// (f32 CUDA cores); the bytes are x and the output once each (and, backward,
// the cotangent, dx and the weight gradients) against 3.35 TB/s.  At the
// RDResUNet's shapes (C 128-816, I = 4C, G 64-224) the operations bound it.
//
// Design, simple and right first: the products run on the CUDA cores in
// f32 (bf16 values are exact in f32); no tensor cores, TMA or wgmma yet.
//
// Forward, one launch.  A block owns 32 rows.  It normalises them into
// shared memory (f32 copies of the T values, channel-major), then walks I in
// chunks of 128: z1 for the chunk (256 threads, 4x4 outputs each, W1 in
// slices of 16 rows through shared memory, the next slice prefetched into
// registers), GELU into shared memory, and the chunk's part of zg W2 added
// to the f32 output accumulators (4 rows x up to 8 columns a thread, G <=
// 256).  The I-wide intermediate never leaves the chip.
//
// Backward, two launches.  (1) Rows, 32 a block: the forward recomputed per
// chunk as above, dz = T(g W2^T) for the chunk with the same thread layout,
// dz1 = T(dz * GELU'(z1)) in registers; h, zg and dz1 are written to scratch
// (M x C and M x I, in T) for launch 2; db1 and db2 are per-block column sums
// added with atomicAdd.  Then dh = T(dz1 W1^T) panel by panel (dz1 read back
// from the block's own rows), and the LayerNorm backward on the block's rows:
// dx, and dgamma, dbeta by atomicAdd.  (2) dW1 = h^T dz1 and dW2 = zg^T g in
// one launch: 64x64 tiles of both, the M rows split over grid.y, partial
// tiles added with atomicAdd.  The atomics make the order of those f32 sums
// change from run to run.

#include "blockmath.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 32;   // rows per block (forward, backward rows)
constexpr int KI = 128;  // columns of an I chunk or a C panel
constexpr int KC = 16;   // rows of a streamed operand slice
constexpr int GJ = 8;    // output columns per thread in the fc2 product: G <= 32 * GJ

// ---- LayerNorm of the block's rows into hT[c][r] (f32 copies of the T
// values; zeros for rows past M and channels past C up to cp).  Warp w
// normalises rows 4w..4w+3.  Optionally writes h to global (backward) and
// keeps each row's mean and 1/std.
template <typename T>
__device__ void layernorm_rows(const T* __restrict__ x, const T* __restrict__ lns,
                               const T* __restrict__ lnb, float* hT, T* h_out, float* row_mu,
                               float* row_rstd, int row0, int M, int C, int cp, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    const int row = row0 + r;
    if (row >= M) {
      for (int c = lane; c < cp; c += 32) hT[c * BM + r] = 0.f;
      continue;
    }
    const T* xr = x + (long long)row * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f32(xr[c]);
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = __fdiv_rn(s, (float)C);
    const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mu, mu)));
    const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
    if (row_mu != nullptr && lane == 0) {
      row_mu[r] = mu;
      row_rstd[r] = rstd;
    }
    for (int c = lane; c < cp; c += 32) {
      float hv = 0.f;
      if (c < C) {
        const float mul = __fmul_rn(rstd, to_f32(lns[c]));
        const T ht = from_f32<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_f32(xr[c]), mu), mul), to_f32(lnb[c])));
        hv = to_f32(ht);
        if (h_out != nullptr) h_out[(long long)row * C + c] = ht;
      }
      hT[c * BM + r] = hv;
    }
  }
}

// ---- the 32 x 128 product tile: thread (rg, cg) holds rows 4rg..4rg+3 and
// columns 4cg..4cg+3.  Each warp spans 4 row groups and 8 column groups, so
// its shared-memory reads of a k step are one broadcast float4 of A rows and
// 8 float4 of B columns.
struct TileIdx {
  int rg, cg;
  __device__ TileIdx() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    rg = (warp >> 2) * 4 + (lane >> 3);
    cg = (warp & 3) * 8 + (lane & 7);
  }
};

// acc += a[k][rows] * b[k][cols] over the KC rows of a slice
__device__ __forceinline__ void fma_slice(const float* a, const float* b, float (&acc)[4][4],
                                          const TileIdx& t) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * BM + t.rg * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * KI + t.cg * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// A KC x KI slice of a row-major (kmax x nmax) operand with leading
// dimension ld, rows k0.., columns n0..: 8 values a thread, zeros outside.
template <typename T>
__device__ __forceinline__ void load_b(const T* b, long long ld, int k0, int kmax, int n0, int nmax,
                                       float (&r)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = threadIdx.x + THREADS * q;
    const int k = k0 + e / KI, n = n0 + e % KI;
    r[q] = (k < kmax && n < nmax) ? to_f32(b[k * ld + n]) : 0.f;
  }
}

__device__ __forceinline__ void store_b(float* bs, const float (&r)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) bs[threadIdx.x + THREADS * q] = r[q];
}

// acc = a_full^T-tile x B over kp rows (a multiple of KC): a_full is [kp][BM]
// in shared memory, B is streamed through bs with the next slice prefetched.
template <typename T>
__device__ void gemm_a_smem(const float* a_full, int kp, const T* b, long long ldb, int kmax, int n0,
                            int nmax, float* bs, float (&acc)[4][4], const TileIdx& t) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float r[8];
  load_b(b, ldb, 0, kmax, n0, nmax, r);
  for (int k0 = 0; k0 < kp; k0 += KC) {
    __syncthreads();  // the previous slice is consumed
    store_b(bs, r);
    __syncthreads();
    if (k0 + KC < kp) load_b(b, ldb, k0 + KC, kmax, n0, nmax, r);
    fma_slice(a_full + k0 * BM, bs, acc, t);
  }
}

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(THREADS)
rdtail_fwd_kernel(const T* __restrict__ x, const T* __restrict__ lns, const T* __restrict__ lnb,
                  const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ b2, T* __restrict__ out, int M, int C, int I, int G,
                  float eps) {
  extern __shared__ __align__(16) float smem[];
  const int cp = round_up(C, KC);
  const int gj = (G + 31) / 32, gp = gj * 32;
  float* hT = smem;          // [cp][BM]
  float* bs = hT + cp * BM;  // [KC][KI]
  float* zT = bs + KC * KI;  // [KI][BM]
  float* w2s = zT + KI * BM; // [KC][gp]
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const TileIdx t;

  layernorm_rows<T>(x, lns, lnb, hT, nullptr, nullptr, nullptr, row0, M, C, cp, eps);

  float acc2[4][GJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < GJ; ++j) acc2[i][j] = 0.f;

  for (int n0 = 0; n0 < I; n0 += KI) {
    float acc[4][4];
    gemm_a_smem<T>(hT, cp, w1, I, C, n0, I, bs, acc, t);
    // z1 = T(T(acc) + b1), zg = T(GELU(z1)) into zT[col][row]; zeros past I
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + t.cg * 4 + j;
      const float bias = col < I ? to_f32(b1[col]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float zg = 0.f;
        if (col < I) zg = round_to<T>(gelu<T>(round_to<T>(round_to<T>(acc[i][j]) + bias)));
        zT[(t.cg * 4 + j) * BM + t.rg * 4 + i] = zg;
      }
    }
    // acc2 += zg W2[n0 : n0 + KI, :]; warp w holds rows 4w..4w+3, lane the
    // columns lane + 32 j
    for (int k0 = 0; k0 < KI && n0 + k0 < I; k0 += KC) {
      __syncthreads();  // zT written, or the previous w2s slice consumed
      for (int e = threadIdx.x; e < KC * gp; e += THREADS) {
        const int k = n0 + k0 + e / gp, n = e % gp;
        w2s[e] = (k < I && n < G) ? to_f32(w2[(long long)k * G + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(zT + (k0 + k) * BM + warp * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int j = 0; j < GJ; ++j) {
          if (j < gj) {
            const float bv = w2s[k * gp + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc2[i][j] = fmaf(ar[i], bv, acc2[i][j]);
          }
        }
      }
    }
    __syncthreads();  // zT and w2s are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + warp * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < GJ; ++j) {
      const int col = lane + 32 * j;
      if (j < gj && col < G)
        out[(long long)row * G + col] = from_f32<T>(round_to<T>(acc2[i][j]) + to_f32(b2[col]));
    }
  }
}

// ------------------------------------------------------- backward, rows

template <typename T>
__global__ void __launch_bounds__(THREADS)
rdtail_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ lns,
                       const T* __restrict__ lnb, const T* __restrict__ w1,
                       const T* __restrict__ w1t, const T* __restrict__ b1,
                       const T* __restrict__ w2t, const T* __restrict__ gout,
                       T* __restrict__ h_out, T* __restrict__ zg_out,
                       T* dz1_out,  // read back by this block: no __restrict__
                       T* __restrict__ dx, float* __restrict__ dlns, float* __restrict__ dlnb,
                       float* __restrict__ db1, float* __restrict__ db2, int M, int C, int I,
                       int G, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int cp = round_up(C, KC);
  const int gk = round_up(G, KC);
  const int dh_ld = cp + 1;  // row stride of dh: rows read across lanes
  float* buf = smem;                // hT [cp][BM], then dh [BM][dh_ld]
  float* gT = buf + BM * dh_ld;     // [gk][BM]
  float* bs = gT + gk * BM;         // [KC][KI]
  float* as = bs + KC * KI;         // [KC][BM]
  float* red = as + KC * BM;        // [8][KI]
  float* row_mu = red + 8 * KI;     // [BM] each
  float* row_rstd = row_mu + BM;
  float* row_m1 = row_rstd + BM;
  float* row_m2 = row_m1 + BM;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int tid = threadIdx.x;
  const TileIdx t;

  layernorm_rows<T>(x, lns, lnb, buf, h_out, row_mu, row_rstd, row0, M, C, cp, eps);

  // the cotangent tile, channel-major, zeros past M and G; db2 by column sums
  for (int e = tid; e < gk * BM; e += THREADS) {
    const int r = e / gk, c = e % gk;
    gT[c * BM + r] = (r < rows && c < G) ? to_f32(gout[(long long)(row0 + r) * G + c]) : 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += gT[tid * BM + r];
    atomicAdd(db2 + tid, s);
  }

  for (int n0 = 0; n0 < I; n0 += KI) {
    float acc[4][4], dacc[4][4];
    gemm_a_smem<T>(buf, cp, w1, I, C, n0, I, bs, acc, t);
    gemm_a_smem<T>(gT, gk, w2t, I, G, n0, I, bs, dacc, t);
    float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + t.cg * 4 + j;
      if (col >= I) continue;
      const float bias = to_f32(b1[col]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t.rg * 4 + i;
        if (r >= rows) continue;
        const float z1 = round_to<T>(round_to<T>(acc[i][j]) + bias);
        const T zg = from_f32<T>(gelu<T>(z1));
        const T d1 = from_f32<T>(round_to<T>(dacc[i][j]) * dgelu<T>(z1));
        const long long o = (long long)(row0 + r) * I + col;
        zg_out[o] = zg;
        dz1_out[o] = d1;
        colsum[j] += to_f32(d1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[t.rg * KI + t.cg * 4 + j] = colsum[j];
    __syncthreads();
    if (tid < KI && n0 + tid < I) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) s += red[g * KI + tid];
      atomicAdd(db1 + n0 + tid, s);
    }
  }
  __syncthreads();  // dz1 of the block's rows is written; hT is no longer read

  // dh = T(dz1 W1^T), 128 channels a panel, into buf as [BM][dh_ld]
  for (int p0 = 0; p0 < C; p0 += KI) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < I; k0 += KC) {
      float r[8];
      load_b(w1t, C, k0, I, p0, C, r);
      float av[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = tid + THREADS * q;
        const int kk = e % KC, rr = e / KC;
        av[q] = (rr < rows && k0 + kk < I) ? to_f32(dz1_out[(long long)(row0 + rr) * I + k0 + kk]) : 0.f;
      }
      __syncthreads();
      store_b(bs, r);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = tid + THREADS * q;
        as[(e % KC) * BM + e / KC] = av[q];
      }
      __syncthreads();
      fma_slice(as, bs, acc, t);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + t.cg * 4 + j;
      if (col >= C) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) buf[(t.rg * 4 + i) * dh_ld + col] = round_to<T>(acc[i][j]);
    }
  }
  __syncthreads();

  // LayerNorm backward.  Per row: m1 = mean(dy g), m2 = mean(dy g xhat).
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      if (r >= rows) continue;
      const T* xr = x + (long long)(row0 + r) * C;
      const float mu = row_mu[r], rstd = row_rstd[r];
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xhat = __fmul_rn(__fsub_rn(to_f32(xr[c]), mu), rstd);
        const float dxhat = __fmul_rn(buf[r * dh_ld + c], to_f32(lns[c]));
        s1 += dxhat;
        s2 = fmaf(dxhat, xhat, s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        row_m1[r] = __fdiv_rn(s1, (float)C);
        row_m2[r] = __fdiv_rn(s2, (float)C);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    const float gf = to_f32(lns[c]);
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long long o = (long long)(row0 + r) * C + c;
      const float rstd = row_rstd[r];
      const float xhat = __fmul_rn(__fsub_rn(to_f32(x[o]), row_mu[r]), rstd);
      const float dy = buf[r * dh_ld + c];
      dg = fmaf(dy, xhat, dg);
      db += dy;
      const float dxhat = __fmul_rn(dy, gf);
      dx[o] = from_f32<T>(
          __fmul_rn(rstd, __fsub_rn(__fsub_rn(dxhat, row_m1[r]), __fmul_rn(xhat, row_m2[r]))));
    }
    atomicAdd(dlns + c, dg);
    atomicAdd(dlnb + c, db);
  }
}

// ------------------------------------------ backward, weight gradients

// dW1 and dW2: tiles [0, p1.tiles) of p1, then those of p2; rows split over grid.y.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rdtail_dw_kernel(DwJob<T> p1, DwJob<T> p2, int K, int rows_per_split) {
  static_assert(THREADS == DW_THREADS, "dw_tile runs on DW_THREADS threads");
  const bool first = blockIdx.x < p1.tiles;
  const DwJob<T> p = first ? p1 : p2;
  const int k_begin = blockIdx.y * rows_per_split;
  dw_tile(p, first ? blockIdx.x : blockIdx.x - p1.tiles, k_begin, min(K, k_begin + rows_per_split));
}

// ---------------------------------------------------------------- host

size_t fwd_smem(int C, int G) {
  return sizeof(float) * (round_up(C, KC) * BM + KC * KI + KI * BM + KC * round_up(G, 32));
}

size_t bwd_smem(int C, int G) {
  return sizeof(float) *
         (BM * (round_up(C, KC) + 1) + round_up(G, KC) * BM + KC * KI + KC * BM + 8 * KI + 4 * BM);
}

template <typename Kernel> int opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <typename T>
int launch_fwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int m, int c, int inter, int g, float eps,
               cudaStream_t stream) {
  const size_t bytes = fwd_smem(c, g);
  if (int err = opt_in(rdtail_fwd_kernel<T>, bytes)) return err;
  rdtail_fwd_kernel<T><<<(m + BM - 1) / BM, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), m, c, inter, g, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* w1t,
               const void* b1, const void* w2t, const void* gout, void* h, void* zg, void* dz1,
               void* dx, void* dlns, void* dlnb, void* dw1, void* db1, void* dw2, void* db2, int m,
               int c, int inter, int g, int splits, float eps, cudaStream_t stream) {
  const size_t bytes = bwd_smem(c, g);
  if (int err = opt_in(rdtail_bwd_rows_kernel<T>, bytes)) return err;
  rdtail_bwd_rows_kernel<T><<<(m + BM - 1) / BM, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const T*>(w1), static_cast<const T*>(w1t), static_cast<const T*>(b1),
      static_cast<const T*>(w2t), static_cast<const T*>(gout), static_cast<T*>(h),
      static_cast<T*>(zg), static_cast<T*>(dz1), static_cast<T*>(dx), static_cast<float*>(dlns),
      static_cast<float*>(dlnb), static_cast<float*>(db1), static_cast<float*>(db2), m, c, inter, g,
      eps);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  DwJob<T> p1{static_cast<const T*>(h), static_cast<const T*>(dz1), static_cast<float*>(dw1),
                  c, inter, (inter + DW - 1) / DW, 0};
  p1.tiles = ((c + DW - 1) / DW) * p1.tiles_n;
  DwJob<T> p2{static_cast<const T*>(zg), static_cast<const T*>(gout), static_cast<float*>(dw2),
                  inter, g, (g + DW - 1) / DW, 0};
  p2.tiles = ((inter + DW - 1) / DW) * p2.tiles_n;
  const int rows_per_split = round_up((m + splits - 1) / splits, KC);
  const dim3 grid(p1.tiles + p2.tiles, (m + rows_per_split - 1) / rows_per_split);
  rdtail_dw_kernel<T><<<grid, THREADS, 0, stream>>>(p1, p2, m, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int m, int c, int inter, int g, int dtype) {
  return m > 0 && c > 0 && inter > 0 && g > 0 && g <= 32 * GJ && (dtype == 0 || dtype == 1) &&
         bwd_smem(c, g) <= 232448 && fwd_smem(c, g) <= 232448;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; every tensor but the f32 gradients is
// in that type.  Returns the cudaGetLastError() code after the launch (0 on
// success).  Pointers are device pointers; the launch goes on `stream` and
// does not synchronise.
extern "C" int rdtail_fwd(const void* x, const void* lns, const void* lnb, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, int m, int c,
                          int inter, int g, int dtype, float eps, void* stream) {
  if (!valid(m, c, inter, g, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, lns, lnb, w1, b1, w2, b2, out, m, c, inter, g, eps, s);
  return launch_fwd<__nv_bfloat16>(x, lns, lnb, w1, b1, w2, b2, out, m, c, inter, g, eps, s);
}

// Two launches.  h (M, C), zg and dz1 (M, I) are scratch in the dtype; dlns,
// dlnb, dw1 (C, I), db1, dw2 (I, G) and db2 are f32 and must be zeroed
// before the call.  w1t is W1 as (I, C), w2t is W2 as (G, I).  `splits`: the
// blocks that share the M-row reduction of each weight-gradient tile.
// Returns the first nonzero cudaGetLastError() code (0 on success).
extern "C" int rdtail_bwd(const void* x, const void* lns, const void* lnb, const void* w1,
                          const void* w1t, const void* b1, const void* w2t, const void* gout,
                          void* h, void* zg, void* dz1, void* dx, void* dlns, void* dlnb, void* dw1,
                          void* db1, void* dw2, void* db2, int m, int c, int inter, int g,
                          int dtype, int splits, float eps, void* stream) {
  if (!valid(m, c, inter, g, dtype) || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, lns, lnb, w1, w1t, b1, w2t, gout, h, zg, dz1, dx, dlns, dlnb, dw1,
                             db1, dw2, db2, m, c, inter, g, splits, eps, s);
  return launch_bwd<__nv_bfloat16>(x, lns, lnb, w1, w1t, b1, w2t, gout, h, zg, dz1, dx, dlns, dlnb,
                                   dw1, db1, dw2, db2, m, c, inter, g, splits, eps, s);
}
