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
// What bounds it on an H100 SXM: 2*M*I*(C + G) operations forward and
// 2*M*I*(3C + 2G) backward, against 989 TFLOP/s (bf16 tensor cores) or 67
// TFLOP/s (f32 CUDA cores); the bytes are x and the output once each (and,
// backward, the cotangent, dx and the weight gradients) against 3.35 TB/s.
// At the RDResUNet's shapes (C 128-816, I = 4C, G 64-224) the operations
// bound it.
//
// Two routes, chosen by the wrapper (ops/rdtail.py:route) from the
// dtype and the shape, never on an error:
//
// - bfloat16 with C, I and G multiples of 8, C <= 1024, G <= 256: the
//   tensor cores (wgmma), csrc/rdtail_tc.cuh, entry points rdtail_tc_fwd
//   (one launch) and rdtail_tc_bwd (four), tiled by ops/rdtail.py:tail_plan.
// - float32, and any other bfloat16 shape: the kernels below, on the CUDA
//   cores in f32 (bf16 values are exact in f32), entry points rdtail_fwd
//   (one launch) and rdtail_bwd (four).  The tensor cores have no f32
//   product, and TF32 would not hold the f32 tolerance.
//
// CUDA-core forward, one launch.  A block owns 32 rows.  It normalises them into shared
// memory (f32 copies of the T values, channel-major), then walks I in
// chunks of 128: z1 for the chunk (256 threads, 4x4 outputs each, W1 in
// slices of 16 rows through shared memory, the next slice prefetched into
// registers), GELU into shared memory, and the chunk's part of zg W2 added
// to the f32 output accumulators (4 rows x up to 8 columns a thread, G <=
// 256).  The I-wide intermediate never leaves the chip.
//
// CUDA-core backward, four launches on the register-tiled f32 mainloop of
// csrc/f32gemm.cuh (128 x BN output tiles, 8 x 8 or 8 x 4 a thread, a
// cp.async ring; tiled by ops/rdtail.py:f32_plan), the weights read as
// they lie:
// (1) the LayerNorm of the rows: h = T(LN(x)) and each row's statistics
//     to scratch, db2 by column sums of g;
// (2) the rows' products, a 128-row x BN-column tile of I a block: z1 =
//     h W1 (K = C) and dz = g W2^T (K = G), one after the other in the same
//     accumulators; zg = T(GELU(z1)) is stored and GELU'(z1) parked in
//     shared memory between them; dz1 = T(T(dz) GELU'(z1)) is stored, also
//     transposed (I, M) so that dh's A operand is K-major, and summed into
//     db1;
// (3) one launch of three products: dh = dz1 W1^T (K = I) and dW1 = h^T
//     dz1, dW2 = zg^T g (K = M), each tile's K split over blocks until the
//     launch holds some four waves, the shares met by atomicAdd in f32;
// (4) the LayerNorm backward, 32 rows a block: dy = T(dh), dx, and
//     dgamma, dbeta by column sums.
// The atomics make the order of those f32 sums change from run to run.

#include "blockmath.cuh"
#include "convchain_tc.cuh"
#include "f32gemm.cuh"
#include "rdtail_tc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 32;   // rows per block of the forward
constexpr int KI = 128;  // columns of an I chunk
constexpr int KC = 16;   // rows of a streamed operand slice
constexpr int GJ = 8;    // output columns per thread in the fc2 product: G <= 32 * GJ

// ---- LayerNorm of the block's rows into hT[c][r] (f32 copies of the T
// values; zeros for rows past M and channels past C up to cp).  Warp w
// normalises rows 4w..4w+3.
template <typename T>
__device__ void layernorm_rows(const T* __restrict__ x, const T* __restrict__ lns,
                               const T* __restrict__ lnb, float* hT, int row0, int M, int C, int cp,
                               float eps) {
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
    for (int c = lane; c < cp; c += 32) {
      float hv = 0.f;
      if (c < C) {
        const float mul = __fmul_rn(rstd, to_f32(lns[c]));
        hv = round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_f32(xr[c]), mu), mul), to_f32(lnb[c])));
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

  layernorm_rows<T>(x, lns, lnb, hT, row0, M, C, cp, eps);

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

// ------------------------------------------ backward, on the CUDA cores

// Four launches on the f32 mainloop of csrc/f32gemm.cuh.  Every tensor is
// f32 in device memory (a bfloat16 caller's values converted exactly by the
// wrapper); T is the type whose rounding points the plain version keeps.
constexpr int LN_ROWS = 32;      // rows a block of the row kernels: 8 warps x 4
constexpr int ROWS_STAGES = 2;   // ring slots of the rows launch (its park takes the rest)
constexpr int JOBS_STAGES = 3;   // ring slots of the GEMM launch

// (1) h = T(LN(x)), each row's mean and 1/std; db2 = column sums of g
template <typename T>
__global__ void __launch_bounds__(f32g::THREADS)
rdtail_f32_ln_kernel(const float* __restrict__ x, const float* __restrict__ lns, const float* __restrict__ lnb,
                     const float* __restrict__ gout, float* __restrict__ h, float* __restrict__ mu_out,
                     float* __restrict__ rstd_out, float* __restrict__ db2, int M, int C, int G, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = blockIdx.x * LN_ROWS;
  const int rows = min(LN_ROWS, M - row0);
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r >= rows) break;
    const float* xr = x + static_cast<long long>(row0 + r) * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = xr[c];
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = __fdiv_rn(s, (float)C);
    const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mu, mu)));
    const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
    if (lane == 0) {
      mu_out[row0 + r] = mu;
      rstd_out[row0 + r] = rstd;
    }
    float* hr = h + static_cast<long long>(row0 + r) * C;
    for (int c = lane; c < C; c += 32)
      hr[c] = round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(xr[c], mu), __fmul_rn(rstd, lns[c])), lnb[c]));
  }
  for (int c = threadIdx.x; c < G; c += f32g::THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += gout[static_cast<long long>(row0 + r) * G + c];
    atomicAdd(db2 + c, s);
  }
}

// (2) A tile of 128 rows x BN columns of I: z1 = h W1 (K = C), then dz =
// g W2^T (K = G) in the same accumulators.  Between them GELU(z1) is
// stored and GELU'(z1) parked in shared memory, a thread's own slots; then
// dz1 = T(T(dz) GELU'(z1)) is stored, row-major (for dW1) and transposed
// (I, M) (for dh, whose A operand it is), and summed into db1.
struct RowsArgs {
  const float *h, *w1, *b1, *g, *w2;
  float *zg, *dz1, *dz1T, *db1;
  int M, C, I, G, w1_vec, m_vec;
};

template <int BN> struct RowsSmem {
  static constexpr int RING = ROWS_STAGES * f32g::Gemm<BN>::SLOT;  // floats
  static constexpr int PARK = 8 * (BN / 16) * f32g::THREADS;       // floats: GELU'(z1), a thread's 8 x TN
  static constexpr int BYTES = (RING + PARK) * 4;
};

template <typename T, int BN>
__global__ void __launch_bounds__(f32g::THREADS, 2) rdtail_f32_rows_kernel(const RowsArgs p) {
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  float* park = smem + RowsSmem<BN>::RING;
  const int m0 = blockIdx.x * f32g::BM, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const f32g::Pos t;
  float acc[8][TN];
  f32g::zero(acc);
  // h's rows are K-contiguous; W1 (C, I) holds each K row's I contiguous
  f32g::gemm<BN, ROWS_STAGES, true, false>(smem, f32g::Operand{p.h, p.C, p.M, 0},
                                           f32g::Operand{p.w1, p.I, p.I, p.w1_vec}, m0, n0, 0, p.C, acc, t);
  // the tile to the park, then row by row (few registers live beside the
  // GELU): zg stored, GELU'(z1) parked in its place
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      park[(i * TN + j) * f32g::THREADS + tid] = acc[i][j];
      acc[i][j] = 0.f;
    }
  float bias[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = n0 + f32g::col<TN>(t.tx, j);
    bias[j] = c < p.I ? p.b1[c] : 0.f;
  }
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + t.row(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + f32g::col<TN>(t.tx, j);
      float* slot = park + (i * TN + j) * f32g::THREADS + tid;
      const float z1 = round_to<T>(round_to<T>(*slot) + bias[j]);
      float g, dg;
      gelu_dgelu<T>(z1, g, dg);
      if (r < p.M && c < p.I) p.zg[static_cast<long long>(r) * p.I + c] = round_to<T>(g);
      *slot = dg;
    }
  }
  // g's rows are K-contiguous; W2 (I, G) holds each I column's K contiguous
  f32g::gemm<BN, ROWS_STAGES, true, true>(smem, f32g::Operand{p.g, p.G, p.M, 0}, f32g::Operand{p.w2, p.G, p.I, 0},
                                          m0, n0, 0, p.G, acc, t);
  float colsum[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + t.row(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + f32g::col<TN>(t.tx, j);
      const float d1 = round_to<T>(round_to<T>(acc[i][j]) * park[(i * TN + j) * f32g::THREADS + tid]);
      acc[i][j] = d1;
      if (r < p.M && c < p.I) {
        p.dz1[static_cast<long long>(r) * p.I + c] = d1;
        colsum[j] += d1;
      }
    }
  }
  // dz1T: a thread's rows are two runs of 4
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = n0 + f32g::col<TN>(t.tx, j);
    if (c >= p.I) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = m0 + t.row(4 * u);
      float* out = p.dz1T + static_cast<long long>(c) * p.M + r;
      if (p.m_vec && r + 3 < p.M) {
        *reinterpret_cast<float4*>(out) = make_float4(acc[4 * u][j], acc[4 * u + 1][j], acc[4 * u + 2][j], acc[4 * u + 3][j]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r + q < p.M) out[q] = acc[4 * u + q][j];
      }
    }
  }
  f32g::col_sums<TN>(colsum, smem, t);
  if (tid < BN && n0 + tid < p.I) atomicAdd(p.db1 + n0 + tid, smem[16 * BN + tid]);
}

// (3) dh = dz1 W1^T (K = I, into f32, rounded to T where it is read), dW1 =
// h^T dz1 and dW2 = zg^T g (K = M): f32g::gemm_jobs_kernel.

// (4) The LayerNorm backward of the rows, dy = T(dh): per row m1 =
// mean(dy gamma), m2 = mean(dy gamma xhat); dx = T(rstd (dy gamma - m1 -
// xhat m2)); dgamma, dbeta by column sums over the block's rows.
template <typename T>
__global__ void __launch_bounds__(f32g::THREADS)
rdtail_f32_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ lns, const float* __restrict__ dh,
                         const float* __restrict__ mu, const float* __restrict__ rstd, float* __restrict__ dx,
                         float* __restrict__ dlns, float* __restrict__ dlnb, int M, int C) {
  __shared__ float row_mu[LN_ROWS], row_rstd[LN_ROWS], row_m1[LN_ROWS], row_m2[LN_ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = blockIdx.x * LN_ROWS;
  const int rows = min(LN_ROWS, M - row0);
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r >= rows) break;
    const long long o = static_cast<long long>(row0 + r) * C;
    const float m = mu[row0 + r], rs = rstd[row0 + r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = __fmul_rn(__fsub_rn(x[o + c], m), rs);
      const float dxhat = __fmul_rn(round_to<T>(dh[o + c]), lns[c]);
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
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += f32g::THREADS) {
    const float gf = lns[c];
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long long o = static_cast<long long>(row0 + r) * C + c;
      const float xhat = __fmul_rn(__fsub_rn(x[o], row_mu[r]), row_rstd[r]);
      const float dy = round_to<T>(dh[o]);
      dg = fmaf(dy, xhat, dg);
      db += dy;
      const float dxhat = __fmul_rn(dy, gf);
      dx[o] = round_to<T>(__fmul_rn(row_rstd[r], __fsub_rn(__fsub_rn(dxhat, row_m1[r]), __fmul_rn(xhat, row_m2[r]))));
    }
    atomicAdd(dlns + c, dg);
    atomicAdd(dlnb + c, db);
  }
}

// ---------------------------------------------------------------- host

size_t fwd_smem(int C, int G) {
  return sizeof(float) * (round_up(C, KC) * BM + KC * KI + KI * BM + KC * round_up(G, 32));
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

// The CUDA-core backward's operands and tiling (ops/rdtail.py:f32_plan):
// the rows launch's BN, and the GEMM launch's BN (128 or 64) and K share (a
// multiple of f32g::BK) of each of its products (dh, dW1, dW2).
struct F32Bwd {
  const float *x, *lns, *lnb, *w1, *b1, *w2, *g;
  float *h, *zg, *dz1, *dz1T, *dh, *mu, *rstd, *dx, *dlns, *dlnb, *dw1, *db1, *dw2, *db2;
  int m, c, inter, gw, rows_bn, bn_dh, bn_dw1, bn_dw2, kps_dh, kps_dw1, kps_dw2;
  float eps;
};

// a GEMM launch's job: out (m x n) += A B over K = k in shares of kps
f32g::Job job(f32g::Operand a, f32g::Operand b, float* out, int m, int n, int k, int bn, int kps) {
  return {a, b, out, m, n, k, bn, (n + bn - 1) / bn, (k + kps - 1) / kps, kps};
}

// vec: whether a K-major operand's rows take 16-byte copies
f32g::Operand operand(const float* p, int ld, int rows, bool kcontig) {
  const bool vec = !kcontig && ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return {p, ld, rows, vec ? 1 : 0};
}

template <typename T, int BN> int launch_rows(const F32Bwd& a, cudaStream_t s) {
  static int raised = 0;
  constexpr int bytes = RowsSmem<BN>::BYTES;
  if (int err = f32g::opt_in(rdtail_f32_rows_kernel<T, BN>, bytes, raised)) return err;
  const RowsArgs p{a.h, a.w1, a.b1, a.g, a.w2, a.zg, a.dz1, a.dz1T, a.db1, a.m, a.c, a.inter, a.gw,
                   operand(a.w1, a.inter, a.inter, false).vec, operand(a.dz1T, a.m, a.m, false).vec};
  const dim3 grid((a.m + f32g::BM - 1) / f32g::BM, (a.inter + BN - 1) / BN);
  rdtail_f32_rows_kernel<T, BN><<<grid, f32g::THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_jobs(const F32Bwd& a, cudaStream_t s) {
  static int raised = 0;
  constexpr int bytes = f32g::gemm_smem_bytes<128, JOBS_STAGES>();
  if (int err = f32g::opt_in(f32g::gemm_jobs_kernel<JOBS_STAGES>, bytes, raised)) return err;
  f32g::Jobs p{};
  // dh (M, C) = dz1 W1^T: dz1T (I, M) K-major, W1 (C, I) K-contiguous
  p.j0 = job(operand(a.dz1T, a.m, a.m, false), operand(a.w1, a.inter, a.c, true), a.dh, a.m, a.c, a.inter,
             a.bn_dh, a.kps_dh);
  // dW1 (C, I) = h^T dz1 and dW2 (I, G) = zg^T g: both K-major
  p.j1 = job(operand(a.h, a.c, a.c, false), operand(a.dz1, a.inter, a.inter, false), a.dw1, a.c, a.inter, a.m,
             a.bn_dw1, a.kps_dw1);
  p.j2 = job(operand(a.zg, a.inter, a.inter, false), operand(a.g, a.gw, a.gw, false), a.dw2, a.inter, a.gw, a.m,
             a.bn_dw2, a.kps_dw2);
  auto blocks = [](const f32g::Job& j) {
    return static_cast<long long>((j.m + f32g::BM - 1) / f32g::BM) * j.tiles_n * j.splits;
  };
  const long long b0 = blocks(p.j0), b1 = blocks(p.j1), b2 = blocks(p.j2);
  if (b0 + b1 + b2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.first1 = static_cast<int>(b0);
  p.first2 = static_cast<int>(b0 + b1);
  f32g::gemm_jobs_kernel<JOBS_STAGES><<<static_cast<unsigned>(b0 + b1 + b2), f32g::THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T> int launch_bwd(const F32Bwd& a, cudaStream_t s) {
  const int row_blocks = (a.m + LN_ROWS - 1) / LN_ROWS;
  rdtail_f32_ln_kernel<T><<<row_blocks, f32g::THREADS, 0, s>>>(a.x, a.lns, a.lnb, a.g, a.h, a.mu, a.rstd, a.db2,
                                                               a.m, a.c, a.gw, a.eps);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  int err = a.rows_bn == 128 ? launch_rows<T, 128>(a, s) : launch_rows<T, 64>(a, s);
  if (err) return err;
  if ((err = launch_jobs(a, s))) return err;
  rdtail_f32_ln_bwd_kernel<T><<<row_blocks, f32g::THREADS, 0, s>>>(a.x, a.lns, a.dh, a.mu, a.rstd, a.dx, a.dlns,
                                                                   a.dlnb, a.m, a.c);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int m, int c, int inter, int g, int dtype) {
  return m > 0 && c > 0 && inter > 0 && g > 0 && g <= 32 * GJ && (dtype == 0 || dtype == 1) &&
         fwd_smem(c, g) <= 232448;
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

// The CUDA-core backward, four launches (the rows' LayerNorm, the rows'
// products, the GEMM launch, the LayerNorm backward).  Every tensor is f32
// (a bfloat16 caller's converted, exactly); dtype (0 = float32, 1 =
// bfloat16) is the type whose rounding the results keep.  h, dh (M, C), zg,
// dz1 (M, I), dz1T (I, M) and stats (2 M) are scratch; dh, dlns, dlnb, dw1
// (C, I), db1,
// dw2 (I, G) and db2 must be zeroed before the call.  W1 (C, I) and W2
// (I, G) are read as they lie.  The tiling (ops/rdtail.py:f32_plan):
// rows_bn, the GEMM launch's bn_* (each 128 or 64) and K shares kps_*
// (multiples of 16) for dh, dW1, dW2.  Returns the first nonzero
// cudaGetLastError() code (0 on success).
extern "C" int rdtail_bwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                          const void* w2, const void* gout, void* h, void* zg, void* dz1, void* dz1T, void* dh,
                          void* stats,
                          void* dx, void* dlns, void* dlnb, void* dw1, void* db1, void* dw2, void* db2, int m, int c,
                          int inter, int g, int dtype, int rows_bn, int bn_dh, int bn_dw1, int bn_dw2, int kps_dh,
                          int kps_dw1, int kps_dw2, float eps, void* stream) {
  auto bn_ok = [](int bn) { return bn == 128 || bn == 64; };
  auto kps_ok = [](int kps) { return kps > 0 && kps % f32g::BK == 0; };
  if (!valid(m, c, inter, g, dtype) || !bn_ok(rows_bn) || !bn_ok(bn_dh) || !bn_ok(bn_dw1) || !bn_ok(bn_dw2) ||
      !kps_ok(kps_dh) || !kps_ok(kps_dw1) || !kps_ok(kps_dw2) || (inter + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const F32Bwd a{f(x), f(lns), f(lnb), f(w1), f(b1), f(w2), f(gout), w(h), w(zg), w(dz1), w(dz1T), w(dh), w(stats),
                 w(stats) + m, w(dx), w(dlns), w(dlnb), w(dw1), w(db1), w(dw2), w(db2), m, c, inter, g, rows_bn,
                 bn_dh, bn_dw1, bn_dw2, kps_dh, kps_dw1, kps_dw2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<float>(a, s) : launch_bwd<__nv_bfloat16>(a, s);
}

// ---------------------------------------------- the tensor-core route

// bfloat16 on the tensor cores (csrc/rdtail_tc.cuh), one launch: `wg`
// warpgroups of 64 rows a block, I chunks of `ni` columns, I split over
// `splits` blocks of one cluster (ops/rdtail.py:tail_plan).  The weights
// are W1 (C, I) and W2 (I, G) row-major.  Returns the cudaGetLastError()
// code after the launch (0 on success).
extern "C" int rdtail_tc_fwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int m, int c, int inter, int g, int wg,
                             int ni, int splits, float eps, void* stream) {
  if (m <= 0 || c <= 0 || inter <= 0 || g <= 0 || c % 8 || inter % 8 || g % 8 || g > 256 || c > rdtc::MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  using rdtc::bf16;
  rdtc::FwdArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
                  static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                  static_cast<const bf16*>(b2), static_cast<bf16*>(out), m, c, inter, g, round_up(c, rdtc::CH), eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gp = g <= 64 ? 64 : g <= 128 ? 128 : 256;
  cudaError_t err = cudaErrorInvalidValue;
  if (wg == 1 && ni == 128 && gp == 64) err = rdtc::launch_fwd<1, 128, 64>(p, splits, s);
  if (wg == 2 && ni == 128 && gp == 64) err = rdtc::launch_fwd<2, 128, 64>(p, splits, s);
  if (wg == 1 && ni == 128 && gp == 128) err = rdtc::launch_fwd<1, 128, 128>(p, splits, s);
  if (wg == 2 && ni == 128 && gp == 128) err = rdtc::launch_fwd<2, 128, 128>(p, splits, s);
  if (wg == 1 && ni == 64 && gp == 256) err = rdtc::launch_fwd<1, 64, 256>(p, splits, s);
  if (wg == 2 && ni == 64 && gp == 256) err = rdtc::launch_fwd<2, 64, 256>(p, splits, s);
  return static_cast<int>(err);
}

// bfloat16 on the tensor cores, four launches: the rows (`rows_wg`
// warpgroups, I chunks of `rows_ni`, I split `rows_splits` ways), dh
// (`dh_bn` channels a block), dW1 and dW2 (rows split in shares of
// `dw_rows`), the LayerNorm backward.  h, dh (M, C), zg and dz1 (M, I) are
// bf16 scratch; dlns, dlnb, dw1 (C, I), db1, dw2 (I, G) and db2 are f32
// and must be zeroed before the call.  Returns the first nonzero
// cudaGetLastError() code (0 on success).
extern "C" int rdtail_tc_bwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                             const void* w2, const void* gout, void* h, void* zg, void* dz1, void* dh, void* dx,
                             void* dlns, void* dlnb, void* dw1, void* db1, void* dw2, void* db2, int m, int c,
                             int inter, int g, int rows_wg, int rows_ni, int rows_splits, int dh_bn, int dw_rows,
                             float eps, void* stream) {
  if (m <= 0 || c <= 0 || inter <= 0 || g <= 0 || c % 8 || inter % 8 || g % 8 || g > 256 || c > rdtc::MAX_C ||
      dw_rows <= 0 || dw_rows % rdtc::CH)
    return static_cast<int>(cudaErrorInvalidValue);
  using rdtc::bf16;
  rdtc::BwdArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
                  static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                  static_cast<const bf16*>(gout), static_cast<bf16*>(h), static_cast<bf16*>(zg),
                  static_cast<bf16*>(dz1), static_cast<bf16*>(dh), static_cast<bf16*>(dx),
                  static_cast<float*>(dlns), static_cast<float*>(dlnb), static_cast<float*>(db1),
                  static_cast<float*>(db2), m, c, inter, g, round_up(c, rdtc::CH), round_up(g, rdtc::CH), eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (rows_wg == 1 && rows_ni == 64) err = rdtc::launch_rows<1, 64>(p, rows_splits, s);
  if (rows_wg == 2 && rows_ni == 64) err = rdtc::launch_rows<2, 64>(p, rows_splits, s);
  if (rows_wg == 1 && rows_ni == 128) err = rdtc::launch_rows<1, 128>(p, rows_splits, s);
  if (rows_wg == 2 && rows_ni == 128) err = rdtc::launch_rows<2, 128>(p, rows_splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const rdtc::DhArgs q{p.dz1, p.w1, p.dh, m, c, inter};
  err = dh_bn == 128 ? rdtc::launch_dh<128>(q, s) : dh_bn == 64 ? rdtc::launch_dh<64>(q, s) : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);

  const rdtc::DwArgs r{rdtc::dw_job(p.h, p.dz1, static_cast<float*>(dw1), c, inter),
                       rdtc::dw_job(p.zg, p.g, static_cast<float*>(dw2), inter, g), m, dw_rows};
  if ((err = rdtc::launch_dw(r, s)) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(rdtc::launch_ln_bwd(p, s));
}
