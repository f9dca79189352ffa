// The bf16 RDNet block tail on Hopper's tensor cores (wgmma), forward and
// backward: the route that csrc/rdtail.cu takes for bfloat16 rows whose C,
// I and G are multiples of 8 and whose tiles fit a block's shared memory
// (ops/rdtail.py:route picks it, tail_plan tiles it).  Replaces, for that
// route, the TPU kernels pssr2_tpu/ops/pallas/rdtail.py:_tail_kernel
// (forward, reached through _pallas_tail) and _tail_bwd_kernel
// (_pallas_tail_bwd).
//
// On rows x (M, C) with W1 (C, I), W2 (I, G), rounding to T = bf16 as
// ops/rdtail.py:reference_tail and reference_tail_bwd round:
//
//   h = T(LN(x))  z1 = T(T(h W1) + b1)  zg = T(gelu_fast(z1))
//   out = T(T(zg W2) + b2)
//   dz = T(g W2^T)  dz1 = T(dz * dgelu_fast(z1))  dh = T(dz1 W1^T)
//   dx, dgamma, dbeta: the LayerNorm backward of dh
//   dW1 = h^T dz1, db1 = sum dz1, dW2 = zg^T g, db2 = sum g   (f32)
//
// Every K sum that is rounded to T is whole in one block before its one
// rounding; the f32 parameter gradients are split over rows and meet in
// atomicAdd.
//
// What bounds it on an H100 SXM: 2 M I (C + G) operations forward and
// 2 M I (3C + 2G) backward against 989 TFLOP/s; x, the output and the
// weights are a few MB.  The backward also streams its bf16 scratch (h, zg,
// dz1, dh: 2 M (C + I) values written and read once more).
//
// The pieces: the products are wgmma.mma_async m64nNk16 (bf16 in, f32
// accumulated) with A from registers and B from shared memory by
// descriptor (csrc/convchain_tc.cuh), B tiles coming through a ring of
// RING stages of 64 K rows, filled by cp.async in the 128-byte swizzle.
// The weights are read as the module holds them, W1 (C, I) and W2 (I, G)
// row-major: MN-major B operands for the forward's products, K-major for
// the backward's dz and dh, so no weight is transposed.
//
// Forward, one launch (rdtail_tc_fwd_kernel<WG, NI, GP>): a block holds WG
// consumer warpgroups of 64 rows each.  Its rows of x come into shared
// memory by cp.async, all at once, and are normalised there in place into
// bf16 h (the A operand, K-major, 64-channel chunks of 128-byte swizzled
// rows, zero past C and M); then the block walks its share of I in chunks of
// NI: GEMM 1 (acc1 = h W1[:, chunk], K = C), whose epilogue (bias,
// roundings, GELU) runs in registers and packs zg straight into the bf16
// A fragments of GEMM 2 (the m64nNk16 accumulator layout is the A fragment
// layout of the next product), then acc2 += zg W2[chunk, :] with N = GP (G
// rounded up to 64, at most 256).  The I-wide intermediate never leaves
// the registers.  Where the rows alone do not fill the card, grid.y splits
// I into S <= 8 shares: the S blocks of a row tile form one thread-block
// cluster, each puts its f32 acc2 into its shared memory, and after a
// cluster barrier each sums a slice of the rows over the S blocks' partial
// sums through distributed shared memory, in rank order, before the one
// rounding.
//
// Backward, four launches:
// 1. rdtail_tc_rows_kernel<WG, NI>: per row tile and share of I (grid.y),
//    the LayerNorm again (h written once, by the first share), g as a
//    second A tile; per I chunk GEMM 1 (z1 again) and dz = g W2^T (B = W2
//    K-major, K = G); in registers zg and dz1, written to bf16 scratch;
//    db1 and db2 column sums, one atomicAdd per column and block.
// 2. rdtail_tc_dh_kernel<BN>: dh = T(dz1 W1^T), K = I whole in one block
//    (A = dz1 K-major, B = W1 K-major), written as bf16.
// 3. rdtail_tc_dw_kernel: dW1 = h^T dz1 and dW2 = zg^T g, 64 x 128 tiles
//    over a share of the rows (grid.y); A read MN-major through
//    ldmatrix.trans, B MN-major by wgmma's transpose; f32 atomicAdd.
// 4. rdtail_ln_bwd_kernel: the LayerNorm backward per row (dx; dgamma and
//    dbeta summed over the block's rows, then atomicAdd); bound by bytes,
//    no product.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blockmath.cuh"
#include "convchain_tc.cuh"

namespace rdtc {

namespace cg = cooperative_groups;
using cctc::bf16;
using cctc::cp_async16;
using cctc::cp_commit;
using cctc::cp_wait;
using cctc::fence_acc;
using cctc::fence_async_smem;
using cctc::hi_f;
using cctc::ldsm_x4;
using cctc::ldsm_x4_trans;
using cctc::lo_f;
using cctc::pack2;
using cctc::ROW;
using cctc::smem_desc;
using cctc::smem_u32;
using cctc::sts16;
using cctc::swz;
using cctc::wg_commit;
using cctc::wg_fence;
using cctc::wg_wait;
using cctc::Wgmma;

constexpr int CH = 64;                 // channels of a K chunk: one 128-byte row
constexpr int RING = 3;                // B tiles in flight: 2 loading while 1 multiplies
constexpr int SMEM_LIMIT = 232448;     // bytes of shared memory a block may use
constexpr int MAX_SPLITS = 8;          // blocks of a cluster (the portable limit)
constexpr int LN_ROWS = 32;            // rows of a LayerNorm-backward block
constexpr int LN_THREADS = 256;
constexpr int LN_Q = 4;                // 16-byte chunks of a row a lane holds: C <= 32 * 8 * LN_Q
constexpr int MAX_C = 32 * 8 * LN_Q;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bfr(float v) { return cctc::bf16r(v); }

// Element e (0-7) of 8 packed bf16.
__device__ __forceinline__ float elem(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return (e & 1) ? hi_f(w) : lo_f(w);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// Offset of 16-byte column j (channels 8j..8j+7) of row r in a packed tile
// of `rows` rows: 64-channel chunks one after the other, each `rows` rows
// of 128 swizzled bytes.
__device__ __forceinline__ uint32_t tile_off(int rows, int r, int j) {
  return static_cast<uint32_t>((j >> 3) * rows * ROW) + swz(r, j & 7);
}

// The row statistics of the plain version: f32 sums, mean, the fast
// variance max(0, E[x^2] - mu^2) and 1/sqrt(var + eps), each step rounded
// on its own.  s, s2 are this lane's partial sums of the row; the warp
// completes them.
__device__ __forceinline__ void row_stats(float s, float s2, int C, float eps, float& mu, float& rstd) {
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = __fdiv_rn(s, (float)C);
  const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mu, mu)));
  rstd = __frsqrt_rn(__fadd_rn(var, eps));
}

// Rows [row0, row0 + BM) of a row-major (M, C) bf16 matrix into the packed
// tile at `tile` (BM rows, kp channels) by cp.async, zero past M and past C
// (a multiple of 8): the 16-byte copies of all rows are in flight at once.
template <int BM, int THREADS>
__device__ __forceinline__ void issue_rows(uint32_t tile, const bf16* src, int row0, int M, int C, int kp) {
  for (int e = threadIdx.x; e < BM * (kp / 8); e += THREADS) {
    const int r = e / (kp / 8), j = e % (kp / 8);
    const int row = row0 + r;
    const bool ok = row < M && 8 * j < C;
    cp_async16(tile + tile_off(BM, r, j), ok ? src + static_cast<long long>(row) * C + 8 * j : src, ok);
  }
}

// The LayerNorm of the x rows that issue_rows put into the tile, in place:
// h = T(LN(x)), also to h_out where given.  A warp takes a row, a lane 8
// channels (16 bytes) at a time; rows past M stay zero.
template <int BM>
__device__ void layernorm_tile(const bf16* __restrict__ lns, const bf16* __restrict__ lnb, uint32_t tile,
                               bf16* __restrict__ h_out, int row0, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int n8 = C / 8;
  for (int r = warp; r < BM && row0 + r < M; r += nwarps) {
    float s = 0.f, s2 = 0.f;
    for (int j = lane; j < n8; j += 32) {
      const uint4 v = cctc::lds16(tile + tile_off(BM, r, j));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = elem(v, e);
        s += a;
        s2 = fmaf(a, a, s2);
      }
    }
    float mu, rstd;
    row_stats(s, s2, C, eps, mu, rstd);
    for (int j = lane; j < n8; j += 32) {
      const uint32_t at = tile + tile_off(BM, r, j);
      const uint4 v = cctc::lds16(at);
      const uint4 gv = reinterpret_cast<const uint4*>(lns)[j];
      const uint4 bv = reinterpret_cast<const uint4*>(lnb)[j];
      float hv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float mul = __fmul_rn(rstd, elem(gv, e));
        hv[e] = __fadd_rn(__fmul_rn(__fsub_rn(elem(v, e), mu), mul), elem(bv, e));
      }
      const uint4 out = pack8(hv);
      sts16(at, out);
      if (h_out != nullptr) *reinterpret_cast<uint4*>(h_out + static_cast<long long>(row0 + r) * C + 8 * j) = out;
    }
  }
}

// The A fragments of the 64 rows of warpgroup wg for the 4 k16 steps of
// 64-channel chunk k of a packed K-major tile (BM rows): lane -> row of the
// warp's 16 and 16-byte half, as ldmatrix.x4 wants them.
template <int BM>
__device__ __forceinline__ void load_a(uint32_t tile, int k, int wg, uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int m = 64 * wg + 16 * w4 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(tile + k * BM * ROW + swz(m, 2 * kk + (lane >> 4)), a[kk]);
}

// 64 K rows x N columns of a row-major (kmax x nmax, leading dimension ld)
// matrix, from row k0 and column n0, into an MN-major tile: N/64 blocks of
// 64 rows x 128 swizzled bytes.  Zero past kmax and nmax (multiples of 8).
template <int N, int THREADS>
__device__ __forceinline__ void issue_mn(uint32_t dst, const bf16* src, long long ld, int k0, int kmax, int n0,
                                         int nmax) {
  for (int e = threadIdx.x; e < CH * (N / 8); e += THREADS) {
    const int r = e / (N / 8), jj = e % (N / 8);
    const int k = k0 + r, n = n0 + 8 * jj;
    const bool ok = k < kmax && n < nmax;
    cp_async16(dst + (jj >> 3) * (CH * ROW) + swz(r, jj & 7), ok ? src + k * ld + n : src, ok);
  }
}

// N rows x 64 K columns of a row-major (nmax x kmax, leading dimension ld)
// matrix, from row n0 and column k0, into a K-major tile: N rows of 128
// swizzled bytes.  Zero past nmax and kmax (multiples of 8).
template <int N, int THREADS>
__device__ __forceinline__ void issue_k(uint32_t dst, const bf16* src, long long ld, int n0, int nmax, int k0,
                                        int kmax) {
  for (int e = threadIdx.x; e < N * 8; e += THREADS) {
    const int r = e >> 3, jj = e & 7;
    const int n = n0 + r, k = k0 + 8 * jj;
    const bool ok = n < nmax && k < kmax;
    cp_async16(dst + swz(r, jj), ok ? src + n * ld + k : src, ok);
  }
}

// The I chunks [lo, hi) of share y of n chunks in `splits` shares (the
// host's ops/rdtail.py:split_range): every share non-empty when splits <= n.
__host__ __device__ __forceinline__ void split_range(int y, int n, int splits, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(y) * n / splits);
  hi = static_cast<int>(static_cast<long long>(y + 1) * n / splits);
}

// ------------------------------------------------------------ forward

struct FwdArgs {
  const bf16* x;    // (M, C)
  const bf16* lns;  // (C)
  const bf16* lnb;  // (C)
  const bf16* w1;   // (C, I)
  const bf16* b1;   // (I)
  const bf16* w2;   // (I, G)
  const bf16* b2;   // (G)
  bf16* out;        // (M, G)
  int M, C, I, G;
  int kp;           // C rounded up to CH
  float eps;
};

template <int WG, int NI, int GP> struct FwdCfg {
  static constexpr int BM = 64 * WG;
  static constexpr int THREADS = 128 * WG;
  static constexpr int STAGE = CH * (NI > GP ? NI : GP) * 2;  // 64 K rows of the wider B tile
  static constexpr int PS = GP + 4;                            // row stride of the f32 partial sums
  static __host__ __device__ int bytes(int kp) {
    const int main = RING * STAGE + BM * kp * 2;
    const int part = BM * PS * 4;
    return (main > part ? main : part) + 1024;  // + alignment slack
  }
};

template <int WG, int NI, int GP>
__global__ void __launch_bounds__(WG * 128, 1) rdtail_tc_fwd_kernel(const FwdArgs p) {
  using Cfg = FwdCfg<WG, NI, GP>;
  constexpr int BM = Cfg::BM, THREADS = Cfg::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base, htile = base + RING * Cfg::STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  int c_lo, c_hi;
  split_range(blockIdx.y, (p.I + NI - 1) / NI, gridDim.y, c_lo, c_hi);
  const int ksteps = p.kp / CH;
  const int per_chunk = ksteps + NI / CH;
  const int nsteps = (c_hi - c_lo) * per_chunk;

  // step s: tile k of chunk c_lo + s / per_chunk; W1 rows [64k, +64) x the
  // chunk's NI columns for k < ksteps, else 64 rows of W2 x GP columns
  auto issue = [&](int s) {
    const int n0 = (c_lo + s / per_chunk) * NI, k = s % per_chunk;
    const uint32_t slot = ring + (s % RING) * Cfg::STAGE;
    if (k < ksteps)
      issue_mn<NI, THREADS>(slot, p.w1, p.I, CH * k, p.C, n0, p.I);
    else
      issue_mn<GP, THREADS>(slot, p.w2, p.G, n0 + CH * (k - ksteps), p.I, 0, p.G);
  };
  // the head of a step: its tile has landed and every thread is past the last step
  auto step_begin = [&]() {
    cp_wait<RING - 2>();
    fence_async_smem();
    __syncthreads();
  };
  auto step_end = [&](int s) {
    if (s + RING - 1 < nsteps) issue(s + RING - 1);
    cp_commit();
  };

  issue_rows<BM, THREADS>(htile, p.x, row0, p.M, p.C, p.kp);
  cp_commit();
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_commit();
  }
  cp_wait<RING - 1>();  // the x rows have landed
  __syncthreads();
  layernorm_tile<BM>(p.lns, p.lnb, htile, nullptr, row0, p.M, p.C, p.eps);

  float acc2[GP / 2];
#pragma unroll
  for (int i = 0; i < GP / 2; ++i) acc2[i] = 0.f;

  int s = 0;
#pragma unroll 1
  for (int ci = c_lo; ci < c_hi; ++ci) {
    float acc1[NI / 2];
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc1[i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < ksteps; ++k, ++s) {
      step_begin();
      uint32_t a[4][4];
      load_a<BM>(htile, k, wg, a);
      const uint32_t slot = ring + (s % RING) * Cfg::STAGE;
      fence_acc(acc1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<NI, 1>::run(acc1, a[kk], smem_desc(slot + 16 * ROW * kk, CH * ROW, 8 * ROW));
      wg_commit();
      wg_wait<0>();
      fence_acc(acc1);
      step_end(s);
    }
    // z1 = T(T(acc1) + b1), zg = T(gelu(z1)) into the A fragments of GEMM 2:
    // columns 8j + 2t, + 1 of rows g, g + 8 are fragment j / 2, registers
    // 2 (j % 2) (row g) and 2 (j % 2) + 1 (row g + 8)
    uint32_t zf[NI / 16][4];
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {
      const int col = ci * NI + 8 * j + 2 * t;
      const bool ok = col < p.I;  // and col + 1: I % 8 == 0
      const float bias0 = ok ? bf(p.b1[col]) : 0.f, bias1 = ok ? bf(p.b1[col + 1]) : 0.f;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        z[q] = ok ? bfr(gelu_fast(bfr(bfr(acc1[4 * j + q]) + ((q & 1) ? bias1 : bias0)))) : 0.f;
      zf[j >> 1][2 * (j & 1)] = pack2(z[0], z[1]);
      zf[j >> 1][2 * (j & 1) + 1] = pack2(z[2], z[3]);
    }
#pragma unroll
    for (int jw = 0; jw < NI / CH; ++jw, ++s) {
      step_begin();
      const uint32_t slot = ring + (s % RING) * Cfg::STAGE;
      fence_acc(acc2);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<GP, 1>::run(acc2, zf[4 * jw + kk], smem_desc(slot + 16 * ROW * kk, CH * ROW, 8 * ROW));
      wg_commit();
      wg_wait<0>();
      fence_acc(acc2);
      step_end(s);
    }
  }
  cp_wait<0>();

  const int rw = 64 * wg + 16 * w4 + g;  // this thread's rows rw, rw + 8 of the block
  if (gridDim.y == 1) {
#pragma unroll
    for (int j = 0; j < GP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.G) continue;
      const float bias0 = bf(p.b2[col]), bias1 = bf(p.b2[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + rw + 8 * h;
        if (row < p.M)
          *reinterpret_cast<__nv_bfloat162*>(p.out + static_cast<long long>(row) * p.G + col) =
              __floats2bfloat162_rn(bfr(acc2[4 * j + 2 * h]) + bias0, bfr(acc2[4 * j + 2 * h + 1]) + bias1);
      }
    }
    return;
  }

  // I split over the cluster: the partial sums through distributed shared memory
  __syncthreads();  // the ring and the tile are free
  float* part = reinterpret_cast<float*>(smem + (base - raw));  // [BM][PS]
#pragma unroll
  for (int j = 0; j < GP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (rw + 8 * h) * Cfg::PS + 8 * j + 2 * t) =
          make_float2(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = gridDim.y, rank = static_cast<int>(cluster.block_rank());
  const int per = (BM + S - 1) / S;
  const int r_lo = rank * per, r_hi = min(BM, r_lo + per);
  for (int e = tid; e < (r_hi - r_lo) * (GP / 4); e += THREADS) {
    const int r = r_lo + e / (GP / 4), c4 = 4 * (e % (GP / 4));
    const int row = row0 + r;
    if (c4 >= p.G || row >= p.M) continue;  // G % 8 == 0: a group of 4 is in or out
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + r * Cfg::PS + c4);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.out + static_cast<long long>(row) * p.G + c4);
    dst[0] = __floats2bfloat162_rn(bfr(sum.x) + bf(p.b2[c4]), bfr(sum.y) + bf(p.b2[c4 + 1]));
    dst[1] = __floats2bfloat162_rn(bfr(sum.z) + bf(p.b2[c4 + 2]), bfr(sum.w) + bf(p.b2[c4 + 3]));
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

// ------------------------------------------------------------ backward

struct BwdArgs {
  const bf16* x;    // (M, C)
  const bf16* lns;  // (C)
  const bf16* lnb;  // (C)
  const bf16* w1;   // (C, I)
  const bf16* b1;   // (I)
  const bf16* w2;   // (I, G)
  const bf16* g;    // (M, G): the cotangent
  bf16* h;          // (M, C) scratch: the normalised rows
  bf16* zg;         // (M, I) scratch
  bf16* dz1;        // (M, I) scratch
  bf16* dh;         // (M, C) scratch
  bf16* dx;         // (M, C)
  float* dlns;      // (C), zeroed by the caller, as every f32 gradient
  float* dlnb;      // (C)
  float* db1;       // (I)
  float* db2;       // (G)
  int M, C, I, G;
  int kp, gk;       // C and G rounded up to CH
  float eps;
};

template <int WG, int NI> struct RowsCfg {
  static constexpr int BM = 64 * WG;
  static constexpr int THREADS = 128 * WG;
  static constexpr int STAGE = NI * ROW;  // 64 rows x NI (W1, MN-major) or NI rows x 64 (W2, K-major)
  static __host__ __device__ int bytes(int kp, int gk) {
    return RING * STAGE + BM * kp * 2 + BM * gk * 2 + 4 * WG * NI * 4 + 1024;
  }
};

template <int WG, int NI>
__global__ void __launch_bounds__(WG * 128, 1) rdtail_tc_rows_kernel(const BwdArgs p) {
  using Cfg = RowsCfg<WG, NI>;
  constexpr int BM = Cfg::BM, THREADS = Cfg::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base, htile = ring + RING * Cfg::STAGE, gtile = htile + BM * p.kp * 2;
  float* red = reinterpret_cast<float*>(smem + (gtile + BM * p.gk * 2 - raw));  // [4 WG warps][NI]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const bool first = blockIdx.y == 0;
  int c_lo, c_hi;
  split_range(blockIdx.y, (p.I + NI - 1) / NI, gridDim.y, c_lo, c_hi);
  const int ksteps = p.kp / CH, gsteps = p.gk / CH;
  const int per_chunk = ksteps + gsteps;
  const int nsteps = (c_hi - c_lo) * per_chunk;

  auto issue = [&](int s) {
    const int n0 = (c_lo + s / per_chunk) * NI, k = s % per_chunk;
    const uint32_t slot = ring + (s % RING) * Cfg::STAGE;
    if (k < ksteps)  // W1 rows [64k, +64) x the chunk's columns: MN-major
      issue_mn<NI, THREADS>(slot, p.w1, p.I, CH * k, p.C, n0, p.I);
    else  // W2 rows of the chunk x G columns [64(k - ksteps), +64): K-major
      issue_k<NI, THREADS>(slot, p.w2, p.G, n0, p.I, CH * (k - ksteps), p.G);
  };
  auto step_begin = [&]() {
    cp_wait<RING - 2>();
    fence_async_smem();
    __syncthreads();
  };
  auto step_end = [&](int s) {
    if (s + RING - 1 < nsteps) issue(s + RING - 1);
    cp_commit();
  };

  // the x rows and the cotangent tile (the A operand of dz) in one group
  issue_rows<BM, THREADS>(htile, p.x, row0, p.M, p.C, p.kp);
  issue_rows<BM, THREADS>(gtile, p.g, row0, p.M, p.G, p.gk);
  cp_commit();
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_commit();
  }
  cp_wait<RING - 1>();
  __syncthreads();
  layernorm_tile<BM>(p.lns, p.lnb, htile, first ? p.h : nullptr, row0, p.M, p.C, p.eps);
  if (first) {  // db2: the column sums of g over the block's rows
    const int rows = min(BM, p.M - row0);
    for (int c = tid; c < p.G; c += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < rows; ++r) sum += bf(p.g[static_cast<long long>(row0 + r) * p.G + c]);
      atomicAdd(p.db2 + c, sum);
    }
  }

  const int rw = 64 * wg + 16 * w4 + g;
  int s = 0;
#pragma unroll 1
  for (int ci = c_lo; ci < c_hi; ++ci) {
    float acc1[NI / 2], accd[NI / 2];
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc1[i] = accd[i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < ksteps; ++k, ++s) {  // z1: h W1[:, chunk]
      step_begin();
      uint32_t a[4][4];
      load_a<BM>(htile, k, wg, a);
      const uint32_t slot = ring + (s % RING) * Cfg::STAGE;
      fence_acc(acc1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<NI, 1>::run(acc1, a[kk], smem_desc(slot + 16 * ROW * kk, CH * ROW, 8 * ROW));
      wg_commit();
      wg_wait<0>();
      fence_acc(acc1);
      step_end(s);
    }
#pragma unroll 1
    for (int k = 0; k < gsteps; ++k, ++s) {  // dz: g W2[chunk, :]^T
      step_begin();
      uint32_t a[4][4];
      load_a<BM>(gtile, k, wg, a);
      const uint32_t slot = ring + (s % RING) * Cfg::STAGE;
      fence_acc(accd);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<NI, 0>::run(accd, a[kk], smem_desc(slot + 32 * kk, 16, 8 * ROW));
      wg_commit();
      wg_wait<0>();
      fence_acc(accd);
      step_end(s);
    }
    // zg = T(gelu(z1)), dz1 = T(T(dz) * gelu'(z1)) to the scratch; db1
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {
      const int col = ci * NI + 8 * j + 2 * t;
      const bool ok = col < p.I;
      const float bias0 = ok ? bf(p.b1[col]) : 0.f, bias1 = ok ? bf(p.b1[col + 1]) : 0.f;
      float colsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + rw + 8 * h;
        float zv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z1 = bfr(bfr(acc1[4 * j + 2 * h + e]) + (e ? bias1 : bias0));
          zv[e] = gelu_fast(z1);
          dv[e] = bfr(bfr(accd[4 * j + 2 * h + e]) * dgelu_fast(z1));
        }
        if (ok && row < p.M) {
          const long long o = static_cast<long long>(row) * p.I + col;
          *reinterpret_cast<__nv_bfloat162*>(p.zg + o) = __floats2bfloat162_rn(zv[0], zv[1]);
          *reinterpret_cast<__nv_bfloat162*>(p.dz1 + o) = __floats2bfloat162_rn(dv[0], dv[1]);
          colsum[0] += dv[0];
          colsum[1] += dv[1];
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) colsum[e] += __shfl_xor_sync(0xffffffffu, colsum[e], off);
        if (g == 0) red[warp * NI + 8 * j + 2 * t + e] = colsum[e];
      }
    }
    __syncthreads();
    if (tid < NI && ci * NI + tid < p.I) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * WG; ++w) sum += red[w * NI + tid];
      atomicAdd(p.db1 + ci * NI + tid, sum);
    }
  }
  cp_wait<0>();
}

struct DhArgs {
  const bf16* dz1;  // (M, I)
  const bf16* w1;   // (C, I)
  bf16* dh;         // (M, C)
  int M, C, I;
};

constexpr int DH_STAGES = 4;
template <int BN> struct DhCfg {
  static constexpr int A_BYTES = 64 * ROW;
  static constexpr int STAGE = A_BYTES + BN * ROW;
  static constexpr int BYTES = DH_STAGES * STAGE + 1024;
};

// dh = T(dz1 W1^T) on 64 rows x BN channels a block, K = I whole.
template <int BN>
__global__ void __launch_bounds__(128) rdtail_tc_dh_kernel(const DhArgs p) {
  using Cfg = DhCfg<BN>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, w4 = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64, c0 = blockIdx.y * BN;
  const int nsteps = (p.I + CH - 1) / CH;
  auto issue = [&](int s) {
    const uint32_t slot = base + (s % DH_STAGES) * Cfg::STAGE;
    issue_k<64, 128>(slot, p.dz1, p.I, row0, p.M, CH * s, p.I);
    issue_k<BN, 128>(slot + Cfg::A_BYTES, p.w1, p.I, c0, p.C, CH * s, p.I);
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < DH_STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_commit();
  }
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<DH_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    const uint32_t slot = base + (s % DH_STAGES) * Cfg::STAGE;
    uint32_t a[4][4];
    load_a<64>(slot, 0, 0, a);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BN, 0>::run(acc, a[kk], smem_desc(slot + Cfg::A_BYTES + 32 * kk, 16, 8 * ROW));
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    if (s + DH_STAGES - 1 < nsteps) issue(s + DH_STAGES - 1);
    cp_commit();
  }
  cp_wait<0>();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= p.C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * w4 + g + 8 * h;
      if (row < p.M)
        *reinterpret_cast<__nv_bfloat162*>(p.dh + static_cast<long long>(row) * p.C + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out (mo x no, f32) += a^T b over rows [k_begin, k_end): a (rows, mo) and
// b (rows, no) row-major bf16; 64 x 128 tiles, tiles_n of them a tile row.
struct DwJob {
  const bf16* a;
  const bf16* b;
  float* out;
  int mo, no, tiles_n, tiles;
};
struct DwArgs {
  DwJob j1, j2;  // dW1 = h^T dz1, then dW2 = zg^T g
  int M, rows_per_split;
};
constexpr int DW_BN = 128;
constexpr int DW_STAGES = 4;
struct DwCfg {
  static constexpr int A_BYTES = 64 * ROW;
  static constexpr int STAGE = A_BYTES + DW_BN * ROW;
  static constexpr int BYTES = DW_STAGES * STAGE + 1024;
};

// The mainloop and epilogue of one weight-gradient tile, shared by the
// RDNet tail's dW launch and the Swin block's (csrc/swinblock_tc.cuh): the
// 64 x 128 tile `tile` of job q over rows [k_begin, k_end), added to q.out
// with f32 atomicAdd.  A block of 128 threads and DwCfg::BYTES of dynamic
// shared memory.
__device__ __forceinline__ void dw_tile_tc(const DwJob& q, int tile, int k_begin, int k_end) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const int m0 = (tile / q.tiles_n) * 64, n0 = (tile % q.tiles_n) * DW_BN;
  const int nsteps = k_begin < k_end ? (k_end - k_begin + CH - 1) / CH : 0;
  const int tid = threadIdx.x, lane = tid & 31, w4 = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  auto issue = [&](int s) {
    const uint32_t slot = base + (s % DW_STAGES) * DwCfg::STAGE;
    const int k0 = k_begin + CH * s;
    issue_mn<64, 128>(slot, q.a, q.mo, k0, k_end, m0, q.mo);
    issue_mn<DW_BN, 128>(slot + DwCfg::A_BYTES, q.b, q.no, k0, k_end, n0, q.no);
  };
  float acc[DW_BN / 2];
#pragma unroll
  for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_commit();
  }
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<DW_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    const uint32_t slot = base + (s % DW_STAGES) * DwCfg::STAGE;
    // A[m = channel][k = row] from the row-major tile, transposed by
    // ldmatrix: matrices (k 0-7 | 8-15) x (m 0-7 | 8-15) of the warp's 16 m
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4_trans(slot + swz(16 * kk + (lane & 7) + ((lane >> 4) << 3), 2 * w4 + ((lane >> 3) & 1)), a[kk]);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<DW_BN, 1>::run(acc, a[kk], smem_desc(slot + DwCfg::A_BYTES + 16 * ROW * kk, CH * ROW, 8 * ROW));
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    if (s + DW_STAGES - 1 < nsteps) issue(s + DW_STAGES - 1);
    cp_commit();
  }
  cp_wait<0>();
  if (nsteps == 0) return;
#pragma unroll
  for (int j = 0; j < DW_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= q.no) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * w4 + g + 8 * h;
      if (m < q.mo)
        atomicAdd(reinterpret_cast<float2*>(q.out + static_cast<long long>(m) * q.no + col),
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
  }
}

__global__ void __launch_bounds__(128) rdtail_tc_dw_kernel(const DwArgs p) {
  const bool first = static_cast<int>(blockIdx.x) < p.j1.tiles;
  const DwJob q{first ? p.j1.a : p.j2.a, first ? p.j1.b : p.j2.b, first ? p.j1.out : p.j2.out,
                first ? p.j1.mo : p.j2.mo, first ? p.j1.no : p.j2.no, first ? p.j1.tiles_n : p.j2.tiles_n, 0};
  const int k_begin = blockIdx.y * p.rows_per_split;
  dw_tile_tc(q, first ? blockIdx.x : blockIdx.x - p.j1.tiles, k_begin, min(p.M, k_begin + p.rows_per_split));
}

// The LayerNorm backward of LN_ROWS rows a block, a warp a row: dx, and
// dgamma, dbeta summed over the block's rows (a lane keeps its channels'
// sums in registers, the warps meet in shared memory), then atomicAdd.
// The arithmetic is rdtail.cu's rdtail_bwd_rows_kernel's.
__global__ void __launch_bounds__(LN_THREADS) rdtail_ln_bwd_kernel(const BwdArgs p) {
  __shared__ float sdg[MAX_C], sdb[MAX_C];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n8 = p.C / 8;
  for (int c = tid; c < p.C; c += LN_THREADS) sdg[c] = sdb[c] = 0.f;
  float gam[LN_Q][8], dg[LN_Q][8], db[LN_Q][8];
#pragma unroll
  for (int q = 0; q < LN_Q; ++q) {
    const int j = lane + 32 * q;
    const uint4 gv = j < n8 ? reinterpret_cast<const uint4*>(p.lns)[j] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gam[q][e] = elem(gv, e);
      dg[q][e] = db[q][e] = 0.f;
    }
  }
  for (int r = warp; r < LN_ROWS; r += LN_THREADS / 32) {
    const int row = blockIdx.x * LN_ROWS + r;
    if (row >= p.M) break;
    const long long o = static_cast<long long>(row) * p.C;
    uint4 xv[LN_Q], dv[LN_Q];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < LN_Q; ++q) {
      const int j = lane + 32 * q;
      xv[q] = dv[q] = make_uint4(0, 0, 0, 0);
      if (j < n8) {
        xv[q] = reinterpret_cast<const uint4*>(p.x + o)[j];
        dv[q] = reinterpret_cast<const uint4*>(p.dh + o)[j];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = elem(xv[q], e);
          s += a;
          s2 = fmaf(a, a, s2);
        }
      }
    }
    float mu, rstd;
    row_stats(s, s2, p.C, p.eps, mu, rstd);
    float s1 = 0.f, sx = 0.f;
#pragma unroll
    for (int q = 0; q < LN_Q; ++q) {
      if (lane + 32 * q >= n8) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = __fmul_rn(__fsub_rn(elem(xv[q], e), mu), rstd);
        const float dxhat = __fmul_rn(elem(dv[q], e), gam[q][e]);
        s1 += dxhat;
        sx = fmaf(dxhat, xhat, sx);
      }
    }
    s1 = warp_sum(s1);
    sx = warp_sum(sx);
    const float m1 = __fdiv_rn(s1, (float)p.C), m2 = __fdiv_rn(sx, (float)p.C);
#pragma unroll
    for (int q = 0; q < LN_Q; ++q) {
      const int j = lane + 32 * q;
      if (j >= n8) continue;
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dy = elem(dv[q], e);
        const float xhat = __fmul_rn(__fsub_rn(elem(xv[q], e), mu), rstd);
        const float dxhat = __fmul_rn(dy, gam[q][e]);
        dg[q][e] = fmaf(dy, xhat, dg[q][e]);
        db[q][e] += dy;
        out[e] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dxhat, m1), __fmul_rn(xhat, m2)));
      }
      reinterpret_cast<uint4*>(p.dx + o)[j] = pack8(out);
    }
  }
  __syncthreads();  // sdg, sdb zeroed
#pragma unroll
  for (int q = 0; q < LN_Q; ++q) {
    const int j = lane + 32 * q;
    if (j >= n8) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      atomicAdd(sdg + 8 * j + e, dg[q][e]);
      atomicAdd(sdb + 8 * j + e, db[q][e]);
    }
  }
  __syncthreads();
  for (int c = tid; c < p.C; c += LN_THREADS) {
    atomicAdd(p.dlns + c, sdg[c]);
    atomicAdd(p.dlnb + c, sdb[c]);
  }
}

// ------------------------------------------------------------ host

// Raises a kernel's dynamic shared-memory limit to SMEM_LIMIT, once per
// kernel and device (`raised`: one bit per device).
template <typename Kernel> cudaError_t allow_smem(Kernel kernel, unsigned long long& raised) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev < 64 && (raised >> dev & 1)) return cudaSuccess;
  if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT))
    return err;
  if (dev < 64) raised |= 1ull << dev;
  return cudaSuccess;
}

template <int WG, int NI, int GP>
cudaError_t launch_fwd(const FwdArgs& p, int splits, cudaStream_t stream) {
  auto kernel = rdtail_tc_fwd_kernel<WG, NI, GP>;
  static unsigned long long raised = 0;
  const int bytes = FwdCfg<WG, NI, GP>::bytes(p.kp);
  if (bytes > SMEM_LIMIT || splits < 1 || splits > MAX_SPLITS || splits > (p.I + NI - 1) / NI)
    return cudaErrorInvalidValue;
  if (cudaError_t err = allow_smem(kernel, raised)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.M + 64 * WG - 1) / (64 * WG), splits);
  cfg.blockDim = dim3(WG * 128);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p)) return err;
  return cudaGetLastError();
}

template <int WG, int NI> cudaError_t launch_rows(const BwdArgs& p, int splits, cudaStream_t stream) {
  auto kernel = rdtail_tc_rows_kernel<WG, NI>;
  static unsigned long long raised = 0;
  const int bytes = RowsCfg<WG, NI>::bytes(p.kp, p.gk);
  if (bytes > SMEM_LIMIT || splits < 1 || splits > 65535 || splits > (p.I + NI - 1) / NI)
    return cudaErrorInvalidValue;
  if (cudaError_t err = allow_smem(kernel, raised)) return err;
  kernel<<<dim3((p.M + 64 * WG - 1) / (64 * WG), splits), WG * 128, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN> cudaError_t launch_dh(const DhArgs& p, cudaStream_t stream) {
  auto kernel = rdtail_tc_dh_kernel<BN>;
  static unsigned long long raised = 0;
  if ((p.C + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  if (cudaError_t err = allow_smem(kernel, raised)) return err;
  kernel<<<dim3((p.M + 63) / 64, (p.C + BN - 1) / BN), 128, DhCfg<BN>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

inline cudaError_t launch_dw(const DwArgs& p, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const int splits = (p.M + p.rows_per_split - 1) / p.rows_per_split;
  if (splits > 65535) return cudaErrorInvalidValue;
  if (cudaError_t err = allow_smem(rdtail_tc_dw_kernel, raised)) return err;
  rdtail_tc_dw_kernel<<<dim3(p.j1.tiles + p.j2.tiles, splits), 128, DwCfg::BYTES, stream>>>(p);
  return cudaGetLastError();
}

inline cudaError_t launch_ln_bwd(const BwdArgs& p, cudaStream_t stream) {
  rdtail_ln_bwd_kernel<<<(p.M + LN_ROWS - 1) / LN_ROWS, LN_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

inline DwJob dw_job(const bf16* a, const bf16* b, float* out, int mo, int no) {
  const int tiles_n = (no + DW_BN - 1) / DW_BN;
  return {a, b, out, mo, no, tiles_n, ((mo + 63) / 64) * tiles_n};
}

}  // namespace rdtc
