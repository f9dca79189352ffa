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
//   (three launches) and rdtail_bwd (four).  The tensor cores have no f32
//   product, and TF32 would not hold the f32 tolerance.
//
// The CUDA-core route runs on the register-tiled f32 mainloop of
// csrc/f32gemm.cuh (128 x BN output tiles, 8 x 8 or 8 x 4 a thread, a
// cp.async ring), the weights read as they lie, every tensor f32 in device
// memory (a bfloat16 caller's values converted exactly by the wrapper) and
// T the type whose rounding points the plain version keeps.
//
// Forward, three launches (tiled by ops/rdtail.py:f32_fwd_plan):
// (1) the LayerNorm of the rows, h = T(LN(x)) to scratch;
// (2) fc1, a 128-row x BN-column tile of I a block: zg = T(GELU(T(T(h W1)
//     + b1))) to scratch (M I f32: 2.4 GB written and read over the 21
//     tails of an RDResUNet forward at batch 16, some 0.7 ms at 3.35 TB/s);
// (3) fc2, 128 x BN tiles of G with K = I split over blocks where the
//     tiles alone leave the card short: a tile's shares add into an f32
//     workspace by atomicAdd and the last share to arrive (a counter a
//     tile) rounds, adds b2 and writes out = T(T(zg W2) + b2); a tile of
//     one share does so from its registers.
//
// Backward, four launches (tiled by ops/rdtail.py:f32_plan):
// (1) the LayerNorm of the rows: h = T(LN(x)) and each row's statistics
//     to scratch, db2 by column sums of g;
// (2) the rows' products (blockmath.cuh:mlp_rows_tile), a 128-row x
//     BN-column tile of I a block: z1 = h W1 (K = C) and dz = g W2^T (K =
//     G), one after the other in the same accumulators; zg = T(GELU(z1)) is
//     stored and GELU'(z1) parked in shared memory between them; dz1 =
//     T(T(dz) GELU'(z1)) is stored, also transposed (I, M) so that dh's A
//     operand is K-major, and summed into db1;
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

constexpr int GMAX = 256;        // G the route takes (ops/rdtail.py:MAX_G)
constexpr int CMAX = 1408;       // C the route takes (ops/rdtail.py:MAX_C)
constexpr int LN_ROWS = 32;      // rows a block of the row kernels: 8 warps x 4
constexpr int FC_STAGES = 3;     // ring slots of the forward's products
constexpr int JOBS_STAGES = 3;   // ring slots of the backward's GEMM launch

// h = T(LN(x)) and, where mu_out is not null, each row's mean and 1/std;
// where db2 is not null, db2 += the column sums of g (M, G)
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
    if (lane == 0 && mu_out != nullptr) {
      mu_out[row0 + r] = mu;
      rstd_out[row0 + r] = rstd;
    }
    float* hr = h + static_cast<long long>(row0 + r) * C;
    for (int c = lane; c < C; c += 32)
      hr[c] = round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(xr[c], mu), __fmul_rn(rstd, lns[c])), lnb[c]));
  }
  if (db2 == nullptr) return;
  for (int c = threadIdx.x; c < G; c += f32g::THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += gout[static_cast<long long>(row0 + r) * G + c];
    atomicAdd(db2 + c, s);
  }
}

// ---------------------------------------------------------------- forward

struct FcArgs {
  const float *a, *w, *bias;  // A (M, K) rows, W (K, N) as it lies, the bias (N)
  float *out, *ws;            // out (M, N); fc2's f32 workspace (M, N), zeroed
  int* count;                 // fc2: the shares arrived at each tile, zeroed
  int M, K, N, kps, w_vec;
};

// (2) zg = T(GELU(T(T(h W1) + b1))), the tile (blockIdx.x, blockIdx.y)
template <typename T, int BN>
__global__ void __launch_bounds__(f32g::THREADS, 2) rdtail_f32_fc1_kernel(const FcArgs p) {
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * f32g::BM, n0 = blockIdx.y * BN;
  const f32g::Pos t;
  float acc[8][TN];
  f32g::zero(acc);
  f32g::gemm<BN, FC_STAGES, true, false>(smem, f32g::Operand{p.a, p.K, p.M, 0}, f32g::Operand{p.w, p.N, p.N, p.w_vec},
                                         m0, n0, 0, p.K, acc, t);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = n0 + f32g::col<TN>(t.tx, j);
    if (c >= p.N) continue;
    const float bias = p.bias[c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + t.row(i);
      if (r < p.M) p.out[static_cast<long long>(r) * p.N + c] = round_to<T>(gelu<T>(round_to<T>(round_to<T>(acc[i][j]) + bias)));
    }
  }
}

// (3) out = T(T(zg W2) + b2): grid (row tiles x K shares, column tiles),
// block x taking share x / row tiles of row tile x % row tiles
template <typename T, int BN>
__global__ void __launch_bounds__(f32g::THREADS, 2) rdtail_f32_fc2_kernel(const FcArgs p) {
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  const int tiles_m = (p.M + f32g::BM - 1) / f32g::BM;
  const int share = blockIdx.x / tiles_m, tile = blockIdx.x % tiles_m + tiles_m * blockIdx.y;
  const int m0 = (blockIdx.x % tiles_m) * f32g::BM, n0 = blockIdx.y * BN;
  const int kb = share * p.kps, ke = min(p.K, kb + p.kps), splits = (p.K + p.kps - 1) / p.kps;
  const f32g::Pos t;
  float acc[8][TN];
  f32g::zero(acc);
  f32g::gemm<BN, FC_STAGES, true, false>(smem, f32g::Operand{p.a, p.K, p.M, 0}, f32g::Operand{p.w, p.N, p.N, p.w_vec},
                                         m0, n0, kb, ke, acc, t);
  auto finish = [&](long long o, int c, float v) { p.out[o] = round_to<T>(round_to<T>(v) + p.bias[c]); };
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + t.row(i);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + f32g::col<TN>(t.tx, j);
        if (r < p.M && c < p.N) finish(static_cast<long long>(r) * p.N + c, c, acc[i][j]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + t.row(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + f32g::col<TN>(t.tx, j);
      if (r < p.M && c < p.N) atomicAdd(p.ws + static_cast<long long>(r) * p.N + c, acc[i][j]);
    }
  }
  // the last share of the tile to arrive finishes it, from the workspace
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.count + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < f32g::BM * BN; e += f32g::THREADS) {
    const int r = m0 + e / BN, c = n0 + e % BN;
    if (r < p.M && c < p.N) {
      const long long o = static_cast<long long>(r) * p.N + c;
      finish(o, c, __ldcg(p.ws + o));
    }
  }
}

// ------------------------------------------ backward, on the CUDA cores

// (2) blockmath.cuh:mlp_rows_tile, with I = inter and G the output width
template <typename T, int BN>
__global__ void __launch_bounds__(f32g::THREADS, 2) rdtail_f32_rows_kernel(const MlpRowsArgs p) {
  mlp_rows_tile<T, BN>(p);
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

int ln_blocks(int m) { return (m + LN_ROWS - 1) / LN_ROWS; }

// The CUDA-core forward's operands and tiling (ops/rdtail.py:f32_fwd_plan):
// fc1's BN, fc2's BN and K share (a multiple of f32g::BK).
struct F32Fwd {
  const float *x, *lns, *lnb, *w1, *b1, *w2, *b2;
  float *h, *zg, *out, *ws;
  int* count;
  int m, c, inter, gw, fc1_bn, fc2_bn, fc2_kps;
  float eps;
};

template <typename Kernel> int launch_fc(Kernel kernel, int& raised, dim3 grid, const FcArgs& p, cudaStream_t s) {
  constexpr int bytes = f32g::gemm_smem_bytes<128, FC_STAGES>();
  if (int err = f32g::opt_in(kernel, bytes, raised)) return err;
  kernel<<<grid, f32g::THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T> int launch_fwd(const F32Fwd& a, cudaStream_t s) {
  static int raised[4] = {0, 0, 0, 0};
  rdtail_f32_ln_kernel<T><<<ln_blocks(a.m), f32g::THREADS, 0, s>>>(a.x, a.lns, a.lnb, nullptr, a.h, nullptr, nullptr,
                                                                   nullptr, a.m, a.c, 0, a.eps);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const int tiles_m = (a.m + f32g::BM - 1) / f32g::BM;
  const FcArgs p1{a.h, a.w1, a.b1, a.zg, nullptr, nullptr, a.m, a.c, a.inter, a.c,
                  f32g::operand(a.w1, a.inter, a.inter, false).vec};
  const dim3 g1(tiles_m, (a.inter + a.fc1_bn - 1) / a.fc1_bn);
  int err = a.fc1_bn == 128 ? launch_fc(rdtail_f32_fc1_kernel<T, 128>, raised[0], g1, p1, s)
                            : launch_fc(rdtail_f32_fc1_kernel<T, 64>, raised[1], g1, p1, s);
  if (err) return err;
  const FcArgs p2{a.zg, a.w2, a.b2, a.out, a.ws, a.count, a.m, a.inter, a.gw, a.fc2_kps,
                  f32g::operand(a.w2, a.gw, a.gw, false).vec};
  const dim3 g2(tiles_m * ((a.inter + a.fc2_kps - 1) / a.fc2_kps), (a.gw + a.fc2_bn - 1) / a.fc2_bn);
  return a.fc2_bn == 128 ? launch_fc(rdtail_f32_fc2_kernel<T, 128>, raised[2], g2, p2, s)
                         : launch_fc(rdtail_f32_fc2_kernel<T, 64>, raised[3], g2, p2, s);
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

template <typename T, int BN> int launch_rows(const F32Bwd& a, cudaStream_t s) {
  static int raised = 0;
  constexpr int bytes = MlpRowsSmem<BN>::BYTES;
  if (int err = f32g::opt_in(rdtail_f32_rows_kernel<T, BN>, bytes, raised)) return err;
  const MlpRowsArgs p{a.h, a.w1, a.b1, a.g, a.w2, a.zg, a.dz1, a.dz1T, a.db1, a.m, a.c, a.inter, a.gw,
                      f32g::operand(a.w1, a.inter, a.inter, false).vec, f32g::operand(a.dz1T, a.m, a.m, false).vec};
  const dim3 grid((a.m + f32g::BM - 1) / f32g::BM, (a.inter + BN - 1) / BN);
  rdtail_f32_rows_kernel<T, BN><<<grid, f32g::THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_jobs(const F32Bwd& a, cudaStream_t s) {
  static int raised = 0;
  using f32g::job;
  using f32g::operand;
  f32g::Jobs p{};
  // dh (M, C) = dz1 W1^T: dz1T (I, M) K-major, W1 (C, I) K-contiguous
  p.j0 = job(operand(a.dz1T, a.m, a.m, false), operand(a.w1, a.inter, a.c, true), a.dh, a.m, a.c, a.inter,
             a.bn_dh, a.kps_dh, true);
  // dW1 (C, I) = h^T dz1 and dW2 (I, G) = zg^T g: both K-major
  p.j1 = job(operand(a.h, a.c, a.c, false), operand(a.dz1, a.inter, a.inter, false), a.dw1, a.c, a.inter, a.m,
             a.bn_dw1, a.kps_dw1, false);
  p.j2 = job(operand(a.zg, a.inter, a.inter, false), operand(a.g, a.gw, a.gw, false), a.dw2, a.inter, a.gw, a.m,
             a.bn_dw2, a.kps_dw2, false);
  return f32g::launch_jobs<JOBS_STAGES>(p, raised, s);
}

template <typename T> int launch_bwd(const F32Bwd& a, cudaStream_t s) {
  const int row_blocks = ln_blocks(a.m);
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
  return m > 0 && c > 0 && inter > 0 && g > 0 && g <= GMAX && c <= CMAX && (dtype == 0 || dtype == 1) &&
         (inter + 63) / 64 <= 65535;
}

bool bn_ok(int bn) { return bn == 128 || bn == 64; }
bool kps_ok(int kps) { return kps > 0 && kps % f32g::BK == 0; }

}  // namespace

// The CUDA-core forward, three launches (the rows' LayerNorm, fc1, fc2).
// Every tensor is f32 (a bfloat16 caller's converted, exactly); dtype (0 =
// float32, 1 = bfloat16) is the type whose rounding the output keeps.  h
// (M, C) and zg (M, I) are scratch; ws (M, G) f32 and count (one int a fc2
// tile: ceil(M / 128) x ceil(G / fc2_bn)) must be zeroed before the call
// where fc2 splits K (fc2_kps < I).  W1 (C, I) and W2 (I, G) are read as
// they lie.  The tiling (ops/rdtail.py:f32_fwd_plan): fc1_bn, fc2_bn (128
// or 64), fc2_kps (a multiple of 16).  Returns the first nonzero
// cudaGetLastError() code (0 on success); the launches go on `stream` and
// do not synchronise.
extern "C" int rdtail_fwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* h, void* zg, void* out, void* ws, void* count, int m,
                          int c, int inter, int g, int dtype, int fc1_bn, int fc2_bn, int fc2_kps, float eps,
                          void* stream) {
  if (!valid(m, c, inter, g, dtype) || !bn_ok(fc1_bn) || !bn_ok(fc2_bn) || !kps_ok(fc2_kps) ||
      static_cast<long long>((m + f32g::BM - 1) / f32g::BM) * ((inter + fc2_kps - 1) / fc2_kps) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const F32Fwd a{f(x), f(lns), f(lnb), f(w1), f(b1), f(w2), f(b2), w(h), w(zg), w(out), w(ws),
                 static_cast<int*>(count), m, c, inter, g, fc1_bn, fc2_bn, fc2_kps, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fwd<float>(a, s) : launch_fwd<__nv_bfloat16>(a, s);
}

// The CUDA-core backward, four launches (the rows' LayerNorm, the rows'
// products, the GEMM launch, the LayerNorm backward).  Every tensor is f32
// (a bfloat16 caller's converted, exactly); dtype (0 = float32, 1 =
// bfloat16) is the type whose rounding the results keep.  h, dh (M, C), zg,
// dz1 (M, I), dz1T (I, M) and stats (2 M) are scratch; dh, dlns, dlnb, dw1
// (C, I), db1, dw2 (I, G) and db2 must be zeroed before the call.  W1 (C, I)
// and W2 (I, G) are read as they lie.  The tiling (ops/rdtail.py:f32_plan):
// rows_bn, the GEMM launch's bn_* (each 128 or 64) and K shares kps_*
// (multiples of 16) for dh, dW1, dW2.  Returns the first nonzero
// cudaGetLastError() code (0 on success).
extern "C" int rdtail_bwd(const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,
                          const void* w2, const void* gout, void* h, void* zg, void* dz1, void* dz1T, void* dh,
                          void* stats,
                          void* dx, void* dlns, void* dlnb, void* dw1, void* db1, void* dw2, void* db2, int m, int c,
                          int inter, int g, int dtype, int rows_bn, int bn_dh, int bn_dw1, int bn_dw2, int kps_dh,
                          int kps_dw1, int kps_dw2, float eps, void* stream) {
  if (!valid(m, c, inter, g, dtype) || !bn_ok(rows_bn) || !bn_ok(bn_dh) || !bn_ok(bn_dw1) || !bn_ok(bn_dw2) ||
      !kps_ok(kps_dh) || !kps_ok(kps_dw1) || !kps_ok(kps_dw2))
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
