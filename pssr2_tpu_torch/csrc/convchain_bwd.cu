// convchain backward for Hopper: the VJP of one ResBlock layer
// (csrc/convchain.cu), in two launches over the same NHWC tensors.
//
// Forward (for reference):  h = relu(x*a + b) rounded to T (or h = x),
//   y = T(conv3x3_SAME(h, W)) + bias,  s1 = sum y,  s2 = sum y^2.
// Given the cotangents gy of y and (gs1, gs2) of the sums:
//
//   g    = gy + T(gs1 + 2*y*gs2)        the stat cotangents folded in f32,
//                                        rounded to T, added in T
//   dh   = conv3x3_SAME^T(g, W)         f32 (Cout -> Cin)
//   dz   = dh * [x*a + b > 0],  dx = T(dz * a),  da = sum dz*x,  db = sum dz
//          (without the prologue: dx = T(dh))
//   dW[tap][ci][co] = sum over pixels of h(shifted by the tap) * g   (f32)
//   dbias = sum g                                                     (f32)
//
// Launch 1 computes dx and d(a, b); launch 2 computes dW and dbias.
//
// Replaces the TPU kernel pssr2_tpu/ops/pallas/convchain.py:
// _layer_bwd_kernel (reached through _pallas_layer_bwd and the custom VJP
// of fused_conv_layer).  That kernel runs one image per grid step in a
// (N, H, C, W) layout and accumulates dW in a grid-revisited output; here
// the layout is NHWC and the rounding is the TPU kernel's.
//
// What bounds it on an H100 SXM: each launch does the forward's
// 2*N*H*W*9*Cin*Cout operations (against 67 TFLOP/s f32 outside the
// tensor cores, 989 TFLOP/s bf16 on them); the bytes are x, y, gy, the
// weights and dx once each against 3.35 TB/s.  At the ResUNet's shapes the
// operations bound both launches by a wide margin.
//
// Two routes, chosen by the wrapper from the dtype.
//
// bfloat16 (convchain_bwd_tc), on the tensor cores (wgmma):
// - dx (convchain_tc_dx_kernel) is the forward's implicit GEMM
//   (csrc/convchain_tc.cuh) with the folded cotangent g as the A operand,
//   K = 9 x Cout, and the forward's weight layout read MN-major at the
//   flipped taps.  Its epilogue recomputes the prologue for the ReLU mask
//   and reduces d(a, b); the blocks of the first Cin tile write g (bf16,
//   (N, H, W, Cout_pad)) for the dW launch.
// - dW (convchain_tc_dw_kernel) is, for each tap, the GEMM M = Cin,
//   N = Cout, K = pixels.  A block
//   owns 64 Cin x 64 Cout x all 9 taps: three warpgroups, one a row of
//   taps (3 accumulators of 64 x 64 each).  A step is one 8x8 pixel
//   sub-tile: B = its g, MN-major, straight from the dx launch's g by
//   cp.async; A = the input's 10x10 halo (x with the prologue, zero outside
//   the image), read for each tap at shifted rows by ldmatrix.trans, which
//   gives the Cin-major fragment.  So each pixel's x and g are loaded once
//   for all 9 taps.  A 4-stage ring walks the block's share of the
//   sub-tiles (grid.z splits them).  The block's 64 x 64 x 9 tile goes
//   through shared memory into dW's own (Cout, Cin, 3, 3) order, where each
//   Cout's 64 Cin x 9 taps are one contiguous run, and the partial sums
//   meet there with 16-byte f32 atomicAdd.  The blocks of the first Cin
//   tile also sum g for dbias.
//
// float32 (convchain_bwd: convchain_f32_dx_kernel, then
// convchain_f32_dw_kernel), on the CUDA cores in true f32 (the tensor cores
// have no f32 product; TF32 would break the 1e-4 tolerance), on the
// register-tiled mainloop of csrc/f32gemm.cuh: a ring of cp.async slots, a
// 16 x 16 grid of threads, each with a register tile.
// - dx is an implicit GEMM: M = pixels, two 8 x 8 sub-tiles a block (128
//   rows), N = Cin (BN 128, 64, 32 or 16: ops/convchain.py:f32_dx_plan),
//   K = 9 taps x Cout, 8 channels a step.  A step's slot holds the halo of
//   gy and y for both sub-tiles, folded into g by the thread that copied
//   each element once it lands, and the weights at the flipped taps (the
//   layout (9, Cout, Cin) that the autograd forward makes beside its own
//   and keeps: 16-byte copies); a thread's 8 x TN tile takes each halo row
//   as a 6-wide window for the three kx.  Its epilogue recomputes the
//   prologue for the ReLU mask and reduces d(a, b); the blocks of the first
//   Cin tile write g (f32) for the dW launch.
// - dW is, for each tap, the GEMM M = Cin, N = Cout, K = pixels: a block
//   owns 32 Cin x 64 Cout x all 9 taps over a share of the sub-tiles
//   (grid.z: f32_dw_plan), a thread 2 Cin x 4 Cout x 9 taps (72 sums).  A
//   step is one sub-tile: its g and its input halo (the prologue applied by
//   the copying thread) are loaded once for the 9 taps, and a thread slides
//   a 3 x 3 window along each pixel row, 3 new halo values and one float4
//   of g a pixel for 72 FMAs.  The block's tile goes through shared memory
//   into dW's own (Cout, Cin, 3, 3) order, where the partial sums meet by
//   atomicAdd, and the blocks of the first Cin tile sum g for dbias.  The
//   atomics make the order of those f32 sums change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convchain_tc.cuh"
#include "f32gemm.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The stat-folded cotangent of one element, as a T tensor holds it:
// g = gy + T(gs1 + 2*y*gs2), in the order the plain version computes it.
template <typename T>
__device__ __forceinline__ float fold(float gy, float y, float gs1, float gs2) {
  const float t = __fadd_rn(gs1, __fmul_rn(2.f * y, gs2));
  return round_to<T>(__fadd_rn(gy, round_to<T>(t)));
}

// ---- float32 on the CUDA cores (csrc/f32gemm.cuh)

constexpr int SUB_W = 8;           // an 8 x 8 pixel sub-tile (cctc::TILE)
constexpr int HALO_W = SUB_W + 2;  // its 10 x 10 halo
constexpr int HALO_PX = HALO_W * HALO_W;
constexpr int DX_KC = 8;           // Cout channels of a dx step
constexpr int DX_STAGES = 2;
constexpr int DW_CI = 32;          // a dW block's Cin ...
constexpr int DW_CO = 64;          // ... and Cout, all 9 taps
constexpr int DW_STAGES = 3;

struct F32Args {
  const float* x;    // (N, H, W, Cin)
  const float* wt;   // (9, Cout, Cin): W at the flipped taps (ops/convchain.py:kernel_weight_dx)
  const float* y;    // (N, H, W, Cout)
  const float* gy;   // (N, H, W, Cout)
  const float* gs;   // (2, Cout)
  const float* ab;   // (2, Cin) or null
  float* dx;         // (N, H, W, Cin)
  float* dab;        // (2, Cin), zeroed by the caller
  float* g;          // (N, H, W, Cout): the folded cotangent, written by dx for dW
  float* dw;         // (Cout, Cin, 3, 3), zeroed by the caller
  float* dbias;      // (Cout), zeroed by the caller
  int H, W, cin, cout, tiles_w, tiles_per_img, n_sub;
};

// dx's ring slot: the folded cotangent's halo of this step's DX_KC
// channels for both sub-tiles ([k][sub][10][10]; gy lands there and y in
// the next HALO floats for the fold), then the weights at the flipped taps
// ([tap][k][BN + PAD], 16-byte rows of Cin)
template <int BN> struct DxSmem {
  static constexpr int HALO = DX_KC * 2 * HALO_PX;
  static constexpr int SB = BN + f32g::PAD;
  static constexpr int SLOT = 2 * HALO + 9 * DX_KC * SB;
  static constexpr int BYTES = DX_STAGES * SLOT * 4;
};

// dx = conv3x3^T(g, W): M = pixels, two 8 x 8 sub-tiles a block (128 rows,
// one for each run of 4 register rows: a thread's 8 pixels are 4 in a row
// of each), N = BN input channels, K = 9 taps x Cout walked DX_KC channels
// a step.  A step's halo is loaded once for its 9 taps: a thread slides a
// 6-wide window of each sub-tile's halo row (py + ky) across the three kx.
template <typename T, bool RELU_IN, int BN>
__global__ void __launch_bounds__(f32g::THREADS, 2) convchain_f32_dx_kernel(const F32Args p) {
  constexpr int TN = BN / 16;
  using S = DxSmem<BN>;
  extern __shared__ __align__(16) float fsmem[];
  const int tid = threadIdx.x, n0 = blockIdx.y * BN;
  const bool writes_g = blockIdx.y == 0;  // the first Cin tile writes g for dW
  const bool wvec = (p.cin & 3) == 0;     // 16-byte weight rows
  const f32g::Pos t;
  int n_a, h_a, w_a, n_b, h_b, w_b;
  const bool ok_a = cctc::sub_origin(2 * blockIdx.x, p.n_sub, p.tiles_per_img, p.tiles_w, n_a, h_a, w_a);
  const bool ok_b = cctc::sub_origin(2 * blockIdx.x + 1, p.n_sub, p.tiles_per_img, p.tiles_w, n_b, h_b, w_b);

  // halo slot e of a step: channel k, sub-tile s, halo pixel q; its element
  // of gy, y and g at `at` where `ok` (in the image, the sub-tile and Cout)
  auto slot = [&](int e, int c0, int& d, long long& at, bool& ok, bool& inner) {
    const int k = e & 7, q = e >> 3, s = q >= HALO_PX, hp = q - s * HALO_PX;
    const int hy = hp / HALO_W, hx = hp % HALO_W;
    const int hh = (s ? h_b : h_a) - 1 + hy, ww = (s ? w_b : w_a) - 1 + hx;
    ok = (s ? ok_b : ok_a) && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && c0 + k < p.cout;
    inner = hy >= 1 && hy <= SUB_W && hx >= 1 && hx <= SUB_W;
    at = ((static_cast<long long>(s ? n_b : n_a) * p.H + hh) * p.W + ww) * p.cout + c0 + k;
    d = (k * 2 + s) * HALO_PX + hp;
  };
  float acc[8][TN];
  f32g::zero(acc);
  f32g::ring<DX_STAGES>(
      fsmem, S::SLOT, (p.cout + DX_KC - 1) / DX_KC,
      [&](float* sl, int i) {
        const int c0 = i * DX_KC;
        for (int e = tid; e < S::HALO; e += f32g::THREADS) {  // 8 channels a lane's run: a 32-byte sector
          int d;
          long long at;
          bool ok, inner;
          slot(e, c0, d, at, ok, inner);
          f32g::cp4(sl + d, ok ? p.gy + at : p.gy, ok);
          f32g::cp4(sl + S::HALO + d, ok ? p.y + at : p.y, ok);
        }
        // [tap][k][n] = W[co][ci][8 - tap] = wt[tap][c0 + k][n0 + n], 4 n a copy
        float* ws = sl + 2 * S::HALO;
        constexpr int CH = BN / 4;
        for (int e = tid; e < 9 * DX_KC * CH; e += f32g::THREADS) {
          const int n = (e % CH) * 4, k = (e / CH) % DX_KC, tap = e / (CH * DX_KC);
          const bool kin = c0 + k < p.cout;
          const long long at = (static_cast<long long>(tap) * p.cout + c0 + k) * p.cin + n0 + n;
          float* d = ws + (tap * DX_KC + k) * S::SB + n;
          if (wvec && n0 + n + 4 <= p.cin) {
            f32g::cp16(d, kin ? p.wt + at : p.wt, kin);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = kin && n0 + n + j < p.cin;
              f32g::cp4(d + j, ok ? p.wt + at + j : p.wt, ok);
            }
          }
        }
      },
      [&](float* sl, int i) {  // the fold, on the slots this thread copied
        const int c0 = i * DX_KC;
#pragma unroll 1
        for (int e = tid; e < S::HALO; e += f32g::THREADS) {
          int d;
          long long at;
          bool ok, inner;
          slot(e, c0, d, at, ok, inner);
          float v = 0.f;
          if (ok) {
            const int co = c0 + (e & 7);
            v = fold<T>(sl[d], sl[S::HALO + d], p.gs[co], p.gs[p.cout + co]);
            if (writes_g && inner) p.g[at] = v;
          }
          sl[d] = v;
        }
      },
      [&](float* sl, int) {
        const float* ws = sl + 2 * S::HALO;
        const int py = t.ty >> 1, px = (t.ty & 1) * 4;
#pragma unroll 2
        for (int k = 0; k < DX_KC; ++k) {
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            float win[2][6];
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int q = 0; q < 6; ++q) win[s][q] = sl[(k * 2 + s) * HALO_PX + (py + ky) * HALO_W + px + q];
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              float a[8], b[TN];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                a[q] = win[0][q + kx];
                a[4 + q] = win[1][q + kx];
              }
              f32g::load_b<TN>(ws + ((ky * 3 + kx) * DX_KC + k) * S::SB, t.tx, b);
              f32g::outer(acc, a, b);
            }
          }
        }
      });

  // epilogue: the ReLU mask of the recomputed prologue, dx, and the d(a, b)
  // sums.  The tile goes to shared memory first (a thread's own slots), so
  // that few registers are live beside the loads of x; a column's sums over
  // the thread's rows go to red ([2][16 thread rows][BN]) for the block's
  // column sums.
  float* park = fsmem;
  float* red = fsmem + 8 * TN * f32g::THREADS;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) park[(i * TN + j) * f32g::THREADS + tid] = acc[i][j];
#pragma unroll 1
  for (int j = 0; j < TN; ++j) {
    const int ci = n0 + f32g::col<TN>(t.tx, j);
    const float a = RELU_IN && ci < p.cin ? p.ab[ci] : 1.f;
    const float b = RELU_IN && ci < p.cin ? p.ab[p.cin + ci] : 0.f;
    float part1 = 0.f, part2 = 0.f;
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const int s = i >> 2, local = t.row(i) & 63;
      const int hh = (s ? h_b : h_a) + local / SUB_W, ww = (s ? w_b : w_a) + local % SUB_W;
      if (!(s ? ok_b : ok_a) || hh >= p.H || ww >= p.W || ci >= p.cin) continue;
      const long long at = ((static_cast<long long>(s ? n_b : n_a) * p.H + hh) * p.W + ww) * p.cin + ci;
      const float v = park[(i * TN + j) * f32g::THREADS + tid];
      if (RELU_IN) {
        const float xv = p.x[at];
        const float z = __fadd_rn(__fmul_rn(xv, a), b);
        const float dz = z > 0.f ? v : 0.f;
        part1 = fmaf(dz, xv, part1);
        part2 += dz;
        p.dx[at] = round_to<T>(__fmul_rn(dz, a));
      } else {
        p.dx[at] = round_to<T>(v);
      }
    }
    if (RELU_IN) {
      red[t.ty * BN + f32g::col<TN>(t.tx, j)] = part1;
      red[(16 + t.ty) * BN + f32g::col<TN>(t.tx, j)] = part2;
    }
  }
  if (RELU_IN) {
    __syncthreads();
    if (tid < BN && n0 + tid < p.cin) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        s1 += red[r * BN + tid];
        s2 += red[(16 + r) * BN + tid];
      }
      atomicAdd(p.dab + n0 + tid, s1);
      atomicAdd(p.dab + p.cin + n0 + tid, s2);
    }
  }
}

// dW's ring slot: one sub-tile's g (64 pixels x 64 Cout, [pixel][DW_CO +
// PAD]) and its input halo with the prologue ([pixel][DW_CI + PAD], 16-byte
// chunks of 4 Cin); then, for the epilogue, the block's tile in dW's own
// order ([64 Cout][32 Cin x 9 taps + PAD]).
struct DwSmemF32 {
  static constexpr int SG = DW_CO + f32g::PAD;
  static constexpr int G = 64 * SG;
  static constexpr int SH = DW_CI + f32g::PAD;
  static constexpr int SLOT = G + HALO_PX * SH;
  static constexpr int OUT_ROW = DW_CI * 9 + f32g::PAD;
  static constexpr int RING = DW_STAGES * SLOT > DW_CO * OUT_ROW ? DW_STAGES * SLOT : DW_CO * OUT_ROW;
  static constexpr int BIAS = f32g::THREADS * 4;  // dbias: each thread's sums of its 4 Cout
  static constexpr int BYTES = (RING + BIAS) * 4;
};

// dW[co][ci][tap] = sum over pixels of h[p + tap][ci] g[p][co]: for each tap
// the GEMM M = Cin, N = Cout, K = pixels.  A block owns 32 Cin x 64 Cout x
// all 9 taps over its share of the sub-tiles (grid.z splits them); a thread
// 2 Cin (ty, ty + 16) x 4 Cout x 9 taps.  A step is one 8 x 8 sub-tile,
// each pixel's halo and g loaded once for the 9 taps: a thread slides a
// 3 x 3 window of each of its two channels' halos along a pixel row, 3 new
// values a pixel and one float4 of g, for 72 FMAs.  The partial sums meet
// in dW's own order by atomicAdd, each Cout's Cin x 9 taps one run.
template <typename T, bool RELU_IN>
__global__ void __launch_bounds__(f32g::THREADS, 2) convchain_f32_dw_kernel(const F32Args p) {
  using S = DwSmemF32;
  extern __shared__ __align__(16) float fsmem[];
  const int tid = threadIdx.x, ci0 = blockIdx.x * DW_CI, co0 = blockIdx.y * DW_CO;
  const int split = blockIdx.z, splits = gridDim.z;
  const int nsteps = split < p.n_sub ? (p.n_sub - 1 - split) / splits + 1 : 0;
  const bool vec = (p.cout & 3) == 0;
  const f32g::Pos t;
  const bool sums_bias = blockIdx.x == 0;  // the first Cin tile sums g for dbias
  float* bsum = fsmem + S::RING;
  if (sums_bias) *reinterpret_cast<float4*>(bsum + 4 * tid) = make_float4(0.f, 0.f, 0.f, 0.f);

  const bool xvec = (p.cin & 3) == 0;  // 16-byte chunks of x
  // input-halo chunk e of a step: Cin ci0 + c4 .. + 3 of halo pixel q; `at`
  // its first element in x, `n_ok` how many of its channels lie in Cin (0
  // outside the image)
  auto hchunk = [&](int e, int n, int h0, int w0, int& q, int& c4, long long& at, int& n_ok) {
    q = e / (DW_CI / 4);
    c4 = (e % (DW_CI / 4)) * 4;
    const int hh = h0 - 1 + q / HALO_W, ww = w0 - 1 + q % HALO_W;
    const bool in = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
    n_ok = in ? max(0, min(4, p.cin - ci0 - c4)) : 0;
    at = ((static_cast<long long>(n) * p.H + hh) * p.W + ww) * p.cin + ci0 + c4;
  };
  float acc[9][2][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][q][j] = 0.f;

  f32g::ring<DW_STAGES>(
      fsmem, S::SLOT, nsteps,
      [&](float* sl, int i) {
        int n, h0, w0;
        cctc::sub_origin(split + i * splits, p.n_sub, p.tiles_per_img, p.tiles_w, n, h0, w0);
        for (int e = tid; e < 64 * (DW_CO / 4); e += f32g::THREADS) {  // g: 16-byte chunks of a pixel's row
          const int px = e >> 4, c = (e & 15) * 4;
          const int hh = h0 + px / SUB_W, ww = w0 + px % SUB_W, co = co0 + c;
          const bool in = hh < p.H && ww < p.W;
          const long long at = ((static_cast<long long>(n) * p.H + hh) * p.W + ww) * p.cout + co;
          float* d = sl + px * S::SG + c;
          if (vec) {
            const bool ok = in && co < p.cout;
            f32g::cp16(d, ok ? p.g + at : p.g, ok);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = in && co + j < p.cout;
              f32g::cp4(d + j, ok ? p.g + at + j : p.g, ok);
            }
          }
        }
        for (int e = tid; e < HALO_PX * DW_CI / 4; e += f32g::THREADS) {
          int q, c4, n_ok;
          long long at;
          hchunk(e, n, h0, w0, q, c4, at, n_ok);
          float* d = sl + S::G + q * S::SH + c4;
          if (xvec) {
            f32g::cp16(d, n_ok ? p.x + at : p.x, n_ok > 0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) f32g::cp4(d + j, j < n_ok ? p.x + at + j : p.x, j < n_ok);
          }
        }
      },
      [&](float* sl, int i) {  // dbias and the prologue, on the slots this thread copied
        if (sums_bias) {  // g: this thread's 4 Cout of pixels tid / 16 + 16 q
          float4 acc4 = *reinterpret_cast<const float4*>(bsum + 4 * tid);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(sl + ((tid >> 4) + 16 * q) * S::SG + (tid & 15) * 4);
            acc4.x += v.x, acc4.y += v.y, acc4.z += v.z, acc4.w += v.w;
          }
          *reinterpret_cast<float4*>(bsum + 4 * tid) = acc4;
        }
        if (!RELU_IN) return;
        int n, h0, w0;
        cctc::sub_origin(split + i * splits, p.n_sub, p.tiles_per_img, p.tiles_w, n, h0, w0);
#pragma unroll 1
        for (int e = tid; e < HALO_PX * DW_CI / 4; e += f32g::THREADS) {
          int q, c4, n_ok;
          long long at;
          hchunk(e, n, h0, w0, q, c4, at, n_ok);
          float* d = sl + S::G + q * S::SH + c4;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ci = ci0 + c4 + j;
            if (j < n_ok) d[j] = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(d[j], p.ab[ci]), p.ab[p.cin + ci]), 0.f));
          }
        }
      },
      [&](float* sl, int) {
        const float* h0 = sl + S::G + t.ty;  // the thread's two channels, ty and ty + 16
        const float* h1 = h0 + 16;
#pragma unroll 1
        for (int r = 0; r < SUB_W; ++r) {
          float win[2][3][3];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 2; ++kx) {
              win[0][ky][kx] = h0[((r + ky) * HALO_W + kx) * S::SH];
              win[1][ky][kx] = h1[((r + ky) * HALO_W + kx) * S::SH];
            }
#pragma unroll
          for (int c = 0; c < SUB_W; ++c) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              win[0][ky][2] = h0[((r + ky) * HALO_W + c + 2) * S::SH];
              win[1][ky][2] = h1[((r + ky) * HALO_W + c + 2) * S::SH];
            }
            const float4 gq = *reinterpret_cast<const float4*>(sl + (r * SUB_W + c) * S::SG + t.tx * 4);
            const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int kx = 0; kx < 3; ++kx)
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    acc[ky * 3 + kx][q][j] = fmaf(win[q][ky][kx], gv[j], acc[ky * 3 + kx][q][j]);
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int ky = 0; ky < 3; ++ky) {
                win[q][ky][0] = win[q][ky][1];
                win[q][ky][1] = win[q][ky][2];
              }
          }
        }
      });

  // the block's tile in dW's own order, then each Cout's run added
  float* out = fsmem;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < 9; ++k) out[(t.tx * 4 + j) * S::OUT_ROW + (t.ty + 16 * q) * 9 + k] = acc[k][q][j];
  __syncthreads();
  const int run = min(DW_CI, p.cin - ci0) * 9;
  for (int e = tid; e < DW_CO * run; e += f32g::THREADS) {
    const int r = e / run, k = e % run;
    if (co0 + r < p.cout)
      atomicAdd(p.dw + (static_cast<long long>(co0 + r) * p.cin + ci0) * 9 + k, out[r * S::OUT_ROW + k]);
  }
  if (sums_bias && tid < DW_CO && co0 + tid < p.cout) {  // Cout tid: bsum[4 (16 u + tid / 4) + tid % 4]
    float b = 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) b += bsum[4 * (16 * u + tid / 4) + tid % 4];
    atomicAdd(p.dbias + co0 + tid, b);
  }
}

template <bool RELU_IN, int BN> cudaError_t launch_f32_dx(const F32Args& p, cudaStream_t s) {
  static int raised = 0;
  constexpr int bytes = DxSmem<BN>::BYTES;
  if (int err = f32g::opt_in(convchain_f32_dx_kernel<float, RELU_IN, BN>, bytes, raised))
    return static_cast<cudaError_t>(err);
  const dim3 grid((p.n_sub + 1) / 2, (p.cin + BN - 1) / BN);
  convchain_f32_dx_kernel<float, RELU_IN, BN><<<grid, f32g::THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

template <bool RELU_IN> cudaError_t launch_f32(const F32Args& p, int dx_bn, int splits, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dx_bn == 128) err = launch_f32_dx<RELU_IN, 128>(p, s);
  if (dx_bn == 64) err = launch_f32_dx<RELU_IN, 64>(p, s);
  if (dx_bn == 32) err = launch_f32_dx<RELU_IN, 32>(p, s);
  if (dx_bn == 16) err = launch_f32_dx<RELU_IN, 16>(p, s);
  if (err != cudaSuccess) return err;
  static int raised = 0;
  if (int e = f32g::opt_in(convchain_f32_dw_kernel<float, RELU_IN>, DwSmemF32::BYTES, raised))
    return static_cast<cudaError_t>(e);
  const dim3 grid((p.cin + DW_CI - 1) / DW_CI, (p.cout + DW_CO - 1) / DW_CO, splits);
  convchain_f32_dw_kernel<float, RELU_IN><<<grid, f32g::THREADS, DwSmemF32::BYTES, s>>>(p);
  return cudaGetLastError();
}

template <int WG, int BN, bool RELU_IN>
__global__ void __launch_bounds__(WG * 128, 2) convchain_tc_dx_kernel(const cctc::ConvArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cctc::conv_tc_body<WG, BN, true, RELU_IN>(p, smem);
}

struct DwArgs {
  const cctc::bf16* x;   // (N, H, W, Cin)
  const cctc::bf16* g;   // (N, H, W, gpad): the folded cotangent, zero past Cout
  const float* ab;       // (2, Cin) or null
  float* dw;             // (Cout, Cin, 3, 3), zeroed by the caller
  float* dbias;          // (Cout), zeroed by the caller
  int H, W, cin, cout, gpad, tiles_w, tiles_per_img, n_sub;
};

// The dW kernel's block: 64 Cin rows x 64 Cout columns x all 9 taps, three
// warpgroups (one a row of taps, ky), over a share of the sub-tiles.  A
// step is one sub-tile: g (B, 64 pixels x 64 channels, MN-major) and the
// input halo (A, 10 x 10 pixels x 64 channels), each loaded once for the
// 9 taps.
struct DwSmem {
  static constexpr int STAGES = 4;                                // 3 steps in flight
  static constexpr int B_BYTES = cctc::SUB * cctc::ROW;        // 8 KB, 1024-aligned
  static constexpr int STAGE = (B_BYTES + cctc::HALO_BYTES + 1023) / 1024 * 1024;
  // the epilogue's tile in dW's own order: [64 Cout][64 Cin][9 taps], rows
  // of OUT_ROW floats (576 and a pad against bank conflicts, 16-byte rows)
  static constexpr int OUT_ROW = 64 * 9 + 4;
  static constexpr int OUT_BYTES = 64 * OUT_ROW * 4;
  static constexpr int BYTES = (STAGES * STAGE > OUT_BYTES ? STAGES * STAGE : OUT_BYTES) + 1024;
};
constexpr int DW_THREADS = 384;

template <bool RELU_IN>
__global__ void __launch_bounds__(DW_THREADS, 1) convchain_tc_dw_kernel(const DwArgs p) {
  using namespace cctc;
  using S = DwSmem;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ky = warp >> 2, w4 = warp & 3;
  const int ci0 = blockIdx.x * 64, co0 = blockIdx.y * 64;
  const int split = blockIdx.z, splits = gridDim.z;
  const int nsteps = split < p.n_sub ? (p.n_sub - 1 - split) / splits + 1 : 0;  // one sub-tile a step
  const bool vec = (p.cin & 7) == 0;
  const bool sums_bias = blockIdx.x == 0;  // the first Cin tile

  // A slot e of step i's halo: 8 channels of one halo pixel
  auto a_slot = [&](int e, int n, int h0, int w0, bool& ok, long long& pix, int& ch) -> uint32_t {
    const int j = e & 7, q = e >> 3;
    const int hh = h0 - 1 + q / HALO, ww = w0 - 1 + q % HALO;
    ch = ci0 + 8 * j;
    ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ch < p.cin;
    pix = (static_cast<long long>(n) * p.H + hh) * p.W + ww;
    return S::B_BYTES + swz(q, j);
  };
  auto issue = [&](int i) {
    const uint32_t sb = base + (i % S::STAGES) * S::STAGE;
    int n, h0, w0;
    sub_origin(split + i * splits, p.n_sub, p.tiles_per_img, p.tiles_w, n, h0, w0);
    for (int e = tid; e < SUB * 8; e += DW_THREADS) {  // g: 64 pixels x 64 channels, MN-major
      const int j = e & 7, px = e >> 3;
      const int hh = h0 + px / TILE, ww = w0 + px % TILE, co = co0 + 8 * j;
      const uint32_t dst = sb + swz(px, j);
      if (hh < p.H && ww < p.W && co < p.gpad)
        cp_async16(dst, p.g + ((static_cast<long long>(n) * p.H + hh) * p.W + ww) * p.gpad + co, true);
      else
        sts16(dst, make_uint4(0, 0, 0, 0));
    }
    for (int e = tid; e < HALO_PIX * 8; e += DW_THREADS) {  // h: the halo
      bool ok;
      long long pix;
      int ch;
      const uint32_t dst = sb + a_slot(e, n, h0, w0, ok, pix, ch);
      if (vec) {
        if (ok)
          cp_async16(dst, p.x + pix * p.cin + ch, true);
        else
          sts16(dst, make_uint4(0, 0, 0, 0));
        continue;
      }
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool in = ok && ch + k < p.cin;
        const float a = in ? __bfloat162float(p.x[pix * p.cin + ch + k]) : 0.f;
        v[k] = RELU_IN && in ? prologue(a, p.ab[ch + k], p.ab[p.cin + ch + k]) : a;
      }
      sts16(dst, make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7])));
    }
  };

  float acc[3][32];  // taps (ky, 0..2)
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  // dbias: this thread's 16-byte column chunk of g and its rows
  const int bchunk = tid & 7;
  float bacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int i = 0; i < S::STAGES - 1; ++i) {
    if (i < nsteps) issue(i);
    cp_commit();
  }

#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const uint32_t sb = base + (i % S::STAGES) * S::STAGE;
    cp_wait<S::STAGES - 2>();
    if (RELU_IN && vec) {  // the prologue on the slots this thread copied
      int n, h0, w0;
      sub_origin(split + i * splits, p.n_sub, p.tiles_per_img, p.tiles_w, n, h0, w0);
      for (int e = tid; e < HALO_PIX * 8; e += DW_THREADS) {
        bool ok;
        long long pix;
        int ch;
        const uint32_t dst = sb + a_slot(e, n, h0, w0, ok, pix, ch);
        if (ok) sts16(dst, prologue8(lds16(dst), p.ab, p.cin, ch));
      }
    }
    fence_async_smem();
    __syncthreads();
    if (sums_bias) {
      for (int row = tid >> 3; row < SUB; row += DW_THREADS / 8) {
        const uint4 v = lds16(sb + swz(row, bchunk));
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bacc[2 * q] += lo_f(u[q]);
          bacc[2 * q + 1] += hi_f(u[q]);
        }
      }
    }
    // tap (ky, kx): A[m = channel][k = pixel] is the halo shifted by the
    // tap; lane -> pixel row and 16-byte chunk of the four 8x8 matrices
    // (k 0-7 | 8-15) x (m 0-7 | 8-15), transposed by ldmatrix
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int px = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        const int q = (px / TILE + ky) * HALO + px % TILE + kx;
        ldsm_x4_trans(sb + S::B_BYTES + swz(q, 2 * w4 + ((lane >> 3) & 1)), a[kk]);
      }
      fence_acc(acc[kx]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<64, 1>::run(acc[kx], a[kk], smem_desc(sb + kk * 16 * ROW, SUB * ROW, 8 * ROW));
      wg_commit();
      wg_wait<0>();
      fence_acc(acc[kx]);
    }

    if (i + S::STAGES - 1 < nsteps) issue(i + S::STAGES - 1);
    cp_commit();
  }
  cp_wait<0>();

  // The block's dW tile to shared memory in dW's own order (Cout, Cin, 3,
  // 3): for each of its 64 Cout, the 64 Cin x 9 taps are one contiguous
  // run of dW.  Rows g, g + 8 of the warp's 16 are Cin; columns 8j + 2t,
  // + 1 are Cout.
  __syncthreads();  // the ring is free
  float* out = reinterpret_cast<float*>(smem + (base - smem_u32(smem)));
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out[(8 * j + 2 * t + (q & 1)) * S::OUT_ROW + (16 * w4 + g + 8 * (q >> 1)) * 9 + 3 * ky + kx] =
            acc[kx][4 * j + q];
  __syncthreads();
  // each run added to dW: 16 bytes an atomic where Cin % 4 == 0 keeps the
  // runs 16-byte aligned, else element by element
  const int run = min(64, p.cin - ci0) * 9;
  if ((p.cin & 3) == 0) {
    for (int e = tid; e < 64 * (run / 4); e += DW_THREADS) {
      const int r = e / (run / 4), k = 4 * (e % (run / 4));
      if (co0 + r >= p.cout) continue;
      const float4 v = *reinterpret_cast<const float4*>(out + r * S::OUT_ROW + k);
      atomicAdd(reinterpret_cast<float4*>(p.dw + (static_cast<long long>(co0 + r) * p.cin + ci0) * 9 + k), v);
    }
  } else {
    for (int e = tid; e < 64 * run; e += DW_THREADS) {
      const int r = e / run, k = e % run;
      if (co0 + r < p.cout) atomicAdd(p.dw + (static_cast<long long>(co0 + r) * p.cin + ci0) * 9 + k, out[r * S::OUT_ROW + k]);
    }
  }
  if (sums_bias) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (co0 + 8 * bchunk + q < p.cout) atomicAdd(p.dbias + co0 + 8 * bchunk + q, bacc[q]);
  }
}

template <int WG, int BN>
cudaError_t launch_tc_dx(const cctc::ConvArgs& p, int relu_in, cudaStream_t stream) {
  const dim3 grid((p.n_sub + WG - 1) / WG, (p.nch + BN - 1) / BN);
  constexpr int bytes = cctc::ConvSmem<WG, BN, true>::BYTES;
  static unsigned long long raised[2] = {0, 0};
  if (relu_in)
    return cctc::launch_tc(convchain_tc_dx_kernel<WG, BN, true>, raised[1], grid, WG * 128, bytes, p, stream);
  return cctc::launch_tc(convchain_tc_dx_kernel<WG, BN, false>, raised[0], grid, WG * 128, bytes, p, stream);
}

cudaError_t launch_tc_dw(const DwArgs& p, int relu_in, int splits, cudaStream_t stream) {
  const dim3 grid((p.cin + 63) / 64, (p.cout + 63) / 64, splits);
  static unsigned long long raised[2] = {0, 0};
  if (relu_in)
    return cctc::launch_tc(convchain_tc_dw_kernel<true>, raised[1], grid, DW_THREADS, DwSmem::BYTES, p, stream);
  return cctc::launch_tc(convchain_tc_dw_kernel<false>, raised[0], grid, DW_THREADS, DwSmem::BYTES, p, stream);
}

}  // namespace

// The float32 route (bfloat16 takes convchain_bwd_tc), two launches on
// `stream`: dx and d(a, b) (BN = dx_bn, 128, 64, 32 or 16, input channels
// a block: ops/convchain.py:f32_dx_plan), writing the folded g to `g`
// ((N, H, W, Cout) f32); then dW and dbias (32 x 64 x 9-tap blocks, the
// sub-tiles split `splits` ways: f32_dw_plan) into dw laid out (Cout, Cin,
// 3, 3).  wk is the dx weight layout (9, Cout, Cin), the taps flipped
// (ops/convchain.py:kernel_weight_dx); gs the f32
// (2, Cout) cotangents of the sums.  dw, dbias and, with the prologue, dab
// must be zeroed before the call.  Returns the first nonzero
// cudaGetLastError() code after a launch (0 on success).
extern "C" int convchain_bwd(const void* x, const void* wk, const void* y, const void* gy, const void* gs,
                             const void* ab, void* dx, void* dw, void* dbias, void* dab, void* g, int n, int h, int w,
                             int cin, int cout, int relu_in, int dx_bn, int splits, void* stream) {
  const long long tiles_w = (w + cctc::TILE - 1) / cctc::TILE;
  const long long tiles_img = tiles_w * ((h + cctc::TILE - 1) / cctc::TILE);
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || n * tiles_img > (1LL << 30) || splits <= 0 ||
      splits > 65535 || (cin + 15) / 16 > 65535 || (cout + DW_CO - 1) / DW_CO > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Args p{static_cast<const float*>(x), static_cast<const float*>(wk), static_cast<const float*>(y),
                  static_cast<const float*>(gy), static_cast<const float*>(gs), static_cast<const float*>(ab),
                  static_cast<float*>(dx), static_cast<float*>(dab), static_cast<float*>(g), static_cast<float*>(dw),
                  static_cast<float*>(dbias), h, w, cin, cout, static_cast<int>(tiles_w), static_cast<int>(tiles_img),
                  static_cast<int>(n * tiles_img)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(relu_in ? launch_f32<true>(p, dx_bn, splits, s) : launch_f32<false>(p, dx_bn, splits, s));
}

// The bfloat16 route on the tensor cores, two launches on `stream`: dx and
// d(a, b) (tiling (dx_wg, dx_bn) of ops/convchain.py:tc_plan over Cin),
// writing the folded g to `g` ((N, H, W, cout_pad) bf16); then dW and dbias
// (64 x 64 x 9-tap blocks, the sub-tiles split `splits` ways: tc_dw_plan)
// into dw laid out (Cout, Cin, 3, 3).  gs1, gs2 are the f32 (Cout)
// cotangents of the sums.  wk is the forward's weight layout (9, Cout,
// cin_pad) bf16, zero for Cin <= k < cin_pad; cin_pad and cout_pad are Cin
// and Cout rounded up to 64.  Returns as convchain_bwd.
extern "C" int convchain_bwd_tc(const void* x, const void* wk, const void* y, const void* gy, const void* gs1,
                                const void* gs2, const void* ab, void* dx, void* dw, void* dbias, void* dab, void* g,
                                int n, int h, int w, int cin, int cout, int cin_pad, int cout_pad, int relu_in,
                                int dx_wg, int dx_bn, int splits, void* stream) {
  const long long tiles_w = (w + cctc::TILE - 1) / cctc::TILE;
  const long long tiles_img = tiles_w * ((h + cctc::TILE - 1) / cctc::TILE);
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cout_pad % cctc::KC != 0 || cout_pad < cout ||
      cout_pad - cout >= cctc::KC || cin_pad % cctc::KC != 0 || cin_pad < cin || cin_pad - cin >= cctc::KC ||
      n * tiles_img > (1LL << 30) || splits <= 0 || splits > 65535 ||
      (cin + dx_bn - 1) / dx_bn > 65535 || (cout + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cctc::ConvArgs p{};
  p.a0 = static_cast<const cctc::bf16*>(gy);
  p.a1 = static_cast<const cctc::bf16*>(y);
  p.wk = static_cast<const cctc::bf16*>(wk);
  p.ab = static_cast<const float*>(ab);
  p.gs1 = static_cast<const float*>(gs1);
  p.gs2 = static_cast<const float*>(gs2);
  p.x = static_cast<const cctc::bf16*>(x);
  p.out = static_cast<cctc::bf16*>(dx);
  p.sum1 = static_cast<float*>(dab);
  p.sum2 = relu_in ? static_cast<float*>(dab) + cin : nullptr;
  p.gout = static_cast<cctc::bf16*>(g);
  p.H = h;
  p.W = w;
  p.kch = cout;
  p.nch = cin;
  p.kpad = cout_pad;
  p.wstride = cin_pad;
  p.tiles_w = static_cast<int>(tiles_w);
  p.tiles_per_img = static_cast<int>(tiles_img);
  p.n_sub = static_cast<int>(n * tiles_img);
  cudaError_t err = cudaErrorInvalidValue;
  if (dx_wg == 2 && dx_bn == 128) err = launch_tc_dx<2, 128>(p, relu_in, s);
  if (dx_wg == 1 && dx_bn == 128) err = launch_tc_dx<1, 128>(p, relu_in, s);
  if (dx_wg == 2 && dx_bn == 64) err = launch_tc_dx<2, 64>(p, relu_in, s);
  if (dx_wg == 1 && dx_bn == 64) err = launch_tc_dx<1, 64>(p, relu_in, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  DwArgs q{static_cast<const cctc::bf16*>(x), static_cast<const cctc::bf16*>(g), static_cast<const float*>(ab),
           static_cast<float*>(dw), static_cast<float*>(dbias), h, w, cin, cout, cout_pad, p.tiles_w,
           p.tiles_per_img, p.n_sub};
  return static_cast<int>(launch_tc_dw(q, relu_in, splits, s));
}
