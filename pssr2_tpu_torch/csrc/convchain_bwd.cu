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
// float32 (convchain_bwd: convchain_bwd_dx_kernel, then
// convchain_bwd_dw_kernel), kept simple first (CUDA cores, no tensor cores,
// no TMA; the tensor cores have no f32 product).  Both fold g from gy, y
// and (gs1, gs2) as they load it; neither writes g to memory:
// - dx is the forward kernel's direct convolution with the roles of the
//   channels swapped: a block owns 8x8 pixels x 64 input channels, 128
//   threads hold 8 pixels x 4 channels each, and the cotangent's output
//   channels stream through shared memory 16 at a time (halo of g, zero
//   outside the image; weights pre-flipped to (9, Cout, Cin) by the
//   wrapper).  The epilogue recomputes the prologue for the ReLU mask and
//   reduces d(a, b) over the block before one atomicAdd per channel.
// - dW is a reduction over all N*H*W pixels.  A block owns 16 input
//   channels x 64 output channels x all 9 taps; its 128 threads each hold
//   one input channel x 8 output channels x 9 taps (72 f32 sums), and it
//   walks a strided share of the 8x8 pixel tiles (grid.z splits the
//   pixels), with the prologue'd input halo and the folded g tile in
//   shared memory.  A thread slides a 3x3 window along a row, so each
//   pixel costs 3 shared loads of h and 2 float4 loads of g for 72
//   multiply-adds.  The blocks' partial sums meet in dW and dbias with
//   atomicAdd, so their order of summation changes from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convchain_tc.cuh"

namespace {

constexpr int TH = 8;        // rows of a pixel tile
constexpr int TW = 8;        // columns of a pixel tile
constexpr int TC = 64;       // channels a block owns (dx: Cin; dW: Cout)
constexpr int KC = 16;       // channels per shared-memory chunk (dx: Cout; dW: Cin)
constexpr int THREADS = 128;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The stat-folded cotangent of one element, as a T tensor holds it:
// g = gy + T(gs1 + 2*y*gs2), in the order the plain version computes it.
template <typename T>
__device__ __forceinline__ float fold(T gy, T y, float gs1, float gs2) {
  const float t = __fadd_rn(gs1, __fmul_rn(2.f * to_f32(y), gs2));
  return round_to<T>(__fadd_rn(to_f32(gy), round_to<T>(t)));
}

template <typename T, bool RELU_IN>
__global__ void __launch_bounds__(THREADS)
convchain_bwd_dx_kernel(const T* __restrict__ x,       // (N, H, W, Cin)
                        const T* __restrict__ wt,      // (9, Cout, Cin): [8-tap] flipped
                        const T* __restrict__ y,       // (N, H, W, Cout)
                        const T* __restrict__ gy,      // (N, H, W, Cout)
                        const float* __restrict__ gs,  // (2, Cout)
                        const float* __restrict__ ab,  // (2, Cin) or null
                        T* __restrict__ dx,            // (N, H, W, Cin)
                        float* __restrict__ dab,       // (2, Cin), zeroed by the caller
                        int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ float g_s[KC][HALO_H][HALO_W];
  __shared__ __align__(16) float w_s[KC][9][TC];
  __shared__ float red1[TH][TC];
  __shared__ float red2[TH][TC];

  const int tid = threadIdx.x;
  const int row = tid / (TC / 4);
  const int cg = tid % (TC / 4);
  const int n = blockIdx.z;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int ci0 = blockIdx.y * TC;

  const long long img = (long long)n * H * W;

  float acc[TW][4];
#pragma unroll
  for (int p = 0; p < TW; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < Cout; c0 += KC) {
    // cotangent halo chunk, folded; zero outside the image and past Cout
    for (int e = tid; e < KC * HALO_H * HALO_W; e += THREADS) {
      const int k = e % KC;
      const int pix = e / KC;
      const int r = pix / HALO_W;
      const int c = pix % HALO_W;
      const int hh = h0 - 1 + r;
      const int ww = w0 - 1 + c;
      const int co = c0 + k;
      float v = 0.f;
      if (co < Cout && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const long long i = (img + (long long)hh * W + ww) * Cout + co;
        v = fold<T>(gy[i], y[i], gs[co], gs[Cout + co]);
      }
      g_s[k][r][c] = v;
    }
    for (int e = tid; e < KC * 9 * TC; e += THREADS) {
      const int c = e % TC;
      const int rest = e / TC;
      const int tap = rest % 9;
      const int k = rest / 9;
      const int co = c0 + k;
      const int ci = ci0 + c;
      float v = 0.f;
      if (co < Cout && ci < Cin) v = to_f32(wt[((long long)tap * Cout + co) * Cin + ci]);
      w_s[k][tap][c] = v;
    }
    __syncthreads();

    const int kc = min(KC, Cout - c0);
    for (int k = 0; k < kc; ++k) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float gin[HALO_W];
#pragma unroll
        for (int j = 0; j < HALO_W; ++j) gin[j] = g_s[k][row + ky][j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[k][ky * 3 + kx][cg * 4]);
#pragma unroll
          for (int p = 0; p < TW; ++p) {
            const float gv = gin[p + kx];
            acc[p][0] = fmaf(gv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(gv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(gv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(gv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: ReLU mask of the recomputed prologue, dx, and d(a, b) sums
  const int hh = h0 + row;
  float part1[4] = {0.f, 0.f, 0.f, 0.f};
  float part2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ci = ci0 + cg * 4 + q;
    if (ci >= Cin || hh >= H) continue;
    const float a = RELU_IN ? ab[ci] : 1.f;
    const float b = RELU_IN ? ab[Cin + ci] : 0.f;
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      const int ww = w0 + p;
      if (ww >= W) continue;
      const long long i = (img + (long long)hh * W + ww) * Cin + ci;
      if (RELU_IN) {
        const float xv = to_f32(x[i]);
        const float z = __fadd_rn(__fmul_rn(xv, a), b);
        const float dz = z > 0.f ? acc[p][q] : 0.f;
        part1[q] = fmaf(dz, xv, part1[q]);
        part2[q] += dz;
        dx[i] = from_f32<T>(__fmul_rn(dz, a));
      } else {
        dx[i] = from_f32<T>(acc[p][q]);
      }
    }
  }
  if (RELU_IN) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red1[row][cg * 4 + q] = part1[q];
      red2[row][cg * 4 + q] = part2[q];
    }
    __syncthreads();
    if (tid < TC && ci0 + tid < Cin) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        t1 += red1[r][tid];
        t2 += red2[r][tid];
      }
      atomicAdd(&dab[ci0 + tid], t1);
      atomicAdd(&dab[Cin + ci0 + tid], t2);
    }
  }
}

template <typename T, bool RELU_IN>
__global__ void __launch_bounds__(THREADS)
convchain_bwd_dw_kernel(const T* __restrict__ x,       // (N, H, W, Cin)
                        const T* __restrict__ y,       // (N, H, W, Cout)
                        const T* __restrict__ gy,      // (N, H, W, Cout)
                        const float* __restrict__ gs,  // (2, Cout)
                        const float* __restrict__ ab,  // (2, Cin) or null
                        float* __restrict__ dw,        // (9, Cin, Cout), zeroed by the caller
                        float* __restrict__ dbias,     // (Cout), zeroed by the caller
                        int H, int W, int Cin, int Cout, int tiles_w, int tiles_per_img,
                        int n_tiles) {
  __shared__ float h_s[KC][HALO_H][HALO_W];
  __shared__ __align__(16) float g_s[TH * TW][TC];

  const int tid = threadIdx.x;
  const int k = tid / (TC / 8);    // 0..KC-1: this thread's input channel in the chunk
  const int cg = tid % (TC / 8);   // 0..7: group of 8 output channels
  const int c0 = blockIdx.x * KC;
  const int co0 = blockIdx.y * TC;
  const bool sums_bias = blockIdx.x == 0 && k == 0;

  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[t][q] = 0.f;
  float bacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int t = blockIdx.z; t < n_tiles; t += gridDim.z) {
    const int n = t / tiles_per_img;
    const int rem = t % tiles_per_img;
    const int h0 = (rem / tiles_w) * TH;
    const int w0 = (rem % tiles_w) * TW;
    const long long img = (long long)n * H * W;

    // input halo with the prologue, zeros outside the image and past Cin
    for (int e = tid; e < KC * HALO_H * HALO_W; e += THREADS) {
      const int ci = e % KC;
      const int pix = e / KC;
      const int r = pix / HALO_W;
      const int c = pix % HALO_W;
      const int hh = h0 - 1 + r;
      const int ww = w0 - 1 + c;
      const int cin = c0 + ci;
      float v = 0.f;
      if (cin < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        v = to_f32(x[(img + (long long)hh * W + ww) * Cin + cin]);
        if (RELU_IN) {
          const float z = __fadd_rn(__fmul_rn(v, ab[cin]), ab[Cin + cin]);
          v = round_to<T>(fmaxf(z, 0.f));
        }
      }
      h_s[ci][r][c] = v;
    }
    // folded cotangent tile, zeros outside the image and past Cout
    for (int e = tid; e < TH * TW * TC; e += THREADS) {
      const int c = e % TC;
      const int pix = e / TC;
      const int hh = h0 + pix / TW;
      const int ww = w0 + pix % TW;
      const int co = co0 + c;
      float v = 0.f;
      if (co < Cout && hh < H && ww < W) {
        const long long i = (img + (long long)hh * W + ww) * Cout + co;
        v = fold<T>(gy[i], y[i], gs[co], gs[Cout + co]);
      }
      g_s[pix][c] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
      float win[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        win[ky][0] = h_s[k][r + ky][0];
        win[ky][1] = h_s[k][r + ky][1];
      }
#pragma unroll
      for (int c = 0; c < TW; ++c) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) win[ky][2] = h_s[k][r + ky][c + 2];
        const float4 ga = *reinterpret_cast<const float4*>(&g_s[r * TW + c][cg * 8]);
        const float4 gb = *reinterpret_cast<const float4*>(&g_s[r * TW + c][cg * 8 + 4]);
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[ky * 3 + kx][q] = fmaf(win[ky][kx], gv[q], acc[ky * 3 + kx][q]);
        if (sums_bias) {
#pragma unroll
          for (int q = 0; q < 8; ++q) bacc[q] += gv[q];
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][0] = win[ky][1];
          win[ky][1] = win[ky][2];
        }
      }
    }
    __syncthreads();
  }

  const int cin = c0 + k;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = co0 + cg * 8 + q;
    if (co >= Cout) continue;
    if (cin < Cin) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) atomicAdd(&dw[((long long)tap * Cin + cin) * Cout + co], acc[tap][q]);
    }
    if (sums_bias) atomicAdd(&dbias[co], bacc[q]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, const void* y, const void* gy, const void* gs,
            const void* ab, void* dx, void* dw, void* dbias, void* dab, int n, int h, int w,
            int cin, int cout, int relu_in, int splits, cudaStream_t stream) {
  const int tiles_w = (w + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const dim3 block(THREADS);
  const dim3 grid_dx(tiles_w * tiles_h, (cin + TC - 1) / TC, n);
  const dim3 grid_dw((cin + KC - 1) / KC, (cout + TC - 1) / TC, splits);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* gyt = static_cast<const T*>(gy);
  const float* gsf = static_cast<const float*>(gs);
  const float* abf = static_cast<const float*>(ab);
  if (relu_in) {
    convchain_bwd_dx_kernel<T, true><<<grid_dx, block, 0, stream>>>(
        xt, static_cast<const T*>(wt), yt, gyt, gsf, abf, static_cast<T*>(dx),
        static_cast<float*>(dab), h, w, cin, cout, tiles_w);
    if (cudaError_t err = cudaGetLastError()) return err;
    convchain_bwd_dw_kernel<T, true><<<grid_dw, block, 0, stream>>>(
        xt, yt, gyt, gsf, abf, static_cast<float*>(dw), static_cast<float*>(dbias), h, w, cin,
        cout, tiles_w, tiles_w * tiles_h, n * tiles_w * tiles_h);
  } else {
    convchain_bwd_dx_kernel<T, false><<<grid_dx, block, 0, stream>>>(
        xt, static_cast<const T*>(wt), yt, gyt, gsf, nullptr, static_cast<T*>(dx), nullptr, h,
        w, cin, cout, tiles_w);
    if (cudaError_t err = cudaGetLastError()) return err;
    convchain_bwd_dw_kernel<T, false><<<grid_dw, block, 0, stream>>>(
        xt, yt, gyt, gsf, nullptr, static_cast<float*>(dw), static_cast<float*>(dbias), h, w,
        cin, cout, tiles_w, tiles_w * tiles_h, n * tiles_w * tiles_h);
  }
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

// The float32 route (bfloat16 takes convchain_bwd_tc).  Launches both
// kernels on `stream` (dx and d(a, b), then dW and dbias) without
// synchronising, and returns the first nonzero cudaGetLastError() code
// after a launch (0 on success).  dw, dbias and, with the prologue, dab
// must be zeroed before the call.  `splits` is the number of blocks that
// share the pixel reduction of each dW tile.
extern "C" int convchain_bwd(const void* x, const void* wt, const void* y, const void* gy,
                             const void* gs, const void* ab, void* dx, void* dw, void* dbias,
                             void* dab, int n, int h, int w, int cin, int cout, int relu_in,
                             int splits, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || n > 65535 || splits <= 0 ||
      splits > 65535 || (cin + TC - 1) / TC > 65535 || (cout + TC - 1) / TC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float>(x, wt, y, gy, gs, ab, dx, dw, dbias, dab, n, h, w, cin, cout, relu_in,
                                        splits, static_cast<cudaStream_t>(stream)));
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
