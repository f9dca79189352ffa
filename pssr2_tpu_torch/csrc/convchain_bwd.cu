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
// Launch 1 (convchain_bwd_dx_kernel) computes dx and d(a, b); launch 2
// (convchain_bwd_dw_kernel) computes dW and dbias.  Both fold g from gy, y
// and (gs1, gs2) as they load it; neither writes g to memory.
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
// Design, kept simple first (CUDA cores, no tensor cores, no TMA):
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

namespace {

constexpr int TH = 8;        // rows of a pixel tile
constexpr int TW = 8;        // columns of a pixel tile
constexpr int TC = 64;       // channels a block owns (dx: Cin; dW: Cout)
constexpr int KC = 16;       // channels per shared-memory chunk (dx: Cout; dW: Cin)
constexpr int THREADS = 128;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches both kernels on `stream` (dx
// and d(a, b), then dW and dbias) without synchronising, and returns the
// first nonzero cudaGetLastError() code after a launch (0 on success).  dw, dbias and, with
// the prologue, dab must be zeroed before the call.  `splits` is the
// number of blocks that share the pixel reduction of each dW tile.
extern "C" int convchain_bwd(const void* x, const void* wt, const void* y, const void* gy,
                             const void* gs, const void* ab, void* dx, void* dw, void* dbias,
                             void* dab, int n, int h, int w, int cin, int cout, int dtype,
                             int relu_in, int splits, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || n > 65535 || splits <= 0 ||
      splits > 65535 || (cin + TC - 1) / TC > 65535 || (cout + TC - 1) / TC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(x, wt, y, gy, gs, ab, dx, dw, dbias, dab, n, h, w, cin, cout, relu_in, splits, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, wt, y, gy, gs, ab, dx, dw, dbias, dab, n, h, w,
                                                  cin, cout, relu_in, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
