// convchain forward for Hopper: one ResBlock layer of the ResUNet as a
// single pass over the activations.
//
//   h  = relu(x*a + b)           optional prologue: the previous layer's
//                                eval BatchNorm and ReLU, f32 affine,
//                                rounded once to the activation type
//   y  = round(conv3x3_SAME(h, W)) + bias     (the add in the activation type)
//   s1[c] = sum y[..., c],  s2[c] = sum y[..., c]^2   (f32, from the rounded y)
//
// Replaces the TPU kernel pssr2_tpu/ops/pallas/convchain.py:_layer_kernel
// (reached through _pallas_layer and fused_conv_layer).  Activations are
// NHWC, float or bfloat16; accumulation is f32.  Any Cin >= 1 and any
// Cout >= 1 are taken; ragged tiles are masked.
//
// What bounds it on an H100 SXM: per layer the work is
// 2*N*H*W*9*Cin*Cout operations against 989 TFLOP/s (bf16 tensor cores) or
// 67 TFLOP/s (f32 outside the tensor cores), and the bytes are x and y
// once each plus the weights, against 3.35 TB/s.  At the ResUNet's shapes
// (Cin, Cout >= 64) the operations bound it by a wide margin.
//
// Design: a direct convolution on the CUDA cores, kept simple and right
// first.  A block owns an 8x8 tile of output pixels of one image and 64
// output channels; 128 threads each hold 8 pixels of one row times 4
// channels (32 f32 sums).  Input channels stream through shared memory in
// chunks of 16: the 10x10 halo (prologue applied once per element, zero
// padding outside the image) and the 9x16x64 weight slice.  Each input row
// read from shared memory serves 3 taps x 8 pixels x 4 channels, each
// float4 of weights 8 pixels x 4 channels.  The stats are reduced over the
// block's rows in shared memory and added to s1/s2 with atomicAdd, so
// their order of summation changes from run to run.  No tensor cores, no
// TMA and no wgmma yet: that is the later work that closes the gap to the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 8;        // output columns per block
constexpr int TC = 64;       // output channels per block
constexpr int KC = 16;       // input channels per shared-memory chunk
constexpr int THREADS = 128; // TH rows x (TC / 4) channel groups
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T and back: the value a T tensor would hold.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, bool RELU_IN>
__global__ void __launch_bounds__(THREADS)
convchain_fwd_kernel(const T* __restrict__ x,        // (N, H, W, Cin)
                     const T* __restrict__ wk,       // (9, Cin, Cout): [ky*3+kx][ci][co]
                     const T* __restrict__ bias,     // (Cout)
                     const float* __restrict__ ab,   // (2, Cin) or null
                     T* __restrict__ y,              // (N, H, W, Cout)
                     float* __restrict__ s1,         // (Cout), zeroed by the caller
                     float* __restrict__ s2,         // (Cout), zeroed by the caller
                     int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ float in_s[KC][HALO_H][HALO_W];
  __shared__ __align__(16) float w_s[KC][9][TC];
  __shared__ float red1[TH][TC];
  __shared__ float red2[TH][TC];

  const int tid = threadIdx.x;
  const int row = tid / (TC / 4);  // 0..TH-1: output row inside the tile
  const int cg = tid % (TC / 4);   // 0..15: group of 4 output channels
  const int n = blockIdx.z;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;

  const T* xn = x + (long long)n * H * W * Cin;

  float acc[TW][4];
#pragma unroll
  for (int p = 0; p < TW; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    // input halo chunk, prologue applied, zeros outside the image and
    // past Cin (the SAME padding pads the post-prologue tensor)
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
        v = to_f32(xn[((long long)hh * W + ww) * Cin + cin]);
        if (RELU_IN) {
          // two roundings, no fused multiply-add: the plain version's order
          const float z = __fadd_rn(__fmul_rn(v, ab[cin]), ab[Cin + cin]);
          v = round_to<T>(fmaxf(z, 0.f));
        }
      }
      in_s[ci][r][c] = v;
    }
    // weight slice for this chunk and this block's output channels
    for (int e = tid; e < KC * 9 * TC; e += THREADS) {
      const int co = e % TC;
      const int rest = e / TC;
      const int tap = rest % 9;
      const int ci = rest / 9;
      const int cin = c0 + ci;
      const int cout = co0 + co;
      float v = 0.f;
      if (cin < Cin && cout < Cout) v = to_f32(wk[((long long)tap * Cin + cin) * Cout + cout]);
      w_s[ci][tap][co] = v;
    }
    __syncthreads();

    const int kc = min(KC, Cin - c0);
    for (int ci = 0; ci < kc; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xin[HALO_W];
#pragma unroll
        for (int j = 0; j < HALO_W; ++j) xin[j] = in_s[ci][row + ky][j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[ci][ky * 3 + kx][cg * 4]);
#pragma unroll
          for (int p = 0; p < TW; ++p) {
            const float xv = xin[p + kx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: round to T, add the bias in T, store, and per-thread stats
  const int hh = h0 + row;
  float part1[4] = {0.f, 0.f, 0.f, 0.f};
  float part2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cout = co0 + cg * 4 + q;
    if (cout >= Cout || hh >= H) continue;
    const float bq = to_f32(bias[cout]);
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      const int ww = w0 + p;
      if (ww >= W) continue;
      const T yt = from_f32<T>(round_to<T>(acc[p][q]) + bq);
      y[(((long long)n * H + hh) * W + ww) * Cout + cout] = yt;
      const float yf = to_f32(yt);
      part1[q] += yf;
      part2[q] = fmaf(yf, yf, part2[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    red1[row][cg * 4 + q] = part1[q];
    red2[row][cg * 4 + q] = part2[q];
  }
  __syncthreads();
  if (tid < TC && co0 + tid < Cout) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      t1 += red1[r][tid];
      t2 += red2[r][tid];
    }
    atomicAdd(&s1[co0 + tid], t1);
    atomicAdd(&s2[co0 + tid], t2);
  }
}

template <typename T>
void launch(const void* x, const void* wk, const void* bias, const void* ab, void* y, void* s1,
            void* s2, int n, int h, int w, int cin, int cout, int relu_in, cudaStream_t stream) {
  const int tiles_w = (w + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (cout + TC - 1) / TC, n);
  const dim3 block(THREADS);
  if (relu_in) {
    convchain_fwd_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<const T*>(bias),
        static_cast<const float*>(ab), static_cast<T*>(y), static_cast<float*>(s1),
        static_cast<float*>(s2), h, w, cin, cout, tiles_w);
  } else {
    convchain_fwd_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<const T*>(bias),
        nullptr, static_cast<T*>(y), static_cast<float*>(s1), static_cast<float*>(s2), h, w,
        cin, cout, tiles_w);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaGetLastError() code
// after the launch (0 on success).  Pointers are device pointers; s1 and
// s2 must be zeroed before the call; the launch goes on `stream` and does
// not synchronise.
extern "C" int convchain_fwd(const void* x, const void* wk, const void* bias, const void* ab,
                             void* y, void* s1, void* s2, int n, int h, int w, int cin, int cout,
                             int dtype, int relu_in, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || n > 65535 ||
      (cout + TC - 1) / TC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, wk, bias, ab, y, s1, s2, n, h, w, cin, cout, relu_in, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, wk, bias, ab, y, s1, s2, n, h, w, cin, cout, relu_in, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
