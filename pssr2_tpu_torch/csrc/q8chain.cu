// One int8 conv layer of the W8A8 serving forward for Hopper:
//
//   acc[n, y, x, co] = sum_{ky, kx, ci} x8[n, y + ky - p, x + kx - p, ci] * w8[co, ci, ky, kx]
//                      (int8 x int8 -> int32, exact; SAME zero padding, K = 3 or 1)
//   z = float(acc) * alpha[co] + beta[co]     (f32; the multiply and the add each rounded)
//   mode 0, mid-chain:  y8 = clip(round_half_even(max(z, 0)), -127, 127) as int8
//                       (ReLU and the requantization to the next layer's scale,
//                       1/sx_next folded into alpha and beta by the caller)
//   mode 1 / 2, out:    y = z as float32 / bfloat16 (the glue dtype)
//
// Replaces the TPU kernel pssr2_tpu/ops/pallas/q8chain.py:_q8_layer_kernel
// (reached through q8_conv_layer), and computes the per-conv int8 sites of
// pssr2_tpu/quant.py (_qconv, the reconstruction's pre-conv) as well: PyTorch
// has no int8 convolution on CUDA.  Activations are NHWC int8, any Cin
// (zero-padded to the kernel's k-tile of 32 channels) and any Cout.
//
// What bounds it on an H100 SXM: 2*N*H*W*K*K*Cin*Cout integer operations
// against 1,979 TOP/s of the int8 tensor cores, and x, y and the weights
// once each against 3.35 TB/s: at the ResUNet's widths the operations.
//
// Design: a direct convolution on the CUDA cores with __dp4a (four int8
// products summed into an int32 a call), simple and right first; the
// int8 tensor cores (mma.sync m16n8k32 or wgmma) are later work.  A block
// owns an 8x16 tile of output pixels of one image and 64 output channels;
// 256 threads each hold 4 adjacent pixels times 8 channels (32 int32
// sums).  Input channels stream through shared memory 32 at a time as
// packed words of 4: the halo tile (pixel stride 9 words, so the 16
// pixels a warp reads fall in 16 banks) and the taps x 8 x 64 weight words
// (the wrapper packs the weights once per call as (K*K, Cin_pad/4, Cout)
// int32).  The epilogue multiplies and adds with __fmul_rn / __fadd_rn, so
// no fused multiply-add changes a rounding, and rounds half to even
// (rintf): the int8 outputs equal the plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;           // output rows per block
constexpr int TW = 16;          // output columns per block
constexpr int TC = 64;          // output channels per block
constexpr int KC = 32;          // input channels per shared-memory chunk
constexpr int KW = KC / 4;      // packed words per pixel and chunk
constexpr int XSTRIDE = KW + 1; // shared-memory words per staged pixel
constexpr int THREADS = 256;    // 32 pixel groups x 8 channel groups

__device__ __forceinline__ void store(int8_t* p, float z) {
  const float q = fminf(fmaxf(rintf(fmaxf(z, 0.0f)), -127.0f), 127.0f);
  *p = static_cast<int8_t>(static_cast<int>(q));
}
__device__ __forceinline__ void store(float* p, float z) { *p = z; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float z) { *p = __float2bfloat16_rn(z); }

template <int K, typename Out>
__global__ void __launch_bounds__(THREADS) q8_conv_kernel(const int8_t* __restrict__ x, const int* __restrict__ wk,
                                                          const float* __restrict__ affine, Out* __restrict__ y,
                                                          int h, int w, int cin, int cout, int cinp, int vec) {
  constexpr int PAD = K / 2;
  constexpr int XH = TH + K - 1, XW = TW + K - 1;
  __shared__ int xs[XH * XW * XSTRIDE];
  __shared__ __align__(16) int ws[K * K * KW * TC];

  const int tiles_w = (w + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int tid = threadIdx.x;
  const int cg = tid % 8, pg = tid / 8;
  const int prow = pg / 4, pcol = (pg % 4) * 4;
  const int8_t* ximg = x + static_cast<long long>(blockIdx.z) * h * w * cin;

  int acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0;

  for (int k0 = 0; k0 < cinp; k0 += KC) {
    for (int i = tid; i < XH * XW * KW; i += THREADS) {
      const int word = i % KW, p = i / KW;
      const int gy = ty0 + p / XW - PAD, gx = tx0 + p % XW - PAD;
      const int c = k0 + 4 * word;
      int v = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && c < cin) {
        const int8_t* src = ximg + (static_cast<long long>(gy) * w + gx) * cin + c;
        if (vec) {
          v = *reinterpret_cast<const int*>(src);
        } else {
          unsigned u = 0;
          for (int b = 0; b < 4 && c + b < cin; ++b) u |= static_cast<unsigned>(static_cast<uint8_t>(src[b])) << (8 * b);
          v = static_cast<int>(u);
        }
      }
      xs[p * XSTRIDE + word] = v;
    }
    for (int i = tid; i < K * K * KW * TC; i += THREADS) {
      const int co = i % TC, rest = i / TC;
      const int word = rest % KW, tap = rest / KW;
      const int gco = co0 + co;
      ws[i] = gco < cout ? wk[(static_cast<long long>(tap) * (cinp / 4) + k0 / 4 + word) * cout + gco] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
#pragma unroll
        for (int word = 0; word < KW; ++word) {
          int xv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[((prow + ky) * XW + pcol + j + kx) * XSTRIDE + word];
          const int4* wp = reinterpret_cast<const int4*>(ws + ((ky * K + kx) * KW + word) * TC + cg * 8);
          const int4 w0 = wp[0], w1 = wp[1];
          const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[j][c] = __dp4a(xv[j], wv[c], acc[j][c]);
        }
      }
    }
    __syncthreads();
  }

  const int gy = ty0 + prow;
  if (gy >= h) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gx = tx0 + pcol + j;
    if (gx >= w) continue;
    Out* row = y + ((static_cast<long long>(blockIdx.z) * h + gy) * w + gx) * cout;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int gco = co0 + cg * 8 + c;
      if (gco < cout) {
        const float z = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][c]), affine[gco]), affine[cout + gco]);
        store(row + gco, z);
      }
    }
  }
}

template <int K>
int launch_k(const void* x, const void* wk, const void* affine, void* y, int n, int h, int w, int cin, int cout,
             int mode, cudaStream_t s) {
  const int cinp = (cin + KC - 1) / KC * KC;
  const int vec = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), (cout + TC - 1) / TC, n);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int* wp = static_cast<const int*>(wk);
  const float* ap = static_cast<const float*>(affine);
  if (mode == 0) {
    q8_conv_kernel<K, int8_t><<<grid, THREADS, 0, s>>>(xp, wp, ap, static_cast<int8_t*>(y), h, w, cin, cout, cinp, vec);
  } else if (mode == 1) {
    q8_conv_kernel<K, float><<<grid, THREADS, 0, s>>>(xp, wp, ap, static_cast<float*>(y), h, w, cin, cout, cinp, vec);
  } else if (mode == 2) {
    q8_conv_kernel<K, __nv_bfloat16><<<grid, THREADS, 0, s>>>(xp, wp, ap, static_cast<__nv_bfloat16*>(y), h, w, cin,
                                                              cout, cinp, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin) int8; wk (K*K, ceil(Cin/32)*8, Cout) int32, packed words of
// 4 input channels (byte b of a word = channel 4*word + b); affine (2, Cout) f32;
// y (N, H, W, Cout): int8 for mode 0, float32 for mode 1, bfloat16 for mode 2.
extern "C" int q8_conv_layer(const void* x, const void* wk, const void* affine, void* y, int n, int h, int w,
                             int cin, int cout, int ksize, int mode, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || n > 65535 || (cout + TC - 1) / TC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ksize == 3) return launch_k<3>(x, wk, affine, y, n, h, w, cin, cout, mode, s);
  if (ksize == 1) return launch_k<1>(x, wk, affine, y, n, h, w, cin, cout, mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
