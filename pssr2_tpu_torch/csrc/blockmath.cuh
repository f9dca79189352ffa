// Device code that the whole-Swin-block kernels (swinblock.cu) and the RDNet
// block-tail kernels (rdtail.cu) share: conversions and rounding to the
// compute type T (float or bfloat16), GELU and its derivative rounded as
// ops/blockmath.py rounds them, and one 64 x 64 tile of a weight gradient
// A^T B summed over a range of rows (the f32 Swin block's; the RDNet tail's
// f32 weight gradients run on csrc/f32gemm.cuh).  Both kernels' plain
// versions hold them to these exact operations.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- GELU and its derivative, in f32, rounded as ops/blockmath.py rounds
// them (every product and sum on its own, no fused multiply-add)

__device__ __forceinline__ float erf_f32(float x) {
  const float a[7] = {-2.72614225801306e-10f, 2.77068142495902e-08f, -2.10102402082508e-06f,
                      -5.69250639462346e-05f, -7.34990630326855e-04f, -2.95459980854025e-03f,
                      -1.60960333262415e-02f};
  const float b[5] = {-1.45660718464996e-05f, -2.13374055278905e-04f, -1.68282697438203e-03f,
                      -7.37332916720468e-03f, -1.42647390514189e-02f};
  const float xc = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = __fmul_rn(xc, xc);
  float pa = a[0], pb = b[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) pa = __fadd_rn(__fmul_rn(pa, x2), a[i]);
#pragma unroll
  for (int i = 1; i < 5; ++i) pb = __fadd_rn(__fmul_rn(pb, x2), b[i]);
  return __fdiv_rn(__fmul_rn(xc, pa), pb);
}

constexpr float SQRT_HALF = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;
__device__ __constant__ float GELU_S[8] = {
    0.398714550644521f,      -0.0659565049580834f,     0.009545222431626374f,
    -0.0010175056451836898f, 7.648234117739626e-05f,   -3.7887493429360835e-06f,
    1.0968829398043447e-07f, -1.3937041721878255e-09f};
// k * GELU_S[k], k = 1..7: each product taken in double and rounded once
__device__ __constant__ float GELU_SP[7] = {
    float(1 * -0.0659565049580834),     float(2 * 0.009545222431626374),
    float(3 * -0.0010175056451836898),  float(4 * 7.648234117739626e-05),
    float(5 * -3.7887493429360835e-06), float(6 * 1.0968829398043447e-07),
    float(7 * -1.3937041721878255e-09)};

template <int N> __device__ __forceinline__ float poly_u(const float* cs, float u) {
  float acc = cs[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = __fadd_rn(__fmul_rn(acc, u), cs[i]);
  return acc;
}

__device__ __forceinline__ float gelu_exact(float z) {
  return __fmul_rn(__fmul_rn(0.5f, z), __fadd_rn(1.f, erf_f32(__fmul_rn(z, SQRT_HALF))));
}

__device__ __forceinline__ float dgelu_exact(float z) {
  const float phi = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, z), z)), INV_SQRT_2PI);
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.f, erf_f32(__fmul_rn(z, SQRT_HALF)))), __fmul_rn(z, phi));
}

__device__ __forceinline__ float gelu_fast(float z) {
  const float xc = fminf(fmaxf(z, -4.f), 4.f);
  const float u = __fmul_rn(xc, xc);
  const float y = __fadd_rn(__fmul_rn(0.5f, xc), __fmul_rn(u, poly_u<8>(GELU_S, u)));
  return z > 4.f ? z : (z < -4.f ? 0.f : y);
}

__device__ __forceinline__ float dgelu_fast(float z) {
  const float xc = fminf(fmaxf(z, -4.f), 4.f);
  const float u = __fmul_rn(xc, xc);
  const float s = __fadd_rn(poly_u<8>(GELU_S, u), __fmul_rn(u, poly_u<7>(GELU_SP, u)));
  const float g = __fadd_rn(0.5f, __fmul_rn(__fmul_rn(2.f, xc), s));
  return z > 4.f ? 1.f : (z < -4.f ? 0.f : g);
}

template <typename T> __device__ __forceinline__ float gelu(float z) {
  return std::is_same<T, float>::value ? gelu_exact(z) : gelu_fast(z);
}
template <typename T> __device__ __forceinline__ float dgelu(float z) {
  return std::is_same<T, float>::value ? dgelu_exact(z) : dgelu_fast(z);
}
// gelu<T>(z) and dgelu<T>(z), the exact pair sharing one erf: the same
// operations, so the same values
template <typename T> __device__ __forceinline__ void gelu_dgelu(float z, float& g, float& dg) {
  if constexpr (std::is_same<T, float>::value) {
    const float e1 = __fadd_rn(1.f, erf_f32(__fmul_rn(z, SQRT_HALF)));
    const float phi = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, z), z)), INV_SQRT_2PI);
    g = __fmul_rn(__fmul_rn(0.5f, z), e1);
    dg = __fadd_rn(__fmul_rn(0.5f, e1), __fmul_rn(z, phi));
  } else {
    g = gelu_fast(z);
    dg = dgelu_fast(z);
  }
}

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---- one tile of a weight gradient

constexpr int DW = 64;           // tile edge
constexpr int DW_KC = 16;        // rows of A and B staged per step
constexpr int DW_THREADS = 256;  // 16 x 16 threads, a 4 x 4 piece of the tile each

// out (mo x no, f32) += A^T B, A (rows x mo) and B (rows x no) row-major in T.
template <typename T> struct DwJob {
  const T* a;
  const T* b;
  float* out;
  int mo, no, tiles_n, tiles;
};

// Tile `tile` of job p over rows [k_begin, k_end), added to p.out with
// atomicAdd; the block has DW_THREADS threads.
template <typename T>
__device__ __forceinline__ void dw_tile(const DwJob<T>& p, int tile, int k_begin, int k_end) {
  __shared__ __align__(16) float as[DW_KC][DW];
  __shared__ __align__(16) float bs[DW_KC][DW];
  if (k_begin >= k_end) return;
  const int m0 = (tile / p.tiles_n) * DW, n0 = (tile % p.tiles_n) * DW;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += DW_KC) {
    float ra[4], rb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + DW_THREADS * q;
      const int k = k0 + e / DW, c = e % DW;
      ra[q] = (k < k_end && m0 + c < p.mo) ? to_f32(p.a[(long long)k * p.mo + m0 + c]) : 0.f;
      rb[q] = (k < k_end && n0 + c < p.no) ? to_f32(p.b[(long long)k * p.no + n0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + DW_THREADS * q;
      as[e / DW][e % DW] = ra[q];
      bs[e / DW][e % DW] = rb[q];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DW_KC; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.mo) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < p.no) atomicAdd(p.out + (long long)m * p.no + c, acc[i][j]);
    }
  }
}

}  // namespace
