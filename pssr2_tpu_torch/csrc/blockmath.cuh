// Device code that the whole-Swin-block kernels (swinblock.cu) and the RDNet
// block-tail kernels (rdtail.cu) share: conversions and rounding to the
// compute type T (float or bfloat16), GELU and its derivative rounded as
// ops/blockmath.py rounds them, and the MLP rows tile of both f32
// CUDA-core backwards on csrc/f32gemm.cuh (z1 = h W1, GELU, dz = g W2^T,
// dz1).  Both kernels' plain versions hold them to these exact operations.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "f32gemm.cuh"

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

// ---- the MLP rows tile of the f32 backwards (csrc/f32gemm.cuh)

// A tile of 128 rows x BN columns of I: z1 = h W1 (K = C), then dz = g
// W2^T (K = G) in the same accumulators.  Between them zg = T(GELU(T(T(z1)
// + b1))) is stored and GELU'(z1) parked in shared memory, a thread's own
// slots; then dz1 = T(T(dz) GELU'(z1)) is stored row-major and, where dz1T
// is not null, transposed (I, M) (a later product's K-major operand), and
// summed into db1.  h and g are (M, C) and (M, G) rows, W1 (C, I) and W2
// (I, G) as they lie; every value f32, rounded to T where the plain
// version rounds.
struct MlpRowsArgs {
  const float *h, *w1, *b1, *g, *w2;
  float *zg, *dz1, *dz1T, *db1;
  int M, C, I, G, w1_vec, m_vec;
};

constexpr int MLP_ROWS_STAGES = 2;  // ring slots (the park takes the rest)

template <int BN> struct MlpRowsSmem {
  static constexpr int RING = MLP_ROWS_STAGES * f32g::Gemm<BN>::SLOT;  // floats
  static constexpr int PARK = 8 * (BN / 16) * f32g::THREADS;           // floats: GELU'(z1), a thread's 8 x TN
  static constexpr int BYTES = (RING + PARK) * 4;
};

// The tile (blockIdx.x, blockIdx.y) of the grid (M / 128, I / BN).
template <typename T, int BN> __device__ __forceinline__ void mlp_rows_tile(const MlpRowsArgs& p) {
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  float* park = smem + MlpRowsSmem<BN>::RING;
  const int m0 = blockIdx.x * f32g::BM, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const f32g::Pos t;
  float acc[8][TN];
  f32g::zero(acc);
  // h's rows are K-contiguous; W1 (C, I) holds each K row's I contiguous
  f32g::gemm<BN, MLP_ROWS_STAGES, true, false>(smem, f32g::Operand{p.h, p.C, p.M, 0},
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
  f32g::gemm<BN, MLP_ROWS_STAGES, true, true>(smem, f32g::Operand{p.g, p.G, p.M, 0},
                                              f32g::Operand{p.w2, p.G, p.I, 0}, m0, n0, 0, p.G, acc, t);
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
  if (p.dz1T != nullptr) {  // a thread's rows are two runs of 4
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + f32g::col<TN>(t.tx, j);
      if (c >= p.I) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = m0 + t.row(4 * u);
        float* out = p.dz1T + static_cast<long long>(c) * p.M + r;
        if (p.m_vec && r + 3 < p.M) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[4 * u][j], acc[4 * u + 1][j], acc[4 * u + 2][j], acc[4 * u + 3][j]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (r + q < p.M) out[q] = acc[4 * u + q][j];
        }
      }
    }
  }
  f32g::col_sums<TN>(colsum, smem, t);
  if (tid < BN && n0 + tid < p.I) atomicAdd(p.db1 + n0 + tid, smem[16 * BN + tid]);
}

}  // namespace
