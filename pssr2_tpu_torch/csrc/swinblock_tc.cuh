// The bf16 Swin block on Hopper's tensor cores (wgmma), forward and
// backward: the route that csrc/swinblock.cu takes for bfloat16 blocks with
// 8 x 8 windows, C a multiple of 16 up to 192, heads of 16 or 32 channels
// and an MLP width a multiple of 16 up to 384 (ops/swinblock.py:route picks
// it, tc_plan sizes the grid).  Replaces, for that route, the TPU kernels
// pssr2_tpu/ops/pallas/swinblock.py:_block_kernel (forward, reached through
// _pallas_block) and _block_bwd_kernel (backward, _pallas_block_bwd) with
// their attention VJP parts.  The rounding is swinblock.cu's (its header
// lists every T(...) of the block and of its VJP).
//
// What bounds it on an H100 SXM: per token about 2 C 3C + 4 n C + 2 C^2 +
// 4 C hidden operations forward (172 k at C 96) and three times that
// backward, against 989 TFLOP/s in bf16; x and the output are 2 C bytes a
// token.  The operations bound it.
//
// The design.  A window's 64 tokens are exactly the M = 64 rows of one
// wgmma.mma_async m64nNk16 (bf16 in, f32 accumulated; the descriptors and
// wrappers of csrc/convchain_tc.cuh): one consumer warpgroup (128 threads)
// owns one window at a time, and a block holds WG = 1 or 2 of them.  The
// grid is persistent: block b takes the window groups b, b + grid, ...,
// and its shared memory holds, per warpgroup, the window's bf16 tiles:
// - tA, tY (and tB in the backward): 64 tokens x C channels, token-major,
//   64-channel chunks of 128-byte rows in the 128-byte swizzle (the A
//   operand of a product, read by ldmatrix);
// - qkvT: the 3C channels of q, k and v transposed, a 128-byte row of 64
//   tokens per channel: q_h is read from it transposed (ldmatrix.trans)
//   as the A operand of the scores, k and v serve as B operands directly
//   (MN-major for the scores q k^T and dp = datt v^T, K-major for p v).
// The weights are read as the module holds them (W_qkv (C, 3C), W_proj,
// W_fc1 (C, hidden), W_fc2 (hidden, C), row-major): 64-row slabs through a
// ring of RING (2 or 3) stages shared by the block's warpgroups, filled by
// cp.async in the 128-byte swizzle, MN-major for the forward's products
// (N padded to a multiple of 64 with zeros) and K-major for the backward's
// dz, dh2, datt and dh1 (so no weight is transposed).  Every stage is
// waited for by a block barrier, which the block's warpgroups share.  A table built at the
// start lists the slabs in the order the products take them, and the ring
// runs ahead through it into the next window group.
//
// Forward (swin_tc_fwd_kernel), per window: the x rows gathered at the
// rolled coordinates by cp.async into tA, LayerNorm'd there in place; qkv =
// h1 W_qkv in N chunks, epilogue T(T(acc) + b) into qkvT; per head the
// scores (one m64n64k16 per 16 channels of the head), the no-max softmax in
// registers (row sums across the quad that holds a row), T(p) packed into
// the A fragments of att_h = T(p) v_h (m64n{16,32}, K = 64 tokens), att_h
// into tA; proj + bias, x s1 + the residual x -> y into tY; LN2 -> h2 into
// tA; the MLP back to back, fc1 in 64-wide chunks of hidden with the GELU
// intermediate packed from the accumulator into the A fragments of fc2; the
// output y + T(T(T(acc) + b2) s2) staged in tA and written to its tokens.
//
// Backward (swin_tc_rows_kernel then swin_tc_dw_kernel).  The rows kernel
// runs the forward above up to h2 again (h1, att and h2 also to bf16
// scratch rows for the weight gradients), then per 64-wide chunk of hidden
// z1 = h2 W1 (MN-major) and dz = gmlp W2^T (K-major), zg and dz1 = T(T(dz)
// GELU'(z1)) in registers and to the scratch; dh2 = dz1 W1^T (K = hidden,
// the window's dz1 rows read back into tB); the LayerNorm-2 backward over
// the staged dh2 in shared memory (dy1 into tY, gproj into tA); datt =
// gproj W_proj^T into tB transposed; per head p again, dp = datt_h v_h^T,
// ds = p32 (dp - rowsum(dp p32)) in registers, dbias += ds (f32
// red.global.add into the gradient, no per-window scratch), dv = T(p^T
// datt_h) and dk = T(T(ds)^T q_h) with p and T(ds) staged in tA and read
// transposed, dq = T(T(ds) k_h) from registers, all three written over the
// head's rows of qkvT; dh1 = dqkv W_qkv^T (A read transposed from qkvT, K
// = 3C) and the LayerNorm-1 backward -> dx.  Its products that span C run
// in 64-column groups, one accumulator of 32 registers at a time, so that
// the kernel fits the 255 registers of a thread without spilling.  The
// bias, LayerNorm and column gradients are summed per block in shared
// memory and added once per block.  swin_tc_dw_kernel then takes the four
// weight gradients as split-K products over the scratch rows, with the
// RDNet tail's weight-gradient tile (rdtc::dw_tile_tc).
//
// Scratch left per token (bf16): LN1(x), att, LN2(y), gmlp, gproj (C
// each), GELU(z1), dz1 (hidden each), dqkv (3C): 8 C + 2 hidden values,
// written once by the rows kernel and read once by the dW launch (dz1
// twice).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blockmath.cuh"
#include "convchain_tc.cuh"
#include "rdtail_tc.cuh"

namespace swtc {

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
using cctc::swz;
using cctc::wg_commit;
using cctc::wg_fence;
using cctc::wg_wait;
using cctc::Wgmma;
using rdtc::elem;
using rdtc::pack8;

constexpr int NT = 64;                 // tokens of a window: the M of one wgmma
constexpr int CHUNK = NT * ROW;        // 8 KB: 64 rows of 128 bytes
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_SLABS = 128;
constexpr int STATS_BYTES = 2048;      // tok, lab, mu1, rstd1, mu2, rstd2, 2 x 64 row means of a window
constexpr float NEG = -100.f;          // the shift mask's value

__device__ __forceinline__ float bfr(float v) { return cctc::bf16r(v); }
__device__ __forceinline__ uint16_t bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

// Shared-memory loads and stores of the tiles.  No "memory" clobber: the
// volatile asm keeps their order among themselves, the barriers (which
// clobber memory) order them against everything else, and the global loads
// of x, g and the biases may be issued ahead of them.
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) { asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v)); }
__device__ __forceinline__ void sts_b16(uint32_t a, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a), "h"(v));
}
__device__ __forceinline__ float lds_bf(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// Element (token r, channel c) of a token-major tile, and its 16-byte column
// j (channels 8j..8j+7).
__device__ __forceinline__ uint32_t tok_at(uint32_t tile, int r, int c) {
  return tile + (c >> 6) * CHUNK + swz(r, (c >> 3) & 7) + (c & 7) * 2;
}
__device__ __forceinline__ uint32_t tok_chunk(uint32_t tile, int r, int j) {
  return tile + (j >> 3) * CHUNK + swz(r, j & 7);
}
// Element (row k, token t) of a transposed tile (a 128-byte row of 64
// tokens per channel).
__device__ __forceinline__ uint32_t tr_at(uint32_t tile, int k, int t) {
  return tile + swz(k, t >> 3) + (t & 7) * 2;
}

// The thread's index read afresh (volatile): the helpers that run once a
// window derive their indices from it, so the compiler does not compute
// them up front and hold them in registers (or local memory) through the
// whole kernel.
__device__ __forceinline__ int tid_now() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ int ctaid_now() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}

// The named barrier of warpgroup wg (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_bar(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory"); }

// The A fragments (m64 x k16, this warp's 16 rows) of k16 step ks of a
// token-major tile, and of rows k0..k0+15 of a transposed tile read
// transposed (A[token][row]).
__device__ __forceinline__ void a_tok(uint32_t tile, int ks, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int m = 16 * w4 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(tile + (ks >> 2) * CHUNK + swz(m, 2 * (ks & 3) + (lane >> 4)), a);
}
__device__ __forceinline__ void a_tr(uint32_t tile, int k0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  ldsm_x4_trans(tile + swz(k0 + (lane & 7) + ((lane >> 4) << 3), 2 * w4 + ((lane >> 3) & 1)), a);
}

// B descriptors: K-major rows n0.. of a 128-byte-row tile at k16 step kk;
// MN-major rows k0..k0+15 (K) of a tile whose rows hold 64 of N.
__device__ __forceinline__ uint64_t b_kmajor(uint32_t tile, int n0, int kk) {
  return smem_desc(tile + n0 * ROW + 32 * kk, 16, 8 * ROW);
}
__device__ __forceinline__ uint64_t b_mnmajor(uint32_t tile, int k0) {
  return smem_desc(tile + k0 * ROW, NT * ROW, 8 * ROW);
}

// acc[64 x 64 ng] += a b for an MN-major B of ng 64-wide groups (ng <= CS):
// the first 32 ng accumulators.
template <int CS>
__device__ __forceinline__ void mma_mn(float (&acc)[32 * CS], const uint32_t (&a)[4], uint64_t desc, int ng) {
  if (CS == 1 || ng == 1) {
    Wgmma<64, 1>::run(*reinterpret_cast<float(*)[32]>(&acc[0]), a, desc);
  } else if (CS == 2 || ng == 2) {
    Wgmma<128, 1>::run(*reinterpret_cast<float(*)[64]>(&acc[0]), a, desc);
  } else {
    Wgmma<192, 1>::run(*reinterpret_cast<float(*)[96]>(&acc[0]), a, desc);
  }
}

// Accumulator groups of the products that span C: all of C in the forward;
// in the backward one (64 columns), the rest in further passes over K,
// which keeps the rows kernel's registers within bounds.
template <bool BWD, int CS> struct Groups {
  static constexpr int NG = BWD ? 1 : CS;
};

// A global pointer taken afresh where it is used: the volatile move keeps
// the compiler from computing it once before the window loop and holding
// it (with the window's offset) in registers through the whole loop.
template <typename T> __device__ __forceinline__ T* opq(T* ptr) {
  T* r;
  asm volatile("mov.b64 %0, %1;\n" : "=l"(r) : "l"(ptr));
  return r;
}

template <int N> __device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The k16 A fragment kk of an m64 accumulator's columns 16kk..16kk+15,
// packed to bf16 (the accumulator layout is the A fragment layout).
template <int N> __device__ __forceinline__ void pack_frag(const float (&d)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack2(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2(d[8 * kk + 6], d[8 * kk + 7]);
}

// Sums of (v0, v1) over the 8 row groups of the warp (lanes of one t), added
// at dst[col], dst[col + 1] (shared memory) by the lanes of row group 0.
__device__ __forceinline__ void col_add(float* dst, int col, bool ok, float v0, float v1) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, off);
    v1 += __shfl_xor_sync(0xffffffffu, v1, off);
  }
  if (ok && (tid_now() & 31) < 4) {
    atomicAdd(dst + col, v0);
    atomicAdd(dst + col + 1, v1);
  }
}
// Sum over the quad that holds a row of the accumulator.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ---- the weight slabs


// One slab of a ring stage.  MN-major (kmajor 0): rows [r0, r0 + 64) x
// columns [c0, c0 + 64 n) of a row-major (rmax x cmax, leading dimension
// ld) matrix, as n groups of 64 rows x 128 swizzled bytes.  K-major: rows
// [r0, r0 + n) x columns [c0, c0 + 64), n rows of 128 swizzled bytes.  Zero
// past rmax and cmax (multiples of 8).
struct Slab {
  const bf16* src;
  int ld, r0, rmax, c0, cmax, n, kmajor, pad;
};
static_assert(sizeof(Slab) == 40, "ops/swinblock.py:tc_smem counts 40 bytes a slab");

__device__ __forceinline__ void issue_slab(const Slab s, uint32_t dst) {  // by value: registers, not shared loads
  if (!s.kmajor) {
    const int per_row = 8 * s.n;
    for (int e = threadIdx.x; e < NT * per_row; e += blockDim.x) {
      const int r = e / per_row, jj = e - r * per_row;
      const int k = s.r0 + r, col = s.c0 + 8 * jj;
      const bool ok = k < s.rmax && col < s.cmax;
      cp_async16(dst + (jj >> 3) * CHUNK + swz(r, jj & 7), ok ? s.src + static_cast<long long>(k) * s.ld + col : s.src,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < s.n * 8; e += blockDim.x) {
      const int r = e >> 3, jj = e & 7;
      const int row = s.r0 + r, k = s.c0 + 8 * jj;
      const bool ok = row < s.rmax && k < s.cmax;
      cp_async16(dst + swz(r, jj), ok ? s.src + static_cast<long long>(row) * s.ld + k : s.src, ok);
    }
  }
}

// The ring: step s uses slab table[s % S] in stage s % nring; acquire()
// waits for it and for every thread to be done with step s - 1, release()
// issues step s + nring - 1 into the stage that step s - 1 used.
// A slab of the table at shared address `at`.
__device__ __forceinline__ Slab load_slab(uint32_t at) {
  uint32_t w[10];
#pragma unroll
  for (int i = 0; i < 10; i += 2)
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(w[i]), "=r"(w[i + 1]) : "r"(at + 4 * i));
  Slab sl;
  sl.src = reinterpret_cast<const bf16*>((static_cast<unsigned long long>(w[1]) << 32) | w[0]);
  sl.ld = static_cast<int>(w[2]);
  sl.r0 = static_cast<int>(w[3]);
  sl.rmax = static_cast<int>(w[4]);
  sl.c0 = static_cast<int>(w[5]);
  sl.cmax = static_cast<int>(w[6]);
  sl.n = static_cast<int>(w[7]);
  sl.kmajor = static_cast<int>(w[8]);
  sl.pad = 0;
  return sl;
}

struct Ring {
  uint32_t base;
  int stage, nring, S, s, total;
  uint32_t table;  // shared address of the slab table
  __device__ __forceinline__ void prologue() {
    for (int i = 0; i < nring - 1; ++i) {
      if (i < total) issue_slab(load_slab(table + (i % S) * sizeof(Slab)), base + i * stage);
      cp_commit();
    }
  }
  __device__ __forceinline__ uint32_t acquire() {
    if (nring == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    fence_async_smem();
    __syncthreads();
    return base + (s % nring) * stage;
  }
  __device__ __forceinline__ void release() {
    const int nx = s + nring - 1;
    if (nx < total) issue_slab(load_slab(table + (nx % S) * sizeof(Slab)), base + (nx % nring) * stage);
    cp_commit();
    ++s;
  }
};

// ---- arguments and shared memory

struct Args {
  const bf16 *x, *gout;
  bf16* out;  // the forward's output, or dx
  const bf16 *ln1_s, *ln1_b, *wqkv, *bqkv, *wproj, *bproj, *ln2_s, *ln2_b, *w1, *b1, *w2, *b2;
  const float* bias;     // (heads, 64, 64)
  const float *s1, *s2;  // (B,) keep-scales, or null
  // backward scratch rows, window by window (row 64 win + t): LN1(x), att,
  // LN2(y), GELU(z1), gmlp, dz1, gproj (C or hidden wide), dqkv (3C)
  bf16 *h1s, *atts, *h2s, *zgs, *gmlps, *dz1s, *gprojs, *dqkvs;
  float *dln1_s, *dln1_b, *dbqkv, *dbproj, *dln2_s, *dln2_b, *db1, *db2, *dbias;
  int B, H, W, C, heads, shift, hidden;
  int nwin, ngroups, wg, nring;
  float eps;
};

__host__ __device__ inline int chunks_of(int c) { return (c + 63) / 64; }
__host__ __device__ inline int per_wg_bytes(int c, bool bwd) {
  return (bwd ? 3 : 2) * chunks_of(c) * CHUNK + 3 * c * ROW + STATS_BYTES;
}
// f32 column sums of the backward: dln1_s, dln1_b (C), dbqkv (3C), dbproj,
// dln2_s, dln2_b (C), db1 (hidden), db2 (C)
__host__ __device__ inline int acc_floats(int c, int hid) { return (9 * c + hid + 3) & ~3; }
__host__ __device__ inline int slab_count(int c, int hid, bool bwd);
__host__ __device__ inline int smem_bytes(int c, int hid, int wg, int nring, bool bwd) {
  return 1024 + nring * chunks_of(c) * CHUNK + wg * per_wg_bytes(c, bwd) + (bwd ? 4 * acc_floats(c, hid) : 0) +
         slab_count(c, hid, bwd) * static_cast<int>(sizeof(Slab));
}

// The slabs in the order the products take them, a window's worth.
template <bool BWD, int CS>
__device__ int build_table(const Args& p, Slab* t) {
  constexpr int NG = Groups<BWD, CS>::NG;
  const int C = p.C, hid = p.hidden, NW = 64 * NG;
  int n = 0;
  auto mn = [&](const bf16* src, int ld, int r0, int rmax, int c0, int cmax, int groups) {
    t[n++] = Slab{src, ld, r0, rmax, c0, cmax, groups, 0, 0};
  };
  auto km = [&](const bf16* src, int ld, int r0, int rmax, int c0, int cmax, int rows) {
    t[n++] = Slab{src, ld, r0, rmax, c0, cmax, rows, 1, 0};
  };
  for (int n0 = 0; n0 < 3 * C; n0 += NW)  // qkv = h1 W_qkv
    for (int k = 0; k < C; k += 64) mn(p.wqkv, 3 * C, k, C, n0, 3 * C, min(NG, (3 * C - n0 + 63) / 64));
  for (int n0 = 0; n0 < C; n0 += NW)  // att W_proj
    for (int k = 0; k < C; k += 64) mn(p.wproj, C, k, C, n0, C, min(NG, (C - n0 + 63) / 64));
  for (int c0 = 0; c0 < hid; c0 += 64) {
    for (int k = 0; k < C; k += 64) mn(p.w1, hid, k, C, c0, hid, 1);  // h2 W1[:, chunk]
    if (!BWD)
      mn(p.w2, C, c0, hid, 0, C, CS);  // zg W2[chunk, :]
    else
      for (int k = 0; k < C; k += 64) km(p.w2, C, c0, hid, k, C, 64);  // gmlp W2[chunk, :]^T
  }
  if (BWD) {
    for (int n0 = 0; n0 < C; n0 += NW) {  // dz1 W1[:, chunk]^T
      const int rows = 64 * min(NG, (C - n0 + 63) / 64);
      for (int c0 = 0; c0 < hid; c0 += 64) km(p.w1, hid, n0, C, c0, hid, rows);
    }
    for (int n0 = 0; n0 < C; n0 += NW) {  // gproj W_proj^T
      const int rows = 64 * min(NG, (C - n0 + 63) / 64);
      for (int k = 0; k < C; k += 64) km(p.wproj, C, n0, C, k, C, rows);
    }
    for (int n0 = 0; n0 < C; n0 += NW) {  // dqkv W_qkv^T
      const int rows = 64 * min(NG, (C - n0 + 63) / 64);
      for (int k = 0; k < 3 * C; k += 64) km(p.wqkv, 3 * C, n0, C, k, 3 * C, rows);
    }
  }
  return n;
}

// The number of slabs build_table lists.
__host__ __device__ inline int slab_count(int c, int hid, bool bwd) {
  const int cs = chunks_of(c), nw = 64 * (bwd ? 1 : cs);
  const int halves = (c + nw - 1) / nw, hc = (hid + 63) / 64;
  const int fwd = (3 * c + nw - 1) / nw * cs + halves * cs + hc * (bwd ? 2 * cs : cs + 1);
  return fwd + (bwd ? halves * (hc + cs + (3 * c + 63) / 64) : 0);
}

// The canonical rows of the window's tokens, read at the rolled
// coordinates, and their group labels in the rolled image (swinblock.cu's
// window_tokens); -1 for a window past the last.
__device__ __forceinline__ void window_tokens(const Args& p, int win, int* tok, int* lab) {
  const int wtid = tid_now() & 127;
  if (wtid >= NT) return;
  if (win >= p.nwin) {
    tok[wtid] = -1;
    lab[wtid] = 0;
    return;
  }
  const int nwx = p.W / 8, nwy = p.H / 8;
  const int b = win / (nwy * nwx), wy = (win / nwx) % nwy, wx = win % nwx;
  const int rr = wy * 8 + wtid / 8, cr = wx * 8 + wtid % 8;
  const int r = (rr + p.shift) % p.H, c = (cr + p.shift) % p.W;
  tok[wtid] = (b * p.H + r) * p.W + c;
  const int lr = rr < p.H - 8 ? 0 : (rr < p.H - p.shift ? 1 : 2);
  const int lc = cr < p.W - 8 ? 0 : (cr < p.W - p.shift ? 1 : 2);
  lab[wtid] = lr * 3 + lc;
}

// The window's rows of a (rows, C) bf16 image at its tokens into a
// token-major tile by cp.async (zeros for a dead window), waited for.
__device__ __forceinline__ void gather_rows(uint32_t tile, const bf16* src, const int* tok, int C) {
  const int n8 = C / 8;
  for (int e = tid_now() & 127; e < NT * n8; e += 128) {
    const int r = e / n8, j = e - r * n8;
    const long long at = tok[r];
    cp_async16(tok_chunk(tile, r, j), at >= 0 ? src + at * C + 8 * j : src, at >= 0);
  }
  cp_commit();
  cp_wait<0>();
}

// A token-major tile's rows to dst (row-major, C wide): row r to dst row
// (rows == null ? base + r : tok[r]); nothing for a dead window.
__device__ __forceinline__ void store_rows(uint32_t tile, bf16* dst, long long base, const int* tok, int C,
                                           bool live) {
  if (!live) return;
  const int n8 = C / 8;
  for (int e = tid_now() & 127; e < NT * n8; e += 128) {
    const int r = e / n8, j = e - r * n8;
    const long long row = tok != nullptr ? static_cast<long long>(tok[r]) : base + r;
    *reinterpret_cast<uint4*>(dst + row * C + 8 * j) = lds128(tok_chunk(tile, r, j));
  }
}

// LayerNorm of a token-major tile's rows into dst (in place allowed):
// h = T((v - mu) (rstd gamma) + beta), the statistics to mu, rstd.  Two
// threads a row, each every second 16-byte column.
__device__ void ln_rows(uint32_t src, uint32_t dst, const bf16* __restrict__ gam, const bf16* __restrict__ bet, int C,
                        float eps, float* mu_out, float* rstd_out) {
  const int wtid = tid_now() & 127, r = wtid >> 1, half = wtid & 1, n8 = C / 8;
  float s = 0.f, s2 = 0.f;
  for (int j = half; j < n8; j += 2) {
    const uint4 v = lds128(tok_chunk(src, r, j));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float a = elem(v, e);
      s += a;
      s2 = fmaf(a, a, s2);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
  const float mu = __fdiv_rn(s, (float)C);
  const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mu, mu)));
  const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
  if (half == 0) {
    mu_out[r] = mu;
    rstd_out[r] = rstd;
  }
  for (int j = half; j < n8; j += 2) {
    const uint4 v = lds128(tok_chunk(src, r, j));
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gam) + j), bv = __ldg(reinterpret_cast<const uint4*>(bet) + j);
    float hv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      hv[e] = __fadd_rn(__fmul_rn(__fsub_rn(elem(v, e), mu), __fmul_rn(rstd, elem(gv, e))), elem(bv, e));
    sts128(tok_chunk(dst, r, j), pack8(hv));
  }
}

// The LayerNorm backward of the window's rows with the statistics mu, rstd
// of the forward: dh (token tile) the cotangent of the normalised rows,
// whose inputs are `in`; o = T(base + T(rstd (dxh - mean(dxh) - xhat
// mean(dxh xhat)))), dxh = dh gamma.  LN2: in = y (tile tY), base = g
// (global rows at tok); o = dy1 back into tY, and gproj = T(dy1 s1) into
// `out` (column sums to sa).  LN1: in = x (global rows at tok), base = dy1
// (tY); o = dx into `out`.  The column sums of dh xhat and dh go to sg,
// sb (shared memory).  Two passes: the row means (two threads a row, into
// mrow), then a thread a 16-byte column and every (128 / (C / 8))-th row,
// its column sums in registers.
template <bool LN2>
__device__ void ln_bwd_rows(uint32_t dh_tile, uint32_t ty, uint32_t out, const bf16* __restrict__ rows, const int* tok,
                            const bf16* __restrict__ gam, int C, const float* mu, const float* rstd, float* mrow,
                            bool scaled, float s1v, float* sa, float* sg, float* sb) {
  const int wtid = tid_now() & 127, n8 = C / 8;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  auto input = [&](int r, int j) {
    if (LN2) return lds128(tok_chunk(ty, r, j));
    return tok[r] >= 0 ? *reinterpret_cast<const uint4*>(rows + static_cast<long long>(tok[r]) * C + 8 * j) : zero4;
  };
  {
    const int r = wtid >> 1, half = wtid & 1;
    const float m = mu[r], rs = rstd[r];
    float s1 = 0.f, sx = 0.f;
    for (int j = half; j < n8; j += 2) {
      const uint4 dv = lds128(tok_chunk(dh_tile, r, j)), iv = input(r, j);
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gam) + j);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dxh = __fmul_rn(elem(dv, e), elem(gv, e));
        s1 += dxh;
        sx = fmaf(dxh, __fmul_rn(__fsub_rn(elem(iv, e), m), rs), sx);
      }
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    sx += __shfl_xor_sync(0xffffffffu, sx, 1);
    if (half == 0) {
      mrow[r] = __fdiv_rn(s1, (float)C);
      mrow[NT + r] = __fdiv_rn(sx, (float)C);
    }
  }
  wg_bar(tid_now() >> 7);
  const int per = 128 / n8, j = wtid % n8, r0 = wtid / n8;
  if (r0 >= per) return;
  const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gam) + j);
  float acc_a[8], acc_g[8], acc_b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc_a[e] = acc_g[e] = acc_b[e] = 0.f;
#pragma unroll 2
  for (int r = r0; r < NT; r += per) {
    const uint4 dv = lds128(tok_chunk(dh_tile, r, j)), iv = input(r, j);
    const uint4 bv = LN2 ? (tok[r] >= 0 ? *reinterpret_cast<const uint4*>(rows + static_cast<long long>(tok[r]) * C + 8 * j)
                                        : zero4)
                         : lds128(tok_chunk(ty, r, j));
    const float m = mu[r], rs = rstd[r], m1 = mrow[r], m2 = mrow[NT + r];
    float o[8], gp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xh = __fmul_rn(__fsub_rn(elem(iv, e), m), rs);
      const float dxh = __fmul_rn(elem(dv, e), elem(gv, e));
      const float d = bfr(__fmul_rn(rs, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh, m2))));
      o[e] = bfr(elem(bv, e) + d);
      gp[e] = scaled ? bfr(__fmul_rn(o[e], s1v)) : o[e];
      acc_a[e] += gp[e];
      acc_g[e] += __fmul_rn(elem(dv, e), xh);
      acc_b[e] += elem(dv, e);
    }
    if (LN2) {
      sts128(tok_chunk(ty, r, j), pack8(o));
      sts128(tok_chunk(out, r, j), pack8(gp));
    } else {
      sts128(tok_chunk(out, r, j), pack8(o));
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (LN2) atomicAdd(sa + 8 * j + e, acc_a[e]);
    atomicAdd(sg + 8 * j + e, acc_g[e]);
    atomicAdd(sb + 8 * j + e, acc_b[e]);
  }
}

// T(acc) of an m64 x 64 accumulator, columns n0 + .. below C, into a
// token tile.
__device__ __forceinline__ void acc_to_tile(const float (&acc)[32], uint32_t tile, int n0, int C) {
  const int tid = tid_now(), lane = tid & 31, w4 = (tid >> 5) & 3, rw = 16 * w4 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= C) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) sts32(tok_at(tile, rw + 8 * i, col), pack2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]));
  }
}

// The f32 probabilities of head h on the accumulator tile: s = q_h k_h^T
// (qkvT, D channels; the bias map loaded while the product runs) plus the
// bias map, -100 between group labels when shifted; p = exp(s) * (1 / sum
// exp(s)), the row sums across the quad that holds a row.
template <int D>
__device__ __forceinline__ void head_probs(float (&S)[32], uint32_t qkvT, int C, int h, const float* __restrict__ bias_h,
                                           const int* lab, bool shifted) {
  uint32_t a[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) a_tr(qkvT, h * D + 16 * kk, a[kk]);
  zero(S);
  fence_acc(S);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) Wgmma<64, 1>::run(S, a[kk], b_mnmajor(qkvT, C + h * D + 16 * kk));
  wg_commit();
  fence_acc(S);
  const int tid = tid_now(), lane = tid & 31, w4 = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  float2 bias[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bias[i][j] = __ldg(reinterpret_cast<const float2*>(bias_h + (16 * w4 + g + 8 * i) * NT + 8 * j + 2 * t));
  wg_wait<0>();
  fence_acc(S);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w4 + g + 8 * i;
    const int lr = lab[r];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = __fadd_rn(S[4 * j + 2 * i + e], e ? bias[i][j].y : bias[i][j].x);
        if (shifted && lr != lab[8 * j + 2 * t + e]) v = __fadd_rn(v, NEG);
        v = expf(v);
        S[4 * j + 2 * i + e] = v;
        sum += v;
      }
    const float inv = __fdiv_rn(1.f, quad_sum(sum));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) S[4 * j + 2 * i + e] = __fmul_rn(S[4 * j + 2 * i + e], inv);
  }
}

// The rows kernel's and the forward's shared body.
template <bool BWD, int CS, int D>
__device__ __forceinline__ void swin_tc_body(const Args& p) {
  constexpr int TILE = CS * CHUNK, NACC = 32 * CS, NG = Groups<BWD, CS>::NG, NACCG = 32 * NG;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - raw);
  const int C = p.C, hid = p.hidden, heads = p.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int per_wg = per_wg_bytes(C, BWD);
  const int ring_bytes = p.nring * TILE;
  const uint32_t my = base + ring_bytes + wg * per_wg;
  const uint32_t tA = my, tY = my + TILE, tB = my + 2 * TILE, qkvT = my + (BWD ? 3 : 2) * TILE;
  uint8_t* stats = gbase + ring_bytes + wg * per_wg + (BWD ? 3 : 2) * TILE + 3 * C * ROW;
  int* tok = reinterpret_cast<int*>(stats);
  int* lab = tok + NT;
  float* mu1 = reinterpret_cast<float*>(lab + NT);
  float* rstd1 = mu1 + NT;
  float* mu2 = rstd1 + NT;
  float* rstd2 = mu2 + NT;
  float* mrow = rstd2 + NT;  // the LayerNorm backwards' row means, 2 x 64
  uint8_t* after = gbase + ring_bytes + p.wg * per_wg;
  float* acc_s = reinterpret_cast<float*>(after);  // the backward's column sums
  Slab* table = reinterpret_cast<Slab*>(after + (BWD ? 4 * acc_floats(C, hid) : 0));
  // the column sums, each taken where it is used: dln1_s, dln1_b, dbqkv,
  // dbproj, dln2_s, dln2_b, db1, db2 at offsets 0, C, 2C, 5C, 6C, 7C, 8C,
  // 8C + hidden of acc_s

  const int n_slabs = slab_count(C, hid, BWD);
  if (tid == 0 && build_table<BWD, CS>(p, table) != n_slabs) __trap();
  if (BWD)
    for (int i = tid; i < acc_floats(C, hid); i += blockDim.x) acc_s[i] = 0.f;
  __syncthreads();
  const int my_groups = p.ngroups > static_cast<int>(blockIdx.x)
                            ? (p.ngroups - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                            : 0;
  Ring ring{base, TILE, p.nring, n_slabs, 0, n_slabs * my_groups, smem_u32(table)};
  ring.prologue();

  const bool scaled = p.s1 != nullptr;
  const int rw = 16 * w4 + g;  // this thread's accumulator rows rw, rw + 8

#pragma unroll 1
  for (int grp = ctaid_now(); grp < p.ngroups; grp += gridDim.x) {
    const int win = grp * p.wg + wg;
    const bool live = win < p.nwin;
#define row0 (static_cast<long long>(win) * NT)  // the window's first scratch row
    const int bimg = live ? win / ((p.H / 8) * (p.W / 8)) : 0;
    const float s1v = scaled ? bfr(p.s1[bimg]) : 1.f, s2v = scaled ? bfr(p.s2[bimg]) : 1.f;
    wg_bar(wg);  // the last window's readers of tok and the tiles are done
    window_tokens(p, win, tok, lab);
    wg_bar(wg);
    gather_rows(tA, opq(p.x), tok, C);
    wg_bar(wg);
    ln_rows(tA, tA, p.ln1_s, p.ln1_b, C, p.eps, mu1, rstd1);
    wg_bar(wg);
    if (BWD) store_rows(tA, opq(p.h1s), row0, nullptr, C, live);

    // ---- qkv = T(T(h1 W_qkv) + b_qkv) into qkvT, in N chunks of 64 NG
#pragma unroll 1
    for (int n0 = 0; n0 < 3 * C; n0 += 64 * NG) {
      const int ng = min(NG, (3 * C - n0 + 63) / 64);
      float acc[NACCG];
      zero(acc);
#pragma unroll 1
      for (int k = 0; k < CS; ++k) {
        const uint32_t slot = ring.acquire();
        const int ks = min(4, (C - 64 * k) / 16);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) a_tok(tA, 4 * k + kk, a[kk]);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) mma_mn<NG>(acc, a[kk], smem_desc(slot + 16 * ROW * kk, NT * ROW, 8 * ROW), ng);
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
        ring.release();
      }
#pragma unroll
      for (int j = 0; j < 8 * NG; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (j >= 8 * ng || col >= 3 * C) continue;
        const float b0 = __bfloat162float(p.bqkv[col]), b1 = __bfloat162float(p.bqkv[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sts_b16(tr_at(qkvT, col, rw + 8 * i), bits(bfr(acc[4 * j + 2 * i]) + b0));
          sts_b16(tr_at(qkvT, col + 1, rw + 8 * i), bits(bfr(acc[4 * j + 2 * i + 1]) + b1));
        }
      }
    }
    fence_async_smem();
    wg_bar(wg);

    // ---- attention, head by head: att_h = T(T(p) v_h) into tA
#pragma unroll 1
    for (int h = 0; h < heads; ++h) {
      float S[32];
      head_probs<D>(S, qkvT, C, h, opq(p.bias) + h * NT * NT, lab, p.shift != 0);
      float O[D / 2];
      zero(O);
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_frag(S, kk, pf[kk]);
      fence_acc(O);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<D, 0>::run(O, pf[kk], b_kmajor(qkvT, 2 * C + h * D, kk));
      wg_commit();
      wg_wait<0>();
      fence_acc(O);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          sts32(tok_at(tA, rw + 8 * i, h * D + 8 * j + 2 * t), pack2(O[4 * j + 2 * i], O[4 * j + 2 * i + 1]));
    }
    wg_bar(wg);
    if (BWD) store_rows(tA, opq(p.atts), row0, nullptr, C, live);

    // ---- y = T(x + T(T(T(att W_proj) + b_proj) s1)) into tY
#pragma unroll 1
    for (int n0 = 0; n0 < C; n0 += 64 * NG) {
      const int ng = min(NG, (C - n0 + 63) / 64);
      float acc[NACCG];
      zero(acc);
#pragma unroll 1
      for (int k = 0; k < CS; ++k) {
        const uint32_t slot = ring.acquire();
        const int ks = min(4, (C - 64 * k) / 16);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) a_tok(tA, 4 * k + kk, a[kk]);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) mma_mn<NG>(acc, a[kk], smem_desc(slot + 16 * ROW * kk, NT * ROW, 8 * ROW), ng);
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
        ring.release();
      }
#pragma unroll
      for (int j = 0; j < 8 * NG; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= C) continue;
        const float b0 = __bfloat162float(p.bproj[col]), b1 = __bfloat162float(p.bproj[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rw + 8 * i;
          float x0 = 0.f, x1 = 0.f;
          if (tok[r] >= 0) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(opq(p.x) + static_cast<long long>(tok[r]) * C + col);
            x0 = __low2float(xv);
            x1 = __high2float(xv);
          }
          float v0 = bfr(bfr(acc[4 * j + 2 * i]) + b0), v1 = bfr(bfr(acc[4 * j + 2 * i + 1]) + b1);
          if (scaled) {
            v0 = bfr(__fmul_rn(v0, s1v));
            v1 = bfr(__fmul_rn(v1, s1v));
          }
          sts32(tok_at(tY, r, col), pack2(x0 + v0, x1 + v1));
        }
      }
    }
    wg_bar(wg);
    // ---- h2 = LN2(y) into tA
    ln_rows(tY, tA, p.ln2_s, p.ln2_b, C, p.eps, mu2, rstd2);
    wg_bar(wg);

    if (!BWD) {
      // ---- the MLP, back to back: zg = T(GELU(T(T(h2 W1) + b1))) in
      // registers, acc2 += zg W2, then out = T(y + T(T(T(acc2) + b2) s2))
      float acc2[NACC];
      zero(acc2);
#pragma unroll 1
      for (int c0 = 0; c0 < hid; c0 += 64) {
        float acc1[32];
        zero(acc1);
#pragma unroll 1
        for (int k = 0; k < CS; ++k) {
          const uint32_t slot = ring.acquire();
          const int ks = min(4, (C - 64 * k) / 16);
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ks) a_tok(tA, 4 * k + kk, a[kk]);
          fence_acc(acc1);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ks) Wgmma<64, 1>::run(acc1, a[kk], smem_desc(slot + 16 * ROW * kk, NT * ROW, 8 * ROW));
          wg_commit();
          wg_wait<0>();
          fence_acc(acc1);
          ring.release();
        }
        uint32_t zf[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const bool ok = col < hid;
          const float b0 = ok ? __bfloat162float(p.b1[col]) : 0.f, b1 = ok ? __bfloat162float(p.b1[col + 1]) : 0.f;
          float z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) z[q] = ok ? bfr(gelu_fast(bfr(bfr(acc1[4 * j + q]) + ((q & 1) ? b1 : b0)))) : 0.f;
          zf[j >> 1][2 * (j & 1)] = pack2(z[0], z[1]);
          zf[j >> 1][2 * (j & 1) + 1] = pack2(z[2], z[3]);
        }
        const int kc = min(4, (hid - c0) / 16);
        const uint32_t slot = ring.acquire();
        fence_acc(acc2);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < kc) mma_mn<CS>(acc2, zf[kk], smem_desc(slot + 16 * ROW * kk, NT * ROW, 8 * ROW), CS);
        wg_commit();
        wg_wait<0>();
        fence_acc(acc2);
        ring.release();
      }
      wg_bar(wg);  // every warp's reads of h2 in tA are done
#pragma unroll
      for (int j = 0; j < 8 * CS; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= C) continue;
        const float b0 = __bfloat162float(p.b2[col]), b1 = __bfloat162float(p.b2[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rw + 8 * i;
          const uint32_t yv = lds32(tok_at(tY, r, col));
          float v0 = bfr(bfr(acc2[4 * j + 2 * i]) + b0), v1 = bfr(bfr(acc2[4 * j + 2 * i + 1]) + b1);
          if (scaled) {
            v0 = bfr(__fmul_rn(v0, s2v));
            v1 = bfr(__fmul_rn(v1, s2v));
          }
          sts32(tok_at(tA, r, col), pack2(lo_f(yv) + v0, hi_f(yv) + v1));
        }
      }
      wg_bar(wg);
      store_rows(tA, opq(p.out), 0, tok, C, live);
      continue;
    }

    // ================= the backward, from here on
    store_rows(tA, opq(p.h2s), row0, nullptr, C, live);
    // ---- gmlp = T(g s2) into tB and its scratch; db2
    {
      const int n8 = C / 8, per = 128 / n8;  // per: the rows a column group's threads share out
      const int wtid = tid_now() & 127, j = wtid % n8, r0 = wtid / n8;
      float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r0 < per) {
#pragma unroll 2
        for (int r = r0; r < NT; r += per) {
          uint4 v = make_uint4(0, 0, 0, 0);
          if (tok[r] >= 0) v = *reinterpret_cast<const uint4*>(opq(p.gout) + static_cast<long long>(tok[r]) * C + 8 * j);
          float f[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            f[e] = scaled ? bfr(__fmul_rn(elem(v, e), s2v)) : elem(v, e);
            cs[e] += f[e];
          }
          const uint4 o = pack8(f);
          sts128(tok_chunk(tB, r, j), o);
          if (live) *reinterpret_cast<uint4*>(opq(p.gmlps) + (row0 + r) * C + 8 * j) = o;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) atomicAdd(opq(acc_s) + 8 * C + hid + 8 * j + e, cs[e]);
      }
    }
    wg_bar(wg);

    // ---- the MLP back, per 64-wide chunk of hidden: z1 = h2 W1, dz = gmlp
    // W2^T, zg and dz1 = T(T(dz) GELU'(z1)) to scratch
#pragma unroll 1
    for (int c0 = 0; c0 < hid; c0 += 64) {
      uint32_t zp[16];  // z1 packed: [2j + i] rows rw + 8i, columns 8j + 2t, + 1
      {
        float acc1[32];
        zero(acc1);
#pragma unroll 1
        for (int k = 0; k < CS; ++k) {
          const uint32_t slot = ring.acquire();
          const int ks = min(4, (C - 64 * k) / 16);
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ks) a_tok(tA, 4 * k + kk, a[kk]);
          fence_acc(acc1);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < ks) Wgmma<64, 1>::run(acc1, a[kk], smem_desc(slot + 16 * ROW * kk, NT * ROW, 8 * ROW));
          wg_commit();
          wg_wait<0>();
          fence_acc(acc1);
          ring.release();
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const bool ok = col < hid;
          const float b0 = ok ? __bfloat162float(p.b1[col]) : 0.f, b1 = ok ? __bfloat162float(p.b1[col + 1]) : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            zp[2 * j + i] = pack2(bfr(acc1[4 * j + 2 * i]) + b0, bfr(acc1[4 * j + 2 * i + 1]) + b1);
        }
      }
      float accd[32];
      zero(accd);
#pragma unroll 1
      for (int k = 0; k < CS; ++k) {
        const uint32_t slot = ring.acquire();
        const int ks = min(4, (C - 64 * k) / 16);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) a_tok(tB, 4 * k + kk, a[kk]);
        fence_acc(accd);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) Wgmma<64, 0>::run(accd, a[kk], smem_desc(slot + 32 * kk, 16, 8 * ROW));
        wg_commit();
        wg_wait<0>();
        fence_acc(accd);
        ring.release();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const bool ok = col < hid;
        float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float z0 = lo_f(zp[2 * j + i]), z1 = hi_f(zp[2 * j + i]);
          const float d0 = ok ? bfr(__fmul_rn(bfr(accd[4 * j + 2 * i]), dgelu_fast(z0))) : 0.f;
          const float d1 = ok ? bfr(__fmul_rn(bfr(accd[4 * j + 2 * i + 1]), dgelu_fast(z1))) : 0.f;
          cs0 += d0;
          cs1 += d1;
          if (ok && live) {
            const long long o = (row0 + rw + 8 * i) * hid + col;
            *reinterpret_cast<__nv_bfloat162*>(opq(p.zgs) + o) = __floats2bfloat162_rn(gelu_fast(z0), gelu_fast(z1));
            *reinterpret_cast<uint32_t*>(opq(p.dz1s) + o) = pack2(d0, d1);
          }
        }
        col_add(opq(acc_s) + 8 * C, col, ok, cs0, cs1);
      }
    }
    // ---- dh2 = T(dz1 W1^T), K = hidden, into tA (h2 is done with): the
    // window's dz1 rows back from the scratch, 64 columns at a time, into tB
    // (so is gmlp)
    __threadfence_block();
#pragma unroll 1
    for (int n0 = 0; n0 < C; n0 += 64) {
      float dh[32];
      zero(dh);
#pragma unroll 1
      for (int c0 = 0; c0 < hid; c0 += 64) {
        wg_bar(wg);  // every warp has read the last chunk of tB
        for (int e = tid_now() & 127; e < NT * 8; e += 128) {
          const int r = e >> 3, j = e & 7;
          const bool ok = live && c0 + 8 * j < hid;
          const bf16* src = opq(p.dz1s);
          cp_async16(tB + swz(r, j), ok ? src + (row0 + r) * hid + c0 + 8 * j : src, ok);
        }
        cp_commit();
        cp_wait<0>();
        wg_bar(wg);
        const int kc = min(4, (hid - c0) / 16);
        const uint32_t slot = ring.acquire();
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < kc) a_tok(tB, kk, a[kk]);
        fence_acc(dh);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < kc) Wgmma<64, 0>::run(dh, a[kk], smem_desc(slot + 32 * kk, 16, 8 * ROW));
        wg_commit();
        wg_wait<0>();
        fence_acc(dh);
        ring.release();
      }
      acc_to_tile(dh, tA, n0, C);
    }
    wg_bar(wg);  // every warp's reads of h2 (tA) and gmlp (tB) are done

    // ---- LayerNorm-2 backward on dh2 (tA): dy1 = T(g + LN2'(dh2)) over y
    // into tY, gproj = T(dy1 s1) into tA in place of dh2; dbproj, dln2_s,
    // dln2_b
    wg_bar(wg);
    {
      float* sums = opq(acc_s);
      ln_bwd_rows<true>(tA, tY, tA, opq(p.gout), tok, p.ln2_s, C, mu2, rstd2, mrow, scaled, s1v, sums + 5 * C,
                        sums + 6 * C, sums + 7 * C);
    }
    wg_bar(wg);
    store_rows(tA, opq(p.gprojs), row0, nullptr, C, live);

    // ---- datt = T(gproj W_proj^T) into tB, transposed
#pragma unroll 1
    for (int n0 = 0; n0 < C; n0 += 64) {
      float acc[32];
      zero(acc);
#pragma unroll 1
      for (int k = 0; k < CS; ++k) {
        const uint32_t slot = ring.acquire();
        const int ks = min(4, (C - 64 * k) / 16);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) a_tok(tA, 4 * k + kk, a[kk]);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) Wgmma<64, 0>::run(acc, a[kk], smem_desc(slot + 32 * kk, 16, 8 * ROW));
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
        ring.release();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= C) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) sts_b16(tr_at(tB, col + e, rw + 8 * i), bits(acc[4 * j + 2 * i + e]));
      }
    }
    fence_async_smem();
    wg_bar(wg);

    // ---- the attention backward, head by head: dq, dk, dv over q, k, v
#pragma unroll 1
    for (int h = 0; h < heads; ++h) {
      float S[32], dp[32];
      head_probs<D>(S, qkvT, C, h, opq(p.bias) + h * NT * NT, lab, p.shift != 0);
      {  // dp = datt_h v_h^T
        uint32_t a[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) a_tr(tB, h * D + 16 * kk, a[kk]);
        zero(dp);
        fence_acc(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) Wgmma<64, 1>::run(dp, a[kk], b_mnmajor(qkvT, 2 * C + h * D + 16 * kk));
        wg_commit();
        wg_wait<0>();
        fence_acc(dp);
      }
      // ds = p32 (dp - rowsum(dp p32)); dbias += ds; p (bf16) into tA
      float* dbias_h = opq(p.dbias) + h * NT * NT;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rw + 8 * i;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) rs += __fmul_rn(dp[4 * j + 2 * i + e], S[4 * j + 2 * i + e]);
        rs = quad_sum(rs);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = 4 * j + 2 * i;
          dp[q] = __fmul_rn(S[q], __fsub_rn(dp[q], rs));
          dp[q + 1] = __fmul_rn(S[q + 1], __fsub_rn(dp[q + 1], rs));
          if (live) atomicAdd(reinterpret_cast<float2*>(dbias_h + r * NT + 8 * j + 2 * t), make_float2(dp[q], dp[q + 1]));
          sts32(tA + swz(r, j) + 4 * t, pack2(S[q], S[q + 1]));
        }
      }
      wg_bar(wg);
      float dv[D / 2], dq[D / 2], dk[D / 2];
      zero(dv);
      zero(dq);
      zero(dk);
      uint32_t dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_frag(dp, kk, dsf[kk]);
      {  // dv = T(p^T datt_h), dq = T(T(ds) k_h)
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_tr(tA, 16 * kk, a[kk]);
        fence_acc(dv);
        fence_acc(dq);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<D, 0>::run(dv, a[kk], b_kmajor(tB, h * D, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<D, 0>::run(dq, dsf[kk], b_kmajor(qkvT, C + h * D, kk));
        wg_commit();
        wg_wait<0>();
        fence_acc(dv);
        fence_acc(dq);
      }
      wg_bar(wg);  // every warp has read p
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sts32(tA + swz(rw + 8 * i, j) + 4 * t, dsf[j >> 1][2 * (j & 1) + i]);
      wg_bar(wg);
      {  // dk = T(T(ds)^T q_h)
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_tr(tA, 16 * kk, a[kk]);
        fence_acc(dk);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<D, 0>::run(dk, a[kk], b_kmajor(qkvT, h * D, kk));
        wg_commit();
        wg_wait<0>();
        fence_acc(dk);
      }
      wg_bar(wg);  // every warp's products over the head's rows of qkvT are done
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = h * D + 8 * j + 2 * t + e, r = rw + 8 * i, q = 4 * j + 2 * i + e;
            sts_b16(tr_at(qkvT, c, r), bits(dq[q]));
            sts_b16(tr_at(qkvT, C + c, r), bits(dk[q]));
            sts_b16(tr_at(qkvT, 2 * C + c, r), bits(dv[q]));
          }
      fence_async_smem();
      wg_bar(wg);
    }

    // ---- dqkv: dbqkv (row sums of qkvT) and the scratch rows
    for (int row = tid_now() & 127; row < 3 * C; row += 128) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 v = lds128(qkvT + swz(row, j));
#pragma unroll
        for (int e = 0; e < 8; ++e) s += elem(v, e);
      }
      atomicAdd(opq(acc_s) + 2 * C + row, s);
    }
    if (live) {
      const int n8 = 3 * C / 8;
      for (int e = tid_now() & 127; e < NT * n8; e += 128) {
        const int r = e & (NT - 1), j = e >> 6;
        float f[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) f[q] = lds_bf(tr_at(qkvT, 8 * j + q, r));
        *reinterpret_cast<uint4*>(opq(p.dqkvs) + (row0 + r) * 3 * C + 8 * j) = pack8(f);
      }
    }

    // ---- dh1 = T(dqkv W_qkv^T), K = 3C; the LayerNorm-1 backward: dx =
    // T(dy1 + T(LN1'(dh1))) staged in tA; dln1_s, dln1_b
#pragma unroll 1
    for (int n0 = 0; n0 < C; n0 += 64) {
      float acc[32];
      zero(acc);
#pragma unroll 1
      for (int k = 0; k < 3 * C; k += 64) {
        const uint32_t slot = ring.acquire();
        const int ks = min(4, (3 * C - k) / 16);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) a_tr(qkvT, k + 16 * kk, a[kk]);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) Wgmma<64, 0>::run(acc, a[kk], smem_desc(slot + 32 * kk, 16, 8 * ROW));
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
        ring.release();
      }
      acc_to_tile(acc, tB, n0, C);  // dh1 = T(acc): tB's datt is done with
    }
    wg_bar(wg);
    {
      float* sums = opq(acc_s);
      ln_bwd_rows<false>(tB, tY, tA, opq(p.x), tok, p.ln1_s, C, mu1, rstd1, mrow, false, 1.f, nullptr, sums, sums + C);
    }
    wg_bar(wg);
    store_rows(tA, opq(p.out), 0, tok, C, live);
  }
#undef row0
  cp_wait<0>();

  if (BWD) {  // the block's column sums, once
    __syncthreads();
    float* dst[8] = {p.dln1_s, p.dln1_b, p.dbqkv, p.dbproj, p.dln2_s, p.dln2_b, p.db1, p.db2};
    const int off[9] = {0, C, 2 * C, 5 * C, 6 * C, 7 * C, 8 * C, 8 * C + hid, 9 * C + hid};
#pragma unroll
    for (int q = 0; q < 8; ++q)
      for (int i = tid; i < off[q + 1] - off[q]; i += blockDim.x) atomicAdd(dst[q] + i, acc_s[off[q] + i]);
  }
}

template <int CS, int D>
__global__ void __launch_bounds__(256, 1) swin_tc_fwd_kernel(const Args p) {
  swin_tc_body<false, CS, D>(p);
}

template <int CS, int D>
__global__ void __launch_bounds__(256, 1) swin_tc_rows_kernel(const Args p) {
  swin_tc_body<true, CS, D>(p);
}

// ------------------------------------------------------ weight gradients

// dW_qkv = LN1(x)^T dqkv, dW_proj = att^T gproj, dW1 = LN2(y)^T dz1, dW2 =
// GELU(z1)^T gmlp over the scratch rows: the tiles of the four jobs one
// after the other on grid.x, the rows split over grid.y.
struct DwArgs4 {
  rdtc::DwJob job[4];
  int M, rows_per_split;
};

__global__ void __launch_bounds__(128) swin_tc_dw_kernel(const DwArgs4 p) {
  int tile = blockIdx.x, j = 0;
  while (j < 3 && tile >= p.job[j].tiles) tile -= p.job[j++].tiles;
  const int k_begin = blockIdx.y * p.rows_per_split;
  rdtc::dw_tile_tc(p.job[j], tile, k_begin, min(p.M, k_begin + p.rows_per_split));
}

// ------------------------------------------------------------ host

template <typename Kernel>
cudaError_t launch_body(Kernel kernel, unsigned long long& raised, const Args& p, int grid, int bytes,
                        cudaStream_t stream) {
  if (cudaError_t err = rdtc::allow_smem(kernel, raised)) return err;
  kernel<<<grid, 128 * p.wg, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int CS, int D> cudaError_t launch_fwd(const Args& p, int grid, int bytes, cudaStream_t stream) {
  static unsigned long long raised = 0;
  return launch_body(swin_tc_fwd_kernel<CS, D>, raised, p, grid, bytes, stream);
}

template <int CS, int D> cudaError_t launch_rows(const Args& p, int grid, int bytes, cudaStream_t stream) {
  static unsigned long long raised = 0;
  return launch_body(swin_tc_rows_kernel<CS, D>, raised, p, grid, bytes, stream);
}

inline cudaError_t launch_dw(const DwArgs4& p, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const int splits = (p.M + p.rows_per_split - 1) / p.rows_per_split;
  if (splits > 65535) return cudaErrorInvalidValue;
  if (cudaError_t err = rdtc::allow_smem(swin_tc_dw_kernel, raised)) return err;
  int tiles = 0;
  for (int i = 0; i < 4; ++i) tiles += p.job[i].tiles;
  swin_tc_dw_kernel<<<dim3(tiles, splits), 128, rdtc::DwCfg::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace swtc
