// The bf16 convchain kernels on Hopper's tensor cores: the pieces that the
// forward (csrc/convchain.cu) and the backward (csrc/convchain_bwd.cu)
// share, and the implicit-GEMM mainloop of the forward and of the
// backward's dx launch.
//
// A conv layer is an implicit GEMM: M = output pixels, N = output channels
// of the pass, K = 9 taps x the input channels of the pass, walked as
// (chunk of 64 input channels, tap).  No im2col is written: for each chunk
// a block loads the (8+2) x (8+2) halo of each of its 8 x 8 pixel
// sub-tiles once into shared memory, 128 bytes a pixel, applies the
// operand's prologue there (the BatchNorm affine + ReLU of the forward, the
// stat fold of the cotangent for dx), and each of the 9 taps is then a
// shift of the row addresses that ldmatrix reads.  The 16-byte column
// chunks of each halo row are XOR-swizzled by the row's index, so the
// 8 rows of one ldmatrix fall on distinct banks.
//
// The weights are the forward's layout (9, Cout, Cin_pad), bf16, built
// once by the wrapper.  One B tile per (chunk, tap) comes through a ring of
// STAGES tiles filled by cp.async in the 128-byte swizzled layout that
// wgmma's descriptor reads; the next tiles are in flight while the current
// one multiplies.  The forward reads a tile K-major ([Cout][64 Cin]); dx
// reads the same array MN-major ([64 Cout][Cin]) at the flipped tap 8 - t,
// so the backward needs no second weight layout.  The products are
// wgmma.mma_async m64nNk16 (N = 64 or 128), bf16 in, f32 accumulated,
// with A from registers and B from shared memory.  Each warpgroup owns one
// 8 x 8 sub-tile (64 rows of M); a block holds WG = 1 or 2 warpgroups and
// BN = 64 or 128 channels of N.  The host's planner (ops/convchain.py:
// tc_plan) picks WG and BN so that the grid fills the 132 SMs.
//
// Policies of the shared mainloop:
// - the forward: A = x with the optional prologue h = T(relu(x*a + b))
//   (__fmul_rn, __fadd_rn, one rounding: the plain version's order);
//   epilogue y = T(T(acc) + bias) and the f32 sums of y and y^2 from the
//   rounded y, reduced over the block by warp shuffles and shared memory,
//   one atomicAdd per channel and block;
// - dx: A = g = gy + T(gs1 + 2*y*gs2), B = the weights at the flipped
//   taps (a transposed conv: N = Cin, K = 9 x Cout); epilogue
//   the ReLU mask of the recomputed prologue, dx = T(dz*a) and the d(a, b)
//   sums.  The blocks of the first N tile also write g, for the dW launch.
//
// The K sum of each output is whole in one block (no split): the epilogue
// rounds it once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cctc {

using bf16 = __nv_bfloat16;

constexpr int TILE = 8;                  // a sub-tile is TILE x TILE output pixels
constexpr int SUB = TILE * TILE;         // 64 pixels: the M rows of one warpgroup
constexpr int HALO = TILE + 2;
constexpr int HALO_PIX = HALO * HALO;    // 100 halo pixels a sub-tile
constexpr int KC = 64;                   // channels of a K chunk
constexpr int ROW = 2 * KC;              // 128 bytes: a pixel's chunk in shared memory
constexpr int HALO_BYTES = HALO_PIX * ROW;
constexpr int STAGES = 3;                // tiles in a ring: 2 in flight while 1 multiplies

// ---- shared memory, copies, fences ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0-7) of 128-byte row `row`: the
// 128-byte swizzle, which is also the layout wgmma's SWIZZLE_128B
// descriptor reads from a 1024-byte aligned tile.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * ROW + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to wgmma's async proxy; a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts16(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---- wgmma ----

// Descriptor of a 1024-byte aligned SWIZZLE_128B operand tile in shared
// memory (8 rows of 128 bytes a swizzle atom).  K-major: rows are N, 64
// bf16 of K a row, SBO = 1024 from one 8-row group to the next (LBO
// unused).  MN-major: rows are K, 64 bf16 of N a row, SBO = 1024 from one
// 8-row group of K to the next, LBO from one 64-wide group of N to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CCTC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CCTC_D16(i) CCTC_D4(i), CCTC_D4(i + 4), CCTC_D4(i + 8), CCTC_D4(i + 12)

// d[64 x N] += a[64 x 16] (registers, the mma.m16n8k16 A fragment per warp)
// * b[16 x N] (shared memory, descriptor); TRANS_B = 1 for an MN-major B.
// N = 64 and 128 serve the convolutions; 256 also the RDNet tail's second
// product (csrc/rdtail_tc.cuh); 16, 32 and 192 the Swin block's heads and
// widths (csrc/swinblock_tc.cuh).
template <int N, int TRANS_B> struct Wgmma;

template <int TRANS_B> struct Wgmma<64, TRANS_B> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : CCTC_D16(0), CCTC_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<128, TRANS_B> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : CCTC_D16(0), CCTC_D16(16), CCTC_D16(32), CCTC_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<256, TRANS_B> {
  __device__ __forceinline__ static void run(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
        "}\n"
        : CCTC_D16(0), CCTC_D16(16), CCTC_D16(32), CCTC_D16(48), CCTC_D16(64), CCTC_D16(80), CCTC_D16(96),
          CCTC_D16(112)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<16, TRANS_B> {
  __device__ __forceinline__ static void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
        "}\n"
        : CCTC_D4(0), CCTC_D4(4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<32, TRANS_B> {
  __device__ __forceinline__ static void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : CCTC_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<192, TRANS_B> {
  __device__ __forceinline__ static void run(float (&d)[96], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n"
        "}\n"
        : CCTC_D16(0), CCTC_D16(16), CCTC_D16(32), CCTC_D16(48), CCTC_D16(64), CCTC_D16(80)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
  }
};

#undef CCTC_D16
#undef CCTC_D4

// ---- bf16 element arithmetic, in the plain version's order ----

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The prologue of one element: relu(x*a + b), two roundings, no fma.
__device__ __forceinline__ float prologue(float v, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, a), b), 0.f);
}
// The stat-folded cotangent of one element: gy + T(gs1 + 2*y*gs2).
__device__ __forceinline__ float fold(float gy, float y, float gs1, float gs2) {
  return __fadd_rn(gy, bf16r(__fadd_rn(gs1, __fmul_rn(2.f * y, gs2))));
}

// The prologue on 8 packed bf16 channels starting at `ch` (ab: (2, C)).
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* __restrict__ ab, int c_total, int ch) {
  const float* a = ab + ch;
  const float* b = ab + c_total + ch;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack2(prologue(lo_f(w[i]), __ldg(a + 2 * i), __ldg(b + 2 * i)),
                 prologue(hi_f(w[i]), __ldg(a + 2 * i + 1), __ldg(b + 2 * i + 1)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}
// The fold on 8 packed channels of gy and y starting at `ch`.
__device__ __forceinline__ uint4 fold8(uint4 g, uint4 y, const float* __restrict__ gs1,
                                       const float* __restrict__ gs2, int ch) {
  const float* s1 = gs1 + ch;
  const float* s2 = gs2 + ch;
  uint32_t w[4] = {g.x, g.y, g.z, g.w};
  const uint32_t u[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack2(fold(lo_f(w[i]), lo_f(u[i]), __ldg(s1 + 2 * i), __ldg(s2 + 2 * i)),
                 fold(hi_f(w[i]), hi_f(u[i]), __ldg(s1 + 2 * i + 1), __ldg(s2 + 2 * i + 1)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- geometry ----

// Origin of sub-tile T (image, first row, first column); false past the
// last sub-tile.  Sub-tiles are numbered image by image, row-major inside
// an image (ops/convchain.py:sub_tile_origin is the same map).
__device__ __forceinline__ bool sub_origin(int T, int n_sub, int tiles_per_img, int tiles_w, int& n, int& h0,
                                           int& w0) {
  if (T >= n_sub) return false;
  n = T / tiles_per_img;
  const int r = T - n * tiles_per_img;
  h0 = (r / tiles_w) * TILE;
  w0 = (r % tiles_w) * TILE;
  return true;
}

// ---- the forward / dx mainloop ----

struct ConvArgs {
  const bf16* a0;      // forward: x (N, H, W, Cin); dx: gy (N, H, W, Cout)
  const bf16* a1;      // dx: y (N, H, W, Cout); forward: unused
  const bf16* wk;      // (9, Cout, wstride) bf16, zero for Cin <= ci < wstride: the forward's layout
  const float* bias;   // forward: (Cout), f32; added as its bf16 rounding
  const float* ab;     // (2, Cin) prologue coefficients, or null
  const float* gs1;    // dx: (Cout) cotangent of s1
  const float* gs2;    // dx: (Cout) cotangent of s2
  const bf16* x;       // dx: x, for the ReLU mask
  bf16* out;           // forward: y; dx: dx
  float* sum1;         // forward: s1 (Cout); dx: da (Cin); zeroed by the caller
  float* sum2;         // forward: s2 (Cout); dx: db (Cin); zeroed by the caller
  bf16* gout;          // dx: g (N, H, W, kpad), written by the first N tile; or null
  int H, W;
  int kch;             // K channels: forward Cin, dx Cout
  int nch;             // N channels: forward Cout, dx Cin
  int kpad;            // kch rounded up to KC
  int wstride;         // Cin rounded up to KC: wk's row
  int tiles_w, tiles_per_img, n_sub;
};

template <int WG, int BN, bool DX> struct ConvSmem {
  static constexpr int B_STAGE = BN * ROW;
  static constexpr int HALO_OFF = STAGES * B_STAGE;
  static constexpr int Y_OFF = HALO_OFF + 2 * WG * HALO_BYTES;
  static constexpr int BYTES = Y_OFF + (DX ? WG * HALO_BYTES : 0) + 1024;  // + alignment slack
};

// One halo slot (16 bytes: 8 channels of one halo pixel of one sub-tile)
// of chunk c: whether it lies in the image and below kch, its shared
// offset inside the chunk's buffer, the global pixel and the channel.
struct HaloSlot {
  bool ok;
  uint32_t off;
  long long pix;
  int ch;
};

template <int WG>
__device__ __forceinline__ HaloSlot halo_slot(const ConvArgs& p, int e, int c) {
  const int j = e & 7;
  const int q = (e >> 3) % HALO_PIX;
  const int sub = (e >> 3) / HALO_PIX;
  int n = 0, h0 = 0, w0 = 0;
  bool ok = sub_origin(blockIdx.x * WG + sub, p.n_sub, p.tiles_per_img, p.tiles_w, n, h0, w0);
  const int hh = h0 - 1 + q / HALO;
  const int ww = w0 - 1 + q % HALO;
  const int ch = c * KC + j * 8;
  ok = ok && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ch < p.kch;
  return {ok, static_cast<uint32_t>(sub * HALO_BYTES) + swz(q, j), (static_cast<long long>(n) * p.H + hh) * p.W + ww,
          ch};
}

// Issues the halo of chunk c into `hbuf` (and y into `ybuf` for dx).  With
// kch % 8 == 0 the slots come by 16-byte cp.async and get their prologue
// later from the thread that copied them (transform_halo); otherwise they
// are loaded element by element here, prologue applied.
template <int WG, bool DX, bool RELU_IN>
__device__ __forceinline__ void issue_halo(const ConvArgs& p, uint32_t hbuf, uint32_t ybuf, int c, bool vec) {
  for (int e = threadIdx.x; e < WG * HALO_PIX * 8; e += WG * 128) {
    const HaloSlot s = halo_slot<WG>(p, e, c);
    if (vec) {
      if (s.ok) {
        cp_async16(hbuf + s.off, p.a0 + s.pix * p.kch + s.ch, true);
        if (DX) cp_async16(ybuf + s.off, p.a1 + s.pix * p.kch + s.ch, true);
      } else {
        sts16(hbuf + s.off, make_uint4(0, 0, 0, 0));
      }
      continue;
    }
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = 0.f;
      const int ch = s.ch + i;
      if (s.ok && ch < p.kch) {
        const long long at = s.pix * p.kch + ch;
        const float a = __bfloat162float(p.a0[at]);
        if (DX)
          v[i] = fold(a, __bfloat162float(p.a1[at]), p.gs1[ch], p.gs2[ch]);
        else
          v[i] = RELU_IN ? prologue(a, p.ab[ch], p.ab[p.kch + ch]) : a;
      }
    }
    sts16(hbuf + s.off, make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7])));
  }
}

// The prologue (forward) or the fold (dx) on the halo slots this thread
// copied with cp.async, once they have landed.
template <int WG, bool DX>
__device__ __forceinline__ void transform_halo(const ConvArgs& p, uint32_t hbuf, uint32_t ybuf, int c) {
  for (int e = threadIdx.x; e < WG * HALO_PIX * 8; e += WG * 128) {
    const HaloSlot s = halo_slot<WG>(p, e, c);
    if (!s.ok) continue;
    const uint4 v = lds16(hbuf + s.off);
    sts16(hbuf + s.off, DX ? fold8(v, lds16(ybuf + s.off), p.gs1, p.gs2, s.ch) : prologue8(v, p.ab, p.kch, s.ch));
  }
}

// dx: the folded g of the block's sub-tiles (their own pixels, not the
// halo's border) for chunk c, to p.gout, which the dW launch reads.
template <int WG>
__device__ __forceinline__ void write_g(const ConvArgs& p, uint32_t hbuf, int c) {
  for (int e = threadIdx.x; e < WG * SUB * 8; e += WG * 128) {
    const int j = e & 7;
    const int px = (e >> 3) & (SUB - 1);
    const int sub = e >> 9;
    int n, h0, w0;
    if (!sub_origin(blockIdx.x * WG + sub, p.n_sub, p.tiles_per_img, p.tiles_w, n, h0, w0)) continue;
    const int hh = h0 + px / TILE, ww = w0 + px % TILE;
    if (hh >= p.H || ww >= p.W) continue;
    const uint4 v = lds16(hbuf + sub * HALO_BYTES + swz((px / TILE + 1) * HALO + px % TILE + 1, j));
    const long long pix = (static_cast<long long>(n) * p.H + hh) * p.W + ww;
    *reinterpret_cast<uint4*>(p.gout + pix * p.kpad + c * KC + 8 * j) = v;
  }
}

// One block: WG sub-tiles x BN channels of N.  DX selects the dx policy.
template <int WG, int BN, bool DX, bool RELU_IN>
__device__ __forceinline__ void conv_tc_body(const ConvArgs& p, uint8_t* smem) {
  using S = ConvSmem<WG, BN, DX>;
  constexpr int THREADS = WG * 128;
  constexpr int NACC = BN / 2;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base;
  const uint32_t halo = base + S::HALO_OFF;
  const uint32_t ybuf = base + S::Y_OFF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2, w4 = warp & 3;
  const int n0 = blockIdx.y * BN;
  const bool vec = (p.kch & 7) == 0;
  const int nsteps = 9 * (p.kpad / KC);

  // step s = (chunk s / 9, tap s % 9): its weight tile into ring slot s %
  // STAGES, and at tap 0 the chunk's halo into buffer chunk % 2
  auto issue = [&](int s) {
    const int c = s / 9, tap = s - 9 * c;
    const uint32_t slot = ring + (s % STAGES) * S::B_STAGE;
    for (int e = tid; e < BN * 8; e += THREADS) {
      if (!DX) {  // K-major: row n = Cout, 64 Cin of the chunk
        const int row = e >> 3, j = e & 7;
        const bool ok = n0 + row < p.nch;
        const bf16* src = p.wk + (static_cast<long long>(tap) * p.nch + n0 + row) * p.wstride + c * KC + j * 8;
        cp_async16(slot + swz(row, j), ok ? src : p.wk, ok);
      } else {  // MN-major: row k = Cout of the chunk, BN Cin in 64-wide halves, tap 8 - t
        const int jj = e % (BN / 8), row = e / (BN / 8);
        const int co = c * KC + row, ci = n0 + 8 * jj;
        const bool ok = co < p.kch && ci < p.wstride;
        const bf16* src = p.wk + (static_cast<long long>(8 - tap) * p.kch + co) * p.wstride + ci;
        cp_async16(slot + (jj >> 3) * (KC * ROW) + swz(row, jj & 7), ok ? src : p.wk, ok);
      }
    }
    if (tap == 0) issue_halo<WG, DX, RELU_IN>(p, halo + (c & 1) * WG * HALO_BYTES, ybuf, c, vec);
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_commit();
  }

  // this lane's ldmatrix row: pixel m of the warp's 16, 16-byte chunk half
  const int m = 16 * w4 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const int c = s / 9, tap = s - 9 * c;
    const uint32_t hbuf = halo + (c & 1) * WG * HALO_BYTES;
    cp_wait<STAGES - 2>();
    if (tap == 0 && vec && (DX || RELU_IN)) transform_halo<WG, DX>(p, hbuf, ybuf, c);
    fence_async_smem();
    __syncthreads();
    if (DX && tap == 0 && p.gout != nullptr && blockIdx.y == 0) write_g<WG>(p, hbuf, c);

    const int ky = tap / 3, kx = tap - 3 * ky;
    const int q = ((m >> 3) + ky) * HALO + (m & 7) + kx;
    const uint32_t arow = hbuf + wg * HALO_BYTES;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(arow + swz(q, 2 * kk + khalf), a[kk]);
    const uint32_t bslot = ring + (s % STAGES) * S::B_STAGE;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!DX)  // K-major: the next 16 of K are 32 bytes on in each row
        Wgmma<BN, 0>::run(acc, a[kk], smem_desc(bslot + 32 * kk, 16, 8 * ROW));
      else  // MN-major: 16 rows of K on; 64-wide halves of N KC rows apart
        Wgmma<BN, 1>::run(acc, a[kk], smem_desc(bslot + 16 * ROW * kk, KC * ROW, 8 * ROW));
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);

    if (s + STAGES - 1 < nsteps) issue(s + STAGES - 1);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();  // the ring becomes the epilogue's reduction buffer

  // epilogue: rows g and g + 8 of the warp's 16 are pixels (row 2*w4 and
  // 2*w4 + 1 of the sub-tile, column g); columns 8j + 2t, + 1 of the tile
  float* red = reinterpret_cast<float*>(smem + (base - raw));  // [2][WG * 4 warps][BN]
  const int g = lane >> 2, t = lane & 3;
  int nimg = 0, h0 = 0, w0 = 0;
  const bool tv = sub_origin(blockIdx.x * WG + wg, p.n_sub, p.tiles_per_img, p.tiles_w, nimg, h0, w0);
  const int ww = w0 + g;
  bool ok[2];
  long long pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int hh = h0 + 2 * w4 + h;
    ok[h] = tv && hh < p.H && ww < p.W;
    pix[h] = (static_cast<long long>(nimg) * p.H + hh) * p.W + ww;
  }
  constexpr bool SUMS = !DX || RELU_IN;
  const bool pairs = (p.nch & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int ch = n0 + col;
    float p1[2] = {0.f, 0.f}, p2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc[4 * j + 2 * h + e];
        o[e] = 0.f;
        if (ch + e >= p.nch) continue;
        if (!DX) {
          o[e] = bf16r(bf16r(v) + bf16r(p.bias[ch + e]));
          p1[e] += o[e];
          p2[e] = fmaf(o[e], o[e], p2[e]);
        } else if (RELU_IN) {
          const float xv = __bfloat162float(p.x[pix[h] * p.nch + ch + e]);
          const float a = p.ab[ch + e];
          const float z = __fadd_rn(__fmul_rn(xv, a), p.ab[p.nch + ch + e]);
          const float dz = z > 0.f ? v : 0.f;
          p1[e] = fmaf(dz, xv, p1[e]);
          p2[e] += dz;
          o[e] = __fmul_rn(dz, a);
        } else {
          o[e] = v;
        }
      }
      bf16* dst = p.out + pix[h] * p.nch + ch;
      if (pairs && ch + 1 < p.nch) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o[0], o[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ch + e < p.nch) dst[e] = __float2bfloat16_rn(o[e]);
      }
    }
    if (SUMS) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          p1[e] += __shfl_xor_sync(0xffffffffu, p1[e], off);
          p2[e] += __shfl_xor_sync(0xffffffffu, p2[e], off);
        }
        if (g == 0) {
          red[warp * BN + col + e] = p1[e];
          red[(WG * 4 + warp) * BN + col + e] = p2[e];
        }
      }
    }
  }
  if (SUMS) {
    __syncthreads();
    if (tid < BN && n0 + tid < p.nch) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int w = 0; w < WG * 4; ++w) {
        t1 += red[w * BN + tid];
        t2 += red[(WG * 4 + w) * BN + tid];
      }
      atomicAdd(p.sum1 + n0 + tid, t1);
      atomicAdd(p.sum2 + n0 + tid, t2);
    }
  }
}

// Launches `kernel` with the dynamic shared memory it needs.  The limit is
// raised once per kernel and device: `raised` is the caller's own flag word
// for this kernel, one bit per device.
template <typename Kernel, typename Args>
cudaError_t launch_tc(Kernel kernel, unsigned long long& raised, dim3 grid, int threads, int smem_bytes,
                      const Args& args, cudaStream_t stream) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev >= 64 || !(raised >> dev & 1)) {
    if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes))
      return err;
    if (dev < 64) raised |= 1ull << dev;
  }
  kernel<<<grid, threads, smem_bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace cctc
