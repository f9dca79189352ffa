// The f32 CUDA-core mainloop of the port's f32 kernels (the CUDA-core
// counterpart of csrc/convchain_tc.cuh): the RDNet tail forward and
// backward (csrc/rdtail.cu), the convchain backward (csrc/convchain_bwd.cu)
// and the Swin block backward's token products (csrc/swinblock.cu) run
// their products on it, in true f32 on the FMA units.  No tensor-core
// instruction of any kind: the f32 routes hold a 1e-4 tolerance that TF32
// would break.
//
// What bounds these products on an H100 SXM: the f32 FMA rate (67 TFLOP/s
// at 700 W: 132 SMs x 128 FMA a clock).  An SM issues one FMA and, beside
// it, far fewer shared-memory loads, so a thread keeps a register tile of
// outputs and loads each operand value once for a row or column of them:
//
// - A block of THREADS = 256 threads owns BM = 128 rows of M and BN = 128,
//   64, 32 or 16 columns of N: a 16 x 16 grid of threads, each with an
//   8 x TN register tile (TN = BN / 16).  Its 8 rows are two runs of 4,
//   64 apart, and with TN = 8 its columns too, so that a warp's float4
//   loads of one k step fall on distinct banks.  A k step loads 8 + TN
//   floats (2 + TN/4 LDS.128) for 8 * TN FMAs: 4 FMAs a float at TN = 8.
// - The operands sit K-major in shared memory ([k][row], rows padded by
//   PAD floats): 16-byte aligned float4 rows, and the transposing copies of
//   a K-contiguous operand land on 32 distinct banks.
// - A ring of STAGES slots, filled by cp.async (16-byte copies where the
//   rows are K-major and aligned in device memory, else 4-byte copies that
//   transpose as they land, 8 k a lane so that a warp reads whole 32-byte
//   sectors), so the copies of step i + STAGES - 1 overlap the FMAs of step
//   i.  Elements past an operand's rows or K are zero-filled by the copy.
// - Hooks: ring() takes the launch's own copies (load), its elementwise
//   prologue on the elements a thread copied once they have landed
//   (arrive: the stat fold of a cotangent, a BatchNorm + ReLU), and its
//   consumer of a slot (compute: the register-tile step below, or a
//   convolution's own walk over a halo); epilogues read the register tile
//   through Pos::row and col<TN>.
//
// gemm_jobs_kernel runs several products in one launch, each output tile's
// K split over blocks whose partial sums meet by atomicAdd in a zeroed f32
// output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32g {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int BM = 128;       // rows of M a block
constexpr int BK = 16;        // K of a GEMM step
constexpr int PAD = 4;        // floats of padding at the end of a shared-memory row

// ---- copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 or 16 bytes global -> shared, asynchronously; zero-filled when !ok
// (the source is then not read, but must be a valid address)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// ---- the ring

// Walks steps 0..nk-1 through STAGES slots of `slot` floats at `smem`.
// load(s, i) issues the copies of step i into slot s; arrive(s, i) runs
// once this thread's copies of step i have landed, before the barrier that
// publishes them (it may rewrite only the elements this thread copied);
// compute(s, i) consumes the slot.  Ends with the ring drained and a
// barrier, so the caller may reuse the shared memory.
template <int STAGES, class Load, class Arrive, class Compute>
__device__ __forceinline__ void ring(float* smem, int slot, int nk, Load&& load, Arrive&& arrive, Compute&& compute) {
  static_assert(STAGES >= 2, "a ring has at least 2 slots");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(smem + s * slot, s);
    commit();
  }
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    float* cur = smem + (i % STAGES) * slot;
    wait<STAGES - 2>();
    arrive(cur, i);
    __syncthreads();  // step i is in; every thread is done with step i - 1
    const int next = i + STAGES - 1;
    if (next < nk) load(smem + (next % STAGES) * slot, next);
    commit();
    compute(cur, i);
  }
  wait<0>();
  __syncthreads();
}

// ---- the register tile

// A thread's place in the 16 x 16 grid: a warp spans 4 rows (ty) x 8
// columns (tx) of threads.
struct Pos {
  int ty, tx;
  __device__ __forceinline__ Pos() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    tx = ((warp & 1) << 3) | (lane & 7);
    ty = ((warp >> 1) << 2) | (lane >> 3);
  }
  // the block row of register row i (0..7)
  __device__ __forceinline__ int row(int i) const { return (i >> 2) * 64 + ty * 4 + (i & 3); }
};
// the block column of register column j (0..TN-1) of thread column tx
template <int TN> __device__ __forceinline__ int col(int tx, int j) {
  return TN == 8 ? (j >> 2) * 64 + tx * 4 + (j & 3) : tx * TN + j;
}

// The thread's 8 rows of one k row of an A tile ([k][BM + PAD])
__device__ __forceinline__ void load_a(const float* a, int ty, float (&r)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(a + ty * 4);
  const float4 v = *reinterpret_cast<const float4*>(a + 64 + ty * 4);
  r[0] = u.x, r[1] = u.y, r[2] = u.z, r[3] = u.w, r[4] = v.x, r[5] = v.y, r[6] = v.z, r[7] = v.w;
}
// The thread's TN columns of one k row of a B tile ([k][BN + PAD])
template <int TN> __device__ __forceinline__ void load_b(const float* b, int tx, float (&r)[TN]) {
  if constexpr (TN == 8) {
    const float4 u = *reinterpret_cast<const float4*>(b + tx * 4);
    const float4 v = *reinterpret_cast<const float4*>(b + 64 + tx * 4);
    r[0] = u.x, r[1] = u.y, r[2] = u.z, r[3] = u.w, r[4] = v.x, r[5] = v.y, r[6] = v.z, r[7] = v.w;
  } else if constexpr (TN == 4) {
    const float4 u = *reinterpret_cast<const float4*>(b + tx * 4);
    r[0] = u.x, r[1] = u.y, r[2] = u.z, r[3] = u.w;
  } else if constexpr (TN == 2) {
    const float2 u = *reinterpret_cast<const float2*>(b + tx * 2);
    r[0] = u.x, r[1] = u.y;
  } else {
    r[0] = b[tx];
  }
}
template <int TN> __device__ __forceinline__ void outer(float (&acc)[8][TN], const float (&a)[8], const float (&b)[TN]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}
template <int TN> __device__ __forceinline__ void zero(float (&acc)[8][TN]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Sums v[j] (one value a register column) over the 16 thread rows: block
// column c's total lands in red[16 BN + c] (BN = 16 TN), read after the
// barrier this ends with.  red: 17 BN floats of shared memory that no
// thread still reads.
template <int TN> __device__ __forceinline__ void col_sums(const float (&v)[TN], float* red, const Pos& t) {
  constexpr int BN = 16 * TN;
#pragma unroll
  for (int j = 0; j < TN; ++j) red[t.ty * BN + col<TN>(t.tx, j)] = v[j];
  __syncthreads();
  if (threadIdx.x < BN) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) s += red[r * BN + threadIdx.x];
    red[16 * BN + threadIdx.x] = s;
  }
  __syncthreads();
}

// ---- GEMM operands and tiles

// A product's operand as the tile loader reads it: the element (r, k) of
// its rows x K view lies at p[r * ld + k] (a K-contiguous operand) or
// p[k * ld + r] (K-major); vec: 16-byte copies allowed (K-major, ld % 4 ==
// 0, p 16-byte aligned).  Which of the two layouts is a template argument
// of the loader (KCONTIG).
struct Operand {
  const float* p;
  int ld, rows, vec;
};

// Issues the copies of rows [r0, r0 + R) x K [k0, k0 + BK) of `op` into
// dst ([BK][R + PAD]); zeros past op.rows and past kend.
template <int R, bool KCONTIG>
__device__ __forceinline__ void load_tile(float* dst, const Operand& op, int r0, int k0, int kend) {
  constexpr int S = R + PAD;
  const int tid = threadIdx.x;
  if constexpr (KCONTIG) {
    static_assert((BK * R) % THREADS == 0 && BK % 8 == 0, "whole 8-k runs a thread");
#pragma unroll
    for (int q = 0; q < BK * R / THREADS; ++q) {
      const int e = tid + THREADS * q;
      const int r = (e >> 3) % R, k = ((e >> 3) / R) * 8 + (e & 7);
      const bool ok = r0 + r < op.rows && k0 + k < kend;
      cp4(dst + k * S + r, ok ? op.p + static_cast<long long>(r0 + r) * op.ld + (k0 + k) : op.p, ok);
    }
  } else {
    constexpr int CH = R / 4;  // 16-byte chunks of a k row
    for (int e = tid; e < BK * CH; e += THREADS) {
      const int k = e / CH, c = (e % CH) * 4;
      const bool kin = k0 + k < kend;
      const long long at = static_cast<long long>(k0 + k) * op.ld + r0 + c;
      float* d = dst + k * S + c;
      if (op.vec && r0 + c + 4 <= op.rows) {
        cp16(d, kin ? op.p + at : op.p, kin);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = kin && r0 + c + j < op.rows;
          cp4(d + j, ok ? op.p + at + j : op.p, ok);
        }
      }
    }
  }
}

template <int BN> struct Gemm {
  static constexpr int TN = BN / 16;
  static constexpr int SA = BM + PAD, SB = BN + PAD;
  static constexpr int SLOT = BK * (SA + SB);  // floats of a ring slot: the A and B tiles of a step
};

// acc += A[m0 .., kbeg .. kend) x B[kbeg .. kend), n0 ..] on the ring at
// smem; KA, KB: whether A and B are K-contiguous.
template <int BN, int STAGES, bool KA, bool KB>
__device__ __forceinline__ void gemm(float* smem, const Operand& a, const Operand& b, int m0, int n0, int kbeg,
                                     int kend, float (&acc)[8][BN / 16], const Pos& t) {
  using G = Gemm<BN>;
  const int nk = (kend - kbeg + BK - 1) / BK;
  ring<STAGES>(
      smem, G::SLOT, nk,
      [&](float* s, int i) {
        load_tile<BM, KA>(s, a, m0, kbeg + i * BK, kend);
        load_tile<BN, KB>(s + BK * G::SA, b, n0, kbeg + i * BK, kend);
      },
      [](float*, int) {},
      [&](float* s, int) {
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          float ar[8], br[G::TN];
          load_a(s + k * G::SA, t.ty, ar);
          load_b<G::TN>(s + BK * G::SA + k * G::SB, t.tx, br);
          outer(acc, ar, br);
        }
      });
}

// ---- several products in one launch

// out (m x n, row stride n, f32, zeroed by the caller) += A (m x k) B
// (k x n); tiles of BM x bn (128 or 64), tiles_n across; the K range of a
// tile split in `splits` shares of kps (a multiple of BK), the shares' sums
// met by atomicAdd.  A is K-major; B K-contiguous where kb, else K-major
// (the RDNet tail's dh takes a K-contiguous B; every weight gradient, K =
// M, both operands K-major).
struct Job {
  Operand a, b;
  float* out;
  int m, n, k, bn, tiles_n, splits, kps, kb;
};
// Up to four jobs; first[i]: the first block of job i + 1 (an unused job
// starts at the grid's end).
struct Jobs {
  Job j0, j1, j2, j3;
  int first1, first2, first3;
};

// One block of a job: its tile's share of K, then the atomics.
template <int BN, int STAGES, bool KB>
__device__ __forceinline__ void job_block(float* smem, const Operand& a, const Operand& b, float* out, int m, int n,
                                          int m0, int n0, int kb, int ke) {
  constexpr int TN = BN / 16;
  const Pos t;
  float acc[8][TN];
  zero(acc);
  gemm<BN, STAGES, false, KB>(smem, a, b, m0, n0, kb, ke, acc, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + t.row(i);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + col<TN>(t.tx, j);
      if (c < n) atomicAdd(out + static_cast<long long>(r) * n + c, acc[i][j]);
    }
  }
}

template <int STAGES>
__global__ void __launch_bounds__(THREADS, 2) gemm_jobs_kernel(const Jobs p) {
  extern __shared__ __align__(16) float smem[];
  const int ji = blockIdx.x >= p.first3 ? 3 : blockIdx.x >= p.first2 ? 2 : blockIdx.x >= p.first1 ? 1 : 0;
  const int b = blockIdx.x - (ji == 3 ? p.first3 : ji == 2 ? p.first2 : ji == 1 ? p.first1 : 0);
  // the job's fields, selected field by field (kernel parameters are read,
  // never copied)
#define F32G_JOB(f) (ji == 3 ? p.j3.f : ji == 2 ? p.j2.f : ji == 1 ? p.j1.f : p.j0.f)
  const int tiles_n = F32G_JOB(tiles_n), kps = F32G_JOB(kps), bn = F32G_JOB(bn);
  // a tile's K shares lie a whole round of tiles apart, so that the blocks
  // in flight together seldom add to the same outputs
  const int tiles = ((F32G_JOB(m) + BM - 1) / BM) * tiles_n;
  const int split = b / tiles, tile = b % tiles;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * bn;
  const int kb = split * kps, ke = min(F32G_JOB(k), kb + kps);
  const Operand a{F32G_JOB(a.p), F32G_JOB(a.ld), F32G_JOB(a.rows), F32G_JOB(a.vec)};
  const Operand bo{F32G_JOB(b.p), F32G_JOB(b.ld), F32G_JOB(b.rows), F32G_JOB(b.vec)};
  float* out = F32G_JOB(out);
  const int m = F32G_JOB(m), n = F32G_JOB(n), kcontig = F32G_JOB(kb);
#undef F32G_JOB
  if (kcontig) {
    if (bn == 128)
      job_block<128, STAGES, true>(smem, a, bo, out, m, n, m0, n0, kb, ke);
    else
      job_block<64, STAGES, true>(smem, a, bo, out, m, n, m0, n0, kb, ke);
  } else {
    if (bn == 128)
      job_block<128, STAGES, false>(smem, a, bo, out, m, n, m0, n0, kb, ke);
    else
      job_block<64, STAGES, false>(smem, a, bo, out, m, n, m0, n0, kb, ke);
  }
}

// A job of gemm_jobs_kernel: out (m x n) += A B over K = k in shares of kps.
inline Job job(Operand a, Operand b, float* out, int m, int n, int k, int bn, int kps, bool kb) {
  return {a, b, out, m, n, k, bn, (n + bn - 1) / bn, (k + kps - 1) / kps, kps, kb ? 1 : 0};
}

// An operand as it lies in device memory; vec: whether a K-major operand's
// rows take 16-byte copies.
inline Operand operand(const float* p, int ld, int rows, bool kcontig) {
  const bool vec = !kcontig && ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return {p, ld, rows, vec ? 1 : 0};
}

// Launches up to four jobs (an unused one has m 0) in one grid on
// `stream`; `raised`: the caller's opt_in record of the kernel.  Returns
// the CUDA error code.
template <int STAGES> int launch_jobs(Jobs p, int& raised, cudaStream_t stream);

template <int BN, int STAGES> constexpr int gemm_smem_bytes() { return STAGES * Gemm<BN>::SLOT * 4; }

// Opts a kernel in to `bytes` of dynamic shared memory (above 48 KB) once
// per process and kernel; returns the CUDA error code.
template <typename Kernel> int opt_in(Kernel kernel, int bytes, int& raised) {
  if (bytes <= 48 * 1024 || bytes <= raised) return 0;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised = bytes;
  return static_cast<int>(err);
}

template <int STAGES> int launch_jobs(Jobs p, int& raised, cudaStream_t stream) {
  constexpr int bytes = gemm_smem_bytes<128, STAGES>();
  if (int err = opt_in(gemm_jobs_kernel<STAGES>, bytes, raised)) return err;
  auto blocks = [](const Job& j) {
    return j.m > 0 ? static_cast<long long>((j.m + BM - 1) / BM) * j.tiles_n * j.splits : 0LL;
  };
  const long long b0 = blocks(p.j0), b1 = blocks(p.j1), b2 = blocks(p.j2), b3 = blocks(p.j3);
  if (b0 + b1 + b2 + b3 > 0x7fffffffLL || b0 + b1 + b2 + b3 == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.first1 = static_cast<int>(b0);
  p.first2 = static_cast<int>(b0 + b1);
  p.first3 = static_cast<int>(b0 + b1 + b2);
  gemm_jobs_kernel<STAGES><<<static_cast<unsigned>(b0 + b1 + b2 + b3), THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32g
