// Per-channel dual sums for Hopper: out[0, c] = sum_r x[r, c] and
// out[1, c] = sum_r x[r, c] * y[r, c] over a (rows, C) view, f32 or
// bfloat16 in, f32 accumulation and out.  The pair of sums train-mode
// BatchNorm needs: (sum x, sum x^2) forward, (sum gy, sum gy * x)
// backward, and (sum gy, sum gy * h) for a per-channel affine's backward.
//
// Replaces the TPU kernel pssr2_tpu/ops/pallas/chanstats.py:_dual_sums_kernel
// (reached through dual_sums).
//
// What bounds it on an H100 SXM: the bytes of x and y read once each
// against 3.35 TB/s; two operations an element are nothing beside them.
//
// Design.  The TPU grid streamed row chunks in order into one (2, C)
// output; here blocks run in no order, so each block reduces its rows and
// adds its (2, tile) partial sums with atomicAdd (the order of those adds
// changes from run to run).  A block of 256 threads owns a tile of
// W = min(C, 256) channels and a range of rows: thread t reads channel
// t % W of every (256 / W)-th row, so a warp reads consecutive addresses
// at every width, C = 1 included (one channel, 256 rows an iteration).
// The threads' sums of one channel are then added in shared memory.  Rows
// are split over enough blocks to fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 1056;  // 132 SMs x 8

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) dual_sums_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                                            float* __restrict__ out, long long rows, int c,
                                                            int tile_w, long long rows_per_block) {
  __shared__ float sx_s[THREADS];
  __shared__ float sxy_s[THREADS];
  const int step = THREADS / tile_w;  // rows an iteration
  const int lane_c = threadIdx.x % tile_w;
  const int r_off = threadIdx.x / tile_w;
  const int col = blockIdx.x * tile_w + lane_c;
  const long long r0 = blockIdx.y * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float sx = 0.0f, sxy = 0.0f;
  if (r_off < step && col < c) {
    for (long long r = r0 + r_off; r < r1; r += step) {
      const float xv = to_f32(x[r * c + col]);
      const float yv = to_f32(y[r * c + col]);
      sx += xv;
      sxy += xv * yv;
    }
  }
  sx_s[threadIdx.x] = sx;
  sxy_s[threadIdx.x] = sxy;
  __syncthreads();
  if (threadIdx.x < tile_w && col < c) {
    float tx = 0.0f, txy = 0.0f;
    for (int j = 0; j < step; ++j) {
      tx += sx_s[j * tile_w + threadIdx.x];
      txy += sxy_s[j * tile_w + threadIdx.x];
    }
    atomicAdd(out + col, tx);
    atomicAdd(out + c + col, txy);
  }
}

template <typename T>
void launch(const void* x, const void* y, void* out, long long rows, int c, cudaStream_t s) {
  const int tile_w = c < THREADS ? c : THREADS;
  const int tiles = (c + tile_w - 1) / tile_w;
  const long long iters = (rows + THREADS / tile_w - 1) / (THREADS / tile_w);
  long long splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  splits = splits < iters ? splits : iters;
  splits = splits < 65535 ? splits : 65535;
  splits = splits > 0 ? splits : 1;
  const long long rows_per_block = (rows + splits - 1) / splits;
  dim3 grid(tiles, static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block));
  dual_sums_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(y),
                                               static_cast<float*>(out), rows, c, tile_w, rows_per_block);
}

}  // namespace

// out (2, C) f32 must be zeroed by the caller (the blocks add into it).
// dtype: 0 float32, 1 bfloat16 (x and y alike).
extern "C" int chanstats_dual_sums(const void* x, const void* y, void* out, long long rows, int c, int dtype,
                                   void* stream) {
  if (rows <= 0 || c <= 0 || c > 65535 * THREADS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, out, rows, c, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, out, rows, c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
