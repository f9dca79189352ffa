// Soft (sigmoid-binned) histogram for Hopper, forward and backward: the
// noise-profile histograms of the learned crappifier's loss.
//
//   s_k(n)  = sigmoid((v_n - c_k) * sigma),  s_{-1} = 1
//   forward:  hist[b, k] = sum_n s_{k-1}(n) - s_k(n)
//   backward: dv[b, n]   = sigma * sum_k gdiff[b, k] * s_k(n) * (1 - s_k(n)),
//             gdiff_k = g_{k+1} - g_k (g_bins = 0), computed by the wrapper
//
// Replaces the TPU kernels pssr2_tpu/ops/pallas/gradhist.py:_fwd_kernel and
// _bwd_kernel (reached through _run_fwd and _run_bwd).  values (B, N) f32,
// centers (bins,) f32, hist (B, bins) f32, dv (B, N) f32.
//
// What bounds it on an H100 SXM: B*N*bins sigmoids, each one exponential
// and one reciprocal on the special-function units (16 a clock per SM),
// against a few MB of values and histograms: the special functions bound
// it by a wide margin (134 M sigmoids at (16, 16384) x 512).
//
// Design.  The TPU grid ran in order and kept the (B, bins) sum in VMEM;
// Hopper's blocks run in no order, so here each block reduces its own
// chunk of values and adds its partial histogram to the output with
// atomicAdd (the order of those adds changes from run to run).  The mass
// of a bin is summed as the XLA formulation sums it, per value, from the
// difference s_{k-1} - s_k: the Pallas kernel's telescoped form
// (sum_n s_{k-1} - sum_n s_k) subtracts sums of about N and loses about
// 1e-3 per bin at N = 16384 in f32.  Forward: a block takes CHUNK values of
// one row, staged in shared memory; each thread owns 4 consecutive bins
// and evaluates 5 sigmoids per value (its bins and the one below them).
// Backward: each thread owns one value and loops over the bins, with the
// centres and gdiff staged in shared memory.  The ragged tail of N is
// masked, so no padding and no bin-0 correction are needed.  The sigmoid
// is 1 / (1 + expf(-z)) with an IEEE divide: expf is accurate to 2 ulps.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;       // values per forward block
constexpr int BINS_PER_THREAD = 4;
constexpr int FWD_THREADS = 128;  // 512 bins in one pass
constexpr int BWD_THREADS = 256;  // one value a thread

__device__ __forceinline__ float sigmoid(float v, float c, float sigma) {
  float z = __fmul_rn(__fsub_rn(v, c), sigma);
  return 1.0f / (1.0f + expf(-z));
}

__global__ void __launch_bounds__(FWD_THREADS) gradhist_fwd_kernel(
    const float* __restrict__ values, const float* __restrict__ centers, float sigma,
    float* __restrict__ hist, int n, int bins) {
  __shared__ float vs[CHUNK];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * CHUNK;
  const int count = min(CHUNK, n - n0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) vs[i] = values[(long long)b * n + n0 + i];
  __syncthreads();

  for (int k0 = BINS_PER_THREAD * threadIdx.x; k0 < bins; k0 += BINS_PER_THREAD * blockDim.x) {
    float c[BINS_PER_THREAD];
    float acc[BINS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < BINS_PER_THREAD; ++j) {
      c[j] = k0 + j < bins ? centers[k0 + j] : 0.0f;
      acc[j] = 0.0f;
    }
    const bool first = k0 == 0;
    const float c_below = first ? 0.0f : centers[k0 - 1];
    for (int i = 0; i < count; ++i) {
      const float v = vs[i];
      float prev = first ? 1.0f : sigmoid(v, c_below, sigma);
#pragma unroll
      for (int j = 0; j < BINS_PER_THREAD; ++j) {
        const float s = sigmoid(v, c[j], sigma);
        acc[j] += prev - s;
        prev = s;
      }
    }
#pragma unroll
    for (int j = 0; j < BINS_PER_THREAD; ++j)
      if (k0 + j < bins) atomicAdd(hist + (long long)b * bins + k0 + j, acc[j]);
  }
}

__global__ void __launch_bounds__(BWD_THREADS) gradhist_bwd_kernel(
    const float* __restrict__ values, const float* __restrict__ centers, float sigma,
    const float* __restrict__ gdiff, float* __restrict__ dv, int n, int bins) {
  extern __shared__ float smem[];
  float* cs = smem;         // bins centres
  float* gs = smem + bins;  // bins gdiff of this row
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    cs[k] = centers[k];
    gs[k] = gdiff[(long long)b * bins + k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = values[(long long)b * n + i];
  float acc = 0.0f;
  for (int k = 0; k < bins; ++k) {
    const float s = sigmoid(v, cs[k], sigma);
    acc += s * (1.0f - s) * gs[k];
  }
  dv[(long long)b * n + i] = sigma * acc;
}

}  // namespace

// hist must be zeroed by the caller (the blocks add into it).
extern "C" int gradhist_fwd(const void* values, const void* centers, float sigma, void* hist,
                            int b, int n, int bins, void* stream) {
  if (b <= 0 || n <= 0 || bins <= 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + CHUNK - 1) / CHUNK, b);
  gradhist_fwd_kernel<<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(centers), sigma,
      static_cast<float*>(hist), n, bins);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gradhist_bwd(const void* values, const void* centers, float sigma, const void* gdiff,
                            void* dv, int b, int n, int bins, void* stream) {
  if (b <= 0 || n <= 0 || bins <= 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * bins;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + BWD_THREADS - 1) / BWD_THREADS, b);
  gradhist_bwd_kernel<<<grid, BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(centers), sigma,
      static_cast<const float*>(gdiff), static_cast<float*>(dv), n, bins);
  return static_cast<int>(cudaGetLastError());
}
