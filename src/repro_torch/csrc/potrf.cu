// potrf: lower Cholesky factor of each n x n SPD tile of a stack, one launch.
//
// Replaces: potrf_pallas in src/repro/kernels/potrf.py (the diagonal-block
// factorization of the packed blocked Cholesky).
//
// What bounds it on the H100: latency. A 128 x 128 tile is n^3/3 = 0.7 MFLOP
// on 128 KiB; the column recurrence has n dependent steps, each a sqrt, a
// column scale and a rank-1 update separated by barriers, and the walk
// calls it once per block column with a single tile. Neither the FMA units
// nor device memory come near their limits; the time is n steps of barrier
// latency inside one SM.
//
// What the design does about it: one CTA per tile, the tile's lower
// triangle resident in shared memory (n(n+1)/2 floats: 33 KB at 128, 132 KB
// at 256, which needs the opt-in above 48 KB), and the unblocked
// right-looking recurrence indexed directly — the TPU kernel's masked
// reductions existed only because Mosaic lacks dynamic slicing. Each step
// costs two barriers; the rank-1 update gives each warp whole rows of the
// trailing triangle. The strict upper half of the output is written as
// zeros (the factor-tile contract).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lo(int i, int j) { return i * (i + 1) / 2 + j; }

__global__ void __launch_bounds__(kThreads)
    potrf_kernel(const float* __restrict__ a, float* __restrict__ l, int batch, int n) {
  extern __shared__ float s[];  // lower triangle, row-major packed
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;
  const long long nn = (long long)n * n;
  for (int bt = blockIdx.x; bt < batch; bt += gridDim.x) {
    const float* ab = a + bt * nn;
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = e / n, c = e % n;
      if (c <= r) s[lo(r, c)] = ab[e];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float d = sqrtf(s[lo(j, j)]);
      __syncthreads();  // every thread has read the pivot before it changes
      for (int i = j + 1 + tid; i < n; i += kThreads) s[lo(i, j)] = s[lo(i, j)] / d;
      if (tid == 0) s[lo(j, j)] = d;
      __syncthreads();
      // rank-1 update of the trailing lower triangle: (i, k), j < k <= i
      for (int i = j + 1 + warp; i < n; i += nwarps) {
        const float li = s[lo(i, j)];
        for (int k = j + 1 + lane; k <= i; k += 32) s[lo(i, k)] -= li * s[lo(k, j)];
      }
      __syncthreads();
    }
    float* lb = l + bt * nn;
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = e / n, c = e % n;
      lb[e] = c <= r ? s[lo(r, c)] : 0.0f;
    }
    __syncthreads();  // the next tile reuses the shared buffer
  }
}

}  // namespace

extern "C" int potrf_smem_bytes(int n) { return n * (n + 1) / 2 * (int)sizeof(float); }

extern "C" int potrf_f32(const float* a, float* l, int batch, int n, void* stream) {
  const int smem = potrf_smem_bytes(n);
  cudaError_t err =
      cudaFuncSetAttribute(potrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = batch < 65535 ? batch : 65535;
  potrf_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, l, batch, n);
  return static_cast<int>(cudaGetLastError());
}
