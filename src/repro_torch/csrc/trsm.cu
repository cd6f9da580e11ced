// trsm: solve X L^T = B (transpose = 1) or X L = B (transpose = 0) for a row
// panel B against a lower-triangular n x n factor L, for a stack, one launch.
//
// Replaces: trsm_pallas in src/repro/kernels/trsm.py (the panel solve of the
// packed blocked Cholesky and the diagonal solves of both substitutions).
//
// What bounds it on the H100: latency. The Cholesky panel (31 panels of
// 128 x 128 against one 128 x 128 factor) is 65 MFLOP on 4 MB, and the
// substitution calls have only r = 8 rows; each row is a chain of n
// dependent steps, so the time is the length of that chain, not the FMA
// rate or the memory rate.
//
// What the design does about it: rows of X are independent (the TPU kernel's
// parallel row blocks), so each CTA takes 32 rows and each warp owns 4 of
// them and solves them together, column by column, with no block-wide
// barrier inside the recurrence: the warp computes x_j for its rows, then
// its 32 lanes subtract x_j times column j (transpose = 1, j ascending) or
// row j (transpose = 0, j descending) of L from the rest of each row. The
// factor's lower triangle (n(n+1)/2 floats) and the 32-row panel live in
// shared memory. The factor is read through a batch stride, so a factor
// broadcast over the panel stack (stride 0) is never copied, and rows past
// m are masked instead of padded.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                 // panel rows per CTA
constexpr int kRowsPerWarp = kRows / kWarps;

__device__ __forceinline__ int lo(int i, int j) { return i * (i + 1) / 2 + j; }

__global__ void __launch_bounds__(kThreads)
    trsm_kernel(const float* __restrict__ l, const float* __restrict__ b, float* __restrict__ x,
                int batch, int m, int n, long long slb, int transpose) {
  extern __shared__ float smem[];
  float* ls = smem;                        // n(n+1)/2: lower triangle of L
  float* xs = smem + n * (n + 1) / 2;      // kRows x (n + 1): the row panel
  const int ld = n + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * kRows;
  for (int bt = blockIdx.y; bt < batch; bt += gridDim.y) {
    const float* lb = l + bt * slb;
    const float* bb = b + ((long long)bt * m + row0) * n;
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = e / n, c = e % n;
      if (c <= r) ls[lo(r, c)] = lb[e];
    }
    for (int e = tid; e < kRows * n; e += kThreads) {
      const int r = e / n, c = e % n;
      xs[r * ld + c] = row0 + r < m ? bb[e] : 0.0f;
    }
    __syncthreads();
    float* rows[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) rows[q] = xs + (warp + kWarps * q) * ld;
    for (int step = 0; step < n; ++step) {
      const int j = transpose ? step : n - 1 - step;
      const float d = ls[lo(j, j)];
      float xj[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) xj[q] = rows[q][j] / d;
      __syncwarp();
      if (transpose) {  // X L^T = B: x_k -= x_j L[k, j] for k > j
        for (int k = j + 1 + lane; k < n; k += 32) {
          const float lkj = ls[lo(k, j)];
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) rows[q][k] -= xj[q] * lkj;
        }
      } else {  // X L = B: x_k -= x_j L[j, k] for k < j
        for (int k = lane; k < j; k += 32) {
          const float ljk = ls[lo(j, k)];
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) rows[q][k] -= xj[q] * ljk;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) rows[q][j] = xj[q];
      }
      __syncwarp();
    }
    __syncthreads();
    float* xb = x + ((long long)bt * m + row0) * n;
    for (int e = tid; e < kRows * n; e += kThreads) {
      const int r = e / n, c = e % n;
      if (row0 + r < m) xb[e] = xs[r * ld + c];
    }
    __syncthreads();  // the next stack entry reuses the shared buffers
  }
}

}  // namespace

extern "C" int trsm_smem_bytes(int n) {
  return (n * (n + 1) / 2 + kRows * (n + 1)) * (int)sizeof(float);
}

// l: element (0, 0) of factor 0, factor b at l + b * slb (slb = 0 broadcasts).
// b, x: (batch, m, n) contiguous.
extern "C" int trsm_f32(const float* l, const float* b, float* x, int batch, int m, int n,
                        long long slb, int transpose, void* stream) {
  const int smem = trsm_smem_bytes(n);
  cudaError_t err =
      cudaFuncSetAttribute(trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + kRows - 1) / kRows, batch < 65535 ? batch : 65535);
  trsm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(l, b, x, batch, m, n,
                                                                          slb, transpose);
  return static_cast<int>(cudaGetLastError());
}
