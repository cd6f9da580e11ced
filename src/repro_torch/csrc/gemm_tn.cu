// gemm_tn: C[b] = alpha * A[b]^T B[b] in float32, for a whole batch in one launch.
//
// Replaces: gemm_tn_pallas in src/repro/kernels/gemm_tn.py (the Pallas TN
// matmul that is the leaf of every Strassen product).
//
// What bounds it on the H100: operations. A Strassen leaf is 512 x 512 x 512
// (2 * 512^3 = 268 MFLOP on 3 MiB), far above the card's float32 balance
// point (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte), so the ceiling
// is the 67 TFLOP/s of the float32 FMA units outside the tensor cores.
//
// What the design does about it: each CTA keeps a 128 x 128 output tile in
// registers (8 x 8 per thread), so every float loaded from shared memory
// feeds 8 FMAs and every float loaded from device memory feeds 128; the next
// depth-8 slab is fetched while the current one is multiplied. The TPU
// kernel's sequential "arbitrary" contraction grid axis is the loop inside
// tn_tile; nothing carries between CTAs. The grid is (k-tiles, n-tiles,
// batch), so a whole Strassen leaf stack is one launch, and ragged edges are
// masked in the loads instead of padded copies. Tensor cores (TF32) are left
// for a later change: they would change the rounding of every leaf.
#include <cuda_runtime.h>

#include "tn_tile.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
    gemm_tn_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int batch, int m, int n, int k, long long sab,
                   long long lda, long long sbb, long long ldb, float alpha) {
  __shared__ __align__(16) TnSmem sm;
  const int r0 = blockIdx.y * kTile;  // rows of C = columns of A
  const int c0 = blockIdx.x * kTile;  // columns of C = columns of B
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int bt = blockIdx.z; bt < batch; bt += gridDim.z) {
    float acc[kMicro][kMicro];
    tn_tile(TnOperand{a + bt * sab, lda, r0, n}, TnOperand{b + bt * sbb, ldb, c0, k}, m, sm,
            acc);
    float* cb = c + (long long)bt * n * k;
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int i = r0 + ty * 8 + ii;
      if (i >= n) continue;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const int j = c0 + tx * 8 + jj;
        if (j < k) cb[(long long)i * k + j] = alpha * acc[ii][jj];
      }
    }
    __syncthreads();  // the next batch entry reuses the shared buffers
  }
}

}  // namespace repro_torch

extern "C" int gemm_tn_f32(const float* a, const float* b, float* c, int batch, int m, int n,
                           int k, long long sab, long long lda, long long sbb, long long ldb,
                           float alpha, void* stream) {
  dim3 grid((k + repro_torch::kTile - 1) / repro_torch::kTile,
            (n + repro_torch::kTile - 1) / repro_torch::kTile, batch < 65535 ? batch : 65535);
  repro_torch::gemm_tn_kernel<<<grid, repro_torch::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a, b, c, batch, m, n, k, sab,
                                                                     lda, sbb, ldb, alpha);
  return static_cast<int>(cudaGetLastError());
}
