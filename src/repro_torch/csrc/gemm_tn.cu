// gemm_tn: C[b] = alpha * A[b]^T B[b], summed in float32, for a whole batch in one launch.
//
// Replaces: gemm_tn_pallas in src/repro/kernels/gemm_tn.py:78 (the Pallas TN
// matmul that is the leaf of every Strassen product). A narrow B (k <=
// kNarrowMaxK columns: CG's, PowerSGD's and serving's products) goes to the
// narrow kernel of tn_narrow.cu instead, which sums each output in the same
// order; the tile engine below takes every wider k.
//
// What bounds it on the H100: operations. A Strassen leaf is 512 x 512 x 512
// (2 * 512^3 = 268 MFLOP on 3 MiB), far above the card's float32 balance
// point (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte), so the ceiling
// is the 67 TFLOP/s of the float32 FMA units outside the tensor cores. The
// first version reached 39 TFLOP/s against cuBLAS's 51: bank conflicts on
// its shared-memory reads paced the FMA loop, its copies ran through
// registers, and it stored scalars (PERF.md).
//
// What the design does about it: the tile engine of tn_tile.cuh — a
// 128 x 128 tile a CTA, 8 x 8 accumulators a thread, warps of 32 x 64 with
// conflict-free LDS.128 reads, and a 3-stage cp.async ring of depth-32
// slabs with one barrier a stage — then float4 stores of each output row
// segment where k allows it (k % 4 == 0), scalar masked stores otherwise.
// Two CTAs share an SM (96 KiB of ring each, at most 128 registers). The
// grid is (k-tiles, n-tiles, batch), so a whole Strassen leaf stack is one
// launch; entries past 65535 stride over gridDim.z. Ragged edges are
// zero-filled by the copies instead of padded. The summation order is the
// engine's (one fmaf chain over depth-8 slabs), so gemm_tn_fused stays
// bitwise equal to this kernel. Tensor cores (TF32) are left out: they
// would change the rounding of every leaf.
//
// Operands are float32 or bfloat16 and the output float32 or bfloat16
// (dtype.cuh): a bfloat16 operand rides the ring as loaded and is
// converted in the multiply; every output is rounded once to its type.
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "tn_narrow.cuh"
#include "tn_tile.cuh"

namespace repro_torch {

template <typename T, typename TO, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_tn_kernel(const T* __restrict__ a, const T* __restrict__ b, TO* __restrict__ c,
                   int batch, int m, int n, int k, long long sab, long long lda, long long sbb,
                   long long ldb, float alpha) {
  extern __shared__ __align__(16) float smem[];
  const TnMap map;
  const int r0 = blockIdx.y * kTile;  // rows of C = columns of A
  const int c0 = blockIdx.x * kTile;  // columns of C = columns of B
  const bool vec_out = (k & 3) == 0;  // every row segment 16 B (8 B bfloat16) aligned
  for (int bt = blockIdx.z; bt < batch; bt += gridDim.z) {
    float acc[kMicro][kMicro];
    tn_tile<T, kVec16>(TnOperand<T>{a + bt * sab, lda, r0, n},
                       TnOperand<T>{b + bt * sbb, ldb, c0, k}, 0, m, smem, map, acc);
    TO* cb = c + (long long)bt * n * k;
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int i = r0 + map.row(ii);
      if (i >= n) continue;
#pragma unroll
      for (int h = 0; h < kMicro; h += 4) {
        const int j = c0 + map.col(h);
        TO* dst = cb + (long long)i * k + j;
        const float v[4] = {alpha * acc[ii][h], alpha * acc[ii][h + 1], alpha * acc[ii][h + 2],
                            alpha * acc[ii][h + 3]};
        if (vec_out && j < k) {
          store4(dst, v);
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            if (j + f < k) store1(dst + f, v[f]);
        }
      }
    }
    __syncthreads();  // the next batch entry refills the ring
  }
}

// The instance's dynamic shared-memory opt-in, once per device.
template <typename T, typename TO, bool kVec16>
static cudaError_t opt_in() {
  static bool done[kMaxDevices] = {};
  return tn_opt_in(reinterpret_cast<const void*>(gemm_tn_kernel<T, TO, kVec16>), kTnSmemBytes,
                   done);
}

template <typename T, typename TO>
static int launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                  long long sab, long long lda, long long sbb, long long ldb, float alpha,
                  int vec16, cudaStream_t stream) {
  if (k <= kNarrowMaxK)
    return tn_narrow_launch<T, TO>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16,
                                   stream);
  cudaError_t err = vec16 ? opt_in<T, TO, true>() : opt_in<T, TO, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((k + kTile - 1) / kTile, (n + kTile - 1) / kTile, batch < 65535 ? batch : 65535);
  auto kernel = vec16 ? gemm_tn_kernel<T, TO, true> : gemm_tn_kernel<T, TO, false>;
  kernel<<<grid, kThreads, kTnSmemBytes, stream>>>(static_cast<const T*>(a),
                                                   static_cast<const T*>(b), static_cast<TO*>(c),
                                                   batch, m, n, k, sab, lda, sbb, ldb, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// vec16: both bases 16 B aligned and every row and batch stride a multiple
// of 16 bytes (the wrapper decides), so the ring fills in 16 B copies.
// dtypes: bit 0 bfloat16 operands, bit 1 bfloat16 output (dtype.cuh).
extern "C" int gemm_tn_f32(const void* a, const void* b, void* c, int batch, int m, int n,
                           int k, long long sab, long long lda, long long sbb, long long ldb,
                           float alpha, int vec16, int dtypes, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes & (kLoadBf16 | kStoreBf16)) {
    case 0:
      return launch<float, float>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16, s);
    case kLoadBf16:
      return launch<bf16, float>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16, s);
    case kStoreBf16:
      return launch<float, bf16>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16, s);
    default:
      return launch<bf16, bf16>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16, s);
  }
}

// out: the tn_info fields of the float32 16 B (vec16 = 1) or 4 B instance; 7 ints.
extern "C" int gemm_tn_info(int vec16, int* out) {
  using namespace repro_torch;
  cudaError_t err = vec16 ? opt_in<float, float, true>() : opt_in<float, float, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tn_info(vec16 ? reinterpret_cast<const void*>(gemm_tn_kernel<float, float, true>)
                    : reinterpret_cast<const void*>(gemm_tn_kernel<float, float, false>),
              out));
}
