// gemm_tn_fused: every Strassen leaf product of one fused level in one launch,
// the leaf operands combined from their slot blocks inside the kernel.
//
// Replaces: gemm_tn_fused_pallas in src/repro/kernels/gemm_tn.py (the Pallas
// leaf launch of leaf_dispatch='fused').
//
// Leaf e = leaf * inner + b computes C[e] = alpha * X^T Y, where
//   X(l, col) = the balanced +-tree over the W slots w of
//               sgn_a[leaf][w] * a[off_a[leaf][w] + b * sab + l * lda + col],
// and Y likewise from b. The wrapper turns the (rows, cols, sign) slot tables
// into element offsets of the caller's block grid, so the grid is read as the
// view it is (the root-padded operand) and no operand stack is written.
//
// What bounds it on the H100: operations. The level-1 launch of ata 8192^2 is
// 686 leaves of 512^3 (184 GFLOP) on 0.27 GB of input; the ceiling is the
// 67 TFLOP/s of the float32 FMA units.
//
// What the design does about it: the CTA, tile and slab loop are gemm_tn's
// (tn_tile_with in tn_tile.cuh), so every output is the same single fmaf
// chain over l; only the element fetch differs. It loads the W slot values
// of an element, negates those of sign -1, and adds them pairwise in the
// order of core.strassen._combine_slots: span 1, 2, 4, ..., a dead (sign-0)
// slot passing its partner through. __fadd_rn keeps each add a separately
// rounded IEEE add. The combined element is therefore bitwise the value the
// unrolled recursion's elementwise adds produce, and the product bitwise
// gemm_tn's on the pre-combined operands. The price is W loads per element
// (served mostly from L2: the slots of neighbouring leaves overlap).
#include <cuda_runtime.h>

#include "tn_tile.cuh"

namespace repro_torch {

// One fused operand of the current leaf: W slot offsets and signs, held in
// shared memory for the CTA.
template <int W>
struct SlotSum {
  const float* p;        // grid base plus the batch entry's offset
  const long long* off;  // W element offsets
  const int* sgn;        // W signs in {-1, 0, +1}
  long long ld;          // row stride

  __device__ __forceinline__ float operator()(int l, int col) const {
    const long long idx = (long long)l * ld + col;
    float v[W];
    bool live[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int s = sgn[w];
      live[w] = s != 0;
      const float x = live[w] ? p[off[w] + idx] : 0.0f;
      v[w] = s < 0 ? -x : x;
    }
#pragma unroll
    for (int span = 1; span < W; span *= 2) {
#pragma unroll
      for (int i = 0; i < W; i += 2 * span) {
        if (live[i] && live[i + span]) {
          v[i] = __fadd_rn(v[i], v[i + span]);
        } else if (live[i + span]) {
          v[i] = v[i + span];
        }
        live[i] = live[i] || live[i + span];
      }
    }
    return v[0];
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads)
    gemm_tn_fused_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const long long* __restrict__ off, const int* __restrict__ sgn,
                         float* __restrict__ c, int leaves, int inner, int m, int n, int k,
                         long long sab, long long lda, long long sbb, long long ldb,
                         float alpha) {
  __shared__ __align__(16) TnSmem sm;
  __shared__ long long s_off[2][W];
  __shared__ int s_sgn[2][W];
  const int r0 = blockIdx.y * kTile;  // rows of C = columns of the X leaf
  const int c0 = blockIdx.x * kTile;  // columns of C = columns of the Y leaf
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long entries = (long long)leaves * inner;
  for (long long e = blockIdx.z; e < entries; e += gridDim.z) {
    const long long leaf = e / inner;
    const long long bt = e % inner;
    if (threadIdx.x < 2 * W) {  // the block loads its own slot indices
      const int side = threadIdx.x / W, w = threadIdx.x % W;
      const long long i = ((long long)side * leaves + leaf) * W + w;
      s_off[side][w] = off[i];
      s_sgn[side][w] = sgn[i];
    }
    __syncthreads();
    float acc[kMicro][kMicro];
    tn_tile_with(SlotSum<W>{a + bt * sab, s_off[0], s_sgn[0], lda}, r0, n,
                 SlotSum<W>{b + bt * sbb, s_off[1], s_sgn[1], ldb}, c0, k, m, sm, acc);
    float* ce = c + e * n * k;
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int i = r0 + ty * 8 + ii;
      if (i >= n) continue;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const int j = c0 + tx * 8 + jj;
        if (j < k) ce[(long long)i * k + j] = alpha * acc[ii][jj];
      }
    }
    __syncthreads();  // the next entry reuses the shared buffers and slot tables
  }
}

template <int W>
static int launch(dim3 grid, cudaStream_t stream, const float* a, const float* b,
                  const long long* off, const int* sgn, float* c, int leaves, int inner, int m,
                  int n, int k, long long sab, long long lda, long long sbb, long long ldb,
                  float alpha) {
  gemm_tn_fused_kernel<W><<<grid, kThreads, 0, stream>>>(a, b, off, sgn, c, leaves, inner, m, n,
                                                         k, sab, lda, sbb, ldb, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// off: (2, leaves, w) int64 element offsets (A side, then B side); sgn: the
// same shape in int32. c: (leaves, inner, n, k). w is 1, 2, 4, 8, 16 or 32.
extern "C" int gemm_tn_fused_f32(const float* a, const float* b, const long long* off,
                                 const int* sgn, float* c, int leaves, int inner, int w, int m,
                                 int n, int k, long long sab, long long lda, long long sbb,
                                 long long ldb, float alpha, void* stream) {
  using repro_torch::kTile;
  using repro_torch::launch;
  const long long entries = (long long)leaves * inner;
  dim3 grid((k + kTile - 1) / kTile, (n + kTile - 1) / kTile,
            static_cast<unsigned>(entries < 65535 ? entries : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch<1>(grid, s, a, b, off, sgn, c, leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha);
    case 2: return launch<2>(grid, s, a, b, off, sgn, c, leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha);
    case 4: return launch<4>(grid, s, a, b, off, sgn, c, leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha);
    case 8: return launch<8>(grid, s, a, b, off, sgn, c, leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha);
    case 16: return launch<16>(grid, s, a, b, off, sgn, c, leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha);
    case 32: return launch<32>(grid, s, a, b, off, sgn, c, leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
