// syrk: C[b] = alpha * A[b]^T A[b] in float32, lower tiles only, in one launch.
//
// Replaces: syrk_pallas in src/repro/kernels/syrk.py (the Pallas kernel for
// the diagonal leaves of ATA, dense dual-write and packed output modes).
//
// What bounds it on the H100: operations, like gemm_tn. A diagonal leaf is
// 512 x 512 over 512 rows (m n (n+1) = 134 MFLOP symmetric-aware on 2 MiB);
// the packed (2048, 1000) call is about 2 GFLOP on 9 MB. Both sit well above
// the float32 balance point, so the ceiling is the 67 TFLOP/s of the FMA
// units.
//
// What the design does about it: the grid visits only lower tile pairs, so
// the upper half of C costs no arithmetic. blockIdx.x enumerates them as
// t = i(i+1)/2 + j and recovers (i, j) with the reference's float sqrt and
// integer correction (tri_coords). Each CTA runs the 128 x 128 TN tile
// engine of tn_tile.cuh, which gemm_tn also runs (warp-tiled, conflict-free
// shared-memory reads behind a cp.async ring), with A as both operands, then
// writes the tile and its transpose straight from the registers through the
// engine's thread map (the TPU kernel's dual write):
//   dense  — (i, j) are 128-tiles of the n x n output; a diagonal tile keeps
//            its lower half and mirrors it up (sym_tile), so the output is
//            bitwise symmetric with no pass over the square afterwards;
//   packed — (i, j) are storage blocks of edge bn (default_block_size, e.g.
//            256 or 104); blockIdx.y picks one 128-tile of the block, since
//            a 256 x 256 float32 accumulator does not fit one CTA's
//            registers. Upper sub-tiles of a diagonal block are skipped and
//            filled by the mirror writes of the lower ones.
// Rows and columns past n load as zero, so pad entries of a packed block are
// exact zeros, as in the reference.
//
// syrk_gather_f32 also replaces syrk_gather_pallas (src/repro/kernels/syrk.py),
// the diagonal leaves of the fused leaf dispatch: the same dense grid, but
// stack entry s = e / inner starts at its own element offset offs[s] (block
// (rows[s], cols[s]) of the caller's block-major grid, computed by the
// wrapper), so the gathered (S, ...) stack is never copied. The arithmetic
// per entry is the dense syrk's, so the two agree bitwise on the same leaf.
#include <cuda_runtime.h>

#include "tn_tile.cuh"

namespace repro_torch {

template <bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
    syrk_kernel(const float* __restrict__ a, float* __restrict__ c, int batch, int m, int n,
                long long sab, long long lda, float alpha, int packed, int bn, int sub,
                const long long* __restrict__ offs, int inner) {
  extern __shared__ __align__(16) float smem[];
  const TnMap map;
  int bi, bj;
  tri_coords(blockIdx.x, bi, bj);
  int p = bi, q = bj, rlim = n, clim = n, r0, c0;
  if (packed) {
    p = blockIdx.y / sub;
    q = blockIdx.y % sub;
    if (bi == bj && p < q) return;  // filled by the mirror of sub-tile (q, p)
    r0 = bi * bn + p * kTile;
    c0 = bj * bn + q * kTile;
    rlim = min(n, (bi + 1) * bn);
    clim = min(n, (bj + 1) * bn);
  } else {
    r0 = p * kTile;
    c0 = q * kTile;
  }
  const long long t_total = (long long)gridDim.x;
  for (int bt = blockIdx.z; bt < batch; bt += gridDim.z) {
    float acc[kMicro][kMicro];
    const float* ab = offs ? a + offs[bt / inner] + (long long)(bt % inner) * sab
                           : a + (long long)bt * sab;
    tn_tile<kVec16>(TnOperand{ab, lda, r0, rlim}, TnOperand{ab, lda, c0, clim}, m, smem, map,
                    acc);
    // dst(i, j) is element (i, j) of the n x n matrix (dense) or of storage
    // block t (packed); (i, j) below are coordinates within that target.
    float* dst;
    int ld, ilim, i0, j0;
    if (packed) {
      dst = c + ((long long)bt * t_total + blockIdx.x) * bn * bn;
      ld = bn;
      ilim = bn;
      i0 = p * kTile;
      j0 = q * kTile;
    } else {
      dst = c + (long long)bt * n * n;
      ld = n;
      ilim = n;
      i0 = r0;
      j0 = c0;
    }
    const bool diag_block = packed ? (bi == bj) : true;
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int i = i0 + map.row(ii);
      if (i >= ilim) continue;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const int j = j0 + map.col(jj);
        if (j >= ilim) continue;
        const float v = alpha * acc[ii][jj];
        if (!diag_block) {  // off-diagonal storage block: full tile
          dst[(long long)i * ld + j] = v;
        } else if (p > q || i >= j) {  // lower half of a symmetric target
          dst[(long long)i * ld + j] = v;
          dst[(long long)j * ld + i] = v;
        }
      }
    }
    __syncthreads();  // the next batch entry reuses the shared buffers
  }
}

template <bool kVec16>
static int launch(dim3 grid, const float* a, float* c, int batch, int m, int n, long long sab,
                  long long lda, float alpha, int packed, int bn, int sub, const long long* offs,
                  int inner, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err =
      tn_opt_in(reinterpret_cast<const void*>(syrk_kernel<kVec16>), kTnSmemBytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  syrk_kernel<kVec16><<<grid, kThreads, kTnSmemBytes, stream>>>(a, c, batch, m, n, sab, lda,
                                                                alpha, packed, bn, sub, offs, inner);
  return static_cast<int>(cudaGetLastError());
}

static int launch(int vec16, dim3 grid, const float* a, float* c, int batch, int m, int n,
                  long long sab, long long lda, float alpha, int packed, int bn, int sub,
                  const long long* offs, int inner, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec16 ? launch<true>(grid, a, c, batch, m, n, sab, lda, alpha, packed, bn, sub, offs,
                              inner, s)
               : launch<false>(grid, a, c, batch, m, n, sab, lda, alpha, packed, bn, sub, offs,
                               inner, s);
}

}  // namespace repro_torch

// packed == 0: c is (batch, n, n); the grid covers the lower 128-tile pairs.
// packed == 1: c is (batch, T, bn, bn) with T = nb(nb+1)/2, nb = ceil(n/bn).
// vec16: a 16 B aligned, lda and sab multiples of 4 floats (16 B copies).
extern "C" int syrk_f32(const float* a, float* c, int batch, int m, int n, long long sab,
                        long long lda, float alpha, int packed, int bn, int vec16, void* stream) {
  using repro_torch::kTile;
  int sub = 1;
  long long nblk;
  if (packed) {
    nblk = (n + bn - 1) / bn;
    sub = (bn + kTile - 1) / kTile;
  } else {
    nblk = (n + kTile - 1) / kTile;
  }
  const long long t_total = nblk * (nblk + 1) / 2;
  if (t_total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(t_total), sub * sub, batch < 65535 ? batch : 65535);
  return repro_torch::launch(vec16, grid, a, c, batch, m, n, sab, lda, alpha, packed, bn, sub,
                             nullptr, 1, stream);
}

// c is (S, inner, n, n): entry (s, b) is the dense syrk of the m x n leaf at
// a + offs[s] + b * sab (row stride lda). vec16 as for syrk_f32, and every
// offs[s] a multiple of 4 floats.
extern "C" int syrk_gather_f32(const float* a, const long long* offs, float* c, int S, int inner,
                               int m, int n, long long sab, long long lda, float alpha, int vec16,
                               void* stream) {
  using repro_torch::kTile;
  const long long nblk = (n + kTile - 1) / kTile;
  const long long t_total = nblk * (nblk + 1) / 2;
  const long long entries = (long long)S * inner;
  if (t_total > 2147483647LL || entries > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int batch = static_cast<int>(entries);
  dim3 grid(static_cast<unsigned>(t_total), 1, batch < 65535 ? batch : 65535);
  return repro_torch::launch(vec16, grid, a, c, batch, m, n, sab, lda, alpha, 0, 0, 1, offs,
                             inner, stream);
}
