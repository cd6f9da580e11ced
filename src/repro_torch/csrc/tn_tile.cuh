// Shared TN tile engine of the gemm_tn and syrk kernels (gemm_tn_fused.cu
// runs the same depth-8 FMA loop on its own combined slabs).
//
// One CTA of 256 threads computes a 128 x 128 tile of C = X^T Y, where
// X (m x nx) and Y (m x ny) are row-major with unit column stride; the tile
// covers C rows [r0, r0+128) (columns of X) and C columns [c0, c0+128)
// (columns of Y). Each thread keeps an 8 x 8 block of float32 accumulators
// in registers. The contraction runs as one loop inside the CTA over
// depth-8 slabs: X[l0:l0+8, r0:r0+128] and Y[l0:l0+8, c0:c0+128] are
// contiguous along their rows, so a warp loads 32 consecutive floats
// (coalesced) and the slab lands in shared memory already in the "k-major"
// layout the outer-product loop reads. X^T is never formed.
//
// Ragged edges are masked in the loads: entries at or beyond a limit load
// as 0, which adds an exact 0 to the sums, so no padded copy is needed.
//
// Summation order: every output is one fmaf chain over l = 0, 1, ..., m-1,
// whatever the tile, the batch index or the batch size. Two launches that
// see the same operands therefore give bitwise-equal outputs, and because
// fmaf(x, y, s) == fmaf(y, x, s), C[i][j] and C[j][i] of a syrk are
// bitwise equal too.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kTile = 128;    // output tile edge
constexpr int kDepth = 8;     // contraction slab depth
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMicro = 8;

struct TnOperand {
  const float* p;  // element (0, 0) of this batch entry
  long long ld;    // row stride in elements
  int col0;        // first column of the tile
  int col_lim;     // columns at or beyond this load as 0
};

// Shared-memory staging of one CTA: two slabs of X and of Y (double buffer).
struct TnSmem {
  float xs[2][kDepth][kTile];
  float ys[2][kDepth][kTile];
};

// Row loader of a plain operand: element (l, col) at p[l * ld + col].
struct RowLoad {
  const float* p;
  long long ld;
  __device__ __forceinline__ float operator()(int l, int col) const {
    return p[(long long)l * ld + col];
  }
};

// Accumulates acc[ii][jj] = sum_l X(l, x0 + ty*8 + ii) * Y(l, y0 + tx*8 + jj),
// where X(l, col) = lx(l, col) for l < m and col < xlim and 0 otherwise (Y
// likewise). A loader is any callable float(int l, int col); RowLoad reads a
// strided operand.
//
// The next slab is fetched into registers while the current one is being
// multiplied out of shared memory, and shared memory is double-buffered, so
// one __syncthreads per slab suffices: a thread that writes buffer b at slab
// s has passed the barrier of slab s-1, which every thread reaches only
// after it finished reading buffer b at slab s-2.
template <class LX, class LY>
__device__ __forceinline__ void tn_tile_with(const LX& lx, int x0, int xlim, const LY& ly, int y0,
                                             int ylim, int m, TnSmem& sm,
                                             float acc[kMicro][kMicro]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lrow = tid / 32;  // slab row this thread loads
  const int lcol = tid % 32;  // first column it loads (then +32, +64, +96)

#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) acc[ii][jj] = 0.0f;

  float px[4], py[4];
  auto fetch = [&](int l0) {
    const int l = l0 + lrow;
    const bool lok = l < m;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cx = x0 + lcol + 32 * e, cy = y0 + lcol + 32 * e;
      px[e] = (lok && cx < xlim) ? lx(l, cx) : 0.0f;
      py[e] = (lok && cy < ylim) ? ly(l, cy) : 0.0f;
    }
  };

  fetch(0);
  int buf = 0;
  for (int l0 = 0; l0 < m; l0 += kDepth) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.xs[buf][lrow][lcol + 32 * e] = px[e];
      sm.ys[buf][lrow][lcol + 32 * e] = py[e];
    }
    __syncthreads();
    if (l0 + kDepth < m) fetch(l0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.xs[buf][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.xs[buf][kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.ys[buf][kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.ys[buf][kk][tx * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
    buf ^= 1;
  }
}

// The plain form: X and Y are strided row-major operands.
__device__ __forceinline__ void tn_tile(const TnOperand x, const TnOperand y, int m,
                                        TnSmem& sm, float acc[kMicro][kMicro]) {
  tn_tile_with(RowLoad{x.p, x.ld}, x.col0, x.col_lim, RowLoad{y.p, y.ld}, y.col0, y.col_lim, m,
               sm, acc);
}

// Packed lower-triangular tile enumeration t = i(i+1)/2 + j (j <= i): a
// float32 square root, then an integer correction at the boundaries — the
// same map as the reference's _tri_coords and repro_torch.kernels.syrk.
__device__ __forceinline__ void tri_coords(long long t, int& i, int& j) {
  long long ii = (long long)floorf((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) / 2.0f);
  if ((ii + 1) * (ii + 2) / 2 <= t) ii += 1;
  if (ii * (ii + 1) / 2 > t) ii -= 1;
  i = (int)ii;
  j = (int)(t - ii * (ii + 1) / 2);
}

}  // namespace repro_torch
