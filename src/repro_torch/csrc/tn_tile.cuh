// Shared TN tile engine of the gemm_tn, syrk and syrk_gather kernels.
//
// Replaces the inner loop of gemm_tn_pallas (src/repro/kernels/gemm_tn.py:78)
// and of the syrk kernels (src/repro/kernels/syrk.py): one CTA of 256
// threads computes a 128 x 128 tile of C = X^T Y, where X (m x nx) and Y
// (m x ny) are row-major with unit column stride. The tile covers C rows
// [r0, r0+128) (columns of X) and C columns [c0, c0+128) (columns of Y);
// each thread keeps an 8 x 8 block of float32 accumulators in registers.
// X^T is never formed: slab rows X[l, r0:r0+128] are contiguous, so they
// land in shared memory already in the k-major layout the multiply reads.
//
// What bounds it on the H100: the float32 FMA pipe (67 TFLOP/s outside the
// tensor cores), provided shared memory and the copies keep up. The first
// engine did not: its threads sat on a flat 16 x 16 grid with 8 contiguous
// columns each, so every float4 read of Y put quarter-warp lanes 32 bytes
// apart (a 2-way bank conflict on every read, the shared-memory pipe
// pacing the loop); each slab went through registers with scalar loads and
// stores that took issue slots from the FMAs; and two buffers meant one
// block barrier every 8 rows. It ran at 39 TFLOP/s (PERF.md).
//
// What this engine does about it:
// * Warp tiling without bank conflicts. Warp w owns 32 rows x 64 columns of
//   the tile, its lanes 4 x 8; thread (ty, tx) holds rows 4*ty + {0..3} and
//   64 + 4*ty + {0..3}, columns 4*tx + {0..3} and 64 + 4*tx + {0..3}
//   (TnMap). Each quarter-warp shares one ty and has 8 consecutive tx, so
//   every LDS.128 of the multiply reads 128 contiguous bytes (Y) or one
//   broadcast address (X): no bank conflicts.
// * An async copy ring. kStages stages of kSlab rows of X and Y each sit in
//   dynamic shared memory, filled by cp.async, kStages - 1 stages ahead of
//   the multiply, with one block barrier per stage; 3 stages of 32 rows
//   (96 KiB) measured fastest on the H100 among 2 to 4 stages of 8, 16 and
//   32 rows (PERF.md): deeper stages cost fewer barriers. 16-byte copies
//   where the host found every base, row stride and batch stride a
//   multiple of 16 bytes (kVec16: 4 float32 elements),
//   element copies otherwise. Rows at or past m and columns at or past a
//   limit are zero-filled through the copy's source size, so the loop has
//   no mask branch.
// * The epilogues use TnMap: gemm_tn stores float4 rows from the registers,
//   syrk stages the tile in the ring's shared memory first (syrk.cu).
//
// Summation order, the contract every caller relies on: tn_tile sums rows
// [l0, l1) of the operands (l0 a multiple of kSlab) as one fmaf chain over
// l = l0, l0 + 1, ... in ascending order, over the depth-8 slabs that start
// below l1 (rows past l1 being exact zeros), whatever the tile, the batch
// index, the batch size or kSlab. gemm_tn calls it with [0, m): every
// output is one chain. For k <= kNarrowMaxK gemm_tn runs tn_narrow.cu's
// kernel instead, which sums the same chain over [0, m) and then adds the
// one +0 of the zero rows that end the engine's last depth-8 slab, so either
// kernel gives the same bits. syrk splits m into K(m, n) ranges and adds the K
// chains in one fixed order (syrk.cu), K being a function of (m, n) alone.
// Two launches that see the same operands therefore give bitwise-equal
// outputs; gemm_tn_fused.cu runs the same depth-8 chain on its combined
// slabs and is bitwise equal to gemm_tn; and because fmaf(x, y, s) ==
// fmaf(y, x, s), C[i][j] and C[j][i] of a syrk are bitwise equal too.
//
// kSkipUpper (syrk's diagonal tiles only): every thread's acc[ii < 4][jj >= 4]
// is tile element (row < 64, column >= 64), strictly above the diagonal of a
// tile whose rows and columns are the same indices. Those 16 of the 64
// accumulators are left at zero, their FMAs never issued; the caller must
// not store them. kCompact unrolls one depth-8 slab of the multiply instead
// of a whole stage of four: syrk inlines two instances of the loop (with
// and without kSkipUpper), and two fully unrolled ones (37 and 28 KB of
// code) ran slower than one (PERF.md). Both off by default: gemm_tn compiles
// as without them.
#pragma once

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace repro_torch {

constexpr int kTile = 128;    // output tile edge
constexpr int kDepth = 8;     // summation slab: the fmaf chain runs over whole depth-8 slabs
constexpr int kThreads = 256; // 8 warps of 32 x 64 outputs, 8 x 8 a thread
constexpr int kMicro = 8;
constexpr int kSlab = 32;     // rows of X and of Y in one ring stage (four depth-8 slabs)
constexpr int kStages = 3;    // ring depth: 96 KiB of float32, two CTAs an SM
constexpr int kStageElems = 2 * kSlab * kTile;
constexpr int kTnSmemBytes = kStages * kStageElems * static_cast<int>(sizeof(float));
constexpr int kMaxDevices = 64;

// The operands' element type T is float: bfloat16 operands run the
// tensor-core kernels (tn_wgmma.cuh).
template <typename T>
struct TnOperand {
  const T* p;      // element (0, 0) of this batch entry
  long long ld;    // row stride in elements
  int col0;        // first column of the tile
  int col_lim;     // columns at or beyond this load as 0
};

// The thread -> output map of the engine: accumulator acc[ii][jj] is tile
// element (row(ii), col(jj)). Every epilogue goes through it.
struct TnMap {
  int ty, tx;
  __device__ __forceinline__ TnMap() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    tx = (warp % 2) * 8 + lane % 8;
    ty = (warp / 2) * 4 + lane / 8;
  }
  __device__ __forceinline__ int row(int ii) const { return 4 * ty + (ii & 3) + (ii & 4) * 16; }
  __device__ __forceinline__ int col(int jj) const { return 4 * tx + (jj & 3) + (jj & 4) * 16; }
};

__device__ __forceinline__ void tn_copy16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tn_copy4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tn_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void tn_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of a stage of one operand: rows rr, rr + kRowsPerPass,
// ... of the slab, the kVec columns starting at col0 + cq. A 16-byte copy
// holds kVec = 4 float32 elements.
template <typename T>
struct TnCopy {
  static_assert(sizeof(T) == 4, "the tile engine loads float32");
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLanesPerRow = kTile / kVec;          // 32
  static constexpr int kRowsPerPass = kThreads / kLanesPerRow;  // 8

  const T* base;  // the operand's element (0, 0): a valid source for empty copies
  const T* src;   // element (0, col0 + cq), or base if no column is live
  long long ld;
  int avail;      // live columns of the copy, 0..kVec

  __device__ __forceinline__ TnCopy(const TnOperand<T>& o, int cq) {
    base = o.p;
    ld = o.ld;
    const int lim = o.col_lim - (o.col0 + cq);
    avail = lim < 0 ? 0 : lim > kVec ? kVec : lim;
    src = avail ? o.p + o.col0 + cq : o.p;
  }

  // Rows at or past m and columns past avail land as zeros, through the
  // copy's source size in bytes (sizeof(T) a live element).
  template <bool kVec16>
  __device__ __forceinline__ void stage(T* dst, int l, int m) const {
    const bool live = l < m && avail > 0;
    const T* row = live ? src + (long long)l * ld : base;
    if constexpr (kVec16) {
      tn_copy16(dst, row, live ? static_cast<int>(sizeof(T)) * avail : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const bool on = live && e < avail;
        tn_copy4(dst + e, on ? row + e : base, on ? 4 : 0);
      }
    }
  }
};

// acc[ii][jj] = sum_{l0 <= l < l1} X(l, x.col0 + map.row(ii)) * Y(l, y.col0 + map.col(jj)),
// X(l, col) being 0 for col >= x.col_lim (Y likewise); l0 <= l1, l0 a
// multiple of kSlab. smem holds kTnSmemBytes. The caller meets a
// __syncthreads() between two calls, and before it overwrites the ring (the
// next call's copies land in stages the last one may still read).
template <typename T, bool kVec16, bool kSkipUpper = false, bool kCompact = false>
__device__ __forceinline__ void tn_tile(const TnOperand<T> x, const TnOperand<T> y, int l0,
                                        int l1, float* smem, const TnMap& map,
                                        float acc[kMicro][kMicro]) {
  using Copy = TnCopy<T>;
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int rr = tid / Copy::kLanesPerRow, cq = Copy::kVec * (tid % Copy::kLanesPerRow);
  const Copy cx(x, cq), cy(y, cq);

#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) acc[ii][jj] = 0.0f;

  // stage s holds slab rows l0 + [s*kSlab, (s+1)*kSlab) of X, then of Y
  auto copy = [&](int s) {
    T* xs = ring + (s % kStages) * kStageElems;
    T* ys = xs + kSlab * kTile;
#pragma unroll
    for (int u = 0; u < kSlab / Copy::kRowsPerPass; ++u) {
      const int r = rr + Copy::kRowsPerPass * u, l = l0 + s * kSlab + r;
      cx.template stage<kVec16>(xs + r * kTile + cq, l, l1);
      cy.template stage<kVec16>(ys + r * kTile + cq, l, l1);
    }
  };

  const int rows = l1 - l0;
  const int slabs = (rows + kSlab - 1) / kSlab;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) copy(s);
    tn_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    tn_wait<kStages - 2>();  // stage s has landed (this thread's copies) ...
    __syncthreads();         // ... everyone's, and stage s-1 is no longer read
    if (s + kStages - 1 < slabs) copy(s + kStages - 1);
    tn_commit();
    const T* xs = ring + (s % kStages) * kStageElems;
    const T* ys = xs + kSlab * kTile;
#pragma unroll (kCompact ? 1 : kSlab / kDepth)
    for (int h = 0; h < kSlab / kDepth; ++h) {
      if (s * kSlab + h * kDepth >= rows) break;  // only the depth-8 slabs that start below l1
#pragma unroll
      for (int kk = h * kDepth; kk < (h + 1) * kDepth; ++kk) {
        const T* xr = xs + kk * kTile + 4 * map.ty;
        const T* yr = ys + kk * kTile + 4 * map.tx;
        const float4 a0 = load4(xr);
        const float4 a1 = load4(xr + 64);
        const float4 b0 = load4(yr);
        const float4 b1 = load4(yr + 64);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
          for (int jj = 0; jj < kMicro; ++jj) {
            if (kSkipUpper && ii < kMicro / 2 && jj >= kMicro / 2) continue;
            acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
          }
      }
    }
  }
}

// Opts a kernel in to `bytes` of dynamic shared memory on the current
// device, once per device: `done` is the calling instance's own flags.
inline cudaError_t tn_opt_in(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

// A tile kernel's resources on the current device: registers per thread,
// static shared bytes, dynamic shared bytes, local (spill) bytes, resident
// CTAs per SM, ring stages, rows a stage.
inline cudaError_t tn_info(const void* kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kTnSmemBytes);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = kTnSmemBytes;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = kStages;
  out[6] = kSlab;
  return cudaSuccess;
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
