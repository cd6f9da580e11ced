// potrf: lower Cholesky factor of each n x n SPD tile of a stack, one launch.
//
// Replaces: potrf_pallas in src/repro/kernels/potrf.py (the diagonal-block
// factorization of the packed blocked Cholesky).
//
// What bounds it on the H100: latency. A 128 x 128 tile is n^3/3 = 0.7 MFLOP
// on 128 KiB, and the walk calls it once per block column with a single
// tile, so one CTA on one SM does all the work. The first version ran the
// unblocked column recurrence with three block barriers a column (384 at
// n = 128), a rank-1 update that read and wrote shared memory for every
// term, and a tile load that waited on each element; its time was barrier
// and memory latency.
//
// What the design does about it: one CTA per tile, the lower triangle
// resident in shared memory (n(n+1)/2 floats), the recurrence blocked in
// panels of 32 columns, and two block barriers a panel (8 at n = 128, 16 at
// n = 256):
//   (a) warp 0 factors the 32 x 32 diagonal block in registers, lane i
//       holding row i; the pivot and each l[c][j] come by __shfl_sync, so
//       its 32 steps need no block barrier. After each step it publishes
//       column j to shared memory and bumps a counter;
//   (b) at the same time warps 1..7 each take 32 rows below the block (at
//       most 224), one row a lane, and run the row's forward substitution
//       column by column as warp 0 publishes them, waiting on the counter
//       and not on a barrier; each row is stored in place and, transposed,
//       into a second buffer;
//   barrier;
//   (c) the trailing lower triangle is updated by the panel in 4 x 4
//       register tiles, reading the transposed panel as float4;
//   barrier.
// What bounds a panel is warp 0's chain of 32 steps (shuffle, sqrtf, IEEE
// division, shuffle, fmaf) and the instructions around it, which one warp
// runs in order; keeping the rows below off warp 0 cut the kernel's device
// time by a third (measured on the H100, PERF.md).
// Each element sees the terms of the plain recurrence in its order:
// ascending j, one fmaf(-l[i][j], l[k][j], a) each, then an IEEE division by
// sqrtf of the pivot, so the factor is bitwise the one of the unblocked
// recurrence. Ragged n (and the last, narrower panel) is masked, not padded.
// The strict upper half of the output is written as zeros (the factor-tile
// contract).
//
// The tile's lower triangle arrives by cp.async, every copy in flight at
// once, so loading it costs one memory latency, not one per element.
//
// Element types (dtype.cuh): the tile is float32 or bfloat16 (the template's
// T), the factor is computed in float32 and stored as float32 or bfloat16.
// A bfloat16 tile is read with plain loads and converted on the way into
// shared memory (cp.async cannot convert, and a 2-byte element is below its
// smallest copy), so the recurrence above runs on the same float32 tile.
//
// Shared memory: n(n+1)/2 + 32 * round_up(n, 4) floats dynamic, 161 KB at
// n = 256 (opt-in above 48 KB), plus 4 KB static for the published columns.
// Registers and occupancy: chip_smoke.py's resources line (potrf_info) and
// PERF.md.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using repro_torch::bf16;

constexpr int kThreads = 256;
constexpr int kPanel = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int lo(int i, int j) { return i * (i + 1) / 2 + j; }

__host__ __device__ __forceinline__ int tri_floats(int n) {
  return (n * (n + 1) / 2 + 3) / 4 * 4;  // the panel buffer after it stays 16 B aligned
}

__host__ __device__ __forceinline__ int panel_ld(int n) { return (n + 3) / 4 * 4; }

// (a) The diagonal block [p0, p0 + nb)^2 of a panel, by warp 0: lane i
// holds row p0 + i in registers, the pivot and each l[c][j] come by
// __shfl_sync, and step j publishes column j (its pivot and l[c][j], c > j)
// to col and then the count of published columns to *ready, so the rows
// below can use it at once.
__device__ __forceinline__ void factor_diagonal(float* s, float* col, volatile int* ready,
                                                int p0, int nb, int lane) {
  float r[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    r[c] = (lane < nb && c <= lane) ? s[lo(p0 + lane, p0 + c)] : 0.0f;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (j >= nb) break;
    const float d = sqrtf(__shfl_sync(kFull, r[j], j));
    if (lane > j) {
      r[j] = r[j] / d;
    } else if (lane == j) {
      r[j] = d;
    }
    const float lij = r[j];
    if (lane >= j) col[j * kPanel + lane] = lij;  // column j: the pivot, then l[c][j]
    __threadfence_block();
    __syncwarp();
    if (lane == 0) *ready = p0 + j + 1;
#pragma unroll
    for (int c = j + 1; c < kPanel; ++c) {
      const float lcj = __shfl_sync(kFull, lij, c);
      if (c <= lane && lane < nb) r[c] = fmaf(-lij, lcj, r[c]);
    }
  }
  if (lane < nb) {
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c <= lane) s[lo(p0 + lane, p0 + c)] = r[c];
  }
}

// (b) Row i below a full panel, by one lane of warps 1..7: forward
// substitution against the diagonal block, column by column as warp 0
// publishes it (no block barrier); the row is stored in place and,
// transposed, into pt for the trailing update.
__device__ __forceinline__ void solve_row(float* s, float* pt, int ptld, const float* col,
                                          volatile int* ready, int p0, int q0, int i) {
  float x[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) x[c] = s[lo(i, p0 + c)];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    while (*ready <= p0 + j) {
    }
    __threadfence_block();
    x[j] = x[j] / col[j * kPanel + j];
#pragma unroll
    for (int c = j + 1; c < kPanel; ++c) x[c] = fmaf(-x[j], col[j * kPanel + c], x[c]);
  }
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    s[lo(i, p0 + c)] = x[c];
    pt[c * ptld + (i - q0)] = x[c];
  }
}

// (c) One 4 x 4 tile of the trailing lower triangle [q0, n)^2: rows
// q0 + 4*bi.., columns q0 + 4*bk.. (bk <= bi), minus the panel's 32 terms.
__device__ __forceinline__ void update_tile(float* s, const float* pt, int ptld, int q0, int n,
                                            int bi, int bk) {
  const int i0 = q0 + 4 * bi, k0 = q0 + 4 * bk;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int i = i0 + ii, k = k0 + kk;
      acc[ii][kk] = (i < n && k <= i) ? s[lo(i, k)] : 0.0f;
    }
#pragma unroll 8
  for (int j = 0; j < kPanel; ++j) {
    const float4 li = *reinterpret_cast<const float4*>(&pt[j * ptld + 4 * bi]);
    const float4 lk = *reinterpret_cast<const float4*>(&pt[j * ptld + 4 * bk]);
    const float lv[4] = {li.x, li.y, li.z, li.w};
    const float kv[4] = {lk.x, lk.y, lk.z, lk.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc[ii][kk] = fmaf(-lv[ii], kv[kk], acc[ii][kk]);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int i = i0 + ii, k = k0 + kk;
      if (i < n && k <= i) s[lo(i, k)] = acc[ii][kk];
    }
}

// Lower-triangular tile enumeration t = bi(bi+1)/2 + bk.
__device__ __forceinline__ void tile_coords(int t, int& bi, int& bk) {
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= t) i += 1;
  if (i * (i + 1) / 2 > t) i -= 1;
  bi = i;
  bk = t - i * (i + 1) / 2;
}

// The tile's lower triangle into s: asynchronous 4-byte copies, all in
// flight at once (float32), or plain loads converted to float32 (bfloat16).
__device__ __forceinline__ void load_lower(float* s, const float* ab, int n, int lane, int warp) {
  for (int r = warp; r < n; r += kThreads / 32)
    for (int c = lane; c <= r; c += 32) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(&s[lo(r, c)]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(ab + r * n + c)
                   : "memory");
    }
}

__device__ __forceinline__ void load_lower(float* s, const bf16* ab, int n, int lane, int warp) {
  for (int r = warp; r < n; r += kThreads / 32)
    for (int c = lane; c <= r; c += 32) s[lo(r, c)] = __bfloat162float(ab[r * n + c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    potrf_kernel(const T* __restrict__ a, void* __restrict__ l, int batch, int n,
                 bool bf16_out) {
  extern __shared__ __align__(16) float s[];  // lower triangle, row-major packed
  float* pt = s + tri_floats(n);              // [kPanel][ptld]: the panel below its block
  __shared__ float col[kPanel * kPanel];      // the diagonal block's columns, as published
  __shared__ int ready_count;                 // columns of the tile published so far
  volatile int* ready = &ready_count;
  const int ptld = panel_ld(n);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long nn = (long long)n * n;
  for (int bt = blockIdx.x; bt < batch; bt += gridDim.x) {
    load_lower(s, a + bt * nn, n, lane, warp);
    if (tid == 0) *ready = 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int p0 = 0; p0 < n; p0 += kPanel) {
      const int nb = n - p0 < kPanel ? n - p0 : kPanel;
      const int q0 = p0 + nb;
      if (warp == 0) {
        factor_diagonal(s, col, ready, p0, nb, lane);
      } else if (q0 + 32 * (warp - 1) + lane < n) {  // warp w > 0: row q0 + 32(w-1) + lane
        solve_row(s, pt, ptld, col, ready, p0, q0, q0 + 32 * (warp - 1) + lane);
      }
      __syncthreads();
      if (q0 >= n) break;  // the last panel has nothing below it
      const int nt = (n - q0 + 3) / 4;
      for (int t = tid; t < nt * (nt + 1) / 2; t += kThreads) {
        int bi, bk;
        tile_coords(t, bi, bk);
        update_tile(s, pt, ptld, q0, n, bi, bk);
      }
      __syncthreads();
    }
    const long long lb = bt * nn;
    for (int r = warp; r < n; r += kThreads / 32)
      for (int c = lane; c < n; c += 32)
        repro_torch::store1(l, lb + r * n + c, c <= r ? s[lo(r, c)] : 0.0f, bf16_out);
    __syncthreads();  // the next tile reuses the shared buffer
  }
}

int smem_bytes(int n) { return (tri_floats(n) + kPanel * panel_ld(n)) * (int)sizeof(float); }

template <typename T>
int launch(const void* a, void* l, int batch, int n, bool bf16_out, cudaStream_t stream) {
  const int smem = smem_bytes(n);
  cudaError_t err =
      cudaFuncSetAttribute(potrf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = batch < 65535 ? batch : 65535;
  potrf_kernel<T><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(a), l, batch, n,
                                                    bf16_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtypes: bit 0 bfloat16 tiles, bit 1 bfloat16 factor (dtype.cuh).
extern "C" int potrf_f32(const void* a, void* l, int batch, int n, int dtypes, void* stream) {
  const bool out16 = (dtypes & repro_torch::kStoreBf16) != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (dtypes & repro_torch::kLoadBf16) ? launch<bf16>(a, l, batch, n, out16, s)
                                           : launch<float>(a, l, batch, n, out16, s);
}

// out: registers per thread, static shared bytes, dynamic shared bytes at n,
// local (spill) bytes, resident CTAs per SM at n; of the float32 instance.
extern "C" int potrf_info(int n, int* out) {
  const int smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(potrf_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, potrf_kernel<float>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, potrf_kernel<float>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  return 0;
}
