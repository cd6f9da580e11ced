// trsm: solve X L^T = B (transpose = 1) or X L = B (transpose = 0) for a row
// panel B against a lower-triangular n x n factor L, for a stack, one launch.
//
// Replaces: trsm_pallas in src/repro/kernels/trsm.py:80 (the panel solve of
// the packed blocked Cholesky and the diagonal solves of both substitutions).
//
// What bounds it on the H100: latency. The Cholesky panel (31 panels of
// 128 x 128 against one 128 x 128 factor) is 65 MFLOP on 4 MB, and the
// substitution calls have only r = 8 rows; each row is a chain of n
// dependent steps (an fmaf and an IEEE division), so the time is the length
// of that chain, not the FMA rate or the memory rate. The first
// version kept the rows in shared memory: every step of the chain made a
// shared-memory round trip, two __syncwarp and a triangular index multiply,
// and in the r = 8 call each warp solved one live row beside three dead
// ones.
//
// What the design does about it:
// * One form for both transposes. X L = B is X' L'^T = B' in reversed
//   column order (X'[:, a] = X[:, n-1-a], L'[a][b] = L[n-1-b][n-1-a]), so
//   the kernel runs the forward recurrence on a' = n-1-j: panels of 32
//   columns ascending for transpose = 1, descending for transpose = 0.
// * Rows in registers. A warp owns R rows; lane c holds columns c + 32p of
//   each (8 registers a row at n = 256). In panel P the lanes past j
//   subtract x_j times their entry of L: no shared-memory round trip and no
//   __syncwarp in the chain. IEEE division by L[j][j] as in the plain
//   version.
// * The chain one step ahead. Every lane holds x_j and, fetched by
//   __shfl_sync a step early, lane j+1's column before x_j's term; so
//   x_{j+1} is one fmaf and one division away from x_j, with the shuffle
//   off the critical path. With several rows a warp, lane r divides row
//   r's numerator: one division sequence a step, not R (the division was
//   the largest cost of the panel solve, measured on the H100).
// * The trailing update rides in the chain: at step j the columns of the
//   later panels take x_j's term too, filling the chain's latency, each lane
//   its own columns, reading L from a dense copy with pitch 33
//   (conflict-free, no triangular index).
// * The factor is staged by cp.async, one group a panel: slab P holds rows
//   [32P, 32*np) of op(L)'s columns [32P, 32P + 32), zero past n (10.6 K
//   floats at n = 128; 152 KB at n = 256), and panel P waits only for its
//   own slab (one block barrier a panel). A factor broadcast over the stack
//   (batch stride 0) is staged once a CTA, not once an entry.
// * Rows per warp follow m: R = 1 for m <= 8 (the r = 8 substitution panel
//   runs one row on each of the 8 warps), else 4. CTAs cover the 8R-row
//   blocks and the stack entries.
// Each x_k sees the terms of the unblocked column recurrence in its order:
// ascending j (in a'), one fmaf(-x_j, L'[k][j], x_k) each, then the IEEE
// division by L'[k][k].
//
// Element types (dtype.cuh): factor and panel are float32 or bfloat16 (the
// template's T), the solve runs in float32 and X is stored as float32 or
// bfloat16. A bfloat16 factor is staged with plain loads converted to
// float32 (a 2-byte element is below cp.async's smallest copy), so the
// chain reads the same float32 slabs.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using repro_torch::bf16;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;
constexpr int kPitch = kPanel + 1;  // staged factor row pitch: lanes c read rows c, no conflict
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int panels(int n) { return (n + kPanel - 1) / kPanel; }

// first float of slab P: slabs P' < P hold 32 * (np - P') rows each
__host__ __device__ __forceinline__ int slab_offset(int np, int P) {
  return kPitch * kPanel * (P * np - P * (P - 1) / 2);
}

__host__ __device__ __forceinline__ int smem_bytes(int n) {
  return slab_offset(panels(n), panels(n)) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// One staged factor element: L' from src where live, else 0. float32: a
// 4-byte cp.async zero-filling dead entries; bfloat16: a plain load.
__device__ __forceinline__ void stage_one(float* dst, const float* l, const float* src,
                                          bool live) {
  copy4(dst, live ? src : l, live ? 4 : 0);
}

__device__ __forceinline__ void stage_one(float* dst, const bf16*, const bf16* src, bool live) {
  *dst = live ? __bfloat162float(*src) : 0.0f;
}

// Stage op(L) of one stack entry: slab P element (a - 32P, b - 32P) is
// L'[a][b] for b <= a < n, 1 on the diagonal past n, else 0: a ragged last
// panel then runs all 32 steps like a full one (its dead columns solve
// against 1 and are never stored, and no live column takes their terms),
// so the chain has no per-step branch. One cp.async group per slab, so the
// solve can start on slab 0 while the others land. Global reads are
// coalesced along L's rows in both forms.
template <typename T>
__device__ __forceinline__ void stage_factor(float* g, const T* l, int n, int transpose) {
  const int np = panels(n), lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int P = 0; P < np; ++P) {
    float* gp = g + slab_offset(np, P);
    const int J0 = P * kPanel, rows = kPanel * (np - P);
    if (transpose) {  // L'[a][b] = L[a][b]: lanes along b
      for (int r = warp; r < rows; r += kWarps) {
        const int a = J0 + r, bcol = J0 + lane;
        const bool live = a < n && bcol <= a;
        if (a >= n && bcol == a) {
          gp[r * kPitch + lane] = 1.0f;
        } else {
          stage_one(gp + r * kPitch + lane, l, l + (long long)a * n + bcol, live);
        }
      }
    } else {  // L'[a][b] = L[n-1-b][n-1-a]: lanes along a
      for (int bb = warp; bb < kPanel; bb += kWarps) {
        const int bcol = J0 + bb;
        for (int r = lane; r < rows; r += 32) {
          const int a = J0 + r;
          const bool live = a < n && bcol <= a;
          if (a >= n && bcol == a) {
            gp[r * kPitch + bb] = 1.0f;
          } else {
            stage_one(gp + r * kPitch + bb, l, l + (long long)(n - 1 - bcol) * n + (n - 1 - a),
                      live);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Waits until at most `pending` (0..7) of this thread's copy groups are in flight.
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending) {
#define REPRO_TRSM_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    REPRO_TRSM_WAIT(0) REPRO_TRSM_WAIT(1) REPRO_TRSM_WAIT(2) REPRO_TRSM_WAIT(3)
    REPRO_TRSM_WAIT(4) REPRO_TRSM_WAIT(5) REPRO_TRSM_WAIT(6)
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
#undef REPRO_TRSM_WAIT
  }
}

// x[r] = num[r] / d for the R rows of a warp, num[r] being the same in every
// lane. One row: every lane divides. Several: lane r divides row r's, so
// one division sequence serves all R rows, and the quotients are broadcast.
template <int R>
__device__ __forceinline__ void divide_rows(const float (&num)[R], float d, float (&x)[R],
                                            int lane) {
  if constexpr (R == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = num[r] / d;
  } else {
    float t = num[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
      if (lane == r) t = num[r];
    const float q = t / d;
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = __shfl_sync(kFull, q, r);
  }
}

// R rows a warp, NP >= ceil(n / 32) panels of registers a row.
template <typename T, int R, int NP>
__global__ void __launch_bounds__(kThreads)
    trsm_kernel(const T* __restrict__ l, const T* __restrict__ b, void* __restrict__ x,
                int batch, int m, int n, long long slb, int transpose, bool bf16_out) {
  extern __shared__ __align__(16) float g[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int np = panels(n);
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  for (int bt = blockIdx.y; bt < batch; bt += gridDim.y) {
    const bool restage = bt == (int)blockIdx.y || slb != 0;
    if (restage) {
      if (bt != (int)blockIdx.y) __syncthreads();  // the last entry's reads of g are done
      stage_factor(g, l + bt * slb, n, transpose);
    }
    // the rows, column a' = 32p + lane in lane, while the factor lands
    const T* bb = b + (long long)bt * m * n;
    float v[NP][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int a = kPanel * p + lane, row = row0 + r;
        v[p][r] = (row < m && a < n) ? to_f32(bb[(long long)row * n + (transpose ? a : n - 1 - a)])
                                     : 0.0f;
      }

    for (int P = 0; P < np; ++P) {
      if (restage) {  // slab P has landed, everyone's copies
        wait_groups(np - 1 - P);
        __syncthreads();
      }
      const float* gp = g + slab_offset(np, P);  // row (a - 32P), column (b - 32P)
      float cur[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cur[r] = v[0][r];
#pragma unroll
        for (int p = 1; p < NP; ++p)
          if (p == P) cur[r] = v[p][r];
      }
      // The panel's constants of the chain, in registers before it starts:
      // each division ends its step with a branch (to its slow path), which
      // no load is scheduled across. L'[j][j] and L'[j+1][j] are the same in
      // every lane; lc[j] is the lane's own L'[lane][j].
      float dg[kPanel], sub[kPanel], lc[kPanel];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        dg[j] = gp[j * kPitch + j];
        sub[j] = j + 1 < kPanel ? gp[(j + 1) * kPitch + j] : 0.0f;
        lc[j] = gp[lane * kPitch + j];
      }
      // The later panels' columns take each x_j's term in the chain (the
      // trailing update); their entries of L are loaded a step ahead, so no
      // load waits in the chain.
      bool later[NP];
      float lv[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        later[p] = p > P && p < np;
        lv[p] = gp[(later[p] ? kPanel * (p - P) + lane : 0) * kPitch];
      }
      // The chain, one step ahead: at step j every lane holds x_j and lane
      // j+1's column as it stood before x_j's term (nxt), so x_{j+1} costs
      // an fmaf and a division with no shuffle in between; lane j+1 computes
      // the same fmaf on the same values, so the result is the one of the
      // plain column recurrence.
      float xj[R], nxt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) nxt[r] = __shfl_sync(kFull, cur[r], 0);
      divide_rows<R>(nxt, dg[0], xj, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) nxt[r] = __shfl_sync(kFull, cur[r], 1);
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        float lvn[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          lvn[p] = j + 1 < kPanel ? gp[(later[p] ? kPanel * (p - P) + lane : 0) * kPitch + j + 1]
                                  : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (lane == j) {
            cur[r] = xj[r];
          } else if (lane > j) {
            cur[r] = fmaf(-xj[r], lc[j], cur[r]);
          }
        }
        float nx2[R];
#pragma unroll
        for (int r = 0; r < R; ++r) nx2[r] = __shfl_sync(kFull, cur[r], (j + 2) % 32);
#pragma unroll
        for (int p = 1; p < NP; ++p)
          if (later[p]) {
#pragma unroll
            for (int r = 0; r < R; ++r) v[p][r] = fmaf(-xj[r], lv[p], v[p][r]);
          }
        if (j + 1 < kPanel) {
          float num[R];
#pragma unroll
          for (int r = 0; r < R; ++r) num[r] = fmaf(-xj[r], sub[j], nxt[r]);
          divide_rows<R>(num, dg[j + 1], xj, lane);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) nxt[r] = nx2[r];
#pragma unroll
        for (int p = 0; p < NP; ++p) lv[p] = lvn[p];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          if (p == P) v[p][r] = cur[r];
    }

    const long long xb = (long long)bt * m * n;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int a = kPanel * p + lane, row = row0 + r;
        if (row < m && a < n)
          repro_torch::store1(x, xb + (long long)row * n + (transpose ? a : n - 1 - a), v[p][r],
                              bf16_out);
      }
  }
}

// Sets the instance's shared-memory limit where `bytes` exceeds what it has
// on the current device (so once per n, the first time), and returns it.
template <typename T, int R, int NP>
cudaError_t prepare(int bytes) {
  static int opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && opted_in[device] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(trsm_kernel<T, R, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < kMaxDevices) opted_in[device] = bytes;
  return err;
}

template <typename T, int R, int NP>
int launch(const void* l, const void* b, void* x, int batch, int m, int n, long long slb,
           int transpose, bool bf16_out, cudaStream_t stream) {
  const int smem = smem_bytes(n);
  cudaError_t err = prepare<T, R, NP>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kWarps * R;
  dim3 grid((m + rows - 1) / rows, batch < 65535 ? batch : 65535);
  trsm_kernel<T, R, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), x, batch, m, n, slb, transpose,
      bf16_out);
  return static_cast<int>(cudaGetLastError());
}

// out: registers per thread, static shared bytes, dynamic shared bytes at n,
// local (spill) bytes, resident CTAs per SM at n, rows a warp; of the
// float32 instance.
template <int R, int NP>
int info(int n, int* out) {
  const int smem = smem_bytes(n);
  cudaError_t err = prepare<float, R, NP>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, trsm_kernel<float, R, NP>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trsm_kernel<float, R, NP>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = R;
  return 0;
}

// The instance for (m, n): rows a warp from m, register panels from n.
#define REPRO_TRSM_DISPATCH(CALL)                                     \
  if (n <= 4 * kPanel) return m <= kWarps ? CALL(1, 4) : CALL(4, 4); \
  return m <= kWarps ? CALL(1, 8) : CALL(4, 8);

}  // namespace

// l: element (0, 0) of factor 0, factor b at l + b * slb (slb = 0 broadcasts).
// b, x: (batch, m, n) contiguous; n <= 256. dtypes: bit 0 bfloat16 factor
// and panel, bit 1 bfloat16 X (dtype.cuh).
extern "C" int trsm_f32(const void* l, const void* b, void* x, int batch, int m, int n,
                        long long slb, int transpose, int dtypes, void* stream) {
  if (n < 1 || n > 8 * kPanel) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool in16 = (dtypes & repro_torch::kLoadBf16) != 0;
  const bool out16 = (dtypes & repro_torch::kStoreBf16) != 0;
#define REPRO_TRSM_LAUNCH(R, NP)                                                        \
  (in16 ? launch<bf16, R, NP>(l, b, x, batch, m, n, slb, transpose, out16, s)           \
        : launch<float, R, NP>(l, b, x, batch, m, n, slb, transpose, out16, s))
  REPRO_TRSM_DISPATCH(REPRO_TRSM_LAUNCH)
#undef REPRO_TRSM_LAUNCH
}

// Resources of the instance trsm_f32 launches for (m, n); out holds 6 ints.
extern "C" int trsm_info(int n, int m, int* out) {
  if (n < 1 || n > 8 * kPanel) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_TRSM_INFO(R, NP) info<R, NP>(n, out)
  REPRO_TRSM_DISPATCH(REPRO_TRSM_INFO)
#undef REPRO_TRSM_INFO
}
