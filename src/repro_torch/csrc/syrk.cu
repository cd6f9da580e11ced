// syrk: C[b] = alpha * A[b]^T A[b], summed in float32, lower tiles only, in one launch.
//
// Replaces: syrk_pallas in src/repro/kernels/syrk.py (the Pallas kernel for
// the diagonal leaves of ATA, dense dual-write and packed output modes).
//
// What bounds it on the H100: operations, like gemm_tn. A diagonal leaf is
// 512 x 512 over 512 rows (m n (n+1) = 134 MFLOP symmetric-aware on 2 MiB);
// lstsq's leaf is 512 x 512 over 2048 rows (538 MFLOP on 4 MiB). Both sit
// well above the float32 balance point, so the ceiling is the 67 TFLOP/s of
// the FMA units.
//
// What the design does about it:
// * Lower tiles only. The grid visits lower tile pairs, enumerated as
//   t = i(i+1)/2 + j and recovered with the reference's float sqrt and
//   integer correction (tri_coords). Each CTA runs the 128 x 128 TN tile
//   engine of tn_tile.cuh (warp-tiled, conflict-free shared-memory reads
//   behind a cp.async ring) with A as both operands.
// * Diagonal tiles skip their dead quadrant. On a tile whose rows and
//   columns are the same indices, every thread's acc[ii < 4][jj >= 4] is
//   strictly upper and never stored, so that tile runs the engine with
//   kSkipUpper: 48 of the 64 FMAs a step. Both engine instances unroll one
//   depth-8 slab (kCompact): with two whole-stage bodies the skip lost.
// * A coalesced dual-write epilogue. The CTA stages alpha * acc in the
//   ring's shared memory (64 KiB of its 96), 16-byte chunk c of tile row i
//   at chunk c ^ ((i / 4) % 8), which keeps the register stores, the row
//   reads and the 4 x 4 block reads below free of bank conflicts. Each lane
//   then takes a 4 x 4 block (4 LDS.128), a warp 4 block rows x 8 block
//   columns, and writes the block's rows and, transposed in registers, its
//   mirror: float4 stores where ld is a multiple of 4 floats (whole 128 B
//   lines for the rows, whole 32 B sectors for the mirror), scalar stores of
//   the same runs otherwise. A diagonal target writes sym of the lower half
//   (T[max(i,j)][min(i,j)]), so the output is bitwise symmetric with no pass
//   over the square afterwards.
// * A cluster-split contraction when the grid is small. m is split into K
//   row ranges [r*chunk, (r+1)*chunk), chunk a multiple of 32; the K CTAs
//   of one output tile form a thread-block cluster along x (grid
//   (T*K, sub^2, batch)). Each runs the engine over its range and stages its
//   partial; after one cluster barrier, CTA r sums its share of the tile's
//   4 x 4 blocks over all K partials through distributed shared memory and
//   writes them. No workspace in global memory, no second launch. K is a
//   template parameter (one instance each for 1, 2, 4, 8), so the
//   epilogue's loops are unrolled. lstsq's single (2048, 512) leaf has 10
//   tiles: 10 CTAs on 132 SMs unsplit, 80 at K = 8.
//
// Summation order, the contract of every output: with p_r the engine's
// fmaf chain over rows [r*chunk, min(m, (r+1)*chunk)) (tn_tile.cuh),
//   C = (...((alpha*p_0 + alpha*p_1) + alpha*p_2) ... + alpha*p_{K-1}),
// rank order, each product and sum rounded once (__fmul_rn, __fadd_rn).
// K = splits is chosen by the wrapper (repro_torch.kernels.syrk.syrk_splits)
// from (m, n) alone, and chunk from (m, K) here, so a batch entry equals its
// single launch, packed equals dense, and syrk_gather equals syrk on the
// stacked leaves, bitwise. At K = 1 an output is alpha * p_0.
//
// Output targets: dense — (i, j) are 128-tiles of the n x n output; packed —
// (i, j) are storage blocks of edge bn (default_block_size, e.g. 256 or
// 104) and blockIdx.y picks one 128-tile of the block. Upper sub-tiles of a
// diagonal block are skipped and filled by the mirror writes of the lower
// ones; off-diagonal storage blocks write the tile only. Rows and columns
// past n load as zero, so pad entries of a packed block are exact zeros, as
// in the reference.
//
// syrk_gather_f32 also replaces syrk_gather_pallas (src/repro/kernels/syrk.py),
// the diagonal leaves of the fused leaf dispatch: the same dense grid, but
// stack entry s = e / inner starts at its own element offset offs[s] (block
// (rows[s], cols[s]) of the caller's block-major grid, computed by the
// wrapper), so the gathered (S, ...) stack is never copied. The arithmetic
// per entry is the dense syrk's, so the two agree bitwise on the same leaf.
//
// Operands are float32 or bfloat16 and the output float32 or bfloat16
// (dtype.cuh). The partials are staged and summed in float32 whatever the
// types; the dual write rounds each output once to its type and stores a
// 4 x 4 block's rows as 16-byte float32 or 8-byte bfloat16 runs. With the
// 4 x 4 blocks of this lane map a bfloat16 row run of a quarter-warp still
// fills whole 32-byte sectors, so the lane map is the float32 one.
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"
#include "tn_tile.cuh"

namespace repro_torch {

constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = kTile / 4;                       // 4 x 4 blocks a tile edge
constexpr int kGroups = (kBlocks / 4) * (kBlocks / 8);   // warp groups of 4 x 8 blocks

struct SyrkArgs {
  const void* a;          // float32 or bfloat16 elements (the instance's T)
  void* c;                // float32 or bfloat16 elements (the instance's TO)
  const long long* offs;  // per-entry element offsets (syrk_gather), or null
  long long sab, lda;     // batch and row strides of a, in elements
  int batch, inner;       // entries; entry e reads a + offs[e / inner] + (e % inner) * sab
  int m, n;
  float alpha;
  int packed, bn, sub;    // packed: storage block edge, 128-tiles a block edge
  int chunk;              // CTA r of a cluster of K sums rows [r*chunk, (r+1)*chunk)
  int vec_out;            // ld a multiple of 4 and c aligned to 4 elements: vector stores
};

// Float index of 16-byte chunk c (columns 4c..4c+3) of row i of the staged
// tile. The XOR keeps the 8 lanes of a quarter-warp on 8 distinct bank groups
// whenever they share (i / 4) % 8 and hold 8 consecutive chunks, or hold
// rows 4 apart at one chunk.
__device__ __forceinline__ int staged(int i, int c) {
  return i * kTile + 4 * (c ^ ((i >> 2) & 7));
}

// Where the tile goes: element (i, j) of the tile is dst[(i0 + i) * ld + j0 + j]
// of a lim x lim target.
template <typename TO>
struct Target {
  TO* dst;
  long long ld;
  int lim, i0, j0;
  bool vec;
};

// Row i of the target from column j on: four values, one vector store if allowed.
template <typename TO>
__device__ __forceinline__ void put4(const Target<TO>& t, int i, int j, const float (&v)[4]) {
  if (i >= t.lim) return;
  TO* p = t.dst + (long long)i * t.ld + j;
  if (t.vec) {  // lim % 4 == 0 and j % 4 == 0: the run is all in or all out
    if (j < t.lim) store4(p, v);
  } else {
#pragma unroll
    for (int f = 0; f < 4; ++f)
      if (j + f < t.lim) store1(p + f, v[f]);
  }
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of this CTA's `p` in the CTA of rank `rank`.
// Volatile, so it stays after the cluster barrier that precedes it (kept out
// of the registers of the main loop).
__device__ __forceinline__ unsigned cluster_address(const float* p, int rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ float4 load_cluster4(unsigned address) {
  float4 v;
  asm("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(address));
  return v;
}

template <typename T, typename TO, bool kVec16, int kSplits>
__global__ void __launch_bounds__(kThreads, 2) syrk_kernel(const SyrkArgs g) {
  extern __shared__ __align__(16) float smem[];
  const TnMap map;
  const int t = blockIdx.x / kSplits, rank = blockIdx.x % kSplits;  // rank in the cluster
  int bi, bj;
  tri_coords(t, bi, bj);
  int p = bi, q = bj, rlim = g.n, clim = g.n, r0, c0;
  if (g.packed) {
    p = blockIdx.y / g.sub;
    q = blockIdx.y % g.sub;
    if (bi == bj && p < q) return;  // the whole cluster: filled by the mirror of (q, p)
    r0 = bi * g.bn + p * kTile;
    c0 = bj * g.bn + q * kTile;
    rlim = min(g.n, (bi + 1) * g.bn);
    clim = min(g.n, (bj + 1) * g.bn);
  } else {
    r0 = p * kTile;
    c0 = q * kTile;
  }
  const bool diag = bi == bj && p == q;            // rows and columns are the same indices
  const bool sym = !g.packed || bi == bj;          // the target is symmetric: mirror writes
  const int l0 = rank * g.chunk;
  const int l1 = max(l0, min(g.m, l0 + g.chunk));
  const long long t_total = (long long)gridDim.x / kSplits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int bt = blockIdx.z; bt < g.batch; bt += gridDim.z) {
    const T* a = static_cast<const T*>(g.a);
    const T* ab = g.offs ? a + g.offs[bt / g.inner] + (long long)(bt % g.inner) * g.sab
                         : a + (long long)bt * g.sab;
    float acc[kMicro][kMicro];
    const TnOperand<T> x{ab, g.lda, r0, rlim}, y{ab, g.lda, c0, clim};
    if (diag)
      tn_tile<T, kVec16, true, true>(x, y, l0, l1, smem, map, acc);
    else
      tn_tile<T, kVec16, false, true>(x, y, l0, l1, smem, map, acc);
    __syncthreads();  // every warp is done with the ring: stage the partial over it
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(smem + staged(map.row(ii), map.tx + 16 * h)) = make_float4(
            __fmul_rn(g.alpha, acc[ii][4 * h]), __fmul_rn(g.alpha, acc[ii][4 * h + 1]),
            __fmul_rn(g.alpha, acc[ii][4 * h + 2]), __fmul_rn(g.alpha, acc[ii][4 * h + 3]));
    if constexpr (kSplits > 1)
      cluster_sync_all();  // every partial of the cluster is staged
    else
      __syncthreads();

    TO* c = static_cast<TO*>(g.c);
    Target<TO> tg;
    if (g.packed) {
      tg = Target<TO>{c + ((long long)bt * t_total + t) * g.bn * g.bn, g.bn, g.bn, p * kTile,
                      q * kTile, g.vec_out != 0};
    } else {
      tg = Target<TO>{c + (long long)bt * g.n * g.n, g.n, g.n, r0, c0, g.vec_out != 0};
    }
    // Warp group w covers block rows 4*(w/4) + {0..3} and block columns
    // 8*(w%4) + {0..7}; lane (lane/8, lane%8) one 4 x 4 block of it. CTA r
    // of the cluster takes groups (u*K + r)*8 + warp. The trip counts and
    // the rank loop below are compile-time, so the loads of every block a
    // warp writes can be in flight together (the same loop with K a
    // run-time value ran 6% slower at K = 1, PERF.md).
#pragma unroll
    for (int u = 0; u < (kGroups + kSplits * kWarps - 1) / (kSplits * kWarps); ++u) {
      const int w = (u * kSplits + rank) * kWarps + warp;
      if (kSplits * kWarps > kGroups && w >= kGroups) break;  // K = 8: ranks 4..7 have none
      const int I = 4 * (w / 4) + lane / 8, J = 8 * (w % 4) + lane % 8;
      float v[4][4];
#pragma unroll
      for (int r = 0; r < kSplits; ++r) {  // the fixed rank order of the contract
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* at = smem + staged(4 * I + e, J);
          const float4 u4 = kSplits == 1 ? *reinterpret_cast<const float4*>(at)
                                         : load_cluster4(cluster_address(at, r));
          if (r == 0) {
            v[e][0] = u4.x, v[e][1] = u4.y, v[e][2] = u4.z, v[e][3] = u4.w;
          } else {
            v[e][0] = __fadd_rn(v[e][0], u4.x), v[e][1] = __fadd_rn(v[e][1], u4.y);
            v[e][2] = __fadd_rn(v[e][2], u4.z), v[e][3] = __fadd_rn(v[e][3], u4.w);
          }
        }
      }
      const int i = tg.i0 + 4 * I, j = tg.j0 + 4 * J;
      if (diag && I == J) {  // on the diagonal: the lower half, mirrored in place
        float s[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) s[e][f] = e >= f ? v[e][f] : v[f][e];
#pragma unroll
        for (int e = 0; e < 4; ++e) put4(tg, i + e, j, s[e]);
      } else if (!diag || I > J) {  // strictly upper blocks: the mirror of (J, I)
#pragma unroll
        for (int e = 0; e < 4; ++e) put4(tg, i + e, j, v[e]);
        if (sym) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float col[4] = {v[0][f], v[1][f], v[2][f], v[3][f]};
            put4(tg, j + f, i, col);
          }
        }
      }
    }
    if constexpr (kSplits > 1)
      cluster_sync_all();  // no CTA of the cluster reads a partial or exits before all are done
    else if (bt + gridDim.z < g.batch)
      __syncthreads();     // the next entry refills the ring
  }
}

using SyrkKernel = void (*)(SyrkArgs);

// The instances of one (operand, output) type pair: [vec16][K = 1, 2, 4, 8].
template <typename T, typename TO>
static SyrkKernel pick(int vec16, int idx) {
  static const SyrkKernel k[2][4] = {
      {syrk_kernel<T, TO, false, 1>, syrk_kernel<T, TO, false, 2>, syrk_kernel<T, TO, false, 4>,
       syrk_kernel<T, TO, false, 8>},
      {syrk_kernel<T, TO, true, 1>, syrk_kernel<T, TO, true, 2>, syrk_kernel<T, TO, true, 4>,
       syrk_kernel<T, TO, true, 8>}};
  return k[vec16 ? 1 : 0][idx];
}

// The instance for the dtypes code (dtype.cuh), the copy width and a split
// K in {1, 2, 4, 8} (null otherwise), and its dynamic shared-memory opt-in,
// once per instance and device.
static SyrkKernel instance(int dtypes, int vec16, int splits, cudaError_t* err) {
  static bool done[4][2][4][kMaxDevices] = {};
  const int idx = splits == 1 ? 0 : splits == 2 ? 1 : splits == 4 ? 2 : splits == 8 ? 3 : -1;
  if (idx < 0) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  const int t = dtypes & (kLoadBf16 | kStoreBf16), v = vec16 ? 1 : 0;
  const SyrkKernel k = t == 0            ? pick<float, float>(v, idx)
                       : t == kLoadBf16  ? pick<bf16, float>(v, idx)
                       : t == kStoreBf16 ? pick<float, bf16>(v, idx)
                                         : pick<bf16, bf16>(v, idx);
  *err = tn_opt_in(reinterpret_cast<const void*>(k), kTnSmemBytes, done[t][v][idx]);
  return *err == cudaSuccess ? k : nullptr;
}

static void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, dim3 grid, int splits,
                      cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kTnSmemBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;  // K = 1: a plain launch, no cluster
}

// Grid (T * K, sub^2, batch), clusters of K along x; chunk from (m, K).
static int launch(int dtypes, int vec16, long long tiles, int sub, int splits, SyrkArgs g,
                  void* stream) {
  cudaError_t err;
  const SyrkKernel kernel = instance(dtypes, vec16, splits, &err);
  if (kernel == nullptr) return static_cast<int>(err);
  if (tiles * splits > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (g.m + splits - 1) / splits;
  g.chunk = (per + kSlab - 1) / kSlab * kSlab;
  const int ld = g.packed ? g.bn : g.n;
  g.vec_out = ld % 4 == 0 && reinterpret_cast<std::uintptr_t>(g.c) % (4 * out_bytes(dtypes)) == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const dim3 grid(static_cast<unsigned>(tiles * splits), sub * sub,
                  g.batch < 65535 ? g.batch : 65535);
  configure(cfg, attr, grid, splits, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// packed == 0: c is (batch, n, n); the grid covers the lower 128-tile pairs.
// packed == 1: c is (batch, T, bn, bn) with T = nb(nb+1)/2, nb = ceil(n/bn).
// splits: K in {1, 2, 4, 8}, the CTAs (one cluster) that share each output tile.
// vec16: a 16 B aligned, lda and sab multiples of 16 bytes (16 B copies).
// dtypes: bit 0 bfloat16 operand, bit 1 bfloat16 output (dtype.cuh).
extern "C" int syrk_f32(const void* a, void* c, int batch, int m, int n, long long sab,
                        long long lda, float alpha, int packed, int bn, int splits, int vec16,
                        int dtypes, void* stream) {
  using repro_torch::kTile;
  int sub = 1;
  long long nblk;
  if (packed) {
    nblk = (n + bn - 1) / bn;
    sub = (bn + kTile - 1) / kTile;
  } else {
    nblk = (n + kTile - 1) / kTile;
  }
  repro_torch::SyrkArgs g{};
  g.a = a, g.c = c, g.offs = nullptr, g.sab = sab, g.lda = lda, g.batch = batch, g.inner = 1;
  g.m = m, g.n = n, g.alpha = alpha, g.packed = packed, g.bn = packed ? bn : 0, g.sub = sub;
  return repro_torch::launch(dtypes, vec16, nblk * (nblk + 1) / 2, sub, splits, g, stream);
}

// c is (S, inner, n, n): entry (s, b) is the dense syrk of the m x n leaf at
// a + offs[s] + b * sab (row stride lda). splits, vec16 and dtypes as for
// syrk_f32, and with vec16 every offs[s] a multiple of 16 bytes.
extern "C" int syrk_gather_f32(const void* a, const long long* offs, void* c, int S, int inner,
                               int m, int n, long long sab, long long lda, float alpha, int splits,
                               int vec16, int dtypes, void* stream) {
  using repro_torch::kTile;
  const long long nblk = (n + kTile - 1) / kTile;
  const long long entries = (long long)S * inner;
  if (entries > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  repro_torch::SyrkArgs g{};
  g.a = a, g.c = c, g.offs = offs, g.sab = sab, g.lda = lda;
  g.batch = static_cast<int>(entries), g.inner = inner;
  g.m = m, g.n = n, g.alpha = alpha, g.packed = 0, g.bn = 0, g.sub = 1;
  return repro_torch::launch(dtypes, vec16, nblk * (nblk + 1) / 2, 1, splits, g, stream);
}

// out: registers per thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes, resident CTAs per SM, cluster size (= splits), and
// resident clusters of that size on the card, for the float32 16 B
// (vec16 = 1) or 4 B instance.
extern "C" int syrk_info(int vec16, int splits, int* out) {
  using namespace repro_torch;
  cudaError_t err;
  const void* kernel = reinterpret_cast<const void*>(instance(0, vec16, splits, &err));
  if (kernel == nullptr) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kTnSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, dim3(10 * splits, 1, 1), splits, nullptr);
  cfg.numAttrs = 1;  // the query counts clusters of one CTA too
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = kTnSmemBytes;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = splits;
  out[6] = clusters;
  return 0;
}
