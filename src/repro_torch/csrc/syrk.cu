// syrk: C[b] = alpha * A[b]^T A[b], summed in float32, lower tiles only, in one launch.
//
// Replaces: syrk_pallas in src/repro/kernels/syrk.py (the Pallas kernel for
// the diagonal leaves of ATA, dense dual-write and packed output modes).
// Two kernels share this file's grid, tile map and epilogue: syrk_kernel on
// float32 operands (the FMA tile engine of tn_tile.cuh) and
// syrk_wgmma_kernel on bfloat16 operands (Hopper's tensor cores,
// tn_wgmma.cuh); the wrapper names the one to run
// (repro_torch.kernels.syrk.syrk_route: by operand type alone), and each C
// entry point refuses the other's operands.
//
// float32, what bounds it on the H100: operations, like gemm_tn. A diagonal
// leaf is 512 x 512 over 512 rows (m n (n+1) = 134 MFLOP symmetric-aware
// on 2 MiB); lstsq's leaf is 512 x 512 over 2048 rows (538 MFLOP on 4 MiB).
// Both sit well above the float32 balance point, so the ceiling is the 67
// TFLOP/s of the FMA units.
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
// * A coalesced dual-write epilogue (write_tile). The CTA stages alpha *
//   acc in the ring's shared memory (64 KiB of its 96), 16-byte chunk c of
//   tile row i at chunk c ^ ((i / 4) % 8), which keeps the register stores,
//   the row reads and the 4 x 4 block reads below free of bank conflicts.
//   Each lane then takes a 4 x 4 block (4 LDS.128), a warp 4 block rows x 8
//   block columns, and writes the block's rows and, transposed in
//   registers, its mirror: float4 stores where ld is a multiple of 4 floats
//   (whole 128 B lines for the rows, whole 32 B sectors for the mirror),
//   scalar stores of the same runs otherwise. A diagonal target writes sym
//   of the lower half (T[max(i,j)][min(i,j)]), so the output is bitwise
//   symmetric with no pass over the square afterwards.
// * A cluster-split contraction when the grid is small. m is cut into
//   chunks of kChunkRows rows, and CTA r of the K that share an output tile
//   sums chunks r, r + K, r + 2K, ... as one chain; the K CTAs form a
//   thread-block cluster along x (grid (T*K, sub^2, batch)). Each runs the
//   engine over its chunks and stages its partial; after one cluster
//   barrier, CTA r sums its share of the tile's 4 x 4 blocks over all K
//   partials through distributed shared memory and writes them. No
//   workspace in global memory, no second launch. K is a template
//   parameter (one instance each for 1, 2, 4, 8), so the epilogue's loops
//   are unrolled. lstsq's single (2048, 512) leaf has 10 tiles: 10 CTAs on
//   132 SMs unsplit, 40 at its K = 4 (four chunks).
// * Row ranges that padding cannot move. The chunks are cut at multiples of
//   a constant, not of m / K, and K (repro_torch.kernels.syrk.syrk_splits)
//   is min(F(n), the power of two at or above the chunk count): with at
//   most F(n) chunks each sits alone first in CTA c, with more every K is
//   F(n). So zero rows appended to A only add exact +0 terms to chains and
//   +0 partials in the rank sum, and a request padded into a serving
//   bucket's band keeps its gram's bits (repro_torch.serve.bucketing).
//
// bfloat16, what bounds it on the H100: bytes. The ata 8192² diagonal
// leaves (256, 512, 512) are 43 GFLOP of lower tiles, 0.04 ms at the
// tensor cores' 989 TFLOP/s, against 134 MB read and 268 MB of float32
// written, 0.12 ms at 3.35 TB/s. The FMA engine, converting each element on
// the read, ran them in 1.10 ms (PERF.md). syrk_wgmma_kernel keeps this
// file's grid, tile map, split and epilogue, and makes each CTA's 128 x 128
// float32 partial with tn_wgmma.cuh's main loop: one producer warp fills a
// ring of kSwStages stages of kSwRows rows by TMA (a 5-D tiled map encoded
// at launch: columns, rows, batch entry, and for syrk_gather the block
// grid's columns and rows, whose box coordinates a device table gives per
// stack entry, so the gathered leaves are read in place), the two consumer
// warpgroups issue wgmma.m64n128k16 on their 64 rows of the tile with both
// descriptors MN-major. A diagonal tile (its rows and columns the same
// columns of A) loads one side a stage and points both descriptors at it:
// half the bytes. Where TMA cannot take the operand (a base or a stride off
// 16 bytes), the producer warp fills the same swizzled stages by element
// loads (tn_wgmma.cuh fill_side). The partial is staged over the ring once
// every wgmma of the entry has finished: the producer warp waits at the
// same barriers, so it refills the ring only after the epilogue has read
// the last partial (a CTA runs one entry unless the batch passes 65535),
// and it stays alive to the end so that every thread of a cluster reaches
// both cluster barriers. Two CTAs share an SM, so one's epilogue stores
// run while the other loads; two CTAs of 9 warps leave a thread 96
// registers (16K a sub-partition), 64 of them accumulators. So the
// producer and the consumers run separate loops that meet at named
// barriers (a shared loop kept the producer's state live beside the
// accumulators), the epilogue reads its tile from shared memory, and its
// shared-memory addresses derive from a thread index read after the main
// loop (else they were computed before it, 32 registers): with each of
// these the kernel spilled, one CTA an SM without spills ran 1.3x slower
// (tools/kernel_variants.py syrk_bf16, PERF.md). What bounds it now: the
// epilogue's 128 KiB of stores a tile, which the loads of the SM's other
// CTA only partly hide (without them the kernel runs near its loads).
//
// Summation order, the contract of every output: with p_r the partial over
// the rows of chunks r, r + K, r + 2K, ... below m (chunk c: rows
// [c*kChunkRows, (c+1)*kChunkRows)) as one chain in ascending rows —
// float32: the engine's fmaf chain (tn_tile.cuh); bfloat16: wgmma's k16
// steps in ascending rows from +0 (tn_wgmma.cuh), kChunkRows being a
// multiple of 64 —
//   C = (...((alpha*p_0 + alpha*p_1) + alpha*p_2) ... + alpha*p_{K-1}),
// rank order, each product and sum rounded once (__fmul_rn, __fadd_rn).
// K = splits is chosen by the wrapper (repro_torch.kernels.syrk.syrk_splits)
// from (m, n) alone, so a batch entry equals its single launch, packed
// equals dense, and syrk_gather equals syrk on the stacked leaves, bitwise.
// At K = 1 an output is alpha * p_0, one chain over [0, m). An element
// (i, j), i > j, is always made with column i of A on the tile's row side,
// whatever the grid (dense, packed, gathered), and the upper half is its
// mirror.
//
// Output targets: dense — (i, j) are 128-tiles of the n x n output; packed —
// (i, j) are storage blocks of edge bn (default_block_size, e.g. 256 or
// 104) and blockIdx.y picks one 128-tile of the block. Upper sub-tiles of a
// diagonal block are skipped and filled by the mirror writes of the lower
// ones; off-diagonal storage blocks write the tile only. Rows and columns
// past n load as zero, so pad entries of a packed block are exact zeros, as
// in the reference; a tile's columns past its block's edge but below n (bn
// = 104) only make entries past the target's edge, which are not written.
//
// syrk_gather also replaces syrk_gather_pallas (src/repro/kernels/syrk.py),
// the diagonal leaves of the fused leaf dispatch: the same dense grid, but
// stack entry s = e / inner is block (rows[s], cols[s]) of the caller's
// block-major grid (an element offset offs[s] for the float32 copies and
// the element fill, box coordinates for TMA), so the gathered (S, ...)
// stack is never copied. The arithmetic per entry is the dense syrk's, so
// the two agree bitwise on the same leaf.
//
// The output is float32 or bfloat16 (dtype.cuh). The partials are staged
// and summed in float32 whatever the types; the dual write rounds each
// output once to its type and stores a 4 x 4 block's rows as 16-byte
// float32 or 8-byte bfloat16 runs. With the 4 x 4 blocks of this lane map a
// bfloat16 row run of a quarter-warp still fills whole 32-byte sectors, so
// the lane map is the float32 one.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"
#include "tn_tile.cuh"
#include "tn_wgmma.cuh"

namespace repro_torch {

constexpr int kWarps = kThreads / 32;
// rows of one chunk of the split contraction (repro_torch.kernels.syrk.CHUNK_ROWS)
constexpr int kChunkRows = 512;
static_assert(kChunkRows % kSlab == 0, "a chunk is whole stages of the FMA engine");
constexpr int kBlocks = kTile / 4;                       // 4 x 4 blocks a tile edge
constexpr int kGroups = (kBlocks / 4) * (kBlocks / 8);   // warp groups of 4 x 8 blocks

struct SyrkArgs {
  const void* a;          // float32 or bfloat16 elements (the instance's operand type)
  void* c;                // float32 or bfloat16 elements (the instance's TO)
  const long long* offs;  // per-entry element offsets (syrk_gather), or null
  long long sab, lda;     // batch and row strides of a, in elements
  int batch, inner;       // entries; entry e reads a + offs[e / inner] + (e % inner) * sab
  int m, n;
  float alpha;
  int packed, bn, sub;    // packed: storage block edge, 128-tiles a block edge
  int vec_out;            // ld a multiple of 4 and c aligned to 4 elements: vector stores
};

// A CTA's output tile: lower tile pair t = (bi, bj) and, packed, 128-tile
// (p, q) of that storage block; rows [r0, r0 + 128) below rlim and columns
// [c0, c0 + 128) below clim of A^T A; the CTA's rank in its cluster.
struct SyrkTile {
  int t, rank, p, q, r0, c0, rlim, clim;
  bool diag;  // rows and columns are the same indices
  bool sym;   // the target is symmetric: mirror writes
};

// The tile of the CTA at blockIdx (bx, by); false where the whole cluster
// has none (an upper 128-tile of a diagonal storage block: filled by the
// mirror of (q, p)).
template <int kSplits>
__device__ __forceinline__ bool syrk_tile(const SyrkArgs& g, SyrkTile& tl, unsigned bx,
                                          unsigned by) {
  tl.t = bx / kSplits, tl.rank = bx % kSplits;
  int bi, bj;
  tri_coords(tl.t, bi, bj);
  tl.p = bi, tl.q = bj, tl.rlim = g.n, tl.clim = g.n;
  if (g.packed) {
    tl.p = by / g.sub;
    tl.q = by % g.sub;
    if (bi == bj && tl.p < tl.q) return false;
    tl.r0 = bi * g.bn + tl.p * kTile;
    tl.c0 = bj * g.bn + tl.q * kTile;
    tl.rlim = min(g.n, (bi + 1) * g.bn);
    tl.clim = min(g.n, (bj + 1) * g.bn);
  } else {
    tl.r0 = tl.p * kTile;
    tl.c0 = tl.q * kTile;
  }
  tl.diag = bi == bj && tl.p == tl.q;
  tl.sym = !g.packed || bi == bj;
  return true;
}

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

// The staged epilogue of both kernels, run by threads 0..255 (warp 0..7,
// lane) once every CTA of the cluster has staged alpha * p_r at `smem`
// (staged() layout): sums this CTA's share of the tile's 4 x 4 blocks over
// the K partials in rank order and writes them, with their mirror where
// the target is symmetric.
template <typename TO, int kSplits>
__device__ __forceinline__ void write_tile(const SyrkArgs& g, const SyrkTile& tl,
                                           const float* smem, int bt, long long t_total,
                                           int warp, int lane) {
  TO* c = static_cast<TO*>(g.c);
  Target<TO> tg;
  if (g.packed) {
    tg = Target<TO>{c + ((long long)bt * t_total + tl.t) * g.bn * g.bn, g.bn, g.bn,
                    tl.p * kTile, tl.q * kTile, g.vec_out != 0};
  } else {
    tg = Target<TO>{c + (long long)bt * g.n * g.n, g.n, g.n, tl.r0, tl.c0, g.vec_out != 0};
  }
  // Warp group w covers block rows 4*(w/4) + {0..3} and block columns
  // 8*(w%4) + {0..7}; lane (lane/8, lane%8) one 4 x 4 block of it. CTA r
  // of the cluster takes groups (u*K + r)*8 + warp. The trip counts and
  // the rank loop below are compile-time, so the loads of every block a
  // warp writes can be in flight together (the same loop with K a
  // run-time value ran 6% slower at K = 1, PERF.md).
#pragma unroll
  for (int u = 0; u < (kGroups + kSplits * kWarps - 1) / (kSplits * kWarps); ++u) {
    const int w = (u * kSplits + tl.rank) * kWarps + warp;
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
    if (tl.diag && I == J) {  // on the diagonal: the lower half, mirrored in place
      float s[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) s[e][f] = e >= f ? v[e][f] : v[f][e];
#pragma unroll
      for (int e = 0; e < 4; ++e) put4(tg, i + e, j, s[e]);
    } else if (!tl.diag || I > J) {  // strictly upper blocks: the mirror of (J, I)
#pragma unroll
      for (int e = 0; e < 4; ++e) put4(tg, i + e, j, v[e]);
      if (tl.sym) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float col[4] = {v[0][f], v[1][f], v[2][f], v[3][f]};
          put4(tg, j + f, i, col);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 operands: the FMA tile engine
// ---------------------------------------------------------------------------

template <typename TO, bool kVec16, int kSplits>
__global__ void __launch_bounds__(kThreads, 2) syrk_kernel(const SyrkArgs g) {
  extern __shared__ __align__(16) float smem[];
  const TnMap map;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  SyrkTile tl;
  if (!syrk_tile<kSplits>(g, tl, blockIdx.x, blockIdx.y)) return;  // the whole cluster
  const long long t_total = (long long)gridDim.x / kSplits;

  for (int bt = blockIdx.z; bt < g.batch; bt += gridDim.z) {
    const float* a = static_cast<const float*>(g.a);
    const float* ab = g.offs ? a + g.offs[bt / g.inner] + (long long)(bt % g.inner) * g.sab
                             : a + (long long)bt * g.sab;
    float acc[kMicro][kMicro];
    const TnOperand<float> x{ab, g.lda, tl.r0, tl.rlim}, y{ab, g.lda, tl.c0, tl.clim};
    // CTA rank's partial: its chunks rank, rank + K, ... as one chain; at
    // K = 1 the rows [0, m) in order
    constexpr int kRun = kSplits > 1 ? kChunkRows : 0;
    const int l0 = kSplits > 1 ? tl.rank * kChunkRows : 0;
    if (tl.diag)
      tn_tile<float, kVec16, true, true, kRun, kSplits * kChunkRows>(x, y, l0, g.m, smem, map, acc);
    else
      tn_tile<float, kVec16, false, true, kRun, kSplits * kChunkRows>(x, y, l0, g.m, smem, map,
                                                                      acc);
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
    write_tile<TO, kSplits>(g, tl, smem, bt, t_total, warp, lane);
    if constexpr (kSplits > 1)
      cluster_sync_all();  // no CTA of the cluster reads a partial or exits before all are done
    else if (bt + gridDim.z < g.batch)
      __syncthreads();     // the next entry refills the ring
  }
}

using SyrkKernel = void (*)(SyrkArgs);

// The index of a split K in {1, 2, 4, 8}, -1 otherwise.
static int split_index(int splits) {
  return splits == 1 ? 0 : splits == 2 ? 1 : splits == 4 ? 2 : splits == 8 ? 3 : -1;
}

// The instances of one output type: [vec16][K = 1, 2, 4, 8].
template <typename TO>
static SyrkKernel pick(int vec16, int idx) {
  static const SyrkKernel k[2][4] = {
      {syrk_kernel<TO, false, 1>, syrk_kernel<TO, false, 2>, syrk_kernel<TO, false, 4>,
       syrk_kernel<TO, false, 8>},
      {syrk_kernel<TO, true, 1>, syrk_kernel<TO, true, 2>, syrk_kernel<TO, true, 4>,
       syrk_kernel<TO, true, 8>}};
  return k[vec16 ? 1 : 0][idx];
}

// The float32-operand instance for the dtypes code (dtype.cuh: bfloat16
// operands are refused, they run syrk_wgmma_kernel), the copy width and a
// split K in {1, 2, 4, 8} (null otherwise), and its dynamic shared-memory
// opt-in, once per instance and device.
static SyrkKernel instance(int dtypes, int vec16, int splits, cudaError_t* err) {
  static bool done[2][2][4][kMaxDevices] = {};
  const int idx = split_index(splits);
  if (idx < 0 || (dtypes & kLoadBf16)) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  const int o = (dtypes & kStoreBf16) ? 1 : 0, v = vec16 ? 1 : 0;
  const SyrkKernel k = o ? pick<bf16>(v, idx) : pick<float>(v, idx);
  *err = tn_opt_in(reinterpret_cast<const void*>(k), kTnSmemBytes, done[o][v][idx]);
  return *err == cudaSuccess ? k : nullptr;
}

static void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, dim3 grid, int splits,
                      int threads, int smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;  // K = 1: a plain launch, no cluster
}

// The output's vector stores, shared by both kernels.
static void plan(SyrkArgs& g, int dtypes) {
  const int ld = g.packed ? g.bn : g.n;
  g.vec_out = ld % 4 == 0 && reinterpret_cast<std::uintptr_t>(g.c) % (4 * out_bytes(dtypes)) == 0;
}

// The grid (T * K, sub^2, batch), clusters of K along x.
static dim3 grid_of(long long tiles, int sub, int splits, int batch) {
  return dim3(static_cast<unsigned>(tiles * splits), sub * sub, batch < 65535 ? batch : 65535);
}

static int launch(int dtypes, int vec16, long long tiles, int sub, int splits, SyrkArgs g,
                  void* stream) {
  cudaError_t err;
  const SyrkKernel kernel = instance(dtypes, vec16, splits, &err);
  if (kernel == nullptr) return static_cast<int>(err);
  if (tiles * splits > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  plan(g, dtypes);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, grid_of(tiles, sub, splits, g.batch), splits, kThreads, kTnSmemBytes,
            static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 operands: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kSwRows = 64;                            // rows of a stage: four k16 steps
constexpr int kSwStages = 3;                           // ring depth: two CTAs an SM
constexpr int kSwSide = wg::side_bytes(kSwRows);       // 16 KiB: the tile's rows or columns
constexpr int kSwStageBytes = 2 * kSwSide;             // X's side, then Y's (diagonal: X's only)
constexpr int kSwSmemBytes = kSwStages * kSwStageBytes + 1024;  // + the 1024-byte alignment
constexpr int kSwThreads = wg::kConsumers + 32;        // two warpgroups and the producer warp
static_assert(kTile * kTile * 4 <= kSwStages * kSwStageBytes, "the partial fits over the ring");
static_assert(wg::kConsumers == kThreads, "write_tile's lane map takes the 8 consumer warps");
static_assert(kChunkRows % kSwRows == 0, "a chunk is whole stages of the tensor-core ring");

// The stages of kSwRows rows that CTA `rank` of K = kSplits sums: those of
// its chunks rank, rank + K, ... below m, every one whole but the last
// chunk of the contraction.
template <int kSplits>
__device__ __forceinline__ int chunk_stages(int m, int rank) {
  const int chunks = (m + kChunkRows - 1) / kChunkRows;
  if (rank >= chunks) return 0;
  const int mine = (chunks - 1 - rank) / kSplits + 1;
  const int last = (rank + (mine - 1) * kSplits) * kChunkRows;  // its last chunk's first row
  return (mine - 1) * (kChunkRows / kSwRows) + (min(m, last + kChunkRows) - last + kSwRows - 1) /
                                                   kSwRows;
}

// The first row of stage s of CTA `rank`'s sequence (chunk_stages).
template <int kSplits>
__device__ __forceinline__ int chunk_row(int s, int rank) {
  constexpr int per = kChunkRows / kSwRows;
  return (rank + (s / per) * kSplits) * kChunkRows + (s % per) * kSwRows;
}

// threadIdx.x, read where it is called: the epilogue's shared-memory
// addresses derive from it after the main loop's last barrier, so the
// compiler cannot compute them (32 registers) before the main loop.
__device__ __forceinline__ int thread_index() {
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return static_cast<int>(v);
}

// The CTA's 288 threads at named barrier 1 (the producer warp and the
// consumer warpgroups reach it from their own loops).
__device__ __forceinline__ void cta_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSwThreads) : "memory");
}

// (B) every partial of the cluster is staged.
template <int kSplits>
__device__ __forceinline__ void staged_barrier() {
  if constexpr (kSplits > 1)
    cluster_sync_all();
  else
    cta_barrier();
}

// (C) no CTA of the cluster reads a partial or exits before all are done;
// alone, the next entry (`more`) may refill the ring.
template <int kSplits>
__device__ __forceinline__ void read_barrier(bool more) {
  if constexpr (kSplits > 1)
    cluster_sync_all();
  else if (more)
    cta_barrier();
}

// A kernel argument (__grid_constant__: the tensor map stays in parameter
// space, where the copy engine reads it).
struct SyrkWgArgs {
  CUtensorMap map;     // a as a 5-D tiled map (columns, rows, inner entry, block column,
                       // block row); read if tma
  SyrkArgs g;
  const int* coords;   // syrk_gather: (rows[s], cols[s]) of stack entry s; null for syrk
  int tma;             // stages arrive by TMA; by the producer warp's element loads otherwise
};

template <typename TO, int kSplits>
__global__ void __launch_bounds__(kSwThreads, 2)
    syrk_wgmma_kernel(const __grid_constant__ SyrkWgArgs w) {
  constexpr int S = kSwStages;
  const SyrkArgs& g = w.g;
  SyrkTile tl;
  if (!syrk_tile<kSplits>(g, tl, blockIdx.x, blockIdx.y)) return;  // the whole cluster
  extern __shared__ unsigned char sw_smem[];
  // full: a stage's copies landed; empty: both warpgroups' wgmma on it finished
  __shared__ __align__(8) unsigned long long full[S], empty[S];
  // the tile, read back by the epilogue: kept out of the registers of the
  // main loop, where the accumulators take 64 of the 96 a thread has (two
  // CTAs of 9 warps an SM)
  __shared__ SyrkTile s_tile;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_tile = tl;
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(&full[s], w.tma ? 1 : 32);
      wg::mbar_init(&empty[s], wg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned char* ring = wg::align1024(sw_smem);
  float* partial = reinterpret_cast<float*>(ring);  // the staged tile, over the ring
  // the CTA's chunks as one sequence of stages, the ring's phases running on
  // across them
  const int stages = chunk_stages<kSplits>(g.m, tl.rank);
  // k16 steps of the last stage, those that start below m (every other
  // stage is whole: only the contraction's last chunk is short, and it is
  // the last of its CTA's)
  const int tail = stages ? min(kSwRows / wg::kStep,
                                (g.m - chunk_row<kSplits>(stages - 1, tl.rank) + wg::kStep - 1) /
                                    wg::kStep)
                          : 0;
  unsigned gs = 0;  // stages filled (the producer) or consumed (the consumers) so far

  // The producer warp and the consumer warpgroups run their own loops over
  // the CTA's entries and meet at the same three barriers an entry: (A) the
  // ring is free, (B) every partial of the cluster is staged, (C) every
  // partial has been read. Kept apart, the producer's state is never live
  // beside the accumulators.
  if (tid >= wg::kConsumers) {  // the producer warp
    const int lane = tid - wg::kConsumers;
    for (int bt = blockIdx.z; bt < g.batch; bt += gridDim.z) {
      const int s_ = bt / g.inner, b = bt % g.inner;
      // TMA's outer coordinates (entry, block column, block row), and the
      // element fill's base
      const int cz = w.coords ? b : bt;
      const int cc = w.coords ? w.coords[2 * s_ + 1] : 0, cr = w.coords ? w.coords[2 * s_] : 0;
      const bf16* base = static_cast<const bf16*>(g.a) +
                         (g.offs ? g.offs[s_] + (long long)b * g.sab : (long long)bt * g.sab);
      for (int s = 0; s < stages; ++s, ++gs) {
        const int slot = gs % S, l = chunk_row<kSplits>(s, tl.rank);
        if (gs >= S) wg::mbar_wait(&empty[slot], (gs / S - 1) & 1);
        unsigned char* xs = ring + slot * kSwStageBytes;
        unsigned char* ys = xs + kSwSide;
        if (w.tma) {
          if (lane == 0) {
            wg::mbar_arrive_tx(&full[slot], tl.diag ? kSwSide : kSwStageBytes);
            wg::tma_load5(xs, &w.map, tl.r0, l, cz, cc, cr, &full[slot]);
            wg::tma_load5(xs + kSwSide / 2, &w.map, tl.r0 + wg::kBox, l, cz, cc, cr, &full[slot]);
            if (!tl.diag) {
              wg::tma_load5(ys, &w.map, tl.c0, l, cz, cc, cr, &full[slot]);
              wg::tma_load5(ys + kSwSide / 2, &w.map, tl.c0 + wg::kBox, l, cz, cc, cr,
                            &full[slot]);
            }
          }
        } else {
          // the partial of the last entry overwrote the ring: every slot's
          // first fill of an entry stores its dead columns' zeros again
          wg::fill_side<kSwRows>(xs, base, g.lda, tl.r0, tl.rlim, l, g.m, lane, s < S);
          if (!tl.diag)
            wg::fill_side<kSwRows>(ys, base, g.lda, tl.c0, tl.clim, l, g.m, lane, s < S);
          wg::fence_async_cta();
          wg::mbar_arrive(&full[slot]);
        }
      }
      __syncwarp();
      cta_barrier();  // (A)
      staged_barrier<kSplits>();
      read_barrier<kSplits>(bt + gridDim.z < g.batch);
    }
    return;
  }

  const int wgi = tid / 128;
  for (int bt = blockIdx.z; bt < g.batch; bt += gridDim.z) {
    float acc[wg::kAcc];
    wg::zero(acc);
    int held = -1;  // the slot whose wgmma may still run
    for (int s = 0; s < stages; ++s, ++gs) {
      const int slot = gs % S;
      wg::mbar_wait(&full[slot], (gs / S) & 1);
      const unsigned xs = wg::smem_u32(ring + slot * kSwStageBytes);
      const int n16 = s + 1 < stages ? kSwRows / wg::kStep : tail;
      wg::hold(acc);
      wg::fence();
      wg::mma_stage(acc, xs, tl.diag ? xs : xs + kSwSide, kSwRows, wgi, n16);
      wg::commit();
      wg::wait<1>();  // the stage before this one is read
      wg::hold(acc);
      if (held >= 0) wg::mbar_arrive(&empty[held]);
      held = slot;
    }
    wg::wait<0>();
    wg::hold(acc);
    if (held >= 0) wg::mbar_arrive(&empty[held]);
    cta_barrier();  // (A) every stage has landed and been read: stage the partial over the ring
    wg::fence_async_cta();  // the ring's last reads were wgmma's: ordinary stores follow
    // thread t of warpgroup wgi holds tile rows 64 wgi + 16 (t / 32) +
    // (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4) + {0, 1} (tn_wgmma.cuh)
    const int me = thread_index();
    const int t = me % 128, row = 64 * (me / 128) + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int j8 = 0; j8 < wg::kTileN / 8; ++j8) {
      const int col = 8 * j8 + 2 * (t % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(partial + staged(row + 8 * h, col >> 2) + (col & 3)) =
            make_float2(__fmul_rn(g.alpha, acc[4 * j8 + 2 * h]),
                        __fmul_rn(g.alpha, acc[4 * j8 + 2 * h + 1]));
    }
    staged_barrier<kSplits>();
    const int who = thread_index();  // read anew: see thread_index
    write_tile<TO, kSplits>(g, s_tile, partial, bt, (long long)gridDim.x / kSplits, who / 32,
                            who % 32);
    const bool more = bt + gridDim.z < g.batch;
    if (more) {  // the reads above, before the next entry's copies land
      if constexpr (kSplits > 1)
        wg::fence_async_cluster();
      else
        wg::fence_async_cta();
    }
    read_barrier<kSplits>(more);
  }
}

using SyrkWgKernel = void (*)(SyrkWgArgs);

template <typename TO>
static SyrkWgKernel pick_wgmma(int idx) {
  static const SyrkWgKernel k[4] = {syrk_wgmma_kernel<TO, 1>, syrk_wgmma_kernel<TO, 2>,
                                    syrk_wgmma_kernel<TO, 4>, syrk_wgmma_kernel<TO, 8>};
  return k[idx];
}

// The bfloat16-operand instance for the dtypes code (float32 operands are
// refused) and a split K in {1, 2, 4, 8}, and its shared-memory opt-in.
static SyrkWgKernel wgmma_instance(int dtypes, int splits, cudaError_t* err) {
  static bool done[2][4][kMaxDevices] = {};
  const int idx = split_index(splits);
  if (idx < 0 || !(dtypes & kLoadBf16)) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  const int o = (dtypes & kStoreBf16) ? 1 : 0;
  const SyrkWgKernel k = o ? pick_wgmma<bf16>(idx) : pick_wgmma<float>(idx);
  *err = tn_opt_in(reinterpret_cast<const void*>(k), kSwSmemBytes, done[o][idx]);
  return *err == cudaSuccess ? k : nullptr;
}

// Launches w (its map encoded where tma; the element fill where the
// encoding refused it, reported in *tma_used when not null).
static int launch_wgmma(int dtypes, long long tiles, int sub, int splits, SyrkWgArgs& w,
                        const long long (&dims)[5], const long long (&strides)[4], int tma,
                        int* tma_used, void* stream) {
  cudaError_t err;
  const SyrkWgKernel kernel = wgmma_instance(dtypes, splits, &err);
  if (kernel == nullptr) return static_cast<int>(err);
  if (tiles * splits > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  plan(w.g, dtypes);
  w.tma = tma && wg::encode_swizzled5(&w.map, w.g.a, dims, strides, kSwRows);
  if (tma_used) *tma_used = w.tma;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, grid_of(tiles, sub, splits, w.g.batch), splits, kSwThreads, kSwSmemBytes,
            static_cast<cudaStream_t>(stream));
  void* args[] = {&w};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The lower tile pairs of the grid and the 128-tiles a packed block edge.
static long long tiles_of(int n, int packed, int bn, int* sub) {
  *sub = packed ? (bn + kTile - 1) / kTile : 1;
  const long long nblk = packed ? (n + bn - 1) / bn : (n + kTile - 1) / kTile;
  return nblk * (nblk + 1) / 2;
}

}  // namespace repro_torch

// packed == 0: c is (batch, n, n); the grid covers the lower 128-tile pairs.
// packed == 1: c is (batch, T, bn, bn) with T = nb(nb+1)/2, nb = ceil(n/bn).
// splits: K in {1, 2, 4, 8}, the CTAs (one cluster) that share each output tile.
// vec16: a 16 B aligned, lda and sab multiples of 16 bytes (16 B copies).
// dtypes: bit 0 bfloat16 operand (refused: syrk_wgmma takes it), bit 1
// bfloat16 output (dtype.cuh).
extern "C" int syrk_f32(const void* a, void* c, int batch, int m, int n, long long sab,
                        long long lda, float alpha, int packed, int bn, int splits, int vec16,
                        int dtypes, void* stream) {
  int sub;
  const long long tiles = repro_torch::tiles_of(n, packed, bn, &sub);
  repro_torch::SyrkArgs g{};
  g.a = a, g.c = c, g.offs = nullptr, g.sab = sab, g.lda = lda, g.batch = batch, g.inner = 1;
  g.m = m, g.n = n, g.alpha = alpha, g.packed = packed, g.bn = packed ? bn : 0, g.sub = sub;
  return repro_torch::launch(dtypes, vec16, tiles, sub, splits, g, stream);
}

// c is (S, inner, n, n): entry (s, b) is the dense syrk of the m x n leaf at
// a + offs[s] + b * sab (row stride lda). splits, vec16 and dtypes as for
// syrk_f32, and with vec16 every offs[s] a multiple of 16 bytes.
extern "C" int syrk_gather_f32(const void* a, const long long* offs, void* c, int S, int inner,
                               int m, int n, long long sab, long long lda, float alpha, int splits,
                               int vec16, int dtypes, void* stream) {
  int sub;
  const long long tiles = repro_torch::tiles_of(n, 0, 0, &sub);
  const long long entries = (long long)S * inner;
  if (entries > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  repro_torch::SyrkArgs g{};
  g.a = a, g.c = c, g.offs = offs, g.sab = sab, g.lda = lda;
  g.batch = static_cast<int>(entries), g.inner = inner;
  g.m = m, g.n = n, g.alpha = alpha, g.packed = 0, g.bn = 0, g.sub = 1;
  return repro_torch::launch(dtypes, vec16, tiles, sub, splits, g, stream);
}

// syrk_f32's launch on bfloat16 operands (dtypes bit 0 set; float32 ones
// are refused): the tensor-core kernel. tma: a 16 B aligned, lda and (batch
// > 1) sab multiples of 16 bytes, so the stages may arrive by TMA; the
// producer warp's element loads otherwise, and where the tensor map's
// encoding refuses the layout. *tma_used (when not null): whether TMA ran.
extern "C" int syrk_wgmma(const void* a, void* c, int batch, int m, int n, long long sab,
                          long long lda, float alpha, int packed, int bn, int splits, int tma,
                          int dtypes, int* tma_used, void* stream) {
  using namespace repro_torch;
  int sub;
  const long long tiles = tiles_of(n, packed, bn, &sub);
  SyrkWgArgs w{};
  SyrkArgs& g = w.g;
  g.a = a, g.c = c, g.offs = nullptr, g.sab = sab, g.lda = lda, g.batch = batch, g.inner = 1;
  g.m = m, g.n = n, g.alpha = alpha, g.packed = packed, g.bn = packed ? bn : 0, g.sub = sub;
  w.coords = nullptr;
  const long long dims[5] = {n, m, batch, 1, 1};
  const long long strides[4] = {lda, sab, 0, 0};
  return launch_wgmma(dtypes, tiles, sub, splits, w, dims, strides, tma, tma_used, stream);
}

// syrk_gather_f32's launch on bfloat16 operands: the leaves are blocks of
// an (R, C, [inner,] m, n) grid (element strides s_r, s_c, sab, lda), entry
// (s, b) block (coords[2s], coords[2s + 1]), b of inner, at a + offs[s] + b
// * sab. tma: a 16 B aligned and lda, sab, s_c and s_r (of each dim past
// extent 1) multiples of 16 bytes. tma_used as for syrk_wgmma.
extern "C" int syrk_gather_wgmma(const void* a, const long long* offs, const int* coords,
                                 void* c, int S, int inner, int m, int n, long long sab,
                                 long long lda, int R, int C, long long s_r, long long s_c,
                                 float alpha, int splits, int tma, int dtypes, int* tma_used,
                                 void* stream) {
  using namespace repro_torch;
  int sub;
  const long long tiles = tiles_of(n, 0, 0, &sub);
  const long long entries = (long long)S * inner;
  if (entries > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  SyrkWgArgs w{};
  SyrkArgs& g = w.g;
  g.a = a, g.c = c, g.offs = offs, g.sab = sab, g.lda = lda;
  g.batch = static_cast<int>(entries), g.inner = inner;
  g.m = m, g.n = n, g.alpha = alpha, g.packed = 0, g.bn = 0, g.sub = 1;
  w.coords = coords;
  const long long dims[5] = {n, m, inner, C, R};
  const long long strides[4] = {lda, sab, s_c, s_r};
  return launch_wgmma(dtypes, tiles, sub, splits, w, dims, strides, tma, tma_used, stream);
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
  configure(cfg, attr, dim3(10 * splits, 1, 1), splits, kThreads, kTnSmemBytes, nullptr);
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

// out: the tensor-core kernel's resources (float32 output) at a split K:
// the syrk_info fields, then ring stages, rows a stage and threads; 10 ints.
extern "C" int syrk_wgmma_info(int splits, int* out) {
  using namespace repro_torch;
  cudaError_t err;
  const void* kernel = reinterpret_cast<const void*>(wgmma_instance(kLoadBf16, splits, &err));
  if (kernel == nullptr) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSwThreads, kSwSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, dim3(10 * splits, 1, 1), splits, kSwThreads, kSwSmemBytes, nullptr);
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = kSwSmemBytes;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = splits;
  out[6] = clusters;
  out[7] = kSwStages;
  out[8] = kSwRows;
  out[9] = kSwThreads;
  return 0;
}
