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
// Contracts. Every output is one fmaf chain over l = 0, 1, ..., m-1 in
// depth-8 slabs, exactly gemm_tn's (tn_tile.cuh), and every combined element
// is the pairwise __fadd_rn tree of core.strassen._combine_slots (span 1, 2,
// 4, ...; a dead, sign-0 slot passes its partner through; sign -1 negates).
// The kernel is therefore bitwise equal to gemm_tn on the materialized
// combined operands. For float32 slot blocks that rules out the tensor
// cores (they take float32 only as TF32, and gemm_tn's float32 chain is an
// fmaf chain): gemm_tn_fused_kernel is a float32 FMA kernel. bfloat16 slot
// blocks run gemm_tn_fused_wgmma_kernel (below), which keeps this design
// and multiplies with gemm_tn's bfloat16 tensor-core main loop.
//
// What bounds it on the H100. The FMA work is gemm_tn's (the level-1 launch
// of ata 8192^2 is 686 leaves of 512^3, 184 GFLOP, 2.75 ms at the 67 TFLOP/s
// float32 peak), so operations bound it; what the first version lost was the
// combine: each of the 16 CTAs of a 512^2 leaf summed its own X and Y
// stripes from all W slot blocks (686 x 16 x 4 MiB = 46 GB through L2 at
// level 1), the W loads went through registers (178 of them, one CTA per
// SM) and nothing hid their latency; the per-element fetch also re-read the
// slot table.
//
// What this design does about it:
// * Thread block clusters. The X stripe of a tile row is needed by every CTA
//   of that row, the Y stripe of a tile column by every CTA of that column.
//   In a C x C cluster each CTA combines 1/C of its X stripe and of its Y
//   stripe per stage and stores the combined values into the stage buffer
//   of every CTA that needs them: its own shared memory and, through
//   distributed shared memory (cooperative_groups::this_cluster()
//   .map_shared_rank), its partners'. A stripe is so combined once per
//   cluster. W >= 4 runs 4 x 4 clusters (a whole 512^2 leaf; 16 CTAs is the
//   H100's non-portable cluster size): level 1 moves 11.5 GB through L2
//   instead of 46. W = 2 runs 2 x 2 clusters. W = 1 has nothing to combine
//   and runs without a cluster (C = 1), each CTA copying its own stripes.
// * An async copy ring. The raw slot slabs of a thread's share arrive by
//   cp.async (16 B copies where every offset is 16 B aligned, as the root
//   grid's always are; 4 B copies otherwise) into a ring of up to 4 stages
//   in dynamic shared memory, kStages - 1 stages ahead. Each thread copies
//   exactly the W raw quads it later combines, so the ring needs no block
//   barrier: cp.async.wait_group orders a thread's own copies.
// * One barrier per stage of R = 2 depth-8 slabs (R = 1 at W = 1). In a
//   cluster it is split into arrive (after the combine of stage s+1) and
//   wait (after the multiply of stage s), which hides the barrier's latency
//   behind the FMA loop; three combined buffers make the split safe (a CTA
//   writing stage s+1 into a partner may find it still multiplying stage s,
//   never stage s-2). A CTA alone (W = 1) multiplies, then meets one
//   __syncthreads, with two buffers.
// * The ring depth is the deepest (at most 4) that lets two CTAs share an
//   SM; __launch_bounds__ then holds registers at 128. At W = 8 that is two
//   stages of two slabs (four depth-8 slabs): stage s+1 is in flight while s
//   is combined and s-1 multiplied. W = 16 and 32 fit one CTA an SM, with a
//   ring of two stages and of one.
// * The slot base pointers and signs are computed once per leaf entry into
//   shared memory; a copy is one pointer add. The combine is a compile-time
//   tree over W, so W = 32 keeps log2(W) + 1 partial sums live, not 32.
// * Ragged edges: the grid is rounded up to whole clusters; a CTA whose tile
//   lies beyond the edge still copies and combines its share (its partners
//   need it) and arrives at every cluster barrier; it only writes nothing.
//   Rows at or beyond m and columns at or beyond the limit combine to 0, and
//   the multiply runs exactly gemm_tn's depth-8 slabs, so the zero rows past
//   m are the same. Entries stride over gridDim.z <= 65535; a cluster's CTAs
//   share blockIdx.z.
//
// The shape per W (cluster edge, slabs a stage) was chosen by measurement
// on the H100 among no cluster, 2 x 2 and 4 x 4 clusters and 1 or 2 slabs a
// stage (tools/fused_shapes.py). Resources (nvcc -Xptxas -v and
// chip_smoke.py's resources line, from cudaFuncGetAttributes and
// cudaOccupancyMaxActiveClusters) and times: PERF.md.
//
// Element types (dtype.cuh): the output is float32 or bfloat16.
// gemm_tn_fused_kernel takes float32 slot blocks. bfloat16 slot blocks run
// gemm_tn_fused_wgmma_kernel: the same clusters, raw slot ring and
// pairwise tree, with two changes.
// * The combine rounds each pairwise add to bfloat16 (__fadd_rn, then round
//   to nearest even): the reference's combine in the operand type
//   (src/repro/kernels/gemm_tn.py:174-182) and the adds the unrolled
//   recursion makes on bfloat16 tensors (core.strassen._combine_slots).
// * The combined stage is written in bfloat16 in the 128-byte swizzled
//   layout of tn_wgmma.cuh (ordinary stores, local and through distributed
//   shared memory, then fence.proxy.async before the cluster barrier hands
//   the stage to wgmma, which reads through the async proxy), and the two
//   warpgroups multiply it with gemm_tn's bfloat16 main loop: the same k16
//   steps over the same zero-filled rows. So a bfloat16 launch is bitwise
//   equal to gemm_tn on the materialized bfloat16 combined operands, and
//   the fused, batched and unrolled dispatches agree bitwise. The wgmma of
//   stage s-1 is issued before the combine of stage s and waited for after
//   it, so the tensor cores run while the slots are summed.
// What bounds the bfloat16 launch: bytes, not operations. At ata 8192^2
// level 1 the tensor cores need 0.19 ms for 1.84e11 flops, the root read
// once a side and 0.72 GB of float32 out about 0.29 ms; the raw slot slabs
// each CTA combines are 5.8 GB through L2. What paces it is neither: with
// the raw copies, the combine, the remote stores or the wgmma taken out one
// at a time it stays within about a fifth of its time (tools/fused_shapes.py
// bf16 ablate, PERF.md), so the stage's fixed cost (a cluster barrier of 16
// CTAs, the copies' and the combine's bookkeeping for one or two quads a
// thread) sets it.
// A quad (4 elements) is one 16-byte (float32) or 8-byte (bfloat16) copy;
// the quad copies need every offset a multiple of 4 elements from a pointer
// aligned to 4 elements, else elements are copied one by one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "tn_tile.cuh"
#include "tn_wgmma.cuh"

namespace repro_torch {
namespace fused {

namespace cg = cooperative_groups;

// Shared-memory plan of one CTA for slot blocks of type T, W slots, a C x C
// cluster and R depth-8 slabs per stage (one barrier a stage). In a cluster
// (C > 1) the barrier's arrive comes before the multiply and wait after it,
// which needs three combined buffers; a CTA alone meets one __syncthreads
// after it, with two.
template <typename T, int W, int C, int R>
struct Plan {
  static constexpr int kRows = kDepth * R;                // slab rows of one stage
  static constexpr int kCols = kTile / C;                 // stripe columns a CTA combines
  static constexpr int kQuads = kCols / 4;                // quads (4 elements) per stage row
  static constexpr int kSideQuads = kRows * kQuads;       // quads per side per stage
  static constexpr int kAllQuads = 2 * kSideQuads;
  static constexpr int kQuadsPerThread = (kAllQuads + kThreads - 1) / kThreads;
  static constexpr int kRawElems = 2 * W * kRows * kCols;   // one raw stage, both sides
  static constexpr int kBufs = C > 1 ? 3 : 2;             // combined stage buffers
  static constexpr int kBufFloats = 2 * kRows * kTile;    // X and Y of one combined stage
  static constexpr int bytes(int stages) {
    return stages * kRawElems * static_cast<int>(sizeof(T)) + kBufs * kBufFloats * 4;
  }
  // The deepest ring (4 stages at most) that lets two CTAs share an SM, or
  // failing that the deepest that fits one CTA.
  static constexpr int kPair = 112 * 1024, kAlone = 220 * 1024;
  static constexpr int kStages = bytes(4) <= kPair ? 4 : bytes(3) <= kPair ? 3
                               : bytes(2) <= kPair ? 2 : bytes(4) <= kAlone ? 4
                               : bytes(3) <= kAlone ? 3 : bytes(2) <= kAlone ? 2 : 1;
  static constexpr int kSmemBytes = bytes(kStages);
  static constexpr int kMinBlocks = kSmemBytes <= kPair ? 2 : 1;
  static_assert(kSmemBytes <= kAlone, "shared memory of one CTA");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The quad of 4 elements at src, `avail` of them live (1..4), into dst: one
// 16-byte (float32) or 8-byte (bfloat16) copy zero-filling the dead ones
// where vec (the host's alignment check), else one copy an element — a
// 4-byte cp.async for float32, a plain load for bfloat16 (cp.async copies 4,
// 8 or 16 bytes).
__device__ __forceinline__ void copy_quad(float* dst, const float* src, int avail, int vec) {
  if (vec) {
    cp_async16(dst, src, 4 * (avail < 4 ? avail : 4));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < avail) cp_async4(dst + j, src + j);
  }
}

__device__ __forceinline__ void copy_quad(bf16* dst, const bf16* src, int avail, int vec) {
  if (vec) {
    cp_async8(dst, src, 2 * (avail < 4 ? avail : 4));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < avail) dst[j] = src[j];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A partial sum of the slot tree: its value and whether any slot under it
// is live.
struct Part {
  float4 v;
  bool live;
};

// x rounded to bfloat16 (nearest even) and back: exact in float32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The tree over slots [w0, w0 + N): the left half, then the right half, then
// one add — the pairwise order of core.strassen._combine_slots; kRound
// rounds each add to bfloat16, as an add of two bfloat16 tensors does.
template <int N, typename T, bool kRound = false>
__device__ __forceinline__ Part slot_tree(const T* raw, int slot_stride, const int* sgn,
                                          int w0) {
  if constexpr (N == 1) {
    const int s = sgn[w0];
    Part p{make_float4(0.f, 0.f, 0.f, 0.f), s != 0};
    if (p.live) {
      const float4 x = load4(raw + w0 * slot_stride);
      p.v = s < 0 ? make_float4(-x.x, -x.y, -x.z, -x.w) : x;
    }
    return p;
  } else {
    Part l = slot_tree<N / 2, T, kRound>(raw, slot_stride, sgn, w0);
    const Part r = slot_tree<N / 2, T, kRound>(raw, slot_stride, sgn, w0 + N / 2);
    if (l.live && r.live) {
      l.v = make_float4(__fadd_rn(l.v.x, r.v.x), __fadd_rn(l.v.y, r.v.y),
                        __fadd_rn(l.v.z, r.v.z), __fadd_rn(l.v.w, r.v.w));
      if constexpr (kRound)
        l.v = make_float4(round_bf16(l.v.x), round_bf16(l.v.y), round_bf16(l.v.z),
                          round_bf16(l.v.w));
    } else if (r.live) {
      l.v = r.v;
    }
    l.live = l.live || r.live;
    return l;
  }
}

// A thread's 8 x 8 outputs, rows i0.., columns j0.., of an n x k entry.
template <typename TO>
__device__ __forceinline__ void store_tile(TO* ce, const float (&acc)[kMicro][kMicro], int i0,
                                           int j0, int n, int k, float alpha) {
#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii) {
    const int i = i0 + ii;
    if (i >= n) continue;
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      const int j = j0 + jj;
      if (j < k) store1(ce + (long long)i * k + j, alpha * acc[ii][jj]);
    }
  }
}

template <typename T, int W, int C, int R>
__global__ void __launch_bounds__(kThreads, (Plan<T, W, C, R>::kMinBlocks))
    gemm_tn_fused_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const long long* __restrict__ off, const int* __restrict__ sgn,
                         void* __restrict__ c, int leaves, int inner, int m, int n, int k,
                         long long sab, long long lda, long long sbb, long long ldb, float alpha,
                         int vec16, bool bf16_out) {
  using P = Plan<T, W, C, R>;
  extern __shared__ __align__(16) float smem[];
  T* raw = reinterpret_cast<T*>(smem);                 // [kStages][2][W][kRows][kCols]
  float* bufs = reinterpret_cast<float*>(raw + P::kStages * P::kRawElems);
                                                       // [kBufs][2][kRows][kTile]
  __shared__ const T* s_base[2][W];                    // slot bases of this entry
  __shared__ int s_sgn[2][W];

  cg::cluster_group cluster = cg::this_cluster();
  const dim3 cidx = cluster.block_index();             // (cx, cy, 0) inside the cluster
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kTile;  // rows of C = columns of the X leaf
  const int c0 = blockIdx.x * kTile;  // columns of C = columns of the Y leaf

  // A quad of the CTA's share: side 0 is X (the stripe of tile row
  // blockIdx.y, split over the cluster's x), side 1 is Y (the stripe of tile
  // column blockIdx.x, split over the cluster's y). Thread tid owns quads
  // tid, tid + kThreads, ...
  struct Quad {
    int side, rr, scol, col, lim;
    long long ld;
  };
  auto quad = [&](int qi) {
    Quad q;
    q.side = qi / P::kSideQuads;
    q.rr = (qi % P::kSideQuads) / P::kQuads;
    const int part = q.side == 0 ? cidx.x : cidx.y;
    q.scol = part * P::kCols + 4 * (qi % P::kQuads);
    q.col = (q.side == 0 ? r0 : c0) + q.scol;
    q.lim = q.side == 0 ? n : k;
    q.ld = q.side == 0 ? lda : ldb;
    return q;
  };

  const long long entries = (long long)leaves * inner;
  const int stages = (m + P::kRows - 1) / P::kRows;
  unsigned seq = 0;  // combined stages produced so far: selects the buffer

  cluster_arrive();  // every CTA of the cluster runs before any remote store
  cluster_wait();
  for (long long e = blockIdx.z; e < entries; e += gridDim.z) {
    const long long leaf = e / inner;
    const long long bt = e % inner;
    if (tid < 2 * W) {  // the slot bases of this entry, once
      const int sd = tid / W, w = tid % W;
      const long long i = ((long long)sd * leaves + leaf) * W + w;
      s_sgn[sd][w] = sgn[i];
      s_base[sd][w] = (sd == 0 ? a + bt * sab : b + bt * sbb) + off[i];
    }
    __syncthreads();

    // Copy stage st of this thread's quads, all live slots, into ring slot
    // st % kStages. One commit group per stage, empty or not.
    auto copy_stage = [&](int st) {
#pragma unroll
      for (int u = 0; u < P::kQuadsPerThread; ++u) {
        const int qi = tid + u * kThreads;
        const Quad q = quad(qi);
        const int l = st * P::kRows + q.rr;
        const int avail = q.lim - q.col;
        if (qi < P::kAllQuads && st < stages && l < m && avail > 0) {
          T* d = raw + (st % P::kStages) * P::kRawElems +
                 ((q.side * W) * P::kRows + q.rr) * P::kCols + (q.scol % P::kCols);
          const long long roff = (long long)l * q.ld + q.col;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (!s_sgn[q.side][w]) continue;
            copy_quad(d + w * P::kRows * P::kCols, s_base[q.side][w] + roff, avail, vec16);
          }
        }
      }
      cp_async_commit();
    };

    for (int st = 0; st < P::kStages - 1; ++st) copy_stage(st);
    float acc[kMicro][kMicro];
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) acc[ii][jj] = 0.0f;

    for (int s = 0; s <= stages; ++s) {
      if (s < stages) {  // combine stage s into buffer seq % kBufs of every sharer
        copy_stage(s + P::kStages - 1);
        cp_async_wait<P::kStages - 1>();
        const int boff = (seq % P::kBufs) * P::kBufFloats;
#pragma unroll
        for (int u = 0; u < P::kQuadsPerThread; ++u) {
          const int qi = tid + u * kThreads;
          if (qi >= P::kAllQuads) continue;
          const Quad q = quad(qi);
          const T* src = raw + (s % P::kStages) * P::kRawElems +
                         ((q.side * W) * P::kRows + q.rr) * P::kCols + (q.scol % P::kCols);
          const Part t = slot_tree<W>(src, P::kRows * P::kCols, s_sgn[q.side], 0);
          const int l = s * P::kRows + q.rr;
          float4 v = (t.live && l < m) ? t.v : make_float4(0.f, 0.f, 0.f, 0.f);
          if (q.col + 0 >= q.lim) v.x = 0.0f;
          if (q.col + 1 >= q.lim) v.y = 0.0f;
          if (q.col + 2 >= q.lim) v.z = 0.0f;
          if (q.col + 3 >= q.lim) v.w = 0.0f;
          // the buffers of the C CTAs that share the stripe: the cluster
          // row for X, the cluster column for Y
          float* local = bufs + boff + (q.side * P::kRows + q.rr) * kTile + q.scol;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const unsigned rank = q.side == 0 ? j + cidx.y * C : cidx.x + j * C;
            float* d = rank == cluster.block_rank() ? local : cluster.map_shared_rank(local, rank);
            *reinterpret_cast<float4*>(d) = v;
          }
        }
        ++seq;
      }
      if constexpr (C > 1) cluster_arrive();
      if (s > 0) {  // multiply stage s-1: gemm_tn's depth-8 outer products
        const unsigned prev = seq - 1 - (s < stages ? 1 : 0);  // stage s-1's buffer
        const float* xs = bufs + (prev % P::kBufs) * P::kBufFloats;
        const float* ys = xs + P::kRows * kTile;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // only the depth-8 slabs gemm_tn runs: the same zero rows past m
          if (((s - 1) * R + r) * kDepth >= m) break;
#pragma unroll
          for (int kk = r * kDepth; kk < (r + 1) * kDepth; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk * kTile + ty * 8]);
            const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk * kTile + ty * 8 + 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&ys[kk * kTile + tx * 8]);
            const float4 b1 = *reinterpret_cast<const float4*>(&ys[kk * kTile + tx * 8 + 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
              for (int jj = 0; jj < kMicro; ++jj)
                acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
          }
        }
      }
      if constexpr (C > 1) {
        cluster_wait();
      } else {
        __syncthreads();  // a CTA alone: the block barrier is the whole barrier
      }
    }

    // one branch on the output type, outside the stores
    if (bf16_out) {
      store_tile(static_cast<bf16*>(c) + e * n * k, acc, r0 + ty * 8, c0 + tx * 8, n, k, alpha);
    } else {
      store_tile(static_cast<float*>(c) + e * n * k, acc, r0 + ty * 8, c0 + tx * 8, n, k, alpha);
    }
    // The next entry's slot bases overwrite s_base only after the cluster
    // barrier above, which every thread of this CTA passed after its last
    // read of them.
  }
}

// Shared-memory plan of one CTA of the bfloat16 kernel: W slots, a C x C
// cluster and R k16 steps a stage. The combined buffers come first, on a
// 1024-byte boundary (the swizzle's), then the raw ring.
template <int W, int C, int R>
struct WgPlan {
  static constexpr int kRows = wg::kStep * R;             // slab rows of one stage
  static constexpr int kCols = kTile / C;                 // stripe columns a CTA combines
  static constexpr int kQuads = kCols / 4;                // quads (4 elements) per stage row
  static constexpr int kSideQuads = kRows * kQuads;       // quads per side per stage
  static constexpr int kAllQuads = 2 * kSideQuads;
  static constexpr int kQuadsPerThread = (kAllQuads + kThreads - 1) / kThreads;
  static constexpr int kRawElems = 2 * W * kRows * kCols;   // one raw stage, both sides
  static constexpr int kBufs = 3;                         // combined stage buffers
  static constexpr int kSideBytes = wg::side_bytes(kRows);  // one side of a combined stage
  static constexpr int kBufBytes = 2 * kSideBytes;        // X, then Y
  static constexpr int bytes(int stages) {
    return 1024 + kBufs * kBufBytes + stages * kRawElems * 2;
  }
  static constexpr int kPair = 112 * 1024, kAlone = 220 * 1024;
  static constexpr int kStages = bytes(4) <= kPair ? 4 : bytes(3) <= kPair ? 3
                               : bytes(2) <= kPair ? 2 : bytes(4) <= kAlone ? 4
                               : bytes(3) <= kAlone ? 3 : bytes(2) <= kAlone ? 2 : 1;
  static constexpr int kSmemBytes = bytes(kStages);
  // two CTAs an SM where they fit, and where the slot tree leaves the 64
  // accumulators room in 128 registers (W = 16 spilled)
  static constexpr int kMinBlocks = kSmemBytes <= kPair && W <= 8 ? 2 : 1;
  static_assert(kSmemBytes <= kAlone, "shared memory of one CTA");
};

// The bfloat16 kernel: gemm_tn_fused_kernel's clusters, raw ring and slot
// tree (each add rounded to bfloat16), the combined stage in the swizzled
// layout of tn_wgmma.cuh, multiplied by the two warpgroups with wgmma.
// Stage s of an entry: combine s into the buffers of its sharers and
// fence the stores for the async proxy, then wait at the cluster barrier
// of stage s-1 (every sharer's combined values of s-1 are in this CTA's
// buffer), multiply s-1 with wgmma and wait for it, then arrive at the
// barrier of s. The combine of s runs between the arrival at s-1 and the
// wait for it, so it hides the barrier's latency. Three buffers: the
// combine of s writes a partner's buffer of s-3, whose wgmma the partner
// finished before it arrived at the barrier of s-2, which this CTA has
// passed. A CTA alone (C = 1) runs the same steps, its cluster one CTA.
template <int W, int C, int R>
__global__ void __launch_bounds__(kThreads, (WgPlan<W, C, R>::kMinBlocks))
    gemm_tn_fused_wgmma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                               const long long* __restrict__ off, const int* __restrict__ sgn,
                               void* __restrict__ c, int leaves, int inner, int m, int n, int k,
                               long long sab, long long lda, long long sbb, long long ldb,
                               float alpha, int vec16, bool bf16_out) {
  using P = WgPlan<W, C, R>;
  extern __shared__ unsigned char wsmem[];
  unsigned char* bufs = wg::align1024(wsmem);          // [kBufs][2][kSideBytes]
  bf16* raw = reinterpret_cast<bf16*>(bufs + P::kBufs * P::kBufBytes);
                                                       // [kStages][2][W][kRows][kCols]
  __shared__ const bf16* s_base[2][W];                 // slot bases of this entry
  __shared__ int s_sgn[2][W];

  cg::cluster_group cluster = cg::this_cluster();
  const dim3 cidx = cluster.block_index();             // (cx, cy, 0) inside the cluster
  const int tid = threadIdx.x;
  const int wgi = tid / 128;                           // this thread's warpgroup
  const int r0 = blockIdx.y * kTile;  // rows of C = columns of the X leaf
  const int c0 = blockIdx.x * kTile;  // columns of C = columns of the Y leaf

  struct Quad {
    int side, rr, scol, col, lim;
    long long ld;
  };
  auto quad = [&](int qi) {
    Quad q;
    q.side = qi / P::kSideQuads;
    q.rr = (qi % P::kSideQuads) / P::kQuads;
    const int part = q.side == 0 ? cidx.x : cidx.y;
    q.scol = part * P::kCols + 4 * (qi % P::kQuads);
    q.col = (q.side == 0 ? r0 : c0) + q.scol;
    q.lim = q.side == 0 ? n : k;
    q.ld = q.side == 0 ? lda : ldb;
    return q;
  };

  const long long entries = (long long)leaves * inner;
  const int stages = (m + P::kRows - 1) / P::kRows;
  const int steps = (m + wg::kStep - 1) / wg::kStep;   // k16 steps of an entry
  unsigned seq = 0;  // combined stages produced so far: selects the buffer

  cluster_arrive();  // every CTA of the cluster runs before any remote store
  cluster_wait();
  for (long long e = blockIdx.z; e < entries; e += gridDim.z) {
    const long long leaf = e / inner;
    const long long bt = e % inner;
    if (tid < 2 * W) {  // the slot bases of this entry, once
      const int sd = tid / W, w = tid % W;
      const long long i = ((long long)sd * leaves + leaf) * W + w;
      s_sgn[sd][w] = sgn[i];
      s_base[sd][w] = (sd == 0 ? a + bt * sab : b + bt * sbb) + off[i];
    }
    __syncthreads();

    auto copy_stage = [&](int st) {
#pragma unroll
      for (int u = 0; u < P::kQuadsPerThread; ++u) {
        const int qi = tid + u * kThreads;
        const Quad q = quad(qi);
        const int l = st * P::kRows + q.rr;
        const int avail = q.lim - q.col;
        if (qi < P::kAllQuads && st < stages && l < m && avail > 0) {
          bf16* d = raw + (st % P::kStages) * P::kRawElems +
                    ((q.side * W) * P::kRows + q.rr) * P::kCols + (q.scol % P::kCols);
          const long long roff = (long long)l * q.ld + q.col;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (!s_sgn[q.side][w]) continue;
            copy_quad(d + w * P::kRows * P::kCols, s_base[q.side][w] + roff, avail, vec16);
          }
        }
      }
      cp_async_commit();
    };

    for (int st = 0; st < P::kStages - 1; ++st) copy_stage(st);
    float acc[wg::kAcc];
    wg::zero(acc);

    for (int s = 0; s <= stages; ++s) {
      if (s < stages) {  // combine stage s into buffer seq % kBufs of every sharer
        copy_stage(s + P::kStages - 1);
        cp_async_wait<P::kStages - 1>();
        unsigned char* buf = bufs + (seq % P::kBufs) * P::kBufBytes;
#pragma unroll
        for (int u = 0; u < P::kQuadsPerThread; ++u) {
          const int qi = tid + u * kThreads;
          if (qi >= P::kAllQuads) continue;
          const Quad q = quad(qi);
          const bf16* src = raw + (s % P::kStages) * P::kRawElems +
                            ((q.side * W) * P::kRows + q.rr) * P::kCols + (q.scol % P::kCols);
          const Part t = slot_tree<W, bf16, true>(src, P::kRows * P::kCols, s_sgn[q.side], 0);
          const int l = s * P::kRows + q.rr;
          float4 v = (t.live && l < m) ? t.v : make_float4(0.f, 0.f, 0.f, 0.f);
          if (q.col + 0 >= q.lim) v.x = 0.0f;
          if (q.col + 1 >= q.lim) v.y = 0.0f;
          if (q.col + 2 >= q.lim) v.z = 0.0f;
          if (q.col + 3 >= q.lim) v.w = 0.0f;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);  // exact: bfloat16 values
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
          const uint2 word = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                        *reinterpret_cast<const unsigned*>(&hi));
          // the buffers of the C CTAs that share the stripe: the cluster
          // row for X, the cluster column for Y
          unsigned char* local =
              buf + q.side * P::kSideBytes + wg::swizzled(P::kRows, q.rr, q.scol);
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const unsigned rank = q.side == 0 ? j + cidx.y * C : cidx.x + j * C;
            unsigned char* d =
                rank == cluster.block_rank() ? local : cluster.map_shared_rank(local, rank);
            *reinterpret_cast<uint2*>(d) = word;
          }
        }
        wg::fence_async_cluster();  // the stores above, before wgmma reads them
        ++seq;
      }
      if (s > 0) {  // multiply stage s-1, once every sharer has combined it
        cluster_wait();
        const unsigned prev = seq - 1 - (s < stages ? 1 : 0);  // stage s-1's buffer
        const unsigned xs = wg::smem_u32(bufs + (prev % P::kBufs) * P::kBufBytes);
        const int n16 = min(R, steps - (s - 1) * R);
        wg::hold(acc);
        wg::fence();
        wg::mma_stage(acc, xs, xs + P::kSideBytes, P::kRows, wgi, n16);
        wg::commit();
        wg::wait<0>();
        wg::hold(acc);
      }
      if (s < stages) cluster_arrive();  // combined stage s, and done reading stage s-1
    }

    if (r0 < n && c0 < k) {  // one branch on the output type, outside the stores
      if (bf16_out) {
        wg::store_tile(static_cast<bf16*>(c) + e * n * k, acc, r0 + 64 * wgi, c0, n, k, alpha);
      } else {
        wg::store_tile(static_cast<float*>(c) + e * n * k, acc, r0 + 64 * wgi, c0, n, k, alpha);
      }
    }
    // The next entry's slot bases overwrite s_base only after the barrier
    // of its last stage above, which every thread of this CTA passed after
    // its last read of them.
  }
}

// Sets a kernel's attributes (once per device and instance: `set` is the
// instance's own flags; they hold for every later launch) and fills the
// launch configuration of a grid of ceil(k/128) x ceil(n/128) tiles rounded
// up to whole C x C clusters.
static cudaError_t configure(const void* kernel, int smem, int C, bool* set,
                             cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int n, int k,
                             long long entries, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && C * C > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) set[device] = true;
  }
  const int tiles_k = (k + kTile - 1) / kTile, tiles_n = (n + kTile - 1) / kTile;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((tiles_k + C - 1) / C * C, (tiles_n + C - 1) / C * C,
                     static_cast<unsigned>(entries < 65535 ? entries : 65535));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// A kernel instance, its dynamic shared bytes, cluster edge, ring stages
// and stage depth (depth-8 slabs of the float32 kernel, k16 steps of the
// bfloat16 one), for launch and info.
struct Instance {
  const void* kernel;
  int smem, C, stages, R;
  bool* set;
  int* resident;  // the bfloat16 kernel's resident clusters, by device; null for float32
};

template <int W, int C, int R>
static Instance f32_instance() {
  using P = Plan<float, W, C, R>;
  static bool set[kMaxDevices] = {};
  return {reinterpret_cast<const void*>(gemm_tn_fused_kernel<float, W, C, R>), P::kSmemBytes, C,
          P::kStages, R, set, nullptr};
}

template <int W, int C, int R>
static Instance bf16_instance() {
  using P = WgPlan<W, C, R>;
  static bool set[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  return {reinterpret_cast<const void*>(gemm_tn_fused_wgmma_kernel<W, C, R>), P::kSmemBytes, C,
          P::kStages, R, set, resident};
}

static int launch(const Instance& in, cudaStream_t stream, const void* a, const void* b,
                  const long long* off, const int* sgn, void* c, int leaves, int inner, int m,
                  int n, int k, long long sab, long long lda, long long sbb, long long ldb,
                  float alpha, int vec16, bool bf16_out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      configure(in.kernel, in.smem, in.C, in.set, cfg, attr, n, k, (long long)leaves * inner,
                stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (in.resident) {
    // the bfloat16 kernel: no more clusters than are resident at once, each
    // walking several entries (no cluster waits for room to launch, and an
    // entry's stores overlap the next one's copies)
    int device = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int resident = device < kMaxDevices ? in.resident[device] : 0;
    if (!resident) {
      err = cudaOccupancyMaxActiveClusters(&resident, in.kernel, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (device < kMaxDevices) in.resident[device] = resident;
    }
    const int per_z = static_cast<int>(cfg.gridDim.x / in.C * (cfg.gridDim.y / in.C));
    const int fit = resident / per_z;
    if (fit >= 1 && static_cast<unsigned>(fit) < cfg.gridDim.z) cfg.gridDim.z = fit;
  }
  // the kernels' parameters, in order (both take the same list)
  void* args[] = {&a,   &b,   &off, &sgn, &c,   &leaves, &inner, &m,        &n,
                  &k,   &sab, &lda, &sbb, &ldb, &alpha,  &vec16, &bf16_out};
  err = cudaLaunchKernelExC(&cfg, in.kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: registers per thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes, resident CTAs per SM, resident clusters on the card,
// ring stages, cluster edge, stage depth.
static int info(const Instance& in, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(in.kernel, in.smem, in.C, in.set, cfg, attr, 512, 512, 1, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, in.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in.kernel, kThreads, in.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(&clusters, in.kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = in.smem;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = clusters;
  out[6] = in.stages;
  out[7] = in.C;
  out[8] = in.R;
  return 0;
}

}  // namespace fused
}  // namespace repro_torch

namespace {
// The shape each slot count runs with: cluster edge and stage depth, in
// depth-8 slabs for float32 and in k16 steps for bfloat16 (measured on the
// H100 by tools/fused_shapes.py [bf16], see PERF.md). bfloat16 takes 4 x 4
// clusters at every W (even W = 1: the cluster shares the stripes' loads)
// and two k16 steps a stage up to W = 4; from W = 8 a stage of two steps
// leaves room for one CTA an SM, and one step with two ran faster.
template <int W>
struct Shape {
  static constexpr int C = W == 1 ? 1 : W == 2 ? 2 : 4;
  static constexpr int R = W == 1 ? 1 : 2;
  static constexpr int C16 = 4;
  static constexpr int R16 = W <= 4 ? 2 : 1;
};

// The instance for w slots of float32 (bf16 false) or bfloat16 blocks;
// kernel null for a slot count that is not instantiated.
repro_torch::fused::Instance instance(int w, bool bf16) {
  using namespace repro_torch::fused;
#define REPRO_FUSED_CASE(W)                                                                        \
  case W:                                                                                          \
    return bf16 ? bf16_instance<W, Shape<W>::C16, Shape<W>::R16>()                                 \
                : f32_instance<W, Shape<W>::C, Shape<W>::R>();
  switch (w) {
    REPRO_FUSED_CASE(1)
    REPRO_FUSED_CASE(2)
    REPRO_FUSED_CASE(4)
    REPRO_FUSED_CASE(8)
    REPRO_FUSED_CASE(16)
    REPRO_FUSED_CASE(32)
    default: return Instance{nullptr, 0, 0, 0, 0, nullptr, nullptr};
  }
#undef REPRO_FUSED_CASE
}
}  // namespace

// off: (2, leaves, w) int64 element offsets (A side, then B side); sgn: the
// same shape in int32. c: (leaves, inner, n, k). w is 1, 2, 4, 8, 16 or 32.
// vec16: every slot base, batch stride and row stride is a multiple of 4
// elements from a pointer aligned to 4 elements, so the raw slabs copy in
// quads (16 B float32, 8 B bfloat16). dtypes: bit 0 bfloat16 blocks (the
// tensor-core kernel), bit 1 bfloat16 output (dtype.cuh).
extern "C" int gemm_tn_fused_f32(const void* a, const void* b, const long long* off,
                                 const int* sgn, void* c, int leaves, int inner, int w, int m,
                                 int n, int k, long long sab, long long lda, long long sbb,
                                 long long ldb, float alpha, int vec16, int dtypes, void* stream) {
  const repro_torch::fused::Instance in = instance(w, (dtypes & repro_torch::kLoadBf16) != 0);
  if (!in.kernel) return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::fused::launch(in, static_cast<cudaStream_t>(stream), a, b, off, sgn, c,
                                    leaves, inner, m, n, k, sab, lda, sbb, ldb, alpha, vec16,
                                    (dtypes & repro_torch::kStoreBf16) != 0);
}

// Resources of the float32 instance for w slots (see fused::info); out holds 9 ints.
extern "C" int gemm_tn_fused_info(int w, int* out) {
  const repro_torch::fused::Instance in = instance(w, false);
  if (!in.kernel) return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::fused::info(in, out);
}

// Resources of the bfloat16 (tensor-core) instance for w slots; 9 ints, the
// last the k16 steps a stage.
extern "C" int gemm_tn_fused_wgmma_info(int w, int* out) {
  const repro_torch::fused::Instance in = instance(w, true);
  if (!in.kernel) return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::fused::info(in, out);
}
