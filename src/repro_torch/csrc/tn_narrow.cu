// tn_narrow: C[b] = alpha * A[b]^T B[b] for a narrow B (k <= kNarrowMaxK = 64
// columns), summed in float32; gemm_tn.cu's launch takes it for every such k.
//
// Replaces: the narrow case of gemm_tn_pallas in src/repro/kernels/gemm_tn.py:78
// (its pl.pallas_call at :121): CG's A^T (A p) at (m, n, k) = (16384, 4096, 8),
// PowerSGD's G^T P at (24576, 2816, 4) and (67584, 1024, 4), serving's A^T b
// (at most 512 rows).
//
// What bounds it on the H100: bytes. A is read once (268 MB at the CG shape,
// 0.080 ms at 3.35 TB/s) for 2 m n k flops (0.016 ms at 67 TFLOP/s). Beside
// that sits a floor of the summation order: each output is ONE fmaf chain
// of m dependent FMAs, so the m rows pass through every thread one after
// another and a warp takes m times its cost a row (its shared-memory loads
// of A and B and its FMAs): 8.5-13 cycles here, above the bytes bound at
// every timed shape (PERF.md). The tile engine spent these shapes on a grid
// of ceil(k/128) x ceil(n/128) CTAs, 32 for 132 SMs at the CG shape, with
// 94-97% of its FMAs on zero columns of B.
//
// What the design does about both:
// * Grid. A CTA owns a strip of w columns of A (rows of C) and all k columns
//   of B, for one batch entry (batch on gridDim.z, strided past 65535). w in
//   {64, 32, 16, 8} is the widest whose grid covers 7/8 of the SMs: 128 CTAs
//   at n = 4096 (w = 32), 176 at n = 2816 (16), 128 at n = 1024 (8).
// * Streaming. Copying warps fill a ring of 4 stages in shared memory (96
//   KiB, two CTAs an SM; 3 stages in flight). Where every base and stride is
//   16-byte aligned, one thread asks for each stage's rows of A's strip as
//   one tensor copy (TMA, from a 3-D map encoded at launch; rows past m and
//   columns past n land as zeros) and the copying threads bring B's rows as
//   8-byte (bfloat16: 4-byte) cp.async copies of column pairs, written
//   transposed: a pair's rows lie side by side. Everything completes on the
//   stage's mbarrier; the consumers hand a stage back on a second one, so no
//   copy waits on a block barrier. Otherwise they copy elements, by 4-byte
//   cp.async for float32 and plain loads for bfloat16 (an alignment path, as
//   the engine's kVec16 = false).
// * Chains. Each consumer thread owns p x 2 outputs (p = 1 or 2), each ONE
//   fmaf chain from 0.0f over l = 0 ... m-1 in ascending order: tn_tile.cuh's
//   summation order. It reads its A values with one load a row and its B
//   pair two rows at a time (one 16-byte load), and loads the next 8 rows
//   while the FMAs of the last 8 run, in a branch-free pipeline. Rows past m
//   are not read: the engine's zero rows up to its next depth-8 slab add one
//   exact +0.0f to each sum, done here once at the end (it turns a -0 sum
//   into +0, as those rows do), so the output is the engine's bit for bit.
// * No tensor cores (TF32 would change every rounding) and no split of the
//   contraction (it would change the order of summation).
//
// Operands are float32 (gemm_tn.cu sends bfloat16 operands to its
// tensor-core kernel at every k, so the kernel is instantiated for float32
// operands only), the output float32 or bfloat16: alpha * sum, rounded
// once to its type, as the engine's epilogue.
#include <cuda.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "tn_narrow.cuh"
#include "tn_tile.cuh"
#include "tn_wgmma.cuh"

namespace repro_torch {

// the mbarrier, TMA and tensor-map helpers of the tensor-core kernels: a
// lost arrival traps (a launch error) after about ten seconds of one stall
// instead of hanging the card
using wg::encode_tiled;
using wg::EncodeTiled;
using wg::mbar_arrive;
using wg::mbar_arrive_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::tma_load;

constexpr int kNarrowStages = 4;            // ring depth: 3 stages in flight
constexpr int kNarrowRingBytes = 96 * 1024; // two CTAs an SM
constexpr int kNarrowGroup = 8;             // rows a thread loads ahead of their FMAs
constexpr int kNarrowMaxRows = 256;         // rows a stage at most
constexpr int kNarrowMaxConsumers = 512;    // threads that own outputs, a CTA
constexpr int kNarrowMaxCopyWarps = 4;      // warps that copy, a CTA, at most

// The shape of one launch, from (n, k, batch), the element size and the
// card's SM count (narrow_plan).
struct NarrowPlan {
  int w;          // strip: columns of A (rows of C) a CTA; 8, 16, 32 or 64
  int p;          // of them a thread's, 1 or 2; each thread also owns 2 columns of B
  int rows;       // rows of A and B a stage, a multiple of 16
  int bp;         // pitch of a pair of B's columns in a stage, in elements
  int stage;      // elements a stage, a multiple of 128 bytes
  int consumers;  // threads that own outputs
  int copiers;    // threads that copy: 32 a warp, after the consumers' warps
  int strips;     // CTAs along n: ceil(n / w)
  int smem;       // dynamic shared bytes: the ring
};

// A kernel argument (__grid_constant__: the tensor maps stay in parameter
// space, where the copy engine reads them).
struct NarrowArgs {
  CUtensorMap ta;  // A's strips as a 3-D tiled map; read if tma
  const void* a;
  const void* b;
  void* c;
  int batch, m, n, k;
  long long sab, lda, sbb, ldb;
  float alpha;
  int tma;  // A arrives by tensor copies and B by pair copies; element copies otherwise
  NarrowPlan plan;
};

// The barrier's arrival once this thread's earlier cp.async copies landed
// (counted in the barrier's initial count).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// P consecutive elements at p as float32 (P = 1 or 2; p aligned to P elements).
template <int P>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[P]) {
  if constexpr (P == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// Rows r and r + 1 of a thread's two columns of B from the pair-major
// block (p aligned to 4 elements): one load for two rows.
__device__ __forceinline__ void ld_rows2(const float* p, float (&b0)[2], float (&b1)[2]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  b0[0] = x.x, b0[1] = x.y, b1[0] = x.z, b1[1] = x.w;
}

// kNarrowGroup rows of a thread's operands from the ring, starting at row r:
// xa is its first column of the stage's A strip (pitch W), xb its pair of
// B's columns (rows of 2 elements).
template <int W, int P, typename T>
__device__ __forceinline__ void narrow_load(const T* xa, const T* xb, int r,
                                            float (&fa)[kNarrowGroup][P],
                                            float (&fb)[kNarrowGroup][2]) {
#pragma unroll
  for (int u = 0; u < kNarrowGroup; ++u) ld_vec<P>(xa + (r + u) * W, fa[u]);
#pragma unroll
  for (int u = 0; u < kNarrowGroup; u += 2) ld_rows2(xb + (r + u) * 2, fb[u], fb[u + 1]);
}

template <int P>
__device__ __forceinline__ void narrow_fma(const float (&fa)[kNarrowGroup][P],
                                           const float (&fb)[kNarrowGroup][2],
                                           float (&acc)[P][2]) {
#pragma unroll
  for (int u = 0; u < kNarrowGroup; ++u)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) acc[p][q] = fmaf(fa[u][p], fb[u][q], acc[p][q]);
}

// acc[p][q] += rows [0, rows) of the stage, in ascending order. Shared-memory
// loads pace it (a warp issues one every few cycles), so it is one
// branch-free pipeline: the next kNarrowGroup rows always load before this
// group's FMAs run. Past the stage's last row those loads read the rest of
// the ring or its padding; their values feed nothing.
template <int W, int P, typename T>
__device__ __forceinline__ void narrow_chain(const T* xa, const T* xb, int rows,
                                             float (&acc)[P][2]) {
  float fa0[kNarrowGroup][P], fb0[kNarrowGroup][2], fa1[kNarrowGroup][P], fb1[kNarrowGroup][2];
  const int groups = rows / kNarrowGroup;
  narrow_load<W, P>(xa, xb, 0, fa0, fb0);
  int h = 0;
  for (; h + 2 <= groups; h += 2) {
    narrow_load<W, P>(xa, xb, (h + 1) * kNarrowGroup, fa1, fb1);
    narrow_fma<P>(fa0, fb0, acc);
    narrow_load<W, P>(xa, xb, (h + 2) * kNarrowGroup, fa0, fb0);
    narrow_fma<P>(fa1, fb1, acc);
  }
  if (h < groups) narrow_fma<P>(fa0, fb0, acc);
  for (int r = groups * kNarrowGroup; r < rows; ++r) {
    float fa[P], fb0r[2], fb1r[2];
    ld_vec<P>(xa + r * W, fa);
    ld_rows2(xb + (r & ~1) * 2, fb0r, fb1r);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) acc[p][q] = fmaf(fa[p], (r & 1) ? fb1r[q] : fb0r[q], acc[p][q]);
  }
}

// Copies two consecutive elements from global to shared memory (8-byte
// aligned for float32, 4-byte for bfloat16), asynchronously.
template <typename T>
__device__ __forceinline__ void copy_pair(T* dst, const T* src) {
  const unsigned d = smem_u32(dst);
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

// Copies one element from global to shared memory: a 4-byte cp.async for
// float32 (its arrival is the thread's cp_async_arrive), a plain load and
// store for bfloat16.
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    tn_copy4(dst, src, 4);
  } else {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  }
}

// A stage of the ring: A's strip [rows][W], then B's columns in pairs,
// [(k + 1) / 2][pair pitch], a pair's rows [rows][2] at the head of its
// block: one 16-byte load gives a thread two rows of its two columns. The
// pair pitch is 16 bytes over 2 * rows elements, so the blocks of
// neighbouring pairs start in different banks.
template <typename T, int W>
struct NarrowStage {
  T* a;
  T* bt;
  __device__ __forceinline__ NarrowStage(T* ring, const NarrowPlan& pl, int slot) {
    a = ring + slot * pl.stage;
    bt = a + pl.rows * W;
  }
};

template <typename T, typename TO, int W, int P>
__global__ void __launch_bounds__(kNarrowMaxConsumers + 32 * kNarrowMaxCopyWarps)
    gemm_tn_narrow_kernel(const __grid_constant__ NarrowArgs g) {
  constexpr int S = kNarrowStages;
  extern __shared__ __align__(128) unsigned char narrow_ring[];
  // full: a stage's copies landed (A's tensor copy and every copying
  // thread's copies); empty: the consumers are done with it
  __shared__ __align__(8) unsigned long long full[S], empty[S];
  const NarrowPlan pl = g.plan;
  const int tid = threadIdx.x;
  const int producer = blockDim.x - pl.copiers;  // the last warps copy
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], pl.copiers + (g.tma ? 1 : 0));
      mbar_init(&empty[s], pl.consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the tensor copies land on 128-byte boundaries: every stage starts a
  // multiple of 128 bytes from here
  T* ring = reinterpret_cast<T*>(narrow_ring + ((128 - (smem_u32(narrow_ring) & 127)) & 127));
  const int c0 = blockIdx.x * W;
  const int stages = (g.m + pl.rows - 1) / pl.rows;  // a batch entry's
  const int kq = (g.k + 1) / 2;                      // B's column pairs

  if (tid >= producer) {
    const int lane = tid - producer;  // of the copying threads
    const int live = min(W, g.n - c0);  // columns of the strip below n
    const int total = (g.batch - blockIdx.z + gridDim.z - 1) / gridDim.z * stages;
    for (int gi = 0; gi < total; ++gi) {
      const int slot = gi % S;
      if (gi >= S) mbar_wait(&empty[slot], (gi / S - 1) & 1);
      const int e = gi / stages, l0 = (gi - e * stages) * pl.rows;
      const int rows = min(pl.rows, g.m - l0);
      const int bt = blockIdx.z + e * gridDim.z;
      const T* bb = static_cast<const T*>(g.b) + bt * g.sbb + l0 * g.ldb;
      const NarrowStage<T, W> st(ring, pl, slot);
      if (g.tma) {
        if (lane == 0) {  // one thread asks for A's tensor copy
          mbar_arrive_tx(&full[slot], pl.rows * W * static_cast<int>(sizeof(T)));
          tma_load(st.a, &g.ta, c0, l0, bt, &full[slot]);
        }
        // B's pairs land transposed: pair jp of row r at bt[jp][r]. For odd k
        // the last pair's second element lies past the row, in the 16-byte
        // granule of its first (so in mapped memory), and feeds only an
        // output that is not stored.
        for (int idx = lane; idx < rows * kq; idx += pl.copiers) {
          const int r = idx / kq, jp = idx - r * kq;
          copy_pair(st.bt + jp * pl.bp + 2 * r, bb + r * g.ldb + 2 * jp);
        }
      } else {
        const T* ab = static_cast<const T*>(g.a) + bt * g.sab + c0 + l0 * g.lda;
        for (int r = 0; r < rows; ++r)
          for (int c = lane; c < live + g.k; c += pl.copiers) {
            if (c < live) {
              copy_elem(st.a + r * W + c, ab + r * g.lda + c);
            } else {
              const int j = c - live;
              copy_elem(st.bt + (j >> 1) * pl.bp + 2 * r + (j & 1), bb + r * g.ldb + j);
            }
          }
      }
      if (g.tma || sizeof(T) == 4) {
        cp_async_arrive(&full[slot]);
      } else {
        mbar_arrive(&full[slot]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    return;
  }
  if (tid >= pl.consumers) return;

  const int i0 = (tid / kq) * P, jp = tid % kq;
  unsigned gs = 0;
  for (int bt = blockIdx.z; bt < g.batch; bt += gridDim.z) {
    float acc[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p][0] = acc[p][1] = 0.0f;
    for (int s = 0; s < stages; ++s, ++gs) {
      const int slot = gs % S;
      mbar_wait(&full[slot], (gs / S) & 1);
      const NarrowStage<T, W> st(ring, pl, slot);
      narrow_chain<W, P>(st.a + i0, st.bt + jp * pl.bp, min(pl.rows, g.m - s * pl.rows), acc);
      mbar_arrive(&empty[slot]);
    }
    TO* cb = static_cast<TO*>(g.c) + (long long)bt * g.n * g.k;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = c0 + i0 + p;
      if (i >= g.n) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 2 * jp + q;
        if (j >= g.k) continue;
        // the engine's zero rows m ... up to its next depth-8 slab
        const float v = (g.m % kDepth) ? acc[p][q] + 0.0f : acc[p][q];
        store1(cb + (long long)i * g.k + j, g.alpha * v);
      }
    }
  }
}

static cudaError_t sm_count(int& sms) {
  static int cached[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached[device]) {
    sms = cached[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) cached[device] = sms;
  return err;
}

// w: the widest strip whose grid covers 7/8 of the SMs, no wider than n
// needs and with at most kNarrowMaxConsumers threads owning outputs; p = 2
// where that still leaves two warps of them (a warp's shared-memory loads
// pace its rows, so fewer, fuller warps); one warp copying for every two of
// B's column pairs, from 2 to kNarrowMaxCopyWarps; the stage: as many rows (a
// multiple of 16) as kNarrowStages stages hold in kNarrowRingBytes, less
// the ring's alignment and the rows that the pipeline of narrow_chain reads
// past the last stage (tools/kernel_variants.py narrow times the choices).
static NarrowPlan narrow_plan(int n, int k, int batch, int elem_bytes, int sms) {
  NarrowPlan pl;
  const int kq = (k + 1) / 2;
  const long long want = (long long)sms * 7 / 8;
  auto cols = [kq](int w) { return w / 2 * kq >= 64 ? 2 : 1; };
  auto consumers = [&](int w) { return w / cols(w) * kq; };
  int w = 64;
  while (w > 8 && ((long long)((n + w - 1) / w) * batch < want || w / 2 >= n ||
                   consumers(w) > kNarrowMaxConsumers))
    w /= 2;
  pl.w = w;
  pl.p = cols(w);
  pl.consumers = consumers(w);
  pl.copiers = 32 * (kq / 2 < 2 ? 2 : kq / 2 > kNarrowMaxCopyWarps ? kNarrowMaxCopyWarps : kq / 2);
  pl.strips = (n + w - 1) / w;
  const int pad = 16 / elem_bytes, line = 128 / elem_bytes;
  const int spare = 128 + kNarrowGroup * (w + 2) * elem_bytes;
  auto stage = [&](int rows) { return (rows * w + kq * (2 * rows + pad) + line - 1) / line * line; };
  int rows = kNarrowMaxRows;
  while (rows > 16 && kNarrowStages * stage(rows) * elem_bytes + spare > kNarrowRingBytes) rows -= 16;
  pl.rows = rows;
  pl.bp = 2 * rows + pad;
  pl.stage = stage(rows);
  pl.smem = kNarrowStages * pl.stage * elem_bytes + spare;
  return pl;
}

template <typename T, typename TO, int W, int P>
static const void* narrow_kernel() {
  return reinterpret_cast<const void*>(gemm_tn_narrow_kernel<T, TO, W, P>);
}

// The instance of a plan's (w, p), and its dynamic shared-memory opt-in,
// once per device.
template <typename T, typename TO, int W, int P>
static cudaError_t narrow_opt_in(const void*& kernel) {
  static bool done[kMaxDevices] = {};
  kernel = narrow_kernel<T, TO, W, P>();
  return tn_opt_in(kernel, kNarrowRingBytes, done);
}

template <typename T, typename TO>
static cudaError_t narrow_instance(const NarrowPlan& pl, const void*& kernel) {
  switch (pl.w * 2 + pl.p - 1) {
    case 16: return narrow_opt_in<T, TO, 8, 1>(kernel);
    case 17: return narrow_opt_in<T, TO, 8, 2>(kernel);
    case 32: return narrow_opt_in<T, TO, 16, 1>(kernel);
    case 33: return narrow_opt_in<T, TO, 16, 2>(kernel);
    case 64: return narrow_opt_in<T, TO, 32, 1>(kernel);
    case 65: return narrow_opt_in<T, TO, 32, 2>(kernel);
    case 128: return narrow_opt_in<T, TO, 64, 1>(kernel);
    default: return narrow_opt_in<T, TO, 64, 2>(kernel);
  }
}

static int narrow_threads(const NarrowPlan& pl) {
  return (pl.consumers + 31) / 32 * 32 + pl.copiers;
}

// A 3-D tiled map of an operand of `batch` entries of rows x cols (row
// stride ld, entry stride sb, in elements), boxes of box_cols x box_rows x 1;
// false where the encoding refuses the layout.
template <typename T>
static bool encode_map(CUtensorMap* map, const void* base, int cols, int rows, int batch,
                       long long ld, long long sb, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld * sizeof(T)),
                                 static_cast<cuuint64_t>((batch > 1 ? sb : rows * ld) * sizeof(T))};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename TO>
int tn_narrow_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                     long long sab, long long lda, long long sbb, long long ldb, float alpha,
                     int vec16, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  NarrowArgs g;
  g.a = a, g.b = b, g.c = c;
  g.batch = batch, g.m = m, g.n = n, g.k = k;
  g.sab = sab, g.lda = lda, g.sbb = sbb, g.ldb = ldb;
  g.alpha = alpha;
  g.plan = narrow_plan(n, k, batch, sizeof(T), sms);
  g.tma = vec16 && encode_map<T>(&g.ta, a, n, m, batch, lda, sab, g.plan.w, g.plan.rows);
  const void* kernel = nullptr;
  err = narrow_instance<T, TO>(g.plan, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.plan.strips, 1, batch < 65535 ? batch : 65535);
  void* args[] = {&g};
  err = cudaLaunchKernel(kernel, grid, dim3(narrow_threads(g.plan)), args, g.plan.smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template int tn_narrow_launch<float, float>(const void*, const void*, void*, int, int, int, int,
                                            long long, long long, long long, long long, float,
                                            int, cudaStream_t);
template int tn_narrow_launch<float, bf16>(const void*, const void*, void*, int, int, int, int,
                                           long long, long long, long long, long long, float, int,
                                           cudaStream_t);

}  // namespace repro_torch

// out: the plan and resources of the float32 instance gemm_tn launches at
// (n, k, batch) on the current device; 13 ints (kernels/_build.py's
// RESOURCE_FIELDS["gemm_tn_narrow_info"]). max_k is kNarrowMaxK: gemm_tn
// takes this kernel for k <= max_k.
extern "C" int gemm_tn_narrow_info(int n, int k, int batch, int* out) {
  using namespace repro_torch;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const NarrowPlan pl = narrow_plan(n, k, batch, sizeof(float), sms);
  const void* kernel = nullptr;
  err = narrow_instance<float, float>(pl, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, narrow_threads(pl),
                                                      pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = pl.smem;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = narrow_threads(pl);
  out[6] = pl.w;
  out[7] = pl.p;
  out[8] = pl.rows;
  out[9] = kNarrowStages;
  out[10] = pl.strips * (batch < 65535 ? batch : 65535);
  out[11] = kNarrowMaxK;
  out[12] = pl.copiers;
  return cudaSuccess;
}
