// gemm_tn: C[b] = alpha * A[b]^T B[b], summed in float32, for a whole batch in one launch.
//
// Replaces: gemm_tn_pallas in src/repro/kernels/gemm_tn.py:78 (the Pallas TN
// matmul that is the leaf of every Strassen product). Its one C entry point
// launches the one of three kernels that the wrapper names
// (kernels/gemm_tn.py tn_route: by operand type and k): bfloat16 operands
// run the tensor-core kernel below (tn_wgmma.cuh) at every k; float32
// operands run the narrow kernel of tn_narrow.cu for a narrow B (k <=
// kNarrowMaxK columns: CG's, PowerSGD's and serving's products), which sums
// each output in the same order as the tile engine below, and the tile
// engine for every wider k. A kernel that cannot take the operands is
// refused.
//
// float32, what bounds it on the H100: operations. A Strassen leaf is 512 x
// 512 x 512 (2 * 512^3 = 268 MFLOP on 3 MiB), far above the card's float32
// balance point (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte), so
// the ceiling is the 67 TFLOP/s of the float32 FMA units outside the tensor
// cores. The first version reached 39 TFLOP/s against cuBLAS's 51: bank
// conflicts on its shared-memory reads paced the FMA loop, its copies ran
// through registers, and it stored scalars (PERF.md).
//
// float32, what the design does about it: the tile engine of tn_tile.cuh —
// a 128 x 128 tile a CTA, 8 x 8 accumulators a thread, warps of 32 x 64
// with conflict-free LDS.128 reads, and a 3-stage cp.async ring of depth-32
// slabs with one barrier a stage — then float4 stores of each output row
// segment where k allows it (k % 4 == 0), scalar masked stores otherwise.
// Two CTAs share an SM (96 KiB of ring each, at most 128 registers). The
// grid is (k-tiles, n-tiles, batch), so a whole Strassen leaf stack is one
// launch; entries past 65535 stride over gridDim.z. Ragged edges are
// zero-filled by the copies instead of padded. The summation order is the
// engine's (one fmaf chain over depth-8 slabs), so gemm_tn_fused stays
// bitwise equal to this kernel. The tensor cores are left out for float32:
// they take float32 only as TF32, which would change the rounding of every
// leaf.
//
// bfloat16 operands, what bounds them: bytes (the leaf stack at the
// tensor cores' 989 TFLOP/s takes 0.39 ms, its 1.5 GB read and 1.5 GB of
// float32 written 0.90 ms). The tile engine converted each element on the
// read and ran at 9% of that bound, slower than in float32 (PERF.md). The
// design: gemm_tn_wgmma_kernel, a 128 x 128 tile a CTA as above, summed by
// two consumer warpgroups with wgmma (tn_wgmma.cuh: the MN-major operands
// in the 128-byte swizzle, the k16 summation order). One producer warp
// fills a ring of kWgStages stages of kWgRows rows: one thread asks for
// four TMA boxes a stage (64 columns x 64 rows of A, twice, and of B) from
// tensor maps encoded at launch, rows past m and columns past n or k
// landing as zeros; the stage's mbarrier completes on their bytes, and the
// consumers hand it back on a second one after the wgmma that read it has
// finished. Two CTAs share an SM. Where TMA cannot take an operand's
// layout (a base or a stride that is not a multiple of 16 bytes, as B's
// rows of 4 columns in PowerSGD's products), the producer warp fills that
// operand's side of the same swizzled stages by element loads and
// ordinary stores, fenced for the async proxy: the same operands in the
// same layout, the same bits.
//
// The output is float32 or bfloat16 (dtype.cuh), rounded once.
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "tn_narrow.cuh"
#include "tn_tile.cuh"
#include "tn_wgmma.cuh"

namespace repro_torch {

template <typename T, typename TO, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_tn_kernel(const T* __restrict__ a, const T* __restrict__ b, TO* __restrict__ c,
                   int batch, int m, int n, int k, long long sab, long long lda, long long sbb,
                   long long ldb, float alpha) {
  extern __shared__ __align__(16) float smem[];
  const TnMap map;
  const int r0 = blockIdx.y * kTile;  // rows of C = columns of A
  const int c0 = blockIdx.x * kTile;  // columns of C = columns of B
  const bool vec_out = (k & 3) == 0;  // every row segment 16 B (8 B bfloat16) aligned
  for (int bt = blockIdx.z; bt < batch; bt += gridDim.z) {
    float acc[kMicro][kMicro];
    tn_tile<T, kVec16>(TnOperand<T>{a + bt * sab, lda, r0, n},
                       TnOperand<T>{b + bt * sbb, ldb, c0, k}, 0, m, smem, map, acc);
    TO* cb = c + (long long)bt * n * k;
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int i = r0 + map.row(ii);
      if (i >= n) continue;
#pragma unroll
      for (int h = 0; h < kMicro; h += 4) {
        const int j = c0 + map.col(h);
        TO* dst = cb + (long long)i * k + j;
        const float v[4] = {alpha * acc[ii][h], alpha * acc[ii][h + 1], alpha * acc[ii][h + 2],
                            alpha * acc[ii][h + 3]};
        if (vec_out && j < k) {
          store4(dst, v);
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            if (j + f < k) store1(dst + f, v[f]);
        }
      }
    }
    __syncthreads();  // the next batch entry refills the ring
  }
}

// The instance's dynamic shared-memory opt-in, once per device.
template <typename T, typename TO, bool kVec16>
static cudaError_t opt_in() {
  static bool done[kMaxDevices] = {};
  return tn_opt_in(reinterpret_cast<const void*>(gemm_tn_kernel<T, TO, kVec16>), kTnSmemBytes,
                   done);
}

template <typename TO>
static int launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                  long long sab, long long lda, long long sbb, long long ldb, float alpha,
                  int vec16, cudaStream_t stream) {
  cudaError_t err = vec16 ? opt_in<float, TO, true>() : opt_in<float, TO, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((k + kTile - 1) / kTile, (n + kTile - 1) / kTile, batch < 65535 ? batch : 65535);
  auto kernel = vec16 ? gemm_tn_kernel<float, TO, true> : gemm_tn_kernel<float, TO, false>;
  kernel<<<grid, kThreads, kTnSmemBytes, stream>>>(static_cast<const float*>(a),
                                                   static_cast<const float*>(b),
                                                   static_cast<TO*>(c), batch, m, n, k, sab, lda,
                                                   sbb, ldb, alpha);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 operands: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                          // rows of A and B a stage
constexpr int kWgStages = 3;                         // ring depth: two CTAs an SM
constexpr int kWgSide = wg::side_bytes(kWgRows);     // 16 KiB: two boxes of one operand
constexpr int kWgStageBytes = 2 * kWgSide;           // A's tile columns, then B's
constexpr int kWgSmemBytes = kWgStages * kWgStageBytes + 1024;  // + the 1024-byte alignment
constexpr int kWgThreads = wg::kConsumers + 32;      // two warpgroups and the producer warp

// A kernel argument (__grid_constant__: the tensor maps stay in parameter
// space, where the copy engine reads them).
struct WgArgs {
  CUtensorMap ta, tb;  // A's and B's boxes as 3-D tiled maps; read if tma
  const bf16* a;
  const bf16* b;
  void* c;
  int batch, m, n, k;
  long long sab, lda, sbb, ldb;
  float alpha;
  int tma_a, tma_b;  // the operand's stages arrive by TMA; by the producer warp's copies otherwise
};

template <typename TO>
__global__ void __launch_bounds__(kWgThreads, 2)
    gemm_tn_wgmma_kernel(const __grid_constant__ WgArgs g) {
  constexpr int S = kWgStages;
  extern __shared__ unsigned char wg_smem[];
  // full: a stage's copies landed; empty: both warpgroups' wgmma on it finished
  __shared__ __align__(8) unsigned long long full[S], empty[S];
  const int tid = threadIdx.x;
  // a stage completes on the TMA bytes (one arrival, where an operand
  // arrives by TMA) and on the producer warp's copies (32 arrivals, where
  // one does not)
  const bool tmas = g.tma_a || g.tma_b, fills = !g.tma_a || !g.tma_b;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(&full[s], (tmas ? 1 : 0) + (fills ? 32 : 0));
      wg::mbar_init(&empty[s], wg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned char* ring = wg::align1024(wg_smem);
  const int r0 = blockIdx.y * wg::kTileM;  // rows of C = columns of A
  const int c0 = blockIdx.x * wg::kTileN;  // columns of C = columns of B
  const int stages = (g.m + kWgRows - 1) / kWgRows;  // a batch entry's

  if (tid >= wg::kConsumers) {  // the producer warp
    const int lane = tid - wg::kConsumers;
    const int total = (g.batch - blockIdx.z + gridDim.z - 1) / gridDim.z * stages;
    for (int gi = 0; gi < total; ++gi) {
      const int slot = gi % S;
      if (gi >= S) wg::mbar_wait(&empty[slot], (gi / S - 1) & 1);
      const int e = gi / stages, l0 = (gi - e * stages) * kWgRows;
      const int bt = blockIdx.z + e * gridDim.z;
      unsigned char* xs = ring + slot * kWgStageBytes;
      unsigned char* ys = xs + kWgSide;
      if (tmas && lane == 0) {
        wg::mbar_arrive_tx(&full[slot], (g.tma_a ? kWgSide : 0) + (g.tma_b ? kWgSide : 0));
        if (g.tma_a) {
          wg::tma_load(xs, &g.ta, r0, l0, bt, &full[slot]);
          wg::tma_load(xs + kWgSide / 2, &g.ta, r0 + wg::kBox, l0, bt, &full[slot]);
        }
        if (g.tma_b) {
          wg::tma_load(ys, &g.tb, c0, l0, bt, &full[slot]);
          wg::tma_load(ys + kWgSide / 2, &g.tb, c0 + wg::kBox, l0, bt, &full[slot]);
        }
      }
      if (fills) {
        if (!g.tma_a)
          wg::fill_side<kWgRows>(xs, g.a + bt * g.sab, g.lda, r0, g.n, l0, g.m, lane, gi < S);
        if (!g.tma_b)
          wg::fill_side<kWgRows>(ys, g.b + bt * g.sbb, g.ldb, c0, g.k, l0, g.m, lane, gi < S);
        wg::fence_async_cta();
        wg::mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  const int wgi = tid / 128;
  const int steps = (g.m + wg::kStep - 1) / wg::kStep;  // k16 steps of an entry
  unsigned gs = 0;                                      // stages consumed so far
  for (int bt = blockIdx.z; bt < g.batch; bt += gridDim.z) {
    float acc[wg::kAcc];
    wg::zero(acc);
    int held = -1;  // the slot whose wgmma may still run
    for (int s = 0; s < stages; ++s, ++gs) {
      const int slot = gs % S;
      wg::mbar_wait(&full[slot], (gs / S) & 1);
      const unsigned xs = wg::smem_u32(ring + slot * kWgStageBytes);
      const int n16 = min(kWgRows / wg::kStep, steps - s * (kWgRows / wg::kStep));
      wg::hold(acc);
      wg::fence();
      wg::mma_stage(acc, xs, xs + kWgSide, kWgRows, wgi, n16);
      wg::commit();
      wg::wait<1>();  // the stage before this one is read
      wg::hold(acc);
      if (held >= 0) wg::mbar_arrive(&empty[held]);
      held = slot;
    }
    wg::wait<0>();
    wg::hold(acc);
    wg::mbar_arrive(&empty[held]);
    wg::store_tile(static_cast<TO*>(g.c) + (long long)bt * g.n * g.k, acc, r0 + 64 * wgi, c0,
                   g.n, g.k, g.alpha);
  }
}

template <typename TO>
static cudaError_t wg_opt_in() {
  static bool done[kMaxDevices] = {};
  return tn_opt_in(reinterpret_cast<const void*>(gemm_tn_wgmma_kernel<TO>), kWgSmemBytes, done);
}

template <typename TO>
static int launch_wgmma(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                        long long sab, long long lda, long long sbb, long long ldb, float alpha,
                        int vec16, cudaStream_t stream) {
  cudaError_t err = wg_opt_in<TO>();
  if (err != cudaSuccess) return static_cast<int>(err);
  WgArgs g;
  g.a = static_cast<const bf16*>(a), g.b = static_cast<const bf16*>(b), g.c = c;
  g.batch = batch, g.m = m, g.n = n, g.k = k;
  g.sab = sab, g.lda = lda, g.sbb = sbb, g.ldb = ldb;
  g.alpha = alpha;
  g.tma_a = (vec16 & 1) && wg::encode_swizzled(&g.ta, a, n, m, batch, lda, sab, kWgRows);
  g.tma_b = (vec16 & 2) && wg::encode_swizzled(&g.tb, b, k, m, batch, ldb, sbb, kWgRows);
  const dim3 grid((k + wg::kTileN - 1) / wg::kTileN, (n + wg::kTileM - 1) / wg::kTileM,
                  batch < 65535 ? batch : 65535);
  void* args[] = {&g};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(gemm_tn_wgmma_kernel<TO>), grid,
                         dim3(kWgThreads), args, kWgSmemBytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// vec16: bit 0 for A, bit 1 for B: the operand's base is 16 B aligned and
// its row and batch strides are multiples of 16 bytes (the wrapper
// decides). float32 takes the 16 B copies (engine) and tensor copies
// (narrow kernel) where both are; bfloat16 takes TMA for each operand that
// is. dtypes: bit 0 bfloat16 operands, bit 1 bfloat16 output (dtype.cuh).
// kernel: the wrapper's choice, 0 the tile engine, 1 the narrow kernel, 2
// the tensor-core kernel; bfloat16 operands take only 2, float32 ones 0, or
// 1 for k <= kNarrowMaxK; anything else returns cudaErrorInvalidValue.
extern "C" int gemm_tn_f32(const void* a, const void* b, void* c, int batch, int m, int n,
                           int k, long long sab, long long lda, long long sbb, long long ldb,
                           float alpha, int vec16, int dtypes, int kernel, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool load_bf16 = dtypes & kLoadBf16, store_bf16 = dtypes & kStoreBf16;
  if (load_bf16 != (kernel == kTnWgmma) || kernel < kTnTile || kernel > kTnWgmma ||
      (kernel == kTnNarrow && k > kNarrowMaxK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == kTnWgmma)
    return store_bf16
               ? launch_wgmma<bf16>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16, s)
               : launch_wgmma<float>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16, s);
  if (kernel == kTnNarrow)
    return store_bf16 ? tn_narrow_launch<float, bf16>(a, b, c, batch, m, n, k, sab, lda, sbb,
                                                      ldb, alpha, vec16 == 3, s)
                      : tn_narrow_launch<float, float>(a, b, c, batch, m, n, k, sab, lda, sbb,
                                                       ldb, alpha, vec16 == 3, s);
  return store_bf16
             ? launch<bf16>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16 == 3, s)
             : launch<float>(a, b, c, batch, m, n, k, sab, lda, sbb, ldb, alpha, vec16 == 3, s);
}

// out: the bfloat16 kernel's resources (float32 output): registers,
// static shared bytes, dynamic shared bytes, local (spill) bytes, resident
// CTAs per SM, ring stages, rows a stage, threads; 8 ints.
extern "C" int gemm_tn_wgmma_info(int* out) {
  using namespace repro_torch;
  cudaError_t err = wg_opt_in<float>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel = reinterpret_cast<const void*>(gemm_tn_wgmma_kernel<float>);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWgThreads, kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = kWgSmemBytes;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  out[5] = kWgStages;
  out[6] = kWgRows;
  out[7] = kWgThreads;
  return 0;
}

// out: the tn_info fields of the float32 16 B (vec16 = 1) or 4 B instance; 7 ints.
extern "C" int gemm_tn_info(int vec16, int* out) {
  using namespace repro_torch;
  cudaError_t err = vec16 ? opt_in<float, float, true>() : opt_in<float, float, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tn_info(vec16 ? reinterpret_cast<const void*>(gemm_tn_kernel<float, float, true>)
                    : reinterpret_cast<const void*>(gemm_tn_kernel<float, float, false>),
              out));
}
