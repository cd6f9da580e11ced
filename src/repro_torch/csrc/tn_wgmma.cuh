// Shared Hopper tensor-core main loop of gemm_tn, gemm_tn_fused, syrk and
// syrk_gather on bfloat16 operands: C = alpha * X^T Y summed in float32 by
// wgmma.
//
// Replaces the bfloat16 case of the inner loop of gemm_tn_pallas and
// gemm_tn_fused_pallas (src/repro/kernels/gemm_tn.py:54-58 and :184-188)
// and of syrk_pallas and syrk_gather_pallas (src/repro/kernels/syrk.py:
// 92-97): dot_general of bfloat16 blocks with preferred_element_type=
// float32, which the TPU runs on its matrix unit. The float32 operands keep
// the FMA tile engine of tn_tile.cuh (and tn_narrow.cu): TF32 would change
// the rounding of every float32 leaf, and the tensor cores take float32
// only as TF32.
//
// What bounds it on the H100: bytes. A Strassen leaf stack (1430 leaves of
// 512^3) is 3.84e11 flops, 0.388 ms at the 989 TFLOP/s of bfloat16 on the
// tensor cores, against 1.5 GB read and 1.5 GB of float32 written, 0.895
// ms at 3.35 TB/s. The FMA engine converted each bfloat16 element on the
// read and ran at 9% of that bound (PERF.md). syrk's diagonal leaves are
// the same case: (256, 512, 512) is 0.04 ms of lower-tile flops against
// 0.12 ms of bytes, the float32 output twice the input; syrk.cu stages
// each tile's partial and writes it with its mirror (its header says what
// bounds that and what the kernel does about it).
//
// The design, shared by both kernels:
// * A CTA makes a 128 x 128 float32 tile of X^T Y: C rows [r0, r0 + 128)
//   (columns of X) and C columns [c0, c0 + 128) (columns of Y). Two
//   consumer warpgroups each own 64 rows and issue
//   wgmma.mma_async.m64n128k16.f32.bf16.bf16 with both operands in shared
//   memory, 64 float32 accumulators a thread. Every k uses this one shape
//   (kTileN columns, zero past k), so the two kernels never differ in it.
// * The TN layout: a stage holds rows l of X and Y with their columns
//   contiguous, which for wgmma is the MN-major form of both operands
//   (imm-trans-a = imm-trans-b = 1, allowed for bfloat16; TF32 has no
//   transpose). So no transposed copy is made: each side of a stage is two
//   boxes of 64 columns (128 bytes a row) by `rows` rows in the 128-byte
//   swizzle, the layout a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes
//   and the one the descriptors below describe (leading byte offset: the
//   box pitch, rows * 128; stride byte offset: 1024, eight rows).
// * Summation order, the contract every caller relies on: the k16 steps
//   over rows 0, 16, 32, ... in ascending order, ceil(m / 16) of them, rows
//   at or past m being zeros, each one instruction on the same 64 x 16 and
//   16 x 128 operand slices; the accumulators start at +0 and every step
//   adds (scale-d = 1). How rows are grouped into stages does not enter, so
//   a batch entry equals its single launch, and gemm_tn_fused (whose stages
//   hold 16 R rows) equals gemm_tn (64 rows) on the same combined operands.
// * gemm_tn's epilogue stores alpha * acc, rounded once to the output
//   type, straight from the registers (two neighbouring columns a thread:
//   8-byte float32 or 4-byte bfloat16 stores where k is even); syrk's
//   stages it in shared memory for its dual write.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace repro_torch {
namespace wg {

constexpr int kTileM = 128;    // C rows a CTA: two warpgroups of 64
constexpr int kTileN = 128;    // C columns a CTA: the instruction's width, for every k
constexpr int kStep = 16;      // rows one instruction sums
constexpr int kBox = 64;       // columns of one swizzled box: 128 bytes of bfloat16
constexpr int kConsumers = 256;
constexpr int kAcc = 64;       // float32 accumulators a thread
// a lost mbarrier arrival traps (a launch error) instead of hanging the card
constexpr long long kHangCycles = 1LL << 34;

// Bytes of one side (X or Y) of a stage of `rows` rows: two boxes.
__host__ __device__ constexpr int side_bytes(int rows) { return 2 * rows * kBox * 2; }

// Byte offset of element (r, col) of one side of a stage of `rows` rows,
// col in [0, 128): box col / 64, row r of it, its 16-byte chunk XOR r % 8.
__device__ __forceinline__ int swizzled(int rows, int r, int col) {
  return (col >> 6) * rows * 128 + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) +
         ((col & 7) << 1);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 1024-byte boundary at or after p: the swizzle is a function of the
// address, so every box starts on one.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A shared-memory matrix descriptor of an MN-major operand in the 128-byte
// swizzle: start address, leading byte offset (between 64-column boxes),
// stride byte offset 1024 (between groups of eight rows), all >> 4.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned box_pitch) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(box_pitch >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across a wgmma fence or wait.
__device__ __forceinline__ void hold(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += X^T Y over one k16 step: X (16 rows x 64 columns) at da, Y (16 rows
// x 128 columns) at db, both MN-major.
__device__ __forceinline__ void mma(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void zero(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.0f;
}

// Issues (does not wait for) `steps` k16 steps of one stage of `rows` rows
// for the calling warpgroup: xs and ys are the shared addresses of the
// stage's X and Y sides, wgi the warpgroup (its 64 C rows are X's box wgi).
// The caller fenced (wgmma.fence) after its last access of d and commits.
__device__ __forceinline__ void mma_stage(float (&d)[kAcc], unsigned xs, unsigned ys, int rows,
                                          int wgi, int steps) {
  const unsigned pitch = static_cast<unsigned>(rows) * 128u;
  const unsigned xa = xs + static_cast<unsigned>(wgi) * pitch;
  for (int s = 0; s < steps; ++s) mma(d, desc(xa + s * 2048, pitch), desc(ys + s * 2048, pitch));
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Stores the calling warpgroup's 64 x 128 accumulators, alpha * d rounded
// to TO, into the n x k entry c: rows i0 + [0, 64), columns c0 + [0, 128),
// those below (n, k). Thread t of the warpgroup holds, for each group j of
// 8 columns, rows 16 (t / 32) + (t % 32) / 4 and 8 below it, columns
// 8 j + 2 (t % 4) and the one after (wgmma's accumulator layout).
template <typename TO>
__device__ __forceinline__ void store_tile(TO* c, const float (&d)[kAcc], int i0, int c0, int n,
                                           int k, float alpha) {
  const int t = threadIdx.x % 128;
  const int r = i0 + 16 * (t / 32) + (t % 32) / 4;
  const bool pairs = (k & 1) == 0;  // every pair 8-byte (4-byte) aligned
#pragma unroll
  for (int j8 = 0; j8 < kTileN / 8; ++j8) {
    const int j = c0 + 8 * j8 + 2 * (t % 4);
    if (j >= k) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r + 8 * h;
      if (i >= n) continue;
      const float v0 = alpha * d[4 * j8 + 2 * h], v1 = alpha * d[4 * j8 + 2 * h + 1];
      TO* p = c + (long long)i * k + j;
      if (pairs) {
        store2(p, v0, v1);
      } else {
        store1(p, v0);
        if (j + 1 < k) store1(p + 1, v1);
      }
    }
  }
}

// mbarriers of the gemm_tn ring (one producer, two consumer warpgroups).
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, int bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// Orders this thread's ordinary stores to shared memory, its CTA's
// (shared::cta) or its cluster's (shared::cluster), before later reads by
// the async proxy (wgmma), once a barrier hands them over. Scoped to shared
// memory: a fence over every state space also waited for the thread's
// copies from global memory in flight.
__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

// One box of a 3-D tiled map, at element (x, y, z), into shared memory; it
// completes on the barrier with the box's bytes (out-of-range elements land
// as zeros and count too).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// The same for a 5-D tiled map, at element (x, y, z, u, v).
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, int x, int y, int z,
                                          int u, int v, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(u), "r"(v),
      "r"(smem_u32(bar))
      : "memory");
}

// The producer warp's fill of one side of a stage of kRows rows where TMA
// cannot take the operand (a base or a stride that is not a multiple of 16
// bytes): rows l0 + [0, kRows) and columns col0 + [0, 128) of p (row stride
// ld), zero at or past (m, lim), in the swizzled layout TMA writes, 8
// elements (16 bytes) a store. Groups of 8 columns wholly at or past lim
// are zero in every stage, so they are stored only where `zeros` (the
// first fill of a ring slot since its memory last held anything else): B
// of 4 columns then costs one group a row. The caller fences the stores
// for the async proxy (fence_async_cta) before it hands the stage over.
template <int kRows>
__device__ __forceinline__ void fill_side(unsigned char* side, const bf16* p, long long ld,
                                          int col0, int lim, int l0, int m, int lane,
                                          bool zeros) {
  constexpr int kGroups = kTileN / 8;
  const int live = min(kGroups, max(0, (lim - col0 + 7) / 8));
  const int groups = zeros ? kGroups : live;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(p);
  for (int q = lane; q < kRows * groups; q += 32) {
    const int r = q / groups, col = (q % groups) * 8, l = l0 + r;
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = col0 + col + 2 * e;
      const bool row = l < m;
      const unsigned lo = (row && j < lim) ? src[(long long)l * ld + j] : 0u;
      const unsigned hi = (row && j + 1 < lim) ? src[(long long)l * ld + j + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(side + swizzled(kRows, r, col)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link
// to libcuda); null where libcuda has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D tiled map of a bfloat16 operand of `batch` entries of rows x cols
// (row stride ld, entry stride sb, in elements), boxes of 64 columns x
// box_rows rows in the 128-byte swizzle; false where the encoding refuses
// the layout.
inline bool encode_swizzled(CUtensorMap* map, const void* base, int cols, int rows, int batch,
                            long long ld, long long sb, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld * 2),
                                 static_cast<cuuint64_t>((batch > 1 ? sb : rows * ld) * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 5-D tiled map of a bfloat16 operand: dims[0] columns, dims[1] rows,
// then three outer dims (a batch, a block grid's columns and rows), and
// strides[i] the element stride of dims[i + 1]. An outer dim of extent 1
// is never stepped: its stride is replaced by the extent of the dims below
// it, rounded up to 16 bytes, so that it is a valid one. Boxes of 64
// columns x box_rows rows (one entry of each outer dim) in the 128-byte
// swizzle; false where the encoding refuses the layout.
inline bool encode_swizzled5(CUtensorMap* map, const void* base, const long long (&dims)[5],
                             const long long (&strides)[4], int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t d[5], s[4];
  for (int i = 0; i < 5; ++i) d[i] = static_cast<cuuint64_t>(dims[i]);
  long long stride = strides[0];
  s[0] = static_cast<cuuint64_t>(stride * 2);
  for (int i = 1; i < 4; ++i) {
    stride = dims[i + 1] > 1 ? strides[i] : (stride * dims[i] + 7) / 8 * 8;
    s[i] = static_cast<cuuint64_t>(stride * 2);
  }
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(box_rows), 1,
                             1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), d, s, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace repro_torch
