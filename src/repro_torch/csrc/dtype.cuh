// Element types of the port's kernels: operands are loaded as float32 or
// bfloat16, every sum is taken in float32, and the output is stored as
// float32 or bfloat16 (rounded to nearest even), as the wrapper's out_dtype
// says. This is what the reference's Pallas kernels compute: bfloat16
// operands with float32 accumulation (tests/test_kernels.py DTYPES), potrf
// and trsm casting any input to float32 and storing out_dtype
// (src/repro/kernels/potrf.py, src/repro/kernels/trsm.py).
//
// The load type chooses the kernel or instance (it sits in the hot loop):
// bfloat16 operands of gemm_tn, gemm_tn_fused, syrk and syrk_gather run the
// tensor-core kernels (tn_wgmma.cuh), float32 ones the FMA kernels; potrf
// and trsm take it as a template parameter. The store type is a template
// parameter in gemm_tn and syrk, whose float32 epilogues ran measurably
// slower on the H100 with a run-time flag (a branch on every store keeps
// the loads of a warp's blocks from being in flight together; development
// runs, PERF.md); gemm_tn_fused branches once
// per tile on a run-time flag, potrf and trsm once per output (two
// instances a shape, not four). Either way the (load, store)
// pairs {float32, bfloat16}^2 all run, and nothing else is instantiated.
//
// The dtypes argument of every C entry point: bit 0 set = operands are
// bfloat16, bit 1 set = the output is bfloat16 (repro_torch.backend.
// kernel_dtypes builds it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

using bf16 = __nv_bfloat16;

constexpr int kLoadBf16 = 1;
constexpr int kStoreBf16 = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Four consecutive elements as float32: one 16-byte load (float32) or one
// 8-byte load (bfloat16); p is aligned to that size. A bfloat16 is the high
// half of its float32, so the conversion is one integer op per element and
// exact.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// Stores v at p, rounded to the output's type.
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stores v[0..4) at p..p+3: one 16-byte (float32) or 8-byte (bfloat16)
// store, which needs p aligned to that size.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&lo);
  w.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// Stores v at element e of a float32 (bf16_out false) or bfloat16 output:
// the run-time form.
__device__ __forceinline__ void store1(void* out, long long e, float v, bool bf16_out) {
  if (bf16_out) {
    store1(static_cast<bf16*>(out) + e, v);
  } else {
    store1(static_cast<float*>(out) + e, v);
  }
}

// Bytes of one output element.
__host__ __device__ __forceinline__ int out_bytes(int dtypes) {
  return (dtypes & kStoreBf16) ? 2 : 4;
}

}  // namespace repro_torch
