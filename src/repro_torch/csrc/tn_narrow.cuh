// The narrow-output TN kernel of gemm_tn (tn_narrow.cu): what gemm_tn.cu's
// launch needs to pick it.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// The widest B (columns) the narrow kernel takes. gemm_tn's wrapper runs it
// for every float32 k up to this and the 128 x 128 tile engine above: at
// (m, n) = (16384, 4096) the narrow kernel was the faster one at every k up
// to 64 (tools/kernel_variants.py narrow, PERF.md).
constexpr int kNarrowMaxK = 64;

// gemm_tn_f32's kernel argument (kernels/gemm_tn.py TN_KERNELS).
constexpr int kTnTile = 0, kTnNarrow = 1, kTnWgmma = 2;

// Launches the narrow kernel on C = alpha * A^T B (gemm_tn_f32's
// arguments); defined in tn_narrow.cu for float32 operands (T = float) and
// either output type of dtype.cuh. vec16: every base 16-byte aligned and every stride a multiple
// of 16 bytes, so A's strip arrives by tensor copies and B's by pairs.
template <typename T, typename TO>
int tn_narrow_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                     long long sab, long long lda, long long sbb, long long ldb, float alpha,
                     int vec16, cudaStream_t stream);

}  // namespace repro_torch
