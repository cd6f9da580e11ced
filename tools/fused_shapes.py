#!/usr/bin/env python3
"""Time gemm_tn_fused's shapes on the card, one ATA level per slot count.

    PYTHONPATH=src python3 tools/fused_shapes.py

The kernel (``src/repro_torch/csrc/gemm_tn_fused.cu``) is a template over
the slot count W, the cluster edge C (1: no cluster) and the depth-8 slabs
a stage R; the library launches one shape per W (``Shape<W>`` there). This
script builds a second library from the same source that instantiates the
other shapes, runs each
on the launch of ata 8192² whose slot count it serves (level 4 - log2 W, the
root grid (16,16,512,512)), checks it bitwise against gemm_tn on that level's
materialized combined operands, and prints the median CUDA-event time of
each beside gemm_tn's and the shipped launch's (and the host time of the
shipped call alone, which the CUDA events of a lone launch include). It needs an NVIDIA Hopper
card and nvcc; the build goes to ``build/kernels/shapes/``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# (cluster edge C, depth-8 slabs a stage R); C = 1 launches no cluster
SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2)]
SLOTS = (1, 2, 4, 8)


def build(_build):
    out_dir = os.path.join(ROOT, "build", "kernels", "shapes")
    os.makedirs(out_dir, exist_ok=True)
    cases = " ".join(f"V({i}, {c}, {r})" for i, (c, r) in enumerate(SHAPES))
    src = os.path.join(out_dir, "shapes.cu")
    with open(src, "w") as f:
        f.write(f'''#include "gemm_tn_fused.cu"
#define SHAPES(V) {cases}
extern "C" int shape_f32(int w, int v, const float* a, const float* b, const long long* off,
                         const int* sgn, float* c, int leaves, int m, int n, int k,
                         long long lda, long long ldb, int vec16, void* stream) {{
  using repro_torch::fused::launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define L(ID, C, R) \\
  if (v == ID) return launch<float, WW, C, R>(s, a, b, off, sgn, c, leaves, 1, m, n, k, 0, lda, \\
                                              0, ldb, 1.0f, vec16);
''')
        for w in SLOTS:
            f.write(f"  if (w == {w}) {{\n#define WW {w}\n    SHAPES(L)\n#undef WW\n  }}\n")
        f.write("  return 1;\n}\n")
    lib = os.path.join(out_dir, "libshapes.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), src,
                    "-o", lib], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).shape_f32
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, I, P, P, P, P, P, I, I, I, I, LL, LL, I, P]
    fn.restype = ctypes.c_int
    return fn


def time_ms(fn, runs: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, runs: int = 5) -> float:
    """Median host time of one call that only enqueues work (no sync)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_shapes: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.core.ata import _level_tables
    from repro_torch.core.strassen import _to_blocks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gemm_tn import (_fused_tables, combine_fused_operands,
                                             fused_launch_tables)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    shape_f32 = build(_build)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((8192, 8192), dtype="float32"), device="cuda")
    ab = _to_blocks(a, 4)[None]
    for w in SLOTS:
        lev = 4 - int(np.log2(w))
        tables = _level_tables(4, lev)
        sides, T, W = _fused_tables(ab, ab, tables)
        off, sgn, ld, _, vec16 = fused_launch_tables(ab, ab, sides, T, W)
        off, sgn = torch.as_tensor(off, device="cuda"), torch.as_tensor(sgn, device="cuda")
        xa, xb = (combine_fused_operands(ab, *t) for t in tables)
        want = ops.gemm_tn(xa, xb)
        c = torch.empty_like(want)
        row = {"level": lev, "leaves": T, "W": W,
               "gemm_tn_ms": time_ms(lambda: ops.gemm_tn(xa, xb)),
               "shipped_ms": time_ms(lambda: ops.gemm_tn_fused(ab, ab, tables)),
               "shipped_host_ms": host_ms(lambda: ops.gemm_tn_fused(ab, ab, tables))}
        for v, shape in enumerate(SHAPES):
            def run():
                return shape_f32(W, v, ab.data_ptr(), ab.data_ptr(), off.data_ptr(),
                                 sgn.data_ptr(), c.data_ptr(), T, 512, 512, 512, ld[0], ld[1],
                                 int(vec16), torch.cuda.current_stream().cuda_stream)
            c.zero_()
            _build.check(run(), f"shape {shape}")
            if not torch.equal(c, want):
                raise AssertionError(f"W={W} shape {shape} != gemm_tn on the combined operands")
            row["C=%d R=%d" % shape] = time_ms(run)
        print(json.dumps(row), flush=True)
        del xa, xb, want, c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
