#!/usr/bin/env python3
"""Time gemm_tn_fused's shapes on the card, one ATA level per slot count.

    PYTHONPATH=src python3 tools/fused_shapes.py [bf16 [ablate]]

The kernels (``src/repro_torch/csrc/gemm_tn_fused.cu``) are templates over
the slot count W, the cluster edge C (1: no cluster) and the stage depth R
(depth-8 slabs for float32 slot blocks, k16 steps for bfloat16 ones); the
library launches one shape per W (``Shape<W>`` there). This script builds a
second library from the same source that instantiates the other shapes,
runs each on the launch of ata 8192² whose slot count it serves (level
4 - log2 W, the root grid (16,16,512,512)), float32 or, with ``bf16``,
bfloat16, checks it bitwise against gemm_tn on that level's materialized
combined operands, and prints the median CUDA-event time of each beside
gemm_tn's and the shipped launch's (and the host time of the shipped call
alone, which the CUDA events of a lone launch include). Shapes whose shared
memory does not fit one CTA are left out. It needs an NVIDIA Hopper card
and nvcc; the build goes to ``build/kernels/shapes/``.

``bf16 ablate`` times the shipped bfloat16 shape at W = 8 (ata 8192²
level 1) instead, beside builds of the same source with one part taken out
(``ABLATIONS``: the raw slot copies, the slot tree, the stores into the
partners' shared memory, the wgmma, the cluster barrier of each stage, or
all but the barrier), each a wrong product: what each part costs, timed in
turns (every build, then the same in reverse order).
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

# (cluster edge C, stage depth R); C = 1 launches no cluster
SHAPES = {"float32": [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2)],
          "bf16": [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 1), (4, 2), (4, 4)]}
SLOTS = (1, 2, 4, 8)

# ablation name -> (text of csrc/gemm_tn_fused.cu, its replacement), applied
# to a copy of the sources; the barrier ablation ends the kernel with one
# cluster barrier so no CTA exits while a partner still writes into it
_COPY = ("copy_quad(d + w * P::kRows * P::kCols, s_base[q.side][w] + roff, avail, vec16);", ";")
_TREE = ("const Part t = slot_tree<W, bf16, true>(src, P::kRows * P::kCols, s_sgn[q.side], 0);",
         "const Part t{make_float4(1.f, 1.f, 1.f, 1.f), true};")
_REMOTE = ("rank == cluster.block_rank() ? local : cluster.map_shared_rank(local, rank);", "local;")
_MMA = ("wg::mma_stage(acc, xs, xs + P::kSideBytes, P::kRows, wgi, n16);", ";")
_BARRIER = [("        cluster_wait();\n        const unsigned prev", "        const unsigned prev"),
            ("      if (s < stages) cluster_arrive();", "      ;"),
            ("    // of its last stage above, which every thread of this CTA passed after\n"
             "    // its last read of them.\n  }\n}", "  }\n  cluster_arrive();\n  cluster_wait();\n}")]
ABLATIONS = {"shipped": [], "no_copies": [_COPY], "no_tree": [_TREE], "no_remote": [_REMOTE],
             "no_wgmma": [_MMA], "no_barrier": _BARRIER,
             "barrier_only": [_COPY, _TREE, _REMOTE, _MMA]}


def fits(dtype: str, w: int, c: int, r: int) -> bool:
    """Whether one ring stage fits a CTA (the Plan/WgPlan static_assert)."""
    if dtype == "float32":
        rows, bufs = 8 * r, 2 * (2 * 8 * r * 128 * 4) if c == 1 else 3 * (2 * 8 * r * 128 * 4)
        return w * 2 * rows * (128 // c) * 4 + bufs <= 220 * 1024
    rows = 16 * r
    bufs = 3 * 2 * (2 * rows * 64 * 2)
    return 1024 + bufs + 2 * w * rows * (128 // c) * 2 <= 220 * 1024


def build(_build, dtype: str):
    out_dir = os.path.join(ROOT, "build", "kernels", "shapes")
    os.makedirs(out_dir, exist_ok=True)
    inst = "f32_instance" if dtype == "float32" else "bf16_instance"
    src = os.path.join(out_dir, f"shapes_{dtype}.cu")
    with open(src, "w") as f:
        f.write(f'''#include "gemm_tn_fused.cu"
extern "C" int shape_launch(int w, int v, const void* a, const void* b, const long long* off,
                            const int* sgn, void* c, int leaves, int m, int n, int k,
                            long long lda, long long ldb, int vec16, void* stream) {{
  using namespace repro_torch::fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
''')
        for w in SLOTS:
            for v, (c, r) in enumerate(SHAPES[dtype]):
                if fits(dtype, w, c, r):
                    f.write(f"  if (w == {w} && v == {v}) return launch({inst}<{w}, {c}, {r}>(), s, "
                            "a, b, off, sgn, c, leaves, 1, m, n, k, 0, lda, 0, ldb, 1.0f, vec16, "
                            "false);\n")
        f.write("  return -1;\n}\n")
    lib = os.path.join(out_dir, f"libshapes_{dtype}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), src,
                    "-o", lib], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).shape_launch
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, I, P, P, P, P, P, I, I, I, I, LL, LL, I, P]
    fn.restype = ctypes.c_int
    return fn


def build_ablations(_build):
    """One library a part taken out, each exporting ``ablation_launch``:
    the shipped bfloat16 shape at W = 8 (``Shape<8>``). All nvcc runs start
    together."""
    import shutil

    root = os.path.join(ROOT, "build", "kernels", "ablations")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        d = os.path.join(root, name)
        shutil.copytree(str(_build.CSRC), d)
        path = os.path.join(d, "gemm_tn_fused.cu")
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"ablation {name}: source text not found: {old[:60]!r}")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src + '''
extern "C" int ablation_launch(const void* a, const void* b, const long long* off, const int* sgn,
                               void* c, int leaves, int m, int n, int k, long long lda,
                               long long ldb, int vec16, void* stream) {
  using namespace repro_torch::fused;
  return launch(bf16_instance<8, Shape<8>::C16, Shape<8>::R16>(),
                static_cast<cudaStream_t>(stream), a, b, off, sgn, c, leaves, 1, m, n, k, 0, lda,
                0, ldb, 1.0f, vec16, false);
}
''')
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", d, path, "-o",
             os.path.join(d, "lib.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} failed to build:\n{out[-3000:]}")
        fn = ctypes.CDLL(os.path.join(root, name, "lib.so")).ablation_launch
        fn.argtypes = [P, P, P, P, P, I, I, I, I, LL, LL, I, P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ablate(_build, ab, tables) -> dict:
    import torch

    from repro_torch.kernels.gemm_tn import _fused_tables, fused_launch_tables

    fns = build_ablations(_build)
    sides, T, W = _fused_tables(ab, ab, tables)
    off, sgn, ld, _, vec16 = fused_launch_tables(ab, ab, sides, T, W)
    off, sgn = torch.as_tensor(off, device="cuda"), torch.as_tensor(sgn, device="cuda")
    c = torch.empty(T, 512, 512, device="cuda")
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            def run(fn=fns[name]):
                return fn(ab.data_ptr(), ab.data_ptr(), off.data_ptr(), sgn.data_ptr(),
                          c.data_ptr(), T, 512, 512, 512, ld[0], ld[1], int(vec16),
                          torch.cuda.current_stream().cuda_stream)
            _build.check(run(), f"ablation {name}")
            times[name].append(time_ms(run))
    return {"level": 1, "leaves": T, "W": W, **{k: statistics.median(v) for k, v in times.items()}}


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


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_shapes: needs an NVIDIA card", file=sys.stderr)
        return 2
    if argv not in ([], ["bf16"], ["bf16", "ablate"]):
        print("fused_shapes: the only arguments are 'bf16' and 'bf16 ablate'", file=sys.stderr)
        return 2
    dtype = "bf16" if argv else "float32"
    from repro_torch.core.ata import _level_tables
    from repro_torch.core.strassen import _to_blocks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gemm_tn import (_fused_tables, combine_fused_operands,
                                             fused_launch_tables)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if argv == ["bf16", "ablate"]:
        rng = np.random.default_rng(0)
        a = torch.as_tensor(rng.standard_normal((8192, 8192), dtype="float32"),
                            device="cuda").bfloat16()
        print(json.dumps(ablate(_build, _to_blocks(a, 4)[None], _level_tables(4, 1))), flush=True)
        return 0
    shape_launch = build(_build, dtype)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((8192, 8192), dtype="float32"), device="cuda")
    if dtype == "bf16":
        a = a.bfloat16()
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
        row = {"dtype": dtype, "level": lev, "leaves": T, "W": W,
               "gemm_tn_ms": time_ms(lambda: ops.gemm_tn(xa, xb)),
               "shipped_ms": time_ms(lambda: ops.gemm_tn_fused(ab, ab, tables)),
               "shipped_host_ms": host_ms(lambda: ops.gemm_tn_fused(ab, ab, tables))}
        for v, shape in enumerate(SHAPES[dtype]):
            if not fits(dtype, W, *shape):
                continue

            def run():
                return shape_launch(W, v, ab.data_ptr(), ab.data_ptr(), off.data_ptr(),
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
    sys.exit(main(sys.argv[1:]))
