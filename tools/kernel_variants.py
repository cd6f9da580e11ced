#!/usr/bin/env python3
"""Time variants of the gemm_tn tile engine and ablations of the trsm kernel.

    PYTHONPATH=src python3 tools/kernel_variants.py

The tile engine (``src/repro_torch/csrc/tn_tile.cuh``) fixes its copy ring
at compile time: ``kStages`` stages of ``kSlab`` rows. This script copies
the port's kernel sources into ``build/kernels/variants/<name>/``, rewrites
those two constants, builds each copy into a library of its own (all
``nvcc`` runs started together), checks every ring shape bitwise against
the shipped one on the ata 8192² leaf stack (1430, 512, 512)², and prints
median CUDA-event times taken in turns (every shape, ``torch.bmm``, then
the same in reverse order). Every shape runs the same fmaf chain, so all
must agree bitwise. One ablation of the engine, timed beside them, reads
X's fragment once for two depth steps (a wrong product): how its time
follows the loop's shared-memory reads.

For ``csrc/trsm.cu`` it builds ablations that each leave one part of the
kernel out (everything but the launch, the chain with its trailing update,
the trailing update, or the division, replaced by a multiplication), and a
variant in which every
lane divides every row of its warp instead of one row a lane, and prints
their device times
(CUDA graphs of 50 launches) at the Cholesky panel (31,128,128) against an
expanded factor and at the r = 8 substitution panel. An ablation computes
a wrong answer; only its time is read.

It needs an NVIDIA Hopper card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SLAB, STAGES = "constexpr int kSlab = 32;", "constexpr int kStages = 3;"
# name -> (rows a stage, stages); the first is the shipped shape
SHAPES = {"32x3": (32, 3), "32x2": (32, 2), "16x4": (16, 4), "16x3": (16, 3), "8x4": (8, 4)}
# name -> textual edit of tn_tile.cuh timed beside the shapes but not held
# bitwise: it reads X's fragment once for two depth steps (a wrong product),
# to see how the loop's time follows its shared-memory reads
ENGINE_ABLATIONS = {
    "half_x_reads": ("const float* xr = xs + kk * kTile",
                     "const float* xr = xs + (kk & ~1) * kTile"),
}
# name -> textual edits of trsm.cu; the first is the shipped kernel
TRSM = {
    "full": [],
    "launch_only": [("for (int bt = blockIdx.y; bt < batch; bt += gridDim.y) {",
                     "for (int bt = blockIdx.y; bt < 0; bt += gridDim.y) {")],
    "no_chain": [("for (int j = 0; j < kPanel; ++j) {\n        float lvn",
                  "for (int j = 0; j < 0; ++j) {\n        float lvn")],
    "no_trailing": [("later[p] = p > P && p < np;", "later[p] = false;")],
    "multiply_for_divide": [(" / d;", " * d;")],
    "divide_every_row": [("if constexpr (R == 1) {", "if constexpr (true) {")],
}


def sources(name, edits):
    from repro_torch.kernels import _build

    out = os.path.join(ROOT, "build", "kernels", "variants", name)
    os.makedirs(out, exist_ok=True)
    for f in ("tn_tile.cuh", "gemm_tn.cu", "trsm.cu"):
        text = (_build.CSRC / f).read_text()
        for old, new in edits.get(f, ()):
            if old not in text:
                raise RuntimeError(f"{f} no longer contains {old!r}: update this script")
            text = text.replace(old, new)
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.potrf import potrf_plain

    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    jobs = {}
    for name, (slab, stages) in SHAPES.items():
        d = sources("tn_" + name, {"tn_tile.cuh": [
            (SLAB, f"constexpr int kSlab = {slab};"),
            (STAGES, f"constexpr int kStages = {stages};")]})
        jobs[("tn", name)] = (d, "gemm_tn.cu")
    for name, edit in ENGINE_ABLATIONS.items():
        jobs[("tn", name)] = (sources("tn_" + name, {"tn_tile.cuh": [edit]}), "gemm_tn.cu")
    for name, edits in TRSM.items():
        jobs[("trsm", name)] = (sources("trsm_" + name, {"trsm.cu": edits}), "trsm.cu")
    procs = {key: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", d, os.path.join(d, src), "-o",
         os.path.join(d, "lib.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (d, src) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed on {key}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"{key[0]} {key[1]}: {regs}", flush=True)
        libs[key] = ctypes.CDLL(os.path.join(jobs[key][0], "lib.so"))

    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    rng = np.random.default_rng(0)
    a = cs.cuda_tensor(rng, (1430, 512, 512))
    b = cs.cuda_tensor(rng, (1430, 512, 512))
    c = torch.empty_like(a)
    runs, want = {}, None
    for name in (*SHAPES, *ENGINE_ABLATIONS):
        fn = libs[("tn", name)].gemm_tn_f32
        fn.argtypes = [P, P, P, I, I, I, I, LL, LL, LL, LL, F, I, P]

        def run(fn=fn):
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1430, 512, 512, 512, 512 * 512, 512,
                     512 * 512, 512, 1.0, 1, torch.cuda.current_stream().cuda_stream)
            _build.check(err, "gemm_tn variant")
        run()
        torch.cuda.synchronize()
        want = c.clone() if want is None else want
        if name in SHAPES and not torch.equal(c, want):
            raise AssertionError(f"ring shape {name} differs from {next(iter(SHAPES))}")
        runs[name] = run
    print("every ring shape bitwise equal to the shipped one", flush=True)
    del want
    runs["torch.bmm"] = lambda: torch.bmm(a.transpose(1, 2), b)
    times = {}
    for name in list(runs) + list(runs)[::-1]:
        times.setdefault(name, []).append(cs.time_ms(runs[name]))
    print("gemm_tn (1430,512,512)² ms, in turns: " + json.dumps(times), flush=True)
    del a, b, c
    torch.cuda.empty_cache()

    l1 = potrf_plain(cs.spd_tiles(rng, 1, 128)[0])
    lx = l1.expand(31, 128, 128)
    p = cs.cuda_tensor(rng, (31, 128, 128))
    r8 = cs.cuda_tensor(rng, (8, 128))
    xp, x8 = torch.empty_like(p), torch.empty_like(r8)
    cases = {}
    for name in TRSM:
        fn = libs[("trsm", name)].trsm_f32
        fn.argtypes = [P, P, P, I, I, I, LL, I, P]
        cases[name] = (
            lambda fn=fn: fn(lx.data_ptr(), p.data_ptr(), xp.data_ptr(), 31, 128, 128, 0, 1,
                             torch.cuda.current_stream().cuda_stream),
            lambda fn=fn: fn(l1.data_ptr(), r8.data_ptr(), x8.data_ptr(), 1, 8, 128, 0, 0,
                             torch.cuda.current_stream().cuda_stream))
    ttimes = {}
    for name in list(cases) + list(cases)[::-1]:
        panel, rows8 = cases[name]
        ttimes.setdefault(name, []).append([cs.graph_ms(panel), cs.graph_ms(rows8)])
    print("trsm device ms [panel (31,128,128), r = 8], in turns: " + json.dumps(ttimes),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
