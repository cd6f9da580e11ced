#!/usr/bin/env python3
"""Time two checkouts of the port on one card: the unrolled leaf dispatch
(``--case dispatch``, the default) or the factor path of lstsq
(``--case solve``).

    python3 tools/compare_checkouts.py OTHER_CHECKOUT [--case dispatch|solve] [--pairs N]

OTHER_CHECKOUT is another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into the ignored ``build/``).
Each side runs in a fresh process from its own root, building its kernels
into its own ``build/kernels/``. The processes run in N pairs (default
10), alternating which side goes first: other, this; this, other; ...
With ``--case dispatch`` each process measures, on one NVIDIA card:

* ``ata(a, out="packed")`` at 8192² and ``strassen_tn`` at 4096³ under the
  unrolled dispatch with ``n_base=512`` pinned (one wrapper call and one
  launch per leaf: 1686 and 343 of them): the median over nine calls of
  the CUDA-event time, and of the host time from the call to its return
  (the enqueue, no synchronisation inside);
* the CUDA-event time of ``ata(a, out="packed")`` at 8192² planned (no
  pins) and under the fused dispatch (``n_base=512``); for the fused one
  also its enqueue, and both again with ``ops.gemm_tn_fused`` and
  ``ops.syrk_gather`` replaced by the bare launch functions of the kernel
  modules (``*_bare_*``: no wrapper, no dispatcher);
* the device time of one 512³ ``gemm_tn`` leaf and one (512, 512) ``syrk``
  leaf (CUDA graphs of 50 launches);
* the host time of one wrapper call on those leaves and of one elementwise
  add (best of five bursts of 200 calls, no synchronisation inside a
  burst).

With ``--case solve`` each process measures, on lstsq's seeded
16384 × 4096 operand and 8 right-hand sides (ridge 1e-3):

* the device time of ``ops.syrk`` on lstsq's single (2048, 512) leaf, on
  the ata 8192² diagonal leaves (256, 512, 512), and on two Shampoo-sized
  grams, (1024, 1024) and (4096, 1024), all float32 (CUDA graphs of 20
  launches): the split contraction's times;
* the CUDA-event time of ``lstsq(a, b, ridge=1e-3, method="factor")``
  (pinned to the factor path) and of ``lstsq(a, b, ridge=1e-3)`` (planned),
  and of its stages each alone on the last one's output: ``Aᵀb``
  (``core.strassen._dot_tn``), the packed Cholesky walk, the two
  substitutions; the walk's enqueue (host time to return, no sync).

The plans are the analytic ones (the plan cache named is never written).
The unrolled dispatches spend much of their time on the host between
launches, so their spread on a shared host is wide: compare within one run.
For each measure the script prints both sides' values in pair order, the
median and the interquartile distance of each side, the median over pairs
of this − other, and in how many pairs this side read higher; the last
line is the same as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MEASURE = r'''
import importlib, json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, "src")
import repro_torch  # noqa: F401
from repro_torch.core.ata import ata
from repro_torch.core.strassen import strassen_tn
from repro_torch.kernels import _build, ops

_build.load()
rng = np.random.default_rng(1)
a = torch.as_tensor(rng.standard_normal((8192, 8192), dtype="float32"), device="cuda")


def events_ms(fn, runs=9):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn, n=50):
    stream, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    return events_ms(graph.replay) / n


def enqueue_ms(fn, runs=9):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_us(fn, n=200):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def bare(fn):
    """``fn`` run with the fused wrappers replaced by the bare launches."""
    gm = importlib.import_module("repro_torch.kernels.gemm_tn")
    sk = importlib.import_module("repro_torch.kernels.syrk")

    def fused(a_blocks, b_blocks, tables, *, alpha=1.0, out_dtype=torch.float32, **_):
        return gm.gemm_tn_fused_cuda(a_blocks, b_blocks, tables, alpha=alpha,
                                     out_dtype=out_dtype)

    def gather(a_blocks, rows, cols, *, alpha=1.0, out_dtype=torch.float32, **_):
        return sk.syrk_gather_cuda(a_blocks, rows, cols, alpha=alpha, out_dtype=out_dtype)

    def run():
        wrapped = ops.gemm_tn_fused, ops.syrk_gather
        ops.gemm_tn_fused, ops.syrk_gather = fused, gather
        try:
            return fn()
        finally:
            ops.gemm_tn_fused, ops.syrk_gather = wrapped
    return run


fused = lambda: ata(a, out="packed", n_base=512, leaf_dispatch="fused")
x, y = a[:512, :512].contiguous(), a[512:1024, :512].contiguous()
s = a[:4096, :4096].contiguous()
print(json.dumps({
    "ata_8192_unrolled_ms": events_ms(lambda: ata(a, out="packed", n_base=512)),
    "ata_8192_unrolled_enqueue_ms": enqueue_ms(lambda: ata(a, out="packed", n_base=512)),
    "strassen_4096_unrolled_ms": events_ms(lambda: strassen_tn(s, s, n_base=512)),
    "strassen_4096_unrolled_enqueue_ms": enqueue_ms(lambda: strassen_tn(s, s, n_base=512)),
    "ata_8192_planned_ms": events_ms(lambda: ata(a, out="packed")),
    "ata_8192_fused_ms": events_ms(fused),
    "ata_8192_fused_enqueue_ms": enqueue_ms(fused),
    "ata_8192_fused_bare_ms": events_ms(bare(fused)),
    "ata_8192_fused_bare_enqueue_ms": enqueue_ms(bare(fused)),
    "gemm_tn_512_device_ms": graph_ms(lambda: ops.gemm_tn(x, y)),
    "syrk_512_device_ms": graph_ms(lambda: ops.syrk(x)),
    "gemm_tn_512_host_us": host_us(lambda: ops.gemm_tn(x, y)),
    "syrk_512_host_us": host_us(lambda: ops.syrk(x)),
    "add_host_us": host_us(lambda: x + y),
}))
'''


SOLVE = r'''
import json, os, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, "src")
os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join("build", "tune_plans.json")
import repro_torch  # noqa: F401
from repro_torch.core.strassen import _dot_tn
from repro_torch.kernels import _build, ops
from repro_torch.solve import cholesky, lstsq, solve_cholesky

_build.load()


def events_ms(fn, runs=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn, n=20):
    stream, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    return events_ms(graph.replay) / n


def enqueue_ms(fn, runs=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def dev(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape, dtype="float32"), device="cuda")


rng = np.random.default_rng(3)
res = {f"syrk_{'x'.join(map(str, sh))}_device_ms": graph_ms(lambda x=dev(rng, sh): ops.syrk(x))
       for sh in ((2048, 512), (256, 512, 512), (1024, 1024), (4096, 1024))}
rng = np.random.default_rng(2)
a, b = dev(rng, (16384, 4096)), dev(rng, (16384, 8))
res["lstsq_pinned_ms"] = events_ms(lambda: lstsq(a, b, ridge=1e-3, method="factor"))
res["lstsq_planned_ms"] = events_ms(lambda: lstsq(a, b, ridge=1e-3))
from repro_torch.core.ata import ata
gram = ata(a, out="packed").add_scaled_identity(1e-3)
rhs = _dot_tn(a, b, torch.float32)
factor = cholesky(gram)
res.update(
    rhs_ms=events_ms(lambda: _dot_tn(a, b, torch.float32)),
    cholesky_ms=events_ms(lambda: cholesky(gram)),
    cholesky_enqueue_ms=enqueue_ms(lambda: cholesky(gram)),
    substitution_ms=events_ms(lambda: solve_cholesky(factor, rhs)))
print(json.dumps(res))
'''

CASES = {"dispatch": MEASURE, "solve": SOLVE}


def measure(root: str, case: str = "dispatch") -> dict:
    out = subprocess.run([sys.executable, "-c", CASES[case]], cwd=root, capture_output=True,
                         text=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode or not lines:
        raise RuntimeError(f"{root} failed:\n{out.stderr[-3000:]}")
    return json.loads(lines[-1])


def iqr(xs) -> float:
    """Distance between the quartiles: the spread of one side's runs."""
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--case", choices=sorted(CASES), default="dispatch")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if args.pairs < 2:
        ap.error("--pairs must be at least 2")
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "src", "repro_torch")):
        ap.error(f"{other} holds no src/repro_torch")
    sides = {"other": other, "this": ROOT}
    pairs = []
    for i in range(args.pairs):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        pairs.append({side: measure(sides[side], args.case) for side in order})
    print(f"other = {other}, this = {ROOT}; case {args.case}, {args.pairs} pairs, "
          "first side alternating")
    summary = {}
    for key in pairs[0]["this"]:
        vals = {side: [p[side][key] for p in pairs] for side in sides}
        diff = [t - o for t, o in zip(vals["this"], vals["other"])]
        summary[key] = {
            "other_median": statistics.median(vals["other"]),
            "this_median": statistics.median(vals["this"]),
            "other_iqr": iqr(vals["other"]),
            "this_iqr": iqr(vals["this"]),
            "median_this_minus_other": statistics.median(diff),
            "pairs_this_higher": sum(d > 0 for d in diff),
            "pairs": len(diff),
        }
        print(f"  {key}: other {vals['other']}")
        print(f"  {' ' * len(key)}  this  {vals['this']}")
        print(f"  {' ' * len(key)}  {json.dumps(summary[key])}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
