#!/usr/bin/env python3
"""Time the unrolled leaf dispatch of two checkouts of the port on one card.

    python3 tools/compare_checkouts.py OTHER_CHECKOUT [--pairs N]

OTHER_CHECKOUT is another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into the ignored ``build/``).
Each side runs in a fresh process from its own root, building its kernels
into its own ``build/kernels/``. The processes run in N pairs (default
10), alternating which side goes first: other, this; this, other; ...
Each process measures, on one NVIDIA card:

* ``ata(a, out="packed")`` at 8192² and ``strassen_tn`` at 4096³ under the
  default unrolled dispatch (one wrapper call and one launch per leaf:
  1686 and 343 of them): the median over nine calls of the CUDA-event
  time, and of the host time from the call to its return (the enqueue,
  no synchronisation inside);
* the device time of one 512³ ``gemm_tn`` leaf and one (512, 512) ``syrk``
  leaf (CUDA graphs of 50 launches);
* the host time of one wrapper call on those leaves and of one elementwise
  add (best of five bursts of 200 calls, no synchronisation inside a
  burst).

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
import json, statistics, sys, time
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


x, y = a[:512, :512].contiguous(), a[512:1024, :512].contiguous()
s = a[:4096, :4096].contiguous()
print(json.dumps({
    "ata_8192_unrolled_ms": events_ms(lambda: ata(a, out="packed")),
    "ata_8192_unrolled_enqueue_ms": enqueue_ms(lambda: ata(a, out="packed")),
    "strassen_4096_unrolled_ms": events_ms(lambda: strassen_tn(s, s)),
    "strassen_4096_unrolled_enqueue_ms": enqueue_ms(lambda: strassen_tn(s, s)),
    "gemm_tn_512_device_ms": graph_ms(lambda: ops.gemm_tn(x, y)),
    "syrk_512_device_ms": graph_ms(lambda: ops.syrk(x)),
    "gemm_tn_512_host_us": host_us(lambda: ops.gemm_tn(x, y)),
    "syrk_512_host_us": host_us(lambda: ops.syrk(x)),
    "add_host_us": host_us(lambda: x + y),
}))
'''


def measure(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", MEASURE], cwd=root, capture_output=True, text=True)
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
        pairs.append({side: measure(sides[side]) for side in order})
    print(f"other = {other}, this = {ROOT}; {args.pairs} pairs, first side alternating")
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
