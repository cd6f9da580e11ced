#!/usr/bin/env python3
"""Profile one call of the port in two checkouts on one card, op by op.

    python3 tools/profile_checkouts.py OTHER_CHECKOUT [--pairs N]

OTHER_CHECKOUT is another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into the ignored ``build/``).
Each side runs in a fresh process from its own root, building its kernels
into its own ``build/kernels/``, in N pairs (default 4) alternating which
side goes first. Each process times ``ata(a, out="packed")`` at 8192² under
the fused dispatch (``n_base=512``) with CUDA events (median of nine),
then runs five calls under ``torch.profiler`` and reports, per call: the
device time of each operator and kernel (self time), the host time each
operator spends itself, the number of device kernels, and the device's
busy time (the sum of the kernels' times) against the events time. The
script prints, per side, the medians over its processes, and the
operators whose device or host time differs most between the sides; the
last line is the same as one JSON object.
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
import json, statistics, sys
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, "src")
from repro_torch.core.ata import ata
from repro_torch.kernels import _build

_build.load()
rng = np.random.default_rng(1)
a = torch.as_tensor(rng.standard_normal((8192, 8192), dtype="float32"), device="cuda")
fn = lambda: ata(a, out="packed", n_base=512, leaf_dispatch="fused")
for _ in range(3):
    fn()
torch.cuda.synchronize()
times = []
for _ in range(9):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    times.append(s.elapsed_time(e))
calls = 5
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()


def dev_us(ev):
    return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)


ops, kernels, busy = {}, 0, 0.0
for ev in prof.key_averages():
    ops[ev.key] = {"device_ms": dev_us(ev) / 1e3 / calls,
                   "host_ms": ev.self_cpu_time_total / 1e3 / calls,
                   "count": ev.count / calls}
for ev in prof.events():
    if ev.device_type == torch.autograd.DeviceType.CUDA:
        kernels += 1
        busy += ev.time_range.elapsed_us()
print(json.dumps({"events_ms": statistics.median(times), "kernels": kernels / calls,
                  "device_busy_ms": busy / 1e3 / calls, "ops": ops}))
'''


def measure(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", MEASURE], cwd=root, capture_output=True, text=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode or not lines:
        raise RuntimeError(f"{root} failed:\n{out.stderr[-3000:]}")
    return json.loads(lines[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "src", "repro_torch")):
        ap.error(f"{other} holds no src/repro_torch")
    sides = {"other": other, "this": ROOT}
    runs = {"other": [], "this": []}
    for i in range(args.pairs):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            runs[side].append(measure(sides[side]))
    print(f"other = {other}, this = {ROOT}; {args.pairs} pairs, first side alternating")
    summary = {}
    for side, rs in runs.items():
        names = {k for r in rs for k in r["ops"]}
        per_op = {k: {f: statistics.median(r["ops"].get(k, {}).get(f, 0.0) for r in rs)
                      for f in ("device_ms", "host_ms", "count")} for k in names}
        summary[side] = {f: statistics.median(r[f] for r in rs)
                         for f in ("events_ms", "kernels", "device_busy_ms")}
        summary[side]["ops"] = per_op
        print(f"  {side}: events {[round(r['events_ms'], 3) for r in rs]}, device busy "
              f"{[round(r['device_busy_ms'], 3) for r in rs]} ms, kernels "
              f"{[r['kernels'] for r in rs]} a call")
    diffs = {}
    for k in set(summary["this"]["ops"]) | set(summary["other"]["ops"]):
        t, o = summary["this"]["ops"].get(k, {}), summary["other"]["ops"].get(k, {})
        diffs[k] = {f: t.get(f, 0.0) - o.get(f, 0.0) for f in ("device_ms", "host_ms", "count")}
    for f in ("device_ms", "host_ms", "count"):
        print(f"  largest differences in {f} a call (this − other):")
        for k in sorted(diffs, key=lambda k: -abs(diffs[k][f]))[:10]:
            print(f"    {diffs[k][f]:+.4f}  {k[:90]}")
    summary["differences"] = diffs
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
