#!/usr/bin/env python3
"""Wall time and device-busy time of ata 8192² on the card, by dispatch.

    PYTHONPATH=src python3 tools/profile_ata.py [--dtype bfloat16|float32] [--n 8192]

Runs ``ata(a, out="packed", n_base=512)`` (the pinned static cutoff) under
the fused and the batched leaf dispatch, and ``torch.matmul(a.mT, a)``
beside them, on one seeded ``n × n`` operand. For each: the median wall
time of one call (host clock around the call and a synchronize, after
warm-up; three calls), the median CUDA-event time of the same calls, and,
from a ``torch.profiler`` trace of one call (CUPTI), its device-busy time
(the sum of its kernels' durations) and its kernel count. The fused ata is host-bound
(thousands of launches a call), so wall and busy differ: busy is what a
faster kernel moves. Prints one JSON object as its last line. It needs an
NVIDIA card; run it in a process of its own (a profiler session leaves
CUPTI state behind for later traces in the same process).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def measure(fn, calls: int = 1) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    wall, events = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    # the trace drops device activity whose converted timestamps fall outside
    # its window: idle the card briefly at both ends so no kernel is lost
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    kernels, busy_us = 0, 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            busy_us += ev.time_range.elapsed_us()
    return {"wall_ms": statistics.median(wall), "events_ms": statistics.median(events),
            "device_busy_ms": busy_us / 1e3 / calls, "kernels": kernels / calls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--n", type=int, default=8192)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_ata: needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.core.ata import ata
    from repro_torch.kernels import _build

    _build.load()
    dt = getattr(torch, args.dtype)
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.standard_normal((args.n, args.n), dtype="float32"),
                        device="cuda").to(dt)
    out = {"dtype": args.dtype, "n": args.n, "n_base": 512,
           "card": torch.cuda.get_device_name(0)}
    for ld in ("fused", "batched"):
        out[ld] = measure(lambda: ata(a, out="packed", n_base=512, leaf_dispatch=ld))
    out["matmul"] = measure(lambda: torch.matmul(a.mT, a))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
