#!/usr/bin/env python3
"""How often a ``torch.profiler`` window loses kernels of a graph replay.

    PYTHONPATH=src python3 tools/profile_window.py [--trials 40] [--pad 0.05]

Warms the serving buckets that ``chip_smoke.py`` phase serve profiles (the
whitening bucket and the first three lstsq buckets), then traces one replay
of each bucket's CUDA graph ``--trials`` times in each of four alternating
series: the replay launched the moment the window opens (pad 0), then with
``--pad`` seconds of idle card at each end of the window, twice each. Prints
per bucket and series how many device events each window held, as a count
of windows per event count; a window that lost events shows a smaller
count. Prints one JSON object as its last line. It needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def device_events(program, pad: float) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        program._graph.replay()
        torch.cuda.synchronize()
        time.sleep(pad)
    return sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.events())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--pad", type=float, default=0.05)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_window: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke
    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.kernels import _build
    from repro_torch.serve.bucketing import make_buckets
    from repro_torch.serve.engine import Server, ServeConfig

    _build.build()
    _build.load()
    buckets = (make_buckets(**chip_smoke.SERVE_WHITEN)
               + make_buckets(**chip_smoke.SERVE_LSTSQ)[:3])
    server = Server(ServeConfig(buckets=buckets, capacity=64, max_wait_s=0.005))
    server.warm()
    out = {}
    for spec in server.buckets:
        program, _ = server.bucket_callable(spec)
        series = []
        for pad in (0.0, args.pad, 0.0, args.pad):
            counts = collections.Counter(device_events(program, pad)
                                         for _ in range(args.trials))
            series.append({"pad_s": pad, "windows_by_events": dict(sorted(counts.items()))})
        out[spec.label()] = series
        print(spec.label(), json.dumps(series), flush=True)
    print(json.dumps({"card": chip_smoke.card_line(), "trials": args.trials, "buckets": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
