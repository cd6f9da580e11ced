#!/usr/bin/env python3
"""Profile one train step of qwen1.5-0.5b on the card, operator by operator.

    python3 tools/profile_train_step.py [--batch 4] [--seq 2048] [--remat dots]
                                         [--top 25] [--out FILE]

The trainer of ``repro_torch`` at full width and depth (24 layers, d_model
1024, vocab 151936; seeded weights, the synthetic token stream), bfloat16
compute, the reference's ``OptimizerConfig`` defaults. For AdamW and for
Shampoo it times three steps with CUDA events, then runs one more step
under ``torch.profiler`` and reports: the step's device busy time (the sum
of its kernels' times) against its events time, the number of kernels,
and the operators that take the most device time themselves (self time),
with their counts and host time. The loss and its gradient alone
(``train_step.loss_and_grads``) are profiled the same way, so the
optimizer's share is the difference. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def dev_us(ev):
    return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)


def profiled(fn, top: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``: events ms, device busy
    ms, kernels, and the ``top`` operators by self device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels, busy = 0, 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            busy += ev.time_range.elapsed_us()
    ops = sorted(({"op": ev.key, "device_ms": dev_us(ev) / 1e3, "count": ev.count,
                   "host_ms": ev.self_cpu_time_total / 1e3} for ev in prof.key_averages()),
                 key=lambda r: -r["device_ms"])
    return {"events_ms": start.elapsed_time(end), "device_busy_ms": busy / 1e3,
            "kernels": kernels, "top_ops": ops[:top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init
    from repro_torch.train.train_step import loss_and_grads, make_loss_fn, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.load()
    shape = ShapeConfig("profile", args.seq, args.batch, "train")
    params = init(torch.Generator(device="cuda").manual_seed(0), CONFIG, device="cuda")
    data = SyntheticLM(CONFIG, shape, seed=0)
    try:
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
                   for _ in range(4)]
    finally:
        data.close()
    result = {"card": card, "batch": args.batch, "seq": args.seq, "remat": args.remat}

    run = RunConfig(model=CONFIG, shape=shape, remat=args.remat)
    loss_fn = make_loss_fn(CONFIG, None, run)
    loss_and_grads(loss_fn, params, batches[0])
    result["loss_and_grads"] = profiled(lambda: loss_and_grads(loss_fn, params, batches[0]),
                                        args.top)
    for name in ("adamw", "shampoo"):
        step_fn, opt = make_train_step(
            CONFIG, None, RunConfig(model=CONFIG, shape=shape, remat=args.remat,
                                    optimizer=OptimizerConfig(name=name)))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        times = []
        for i in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step_fn(state, batches[i])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        box = {}

        def one_step():
            box["state"], _ = step_fn(state, batches[3])

        result[name] = dict(step_ms=times, median_ms_2_3=statistics.median(times[1:]),
                            peak_bytes=torch.cuda.max_memory_allocated(),
                            **profiled(one_step, args.top))
        del state, box, step_fn, opt
        torch.cuda.empty_cache()

    for name in ("loss_and_grads", "adamw", "shampoo"):
        r = result[name]
        print(f"{name}: events {r['events_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f} ms,"
              f" {r['kernels']} kernels" + (f"; steps {[round(t, 2) for t in r['step_ms']]}"
                                             if "step_ms" in r else ""))
        for op in r["top_ops"]:
            print(f"  {op['device_ms']:10.3f} ms device  {op['host_ms']:9.3f} ms host  "
                  f"x{op['count']:<6} {op['op']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
