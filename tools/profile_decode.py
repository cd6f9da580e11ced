#!/usr/bin/env python3
"""Profile one decode step of qwen1.5-0.5b on the card, operator by operator.

    python3 tools/profile_decode.py [--batch 4] [--prompt 512] [--out FILE]

The model server of ``repro_torch`` at full width and depth (24 layers,
d_model 1024, vocab 151936; seeded weights): ``--batch`` slots prefilled
with ``--prompt`` tokens of the synthetic stream, two decode steps to warm
up, then one bfloat16 decode step (the served one) under ``torch.profiler``.
It reports the step's events time, the card's busy time (the sum of its
kernels' times), the number of kernels, the eight operators that take the
most device time, and beside them the least time the bytes of the step's
weight casts take (each float32 weight read, its bfloat16 copy written and
read, at the H100's 3.35 TB/s): a step far above its busy time is bound by
the host's launches, one near it by bytes. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PEAK_BYTES = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
TOP_OPS = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_decode: needs an NVIDIA card", file=sys.stderr)
        return 2
    from profile_train_step import profiled

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_leaves
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    params = init(torch.Generator(device="cuda").manual_seed(0), CONFIG, device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    shape = ShapeConfig("profile", args.prompt + 3, args.batch, "prefill")
    toks = torch.as_tensor(make_batch(CONFIG, shape, 0, 0)["tokens"], device="cuda")
    _, cache = make_prefill_step(CONFIG, None, torch.bfloat16, cache_len=args.prompt + 3)(
        params, {"tokens": toks[:, :args.prompt]})
    decode = make_decode_step(CONFIG, None, torch.bfloat16)

    def step(t):
        pos = torch.full((args.batch,), t, dtype=torch.int32, device="cuda")
        decode(params, toks[:, t:t + 1], cache, pos)

    step(args.prompt)
    step(args.prompt + 1)
    result = {"card": card, "batch": args.batch, "prompt": args.prompt, "n_params": n_params,
              "bytes_bound_ms": (4 + 2 + 2) * n_params / PEAK_BYTES * 1e3,
              **profiled(lambda: step(args.prompt + 2), TOP_OPS)}
    print(f"one bfloat16 decode step at {args.batch} slots: events {result['events_ms']:.3f} "
          f"ms, device busy {result['device_busy_ms']:.3f} ms, {result['kernels']} kernels; the "
          f"weight casts' bytes bound it at {result['bytes_bound_ms']:.3f} ms")
    for op in result["top_ops"]:
        print(f"  {op['device_ms']:10.3f} ms device  {op['host_ms']:9.3f} ms host  "
              f"x{op['count']:<6} {op['op']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
