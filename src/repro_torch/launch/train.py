"""End-to-end training entry point (port of ``repro.launch.train``).

Runs real training (CPU-sized smoke configs or a registry arch of the
dense family) with the stack of the port: the eager train step,
checkpoint/restore, preemption guard, deterministic data pipeline, metrics
logging, heartbeat.

Examples::

    # the smoke config on the CPU
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
        --steps 300 --batch 8 --seq 256 --device cpu --out /tmp/run1

    # qwen1.5-0.5b at full width on the card, Shampoo's grams on the kernels
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --optimizer shampoo \
        --steps 4 --save-every 2

    # resume after a crash/preemption: same command — restores automatically

Departures from the reference: ``--device`` (default ``cuda``); ``--mesh``
other than ``1x1`` raises until ``parallel/sharding.py`` is ported; the
step runs eagerly (no ``jit``, no donation); ``metrics.jsonl`` holds the
loss and grad norm unrounded, so two runs can be compared bitwise; the
default ``--out`` lies under the temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.transformer import init
from repro_torch.runtime.fault_tolerance import Heartbeat, PreemptionGuard
from repro_torch.train.train_step import make_train_step


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--optimizer", choices=["adamw", "shampoo"], default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1 until sharding")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m > 1:
        raise NotImplementedError(f"--mesh {args.mesh}: a mesh waits for the port of "
                                  "parallel/sharding.py; run with --mesh 1x1")
    device = torch.device(args.device)

    run = RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  warmup_steps=min(50, args.steps // 10 + 1)),
        remat=args.remat, microbatch=args.microbatch, seed=args.seed,
    )
    train_step, opt = make_train_step(cfg, None, run, total_steps=args.steps)

    os.makedirs(args.out, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.out, "ckpt"), keep=2)
    guard = PreemptionGuard()

    # --- build or restore state -------------------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init(gen, cfg, device=device)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state, start_step = ckpt.restore(state)
        print(f"resumed from checkpoint step {start_step}")

    data = SyntheticLM(cfg, shape, seed=args.seed, start_step=start_step)
    hb = Heartbeat(os.path.join(args.out, "heartbeat"), interval=5.0).start()
    log_path = os.path.join(args.out, "metrics.jsonl")

    t0 = time.time()
    losses = []
    try:
        with open(log_path, "a") as logf:
            for step in range(start_step, args.steps):
                batch = {k: torch.as_tensor(v, device=device) for k, v in next(data).items()}
                state, metrics = train_step(state, batch)
                losses.append(float(metrics["loss"]))
                if (step + 1) % args.log_every == 0:
                    rec = {
                        "step": step + 1,
                        "loss": float(np.mean(losses[-args.log_every:])),
                        "grad_norm": float(metrics["grad_norm"]),
                        "wall_s": round(time.time() - t0, 1),
                    }
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
                    print(rec, flush=True)
                if (step + 1) % args.save_every == 0 or guard.preempted:
                    ckpt.save(step + 1, state, blocking=False,
                              extra={"data_step": step + 1})
                    if guard.preempted:
                        print("preemption requested — checkpointed, exiting")
                        break
    finally:
        ckpt.wait()
        data.close()
        hb.stop()
        guard.restore()
    final = float(np.mean(losses[-10:])) if losses else float("nan")
    print(f"final loss (mean of last 10): {final:.4f}")
    return final


if __name__ == "__main__":
    main()
