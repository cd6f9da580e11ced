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

    # a (data=2, model=2) mesh: 4 ranks (4 cards, or all on card 0 over gloo)
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --mesh 2x2 \
        --steps 20 --batch 4 --seq 64 --device cpu --out /tmp/run2

``--mesh DxM`` with ``D·M > 1`` starts ``D·M`` ranks on this host
(``launch.mesh.spawn``): over NCCL with one card a rank when the host has
that many cards, else over gloo with every rank on card 0, and with
``--device cpu`` over gloo with CPU tensors. Each rank runs the meshed
train step (``train.train_step``: its block of the global batch, ZeRO-1
moments) on the same data stream; rank 0 logs, writes ``metrics.jsonl``
and the heartbeat, and writes the checkpoints every rank gathers. A run
resumes from the newest checkpoint on whatever mesh it is started with
(``CheckpointManager.restore_sharded``); a preemption signal to any rank
checkpoints and stops them all. The padded vocab follows the ``model``
axis (``pad_vocab``), so a run resumed on another ``model`` size crops or
zero-fills the padded rows of ``embed`` and ``lm_head`` and of their
moments, which no token reaches.

Departures from the reference: ``--device`` (default ``cuda``) and
``--layers`` (a depth cut at full width); the step
runs eagerly (no ``jit``, no donation); ``metrics.jsonl`` holds the loss
and grad norm unrounded, so two runs can be compared bitwise; the default
``--out`` lies under the temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import collectives
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.transformer import init
from repro_torch.runtime.fault_tolerance import Heartbeat, PreemptionGuard
from repro_torch.train.train_step import held_state_specs, init_state, make_train_step


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers (widths unchanged), e.g. to fit a "
                         "mesh's ranks on one card")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--optimizer", choices=["adamw", "shampoo"], default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x4 (one rank each)")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def mesh_dims(spec: str):
    """``"DxM"`` → (D, M)."""
    d, m = (int(x) for x in spec.split("x"))
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec}: both sizes must be positive")
    return d, m


def backend_for(device: str, ranks: int):
    """The process groups' backend and each rank's device rule: NCCL with
    one card a rank where the host has ``ranks`` cards, else gloo (all
    ranks on card 0, or CPU tensors)."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= ranks else "gloo"


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    return dev


def main(argv=None):
    args = build_argparser().parse_args(argv)
    d, m = mesh_dims(args.mesh)
    if d * m == 1:
        return _run(args, None, torch.device(args.device))
    if args.batch % d:
        raise ValueError(f"--mesh {args.mesh}: the data axis ({d}) does not divide --batch "
                         f"{args.batch} (the reference would shard the sequence)")
    from repro_torch.launch.mesh import spawn

    backend = backend_for(args.device, d * m)
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    return spawn(_rank, d * m, backend=backend, timeout_s=float("inf"),
                 args=(argv, backend))[0]


def _rank(rank: int, world: int, argv, backend: str):
    """One rank of a meshed run (``launch.mesh.spawn``'s body)."""
    from repro_torch.launch.mesh import make_mesh

    args = build_argparser().parse_args(argv)
    device = rank_device(rank, backend, args.device)
    mesh = make_mesh(mesh_dims(args.mesh), ("data", "model"), backend=backend, device=device)
    return _run(args, mesh, device)


def _fit_vocab(cfg):
    """``restore_sharded``'s ``fit`` for a run resumed on a mesh whose
    ``model`` axis pads the vocab otherwise (``pad_vocab`` rounds it to a
    multiple of ``model · 128``): the padded rows of ``embed`` and columns
    of ``lm_head`` (and of their moments) are cropped, or zero-filled. No
    token reaches them, and the loss masks their logits."""

    def fit(key, arr, shape):
        name = key.rsplit("[", 1)[-1]
        if name not in ("'embed']", "'lm_head']") or arr.ndim != 2 or len(shape) != 2:
            return arr
        if name == "'embed']":
            arr, want = arr[None], (1, *shape)                       # (1, V, d)
        else:
            k = max(cfg.num_codebooks, 1)
            arr = arr.reshape(arr.shape[0], k, -1).transpose(1, 2, 0)   # (K, V, d)
            want = (k, shape[1] // k, shape[0])
        if min(arr.shape[1], want[1]) < cfg.vocab_size:
            raise ValueError(f"{key}: a vocab of {arr.shape[1]} or {want[1]} rows does not "
                             f"hold {cfg.name}'s {cfg.vocab_size}")
        out = np.zeros(want, arr.dtype)
        rows = min(arr.shape[1], want[1])
        out[:, :rows] = arr[:, :rows]
        if name == "'embed']":
            return out[0]
        return out.transpose(2, 0, 1).reshape(shape)

    return fit


def _run(args, mesh, device):
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    rank0 = mesh is None or mesh.rank == 0

    run = RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  warmup_steps=min(50, args.steps // 10 + 1)),
        remat=args.remat, microbatch=args.microbatch, seed=args.seed,
    )
    train_step, opt = make_train_step(cfg, mesh, run, total_steps=args.steps)

    os.makedirs(args.out, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.out, "ckpt"), keep=2)
    guard = PreemptionGuard()

    # --- build or restore state -------------------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init(gen, cfg, mesh, device=device)
    shardings = None
    if mesh is None:
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
    else:
        from repro_torch.parallel.sharding import named

        state = init_state(cfg, mesh, run, opt, params)
        shardings = named(mesh, held_state_specs(cfg, mesh, run, opt, params))
    del params
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        if mesh is None:
            state, start_step = ckpt.restore(state)
        else:
            state, start_step = ckpt.restore_sharded(state, shardings, fit=_fit_vocab(cfg))
        if rank0:
            print(f"resumed from checkpoint step {start_step}")

    data = SyntheticLM(cfg, shape, seed=args.seed, start_step=start_step)
    hb = Heartbeat(os.path.join(args.out, "heartbeat"), interval=5.0).start() if rank0 else None
    log_path = os.path.join(args.out, "metrics.jsonl")

    def preempted() -> bool:
        if mesh is None:
            return guard.preempted
        flag = torch.tensor([float(guard.preempted)], device=device)
        return bool(collectives.all_reduce(flag, mesh.group(mesh.axis_names))[0] > 0)

    t0 = time.time()
    losses = []
    try:
        with open(log_path, "a") if rank0 else open(os.devnull, "w") as logf:
            for step in range(start_step, args.steps):
                batch = {k: torch.as_tensor(v, device=device) for k, v in next(data).items()}
                state, metrics = train_step(state, batch)
                losses.append(float(metrics["loss"]))
                if (step + 1) % args.log_every == 0 and rank0:
                    rec = {
                        "step": step + 1,
                        "loss": float(np.mean(losses[-args.log_every:])),
                        "grad_norm": float(metrics["grad_norm"]),
                        "wall_s": round(time.time() - t0, 1),
                    }
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
                    print(rec, flush=True)
                stop = preempted()
                if (step + 1) % args.save_every == 0 or stop:
                    ckpt.save(step + 1, state, blocking=False,
                              extra={"data_step": step + 1}, shardings=shardings)
                    if stop:
                        if rank0:
                            print("preemption requested — checkpointed, exiting")
                        break
    finally:
        ckpt.wait()
        data.close()
        if hb is not None:
            hb.stop()
        guard.restore()
    final = float(np.mean(losses[-10:])) if losses else float("nan")
    if rank0:
        print(f"final loss (mean of last 10): {final:.4f}", flush=True)
    return final


if __name__ == "__main__":
    main()
