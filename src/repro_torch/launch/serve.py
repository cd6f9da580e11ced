"""Serving driver: batched prefill + decode with slot-based continuous
batching (port of ``repro.launch.serve``).

The server keeps a fixed pool of ``--batch`` sequence slots. Requests are
prefilled (batched) into their slot's cache region; every decode step
advances all active slots by one token; finished slots (length budget)
are refilled from the queue. The prompts come from
``np.random.default_rng(seed)``, the same stream as the reference's.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
        --requests 16 --batch 4 --prompt-len 32 --gen-len 32 --device cpu

Departures from the reference: ``--device`` (default ``cuda``),
``--compute-dtype`` (default ``bfloat16``, the reference's) and ``--out``
(a JSON file of the prompts, the generated tokens and the step times);
``--mesh`` other than ``1x1`` raises until the sharding slice; the
weights are the port's own seeded draws (``init`` from a
``torch.Generator``); sampling draws from a ``torch.Generator`` seeded
with ``seed + 1`` (``train.serve_step.sample_logits``); prefill and decode
run eagerly (no ``jit``, no CUDA graph).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.models.transformer import init
from repro_torch.train.serve_step import make_decode_step, make_prefill_step, sample_logits


def _pad_slots(real: np.ndarray, b: int) -> np.ndarray:
    """Zero-pad a ragged tail batch of ``n < b`` real prompts up to the
    static slot count. Keeps the prefill/decode shapes static without
    drawing RNG for padding slots, so the prompt stream advances only for
    requested slots."""
    n = real.shape[0]
    if n == b:
        return real
    pad = np.zeros((b - n, *real.shape[1:]), dtype=real.dtype)
    return np.concatenate([real, pad], axis=0)


class _Clock:
    """Marks on the device's timeline: CUDA events on a card (no host sync
    until :meth:`read`), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def read(self, a, b) -> float:
        """Milliseconds from mark ``a`` to mark ``b``."""
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def serve(cfg, params, *, batch: int, requests: int, prompt_len: int, gen_len: int,
          temperature: float, seed: int, device, compute_dtype=torch.bfloat16,
          log=print) -> dict:
    """Serve ``requests`` prompts of ``prompt_len`` tokens through ``batch``
    slots, ``gen_len`` tokens each. Returns the prompts and generated
    tokens of every request (numpy, in order), each prefill's and each
    decode step's milliseconds (sampling included), the tokens counted
    as the reference counts them and the seconds taken."""
    device = torch.device(device)
    b, p_len, g_len = batch, prompt_len, gen_len
    prefill = make_prefill_step(cfg, None, compute_dtype, cache_len=p_len + g_len)
    decode = make_decode_step(cfg, None, compute_dtype)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    clock = _Clock(device)

    def new_prompts(n):
        if cfg.num_codebooks > 1:
            return rng.integers(0, cfg.vocab_size, (n, p_len, cfg.num_codebooks))
        return rng.integers(0, cfg.vocab_size, (n, p_len))

    prompts, outputs, prefill_ms, decode_ms = [], [], [], []
    served = tokens_out = 0
    t0 = time.perf_counter()
    while served < requests:
        n = min(b, requests - served)
        real = new_prompts(n)
        toks = torch.as_tensor(_pad_slots(real, b), dtype=torch.int32, device=device)
        marks = [clock.mark()]
        logits, cache = prefill(params, {"tokens": toks})
        tok = sample_logits(logits, gen, temperature, cfg.vocab_size)
        marks.append(clock.mark())
        out = [tok]
        pos = torch.full((b,), p_len, dtype=torch.int32, device=device)
        for _ in range(g_len - 1):
            lg, cache = decode(params, tok, cache, pos)
            tok = sample_logits(lg, gen, temperature, cfg.vocab_size)
            marks.append(clock.mark())
            out.append(tok)
            pos = pos + 1
            tokens_out += n
        prompts.append(real)
        outputs.append(torch.cat(out, dim=1)[:n].cpu().numpy())
        prefill_ms.append(clock.read(marks[0], marks[1]))
        decode_ms += [clock.read(a, c) for a, c in zip(marks[1:-1], marks[2:])]
        del cache
        served += n
        log(f"served {served}/{requests} requests "
            f"({tokens_out} tokens, {time.perf_counter() - t0:.1f}s)")
    seconds = time.perf_counter() - t0
    return dict(prompts=np.concatenate(prompts), tokens=np.concatenate(outputs),
                prefill_ms=prefill_ms, decode_ms=decode_ms, tokens_out=tokens_out,
                seconds=seconds)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1 until sharding")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=None,
                    help="write the prompts, generated tokens and step times here (JSON)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m > 1:
        raise NotImplementedError(f"--mesh {args.mesh}: a mesh waits for the port of "
                                  "parallel/sharding.py; run with --mesh 1x1")
    device = torch.device(args.device)
    params = init(torch.Generator(device=device).manual_seed(args.seed), cfg, device=device)
    res = serve(cfg, params, batch=args.batch, requests=args.requests,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                temperature=args.temperature, seed=args.seed, device=device,
                compute_dtype=getattr(torch, args.compute_dtype),
                log=lambda line: print(line, flush=True))
    print(f"throughput: {res['tokens_out'] / res['seconds']:.1f} tok/s "
          f"({args.requests} requests in {res['seconds']:.1f}s)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"arch": cfg.name, "device": str(device),
                       "compute_dtype": args.compute_dtype,
                       **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                          for k, v in res.items()}}, f)
    return res


if __name__ == "__main__":
    main()
