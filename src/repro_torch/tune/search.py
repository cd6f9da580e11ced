"""Measured autotuning: time candidate plans, keep the fastest (port of
``repro.tune.search``), and the timing discipline it uses.

* every timed call ends in ``torch.cuda.synchronize`` of each card its
  operands lie on, as the reference's ``jax.block_until_ready`` waits for
  its result; nothing is synchronised for CPU operands;
* ``warmup`` calls are discarded (first-touch, and the kernels' build);
* ``time_fn`` reports the **median** over ``iters``; ``time_pair``
  interleaves two functions; ``time_ratio`` takes the minimum of each of
  two interleaved series with alternating order, the clean-machine floor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import calibrate, metrics
from repro_torch.tune import cost

__all__ = ["time_fn", "time_pair", "time_ratio", "measure_plan", "autotune"]


def _syncer(args):
    """A function that waits for every card among ``args``' devices."""
    cards = {a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda}

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    return sync


def time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median wall seconds of ``fn(*args)``, each call waited for."""
    sync = _syncer(args)
    for _ in range(warmup):
        fn(*args)
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def time_pair(fn_a, fn_b, *args, iters: int = 7, warmup: int = 2):
    """Median wall seconds of two functions measured **interleaved**."""
    sync = _syncer(args)
    for _ in range(warmup):
        fn_a(*args)
        sync()
        fn_b(*args)
        sync()
    ta, tb = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn_a(*args)
        sync()
        ta.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        fn_b(*args)
        sync()
        tb.append(time.perf_counter() - t0)
    return float(np.median(ta)), float(np.median(tb))


def time_ratio(fn_a, fn_b, *args, iters: int = 8, warmup: int = 1):
    """Speed ratio ``t_a / t_b`` from the **minimum** of each series, calls
    interleaved with alternating order. Interference only adds time, so
    the minimum is each function's floor, and alternating the order
    cancels warm-cache bias. Returns ``(ratio, min_t_a, min_t_b)``."""
    sync = _syncer(args)
    for _ in range(warmup):
        fn_a(*args)
        sync()
        fn_b(*args)
        sync()
    tas, tbs = [], []
    for k in range(iters):
        first, second = (fn_a, fn_b) if k % 2 == 0 else (fn_b, fn_a)
        t0 = time.perf_counter()
        first(*args)
        sync()
        t1 = time.perf_counter()
        second(*args)
        sync()
        t2 = time.perf_counter()
        ta, tb = (t1 - t0, t2 - t1) if k % 2 == 0 else (t2 - t1, t1 - t0)
        tas.append(ta)
        tbs.append(tb)
    ta, tb = min(tas), min(tbs)
    return ta / tb, ta, tb


# ---------------------------------------------------------------------------
# plan measurement
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64}


def _operands(plan: cost.Plan, seed: int = 0):
    """Operands of the plan's problem, drawn with numpy from ``seed`` and
    put on the plan's device."""
    rng = np.random.default_rng(seed)
    lead = (plan.batch,) if plan.batch else ()
    kw = dict(dtype=_TORCH_DTYPES[plan.dtype], device=torch.device(plan.backend))

    def draw(shape):
        return torch.as_tensor(rng.standard_normal(shape)).to(**kw)

    a = draw((*lead, plan.m, plan.n))
    if plan.op == "gemm_tn":
        return (a, draw((*lead, plan.m, plan.k)))
    if plan.op == "solve":
        return (a, draw((plan.m, plan.k)))
    return (a,)


def _load_kernels(plan: cost.Plan) -> None:
    """Build and load the CUDA kernels before anything is timed: the first
    launch would otherwise build them inside a timed call."""
    if plan.use_kernels and plan.backend == "cuda":
        from repro_torch.kernels import _build

        _build.load()


def measure_plan(plan: cost.Plan, *, iters: int = 3, warmup: int = 1, seed: int = 0) -> float:
    """Median seconds of the plan's callable on drawn operands."""
    from repro_torch.tune.apply import build_callable

    _load_kernels(plan)
    return time_fn(build_callable(plan), *_operands(plan, seed), iters=iters, warmup=warmup)


def autotune(
    op: str,
    m: int,
    n: int,
    k: Optional[int] = None,
    *,
    batch: int = 0,
    dtype: str = "float32",
    out: str = "dense",
    backend: str = "cpu",
    devices: int = 1,
    row_devices: int = 1,
    max_candidates: int = 4,
    iters: int = 8,
    warmup: int = 1,
    margin: float = 0.15,
) -> cost.Plan:
    """Time the analytic top-``max_candidates`` candidates, each **paired
    against the static default** (``time_ratio``); a candidate replaces the
    default only when it wins by more than ``margin``, and a win must
    replicate in a second, independent window (the minimum of the two
    counts). Every trial's floor is a calibration row against the
    candidate's prediction. The result is the winner (or the default) with
    ``source='measured'``, ``measured_s`` and ``baseline_s``.
    """
    from repro_torch.tune.apply import build_callable

    key = dict(batch=batch, dtype=dtype, out=out, backend=backend, devices=devices,
               row_devices=row_devices)
    base = cost.default_plan(op, m, n, k, **key)
    cands = [c for c in cost.candidates(op, m, n, k, **key)[:max_candidates]
             if not _same_dispatch(c, base)]

    metrics.inc("tune.autotune.runs")
    _load_kernels(base)
    base_fn = build_callable(base)
    args = _operands(base)
    t_base = time_fn(base_fn, *args, iters=iters, warmup=warmup)
    calibrate.record(base, t_base, source="autotune")
    best = (1.0, base, t_base, t_base)
    for cand in cands:
        metrics.inc("tune.autotune.trials")
        cand_fn = build_callable(cand)
        ratio, tb, tc = time_ratio(base_fn, cand_fn, *args, iters=iters, warmup=warmup)
        if ratio > 1.0 + margin:
            r2, tb2, tc2 = time_ratio(base_fn, cand_fn, *args, iters=iters, warmup=0)
            ratio = min(ratio, r2)
            tb, tc = min(tb, tb2), min(tc, tc2)
        calibrate.record(cand, tc, source="autotune")
        if ratio > 1.0 + margin and ratio > best[0]:
            best = (ratio, cand, tc, tb)
    ratio_won, plan, t, t_baseline = best
    if plan is base:
        metrics.inc("tune.autotune.kept_default")
    else:
        metrics.inc("tune.autotune.wins")
        metrics.observe("tune.autotune.win_margin", ratio_won - 1.0)
    return dataclasses.replace(plan, source="measured", measured_s=t, baseline_s=t_baseline)


def _same_dispatch(a: cost.Plan, b: cost.Plan) -> bool:
    """True when two plans dispatch identically (tunables equal)."""
    keys = ("algorithm", "n_base", "packed_block", "use_kernels", "syrk_blocks", "gemm_blocks",
            "leaf_dispatch", "method", "nb", "tile_w", "comm_schedule", "row_devices")
    return all(getattr(a, f) == getattr(b, f) for f in keys)
