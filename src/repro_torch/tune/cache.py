"""Persistent plan cache and the ``repro_torch.tune.plan(...)`` front door
(port of ``repro.tune.cache``).

Resolution order for one problem key:

1. **in-process memo** — a resolved Plan is memoized, so a front door
   called many times at one shape plans once (a memo hit is one lock and
   one dict lookup);
2. **JSON cache file** — *measured* plans persist across processes, keyed
   by :func:`plan_key` (the problem, the card's name and the torch
   version: a new card or runtime can move the crossovers);
3. **analytic model** (``tune.cost.analytic_plan``) on a miss — or the
   **measured autotuner** (``tune.search.autotune``) with
   ``autotune=True``, whose result is written back to the file.

Only measured plans are persisted: the analytic model is deterministic and
free to recompute. Cache location: ``$REPRO_TORCH_TUNE_CACHE`` if set,
else ``~/.cache/repro_torch/tune_plans.json`` — never the reference's
file, so the two packages never read each other's plans.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
from typing import Optional

import torch

from repro_torch.obs import metrics
from repro_torch.tune import cost

__all__ = [
    "plan",
    "plan_key",
    "cache_path",
    "load_cache",
    "save_cache",
    "clear_memo",
    "cache_stats",
    "warm",
    "cache_prefetch",
]

_LOG = logging.getLogger("repro_torch.tune.cache")

# counters of the plan cache (obs.metrics, ``tune.cache.<name>``): hit and
# miss count front-door resolutions, the load-side ones count per load
_STAT_NAMES = (
    "memo_hit",        # resolved from the in-process memo
    "hit",             # resolved from the persistent JSON cache
    "miss",            # fell through to the analytic model
    "autotuned",       # resolved by a measured autotune run (persisted)
    "migrated",        # old-schema keys migrated on load
    "sanitized",       # unknown leaf_dispatch / comm_schedule entries sanitized on load
    "skipped_entries", # undeserializable entries skipped on load
    "load_failure",    # unreadable cache file tolerated
    "warm_hit",        # warm(): resolved from the persistent JSON cache
    "warm_miss",       # warm(): fell through to the analytic model
    "warm_memo",       # warm(): key already memoized (left untouched)
)


def cache_stats() -> dict:
    """Current plan-cache counters, ``{short_name: count}``."""
    return {name: metrics.get(f"tune.cache.{name}") for name in _STAT_NAMES}


_MEMO: dict = {}
_LOCK = threading.Lock()
# The reference's schema, so the key layout and its migration rules are
# the same: v4 added the ``r=`` (row devices) segment and comm_schedule,
# v3 the 'fused' leaf_dispatch, v2 op='solve' and ``method``. Older keys
# are migrated on load (prefix swapped, ``r=1`` inserted before the
# runtime segment); values a newer schema may write sanitize to the
# always-valid ones.
_SCHEMA = "v4"
_COMPAT_SCHEMAS = ("v1", "v2", "v3")
_KNOWN_LEAF_DISPATCHES = ("unrolled", "batched", "fused")


def _valid_comm_schedule(cs) -> bool:
    """None (the psum schedule) or a non-empty {'B','D'} string."""
    return cs is None or (isinstance(cs, str) and bool(cs) and all(c in "BD" for c in cs))


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "tune_plans.json")


@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _device_label(backend: str) -> str:
    """The runtime's device segment of a key: the card's name for a CUDA
    plan made where a card is present, else the backend name."""
    if backend == "cuda" and torch.cuda.is_available():
        return _cuda_name(torch.cuda.current_device())
    return backend


def plan_key(op: str, m: int, n: int, k: int, batch: int, dtype: str, out: str, backend: str,
             devices: int = 1, row_devices: int = 1) -> str:
    """The cache key: the problem, then the runtime (the device's name and
    the torch version) in place of the reference's ``jax=`` segment."""
    return (f"{_SCHEMA}|{op}|m={m}|n={n}|k={k}|b={batch}|{dtype}|{out}"
            f"|{backend}|p={devices}|r={row_devices}|dev={_device_label(backend)}"
            f"|torch={torch.__version__}")


def load_cache(path: Optional[str] = None) -> dict:
    """{key: Plan} from the JSON file (empty on a missing or unreadable
    file; undeserializable entries are skipped and counted)."""
    path = path or cache_path()
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, json.JSONDecodeError) as e:
        metrics.inc("tune.cache.load_failure")
        _LOG.warning("plan cache %s unreadable (%s: %s); continuing with empty cache",
                     path, type(e).__name__, e)
        return {}
    out = {}
    skipped = 0
    for key, d in raw.get("plans", {}).items():
        for old in _COMPAT_SCHEMAS:
            if key.startswith(old + "|"):
                key = _SCHEMA + key[len(old):]
                if "|r=" not in key and "|dev=" in key:
                    key = key.replace("|dev=", "|r=1|dev=", 1)
                metrics.inc("tune.cache.migrated")
                break
        try:
            p = cost.Plan.from_json(d)
        except (TypeError, KeyError, ValueError):
            # schema drift, a truncated entry, a non-dict value: the
            # analytic model covers the key instead
            skipped += 1
            continue
        if p.leaf_dispatch not in _KNOWN_LEAF_DISPATCHES:
            p = dataclasses.replace(p, leaf_dispatch="unrolled")
            metrics.inc("tune.cache.sanitized")
        if not _valid_comm_schedule(p.comm_schedule):
            p = dataclasses.replace(p, comm_schedule=None)
            metrics.inc("tune.cache.sanitized")
        out[key] = p
    if skipped:
        metrics.inc("tune.cache.skipped_entries", skipped)
        _LOG.warning("plan cache %s: skipped %d undeserializable entr%s",
                     path, skipped, "y" if skipped == 1 else "ies")
    return out


def save_cache(plans: dict, path: Optional[str] = None) -> str:
    """Write ``{key: Plan}`` atomically (a temporary file, then a rename)."""
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"schema": _SCHEMA,
               "plans": {key: p.to_json() for key, p in sorted(plans.items())}}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def clear_memo() -> None:
    """Drop the in-process memo (tests; cache-file experiments)."""
    with _LOCK:
        _MEMO.clear()


def _default_backend() -> str:
    from repro_torch.backend import DEFAULT_DEVICE

    return torch.device(DEFAULT_DEVICE).type


def _check_op(op: str, batch: int) -> None:
    if op not in ("ata", "gemm_tn", "solve"):
        raise ValueError(f"unknown op {op!r}; use 'ata', 'gemm_tn' or 'solve'")
    if op == "solve" and batch:
        raise ValueError(f"op='solve' plans are unbatched (lstsq is 2-D); got batch={batch}")


def warm(specs, *, cache_file: Optional[str] = None) -> list:
    """Resolve many plan keys into the memo with ONE read of the cache file.

    ``specs``: dicts of :func:`plan` keyword arguments (``op``, ``m``,
    ``n``, and optionally ``k``, ``batch``, ``dtype``, ``out``,
    ``backend``, ``devices``, ``row_devices``). Each resolves against the
    file (persisted plan → ``source='cache'``) or the analytic model.
    Returns the Plans in spec order; a key already memoized keeps its plan
    (``warm_memo``) — warm never clobbers.
    """
    persisted = load_cache(cache_file)
    resolved_plans = []
    for spec in specs:
        kw = dict(spec)
        op = kw.pop("op", "ata")
        m, n = kw.pop("m"), kw.pop("n")
        k = kw.pop("k", None)
        k = n if k is None else k
        batch = kw.pop("batch", 0)
        _check_op(op, batch)
        dtype = kw.pop("dtype", "float32")
        out = kw.pop("out", "dense")
        backend = kw.pop("backend", None) or _default_backend()
        devices = kw.pop("devices", 1)
        row_devices = kw.pop("row_devices", 1)
        if kw:
            raise TypeError(f"warm spec has unknown keys {sorted(kw)}")
        key = plan_key(op, m, n, k, batch, dtype, out, backend, devices, row_devices)
        hit = persisted.get(key)
        if hit is not None:
            metrics.inc("tune.cache.warm_hit")
            resolved = dataclasses.replace(hit, source="cache")
        else:
            metrics.inc("tune.cache.warm_miss")
            resolved = cost.analytic_plan(op, m, n, k, batch=batch, dtype=dtype, out=out,
                                          backend=backend, devices=devices,
                                          row_devices=row_devices)
        memo_key = (key, cache_file, False)
        with _LOCK:
            if memo_key in _MEMO:
                metrics.inc("tune.cache.warm_memo")
                resolved = _MEMO[memo_key]
            else:
                _MEMO[memo_key] = resolved
        resolved_plans.append(resolved)
    return resolved_plans


# the reference's serve layer's name for the same operation
cache_prefetch = warm


def plan(
    op: str = "ata",
    *,
    m: int,
    n: int,
    k: Optional[int] = None,
    batch: int = 0,
    dtype: str = "float32",
    out: str = "dense",
    backend: Optional[str] = None,
    devices: int = 1,
    row_devices: int = 1,
    autotune: bool = False,
    cache_file: Optional[str] = None,
) -> cost.Plan:
    """The front door: one frozen Plan for a dispatch.

    Args:
      op: ``'ata'`` (``AᵀA``), ``'gemm_tn'`` (``AᵀB``) or ``'solve'`` (the
        normal equations of ``repro_torch.solve.lstsq``; the plan carries
        ``method``).
      m, n, k: A is ``(m, n)``, B is ``(m, k)``; k defaults to n and is the
        RHS count for ``op='solve'``.
      batch: leading batch size (0 = unbatched).
      dtype: ``'float32'``, ``'bfloat16'`` or ``'float64'``
        (``repro_torch.backend.planner_key`` gives it for a tensor).
      out: ``'dense'`` or ``'packed'``.
      backend: ``'cuda'`` or ``'cpu'``; None is the device type of
        ``backend.DEFAULT_DEVICE`` (``'cuda'``). The front doors pass their
        operand's.
      devices: task-axis size of the distributed schedules (the plan then
        carries the stripe grid ``nb``/``tile_w``).
      row_devices: row-axis size of the two-level mesh; over more than one
        rank the plan carries the interleaving ``comm_schedule`` priced by
        the α-β model against the per-device memory budget.
      autotune: time the candidates on this process's device instead of
        trusting the model; the winner persists to the cache file.
        Single-device only: with ``devices > 1`` the plan stays analytic.
      cache_file: cache path override (default: :func:`cache_path`).
    """
    _check_op(op, batch)
    backend = backend or _default_backend()
    k = n if k is None else k
    key = plan_key(op, m, n, k, batch, dtype, out, backend, devices, row_devices)
    memo_key = (key, cache_file, autotune)

    with _LOCK:
        hit = _MEMO.get(memo_key)
    if hit is not None:
        metrics.inc("tune.cache.memo_hit")
        return hit

    measured_now = False
    persisted = load_cache(cache_file).get(key)
    if persisted is not None and (persisted.source == "measured" or not autotune):
        metrics.inc("tune.cache.hit")
        resolved = dataclasses.replace(persisted, source="cache")
    elif autotune and devices == 1:
        from repro_torch.tune import search

        metrics.inc("tune.cache.autotuned")
        resolved = search.autotune(op, m, n, k, batch=batch, dtype=dtype, out=out,
                                   backend=backend, devices=devices, row_devices=row_devices)
        plans = load_cache(cache_file)
        plans[key] = resolved
        save_cache(plans, cache_file)
        measured_now = True
    else:
        # a distributed request with autotune lands here too: the autotuner
        # times the single-device op, which says nothing of the schedule
        metrics.inc("tune.cache.miss")
        resolved = cost.analytic_plan(op, m, n, k, batch=batch, dtype=dtype, out=out,
                                      backend=backend, devices=devices, row_devices=row_devices)

    with _LOCK:
        _MEMO[memo_key] = resolved
        if measured_now:
            # the cache file changed: default dispatches of this process
            # see the measured plan, as a fresh process reading it would
            _MEMO[(key, cache_file, False)] = resolved
    return resolved
