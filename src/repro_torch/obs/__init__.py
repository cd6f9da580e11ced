"""``repro_torch.obs`` — observability of the port (port of ``repro.obs``).

Three small modules, one switch:

* :mod:`repro_torch.obs.trace` — nestable **spans** naming recursion
  levels, batched/fused leaf launches, kernel wrappers and the solve front
  door. Disabled (the default) they are strict no-ops; enabled
  (``REPRO_OBS=1`` or :func:`enable`) they record events and wrap regions
  in ``torch.profiler.record_function`` and NVTX ranges.
* :mod:`repro_torch.obs.metrics` — always-on process-local counters /
  gauges / histograms (dispatches, leaf counts, kernel wrapper calls, solve
  iterations) with a validated JSON snapshot under the reference's schema
  ``repro.obs/v1``.
* :mod:`repro_torch.obs.calibrate` — predicted-vs-measured seconds per
  planned dispatch: with obs enabled, every call that carries a plan with
  a prediction (each unpinned ``ata``/``strassen_tn``/``lstsq`` call, and
  each autotuner trial) times itself, synchronising its result's device,
  and records a row.

    from repro_torch import obs
    obs.enable()
    c = ata(a, out="packed")            # spans + dispatch counters + a row
    snap = obs.metrics.snapshot()       # JSON-ready; obs.report() for text

Smoke entry point: ``python -m repro_torch.obs [--device cpu] [--out
PATH]`` runs one planned ``plan → ata → lstsq`` with tracing on, checks
the snapshot and writes it (``obs/__main__.py``).
"""

from __future__ import annotations

import time

import torch

from repro_torch.obs import calibrate, metrics, trace
from repro_torch.obs.trace import disable, enable, enabled, span

__all__ = [
    "trace",
    "metrics",
    "calibrate",
    "enable",
    "disable",
    "enabled",
    "span",
    "report",
    "dispatch_start",
    "dispatch_finish",
]


def report() -> str:
    """The calibration drift table (text) — see ``calibrate.report``."""
    return calibrate.report()


# ---------------------------------------------------------------------------
# dispatch-site calibration helpers (used by core.ata / core.strassen /
# solve.lstsq — the planned front doors)
# ---------------------------------------------------------------------------


def dispatch_start(plan, operand):
    """Start a calibration measurement for one planned dispatch, or return
    ``None`` when there is nothing meaningful to measure:

    * obs disabled (the common case — one branch);
    * no plan / no ``predicted_s`` on it (pinned calls, hand-built plans,
      the inner gram plan of ``lstsq``);
    * the call is being traced by ``torch.compile``, where a host clock
      measures compilation (the reference's tracer check).
    """
    if not trace.enabled():
        return None
    if plan is None or getattr(plan, "predicted_s", None) is None:
        return None
    if torch.compiler.is_compiling():
        return None
    return time.perf_counter()


def _devices(result):
    """The CUDA devices of the tensors in ``result`` (a tensor, a packed
    matrix with ``.blocks``, or a tuple or list of them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, (tuple, list)):
        return set().union(*(_devices(x) for x in result))
    blocks = getattr(result, "blocks", None)
    return _devices(blocks) if blocks is not None else set()


def dispatch_finish(plan, t0, result):
    """Close a measurement opened by :func:`dispatch_start`: wait for the
    result's devices, record the pair, hand the result back. With no
    measurement open it returns at once and synchronises nothing."""
    if t0 is None:
        return result
    for device in _devices(result):
        torch.cuda.synchronize(device)
    calibrate.record(plan, time.perf_counter() - t0)
    return result
