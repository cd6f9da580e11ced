"""``serve.*`` telemetry: counters/gauges into ``repro_torch.obs`` plus
latency percentiles (port of ``repro.serve.metrics``).

Everything countable rides the always-on ``repro_torch.obs.metrics`` registry
under the ``serve.`` prefix (so the CI obs snapshot carries the serving
story with zero extra plumbing):

    serve.requests.accepted / .rejected.<reason> / .completed
    serve.flushes / serve.flushes.ragged
    serve.padded_slots          replicated fill slots across all flushes
    serve.padded_rows           zero rows added by m-banding
    serve.padded_cols           zero cols added by r-banding
    serve.retraces              steady-state rebuilds or recaptures (MUST stay 0)
    serve.deadline_missed       completed after their deadline
    serve.queue.depth           gauge: pending requests right now
    serve.latency.request       histogram: submit→result seconds
    serve.latency.dispatch      histogram: flush launch seconds

The obs registry's histograms carry count/sum/min/max only — enough for
means, useless for SLOs — so this module adds the missing half: a bounded
reservoir per series (last ``RESERVOIR_SIZE`` samples) from which
:func:`percentile` computes p50/p95/p99 by linear interpolation.
:func:`publish_percentiles` folds them into the obs registry as gauges
(``serve.latency.request.p95`` …), which is how they reach the snapshot
the CLI/bench validate.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _obs

__all__ = [
    "RESERVOIR_SIZE",
    "record_latency",
    "percentile",
    "percentiles",
    "latency_summary",
    "publish_percentiles",
    "samples",
    "reset",
]

# per-series sample bound: at serving rates the tail of the last 4096
# requests is the SLO window that matters; memory stays O(pages), and the
# reservoir can never grow with uptime.
RESERVOIR_SIZE = 4096

_LOCK = threading.Lock()
_RES: Dict[str, deque] = {}

# the percentile set every summary/gauge publication reports
_PCTS = (50.0, 95.0, 99.0)


def record_latency(series: str, seconds: float) -> None:
    """One latency sample: obs histogram + the local percentile reservoir.

    ``series`` is the suffix under ``serve.latency.`` — e.g. ``request``,
    ``dispatch``, or a per-bucket ``request.lstsq:m96:n64:r8:float32:b4``.
    """
    name = f"serve.latency.{series}"
    _obs.observe(name, seconds)
    with _LOCK:
        res = _RES.get(name)
        if res is None:
            res = _RES[name] = deque(maxlen=RESERVOIR_SIZE)
        res.append(float(seconds))


def samples(series: str) -> List[float]:
    with _LOCK:
        return list(_RES.get(f"serve.latency.{series}", ()))


def percentile(values: List[float], p: float) -> float:
    """Linear-interpolation percentile of ``values`` (p in [0, 100])."""
    if not values:
        return float("nan")
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def percentiles(series: str) -> Optional[Dict[str, float]]:
    """{'p50': …, 'p95': …, 'p99': …, 'count': N, 'mean': …} or None."""
    vals = samples(series)
    if not vals:
        return None
    out = {f"p{int(p)}": percentile(vals, p) for p in _PCTS}
    out["count"] = len(vals)
    out["mean"] = sum(vals) / len(vals)
    return out


def latency_summary() -> Dict[str, Dict[str, float]]:
    """Every tracked series → its percentile summary."""
    with _LOCK:
        names = list(_RES)
    prefix = "serve.latency."
    return {
        name[len(prefix):]: p
        for name in names
        if (p := percentiles(name[len(prefix):])) is not None
    }


def publish_percentiles() -> Dict[str, float]:
    """Fold current percentiles into the obs registry as gauges
    (``serve.latency.<series>.p95`` …) so they land in the snapshot the
    CLI and bench validate; returns the published {gauge: value} map."""
    published = {}
    for series, summary in latency_summary().items():
        for key in ("p50", "p95", "p99"):
            gauge = f"serve.latency.{series}.{key}"
            _obs.set_gauge(gauge, summary[key])
            published[gauge] = summary[key]
    return published


def reset() -> None:
    """Clear the local reservoirs (tests). The obs registry has its own
    ``reset`` — serving counters live there, not here."""
    with _LOCK:
        _RES.clear()
