"""Process-local counters / gauges / histograms with JSON snapshot export
(port of ``repro.obs.metrics``).

The registry is **always on**: counters are plain integers behind one
lock, incremented on the host at dispatch time (never inside a kernel), so
they cost nanoseconds and change nothing a call computes. What
``obs.enable()`` gates is the tracing half (spans) and the calibration
timing, both of which do real work.

PyTorch runs eagerly, so a counter counts calls as they run: e.g.
``kernels.launch.syrk`` is the number of ``ops.syrk`` calls, on the card or
on the CPU (``repro_torch.kernels.ops.launches`` counts the CUDA launches
alone).

Naming convention (dotted, lowercase), as in the reference:

    tune.cache.*       plan-cache hits/misses/migrations/sanitizations
    tune.autotune.*    trials, wins, win-margin histogram
    dispatch.<op>.*    dispatches per leaf dispatch / method
    <op>.leaves.*      leaf counts per dispatch
    kernels.launch.*   kernel wrapper calls
    solve.*            solver front-door counters
    collective_bytes.* per-kind collective payload (via record_collective_bytes)
    collective_seconds.* per-kind collective seconds, with tracing on (histograms)

The reference's ``record_collective_bytes`` reads the payload from a
compiled XLA module's text; the port's collectives run eagerly, so its
wrappers (``repro_torch.launch.collectives``) hand it the bytes of each
call's result by kind.

Snapshot schema (``SNAPSHOT_SCHEMA``, the reference's): see
:func:`snapshot` / :func:`validate_snapshot`.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional

import torch

__all__ = [
    "inc",
    "set_gauge",
    "observe",
    "get",
    "counters",
    "gauges",
    "histograms",
    "snapshot",
    "validate_snapshot",
    "export_json",
    "record_collective_bytes",
    "reset",
    "SNAPSHOT_SCHEMA",
]

SNAPSHOT_SCHEMA = "repro.obs/v1"

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_GAUGES: Dict[str, float] = {}
_HISTS: Dict[str, dict] = {}   # name -> {count, sum, min, max}


def inc(name: str, value: int = 1) -> None:
    """Add ``value`` to counter ``name`` (created at 0)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(value)


def set_gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to the latest value."""
    with _LOCK:
        _GAUGES[name] = float(value)


def observe(name: str, value: float) -> None:
    """Record one sample into histogram ``name`` (count/sum/min/max)."""
    v = float(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            _HISTS[name] = {"count": 1, "sum": v, "min": v, "max": v}
        else:
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)


def get(name: str, default: int = 0) -> int:
    """Current value of counter ``name``."""
    with _LOCK:
        return _COUNTERS.get(name, default)


def counters(prefix: str = "") -> Dict[str, int]:
    with _LOCK:
        return {k: v for k, v in _COUNTERS.items() if k.startswith(prefix)}


def gauges(prefix: str = "") -> Dict[str, float]:
    with _LOCK:
        return {k: v for k, v in _GAUGES.items() if k.startswith(prefix)}


def histograms(prefix: str = "") -> Dict[str, dict]:
    with _LOCK:
        return {k: dict(v) for k, v in _HISTS.items() if k.startswith(prefix)}


def reset() -> None:
    """Clear every registered metric. Spans and calibration rows have their
    own ``reset`` in their modules."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()


def record_collective_bytes(by_kind: dict, prefix: str = "collective_bytes") -> dict:
    """Fold per-kind collective bytes into the registry: counter
    ``<prefix>.<kind>`` += bytes for each kind (``"all-reduce"``,
    ``"reduce-scatter"``, ``"all-gather"``, the reference's HLO names).
    Returns the nonzero kinds, as the reference's does."""
    by_kind = {k: int(v) for k, v in by_kind.items() if v}
    for kind, b in by_kind.items():
        inc(f"{prefix}.{kind}", b)
    return by_kind


def _meta() -> dict:
    """Runtime identity stamped on snapshots: the torch version, the
    backend (``"cuda"`` where a card is visible, else ``"cpu"``) and the
    device name."""
    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "torch_version": torch.__version__,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


def snapshot() -> dict:
    """One JSON-serializable view of everything observed this process:
    metrics, span counts (``trace``) and calibration rows (``calibrate``)."""
    from repro_torch.obs import calibrate, trace

    return {
        "schema": SNAPSHOT_SCHEMA,
        "meta": _meta(),
        "counters": counters(),
        "gauges": gauges(),
        "histograms": histograms(),
        "spans": trace.span_counts(),
        "calibration": calibrate.rows(),
    }


def validate_snapshot(d: dict) -> dict:
    """Schema check for :func:`snapshot` output. Raises ``ValueError`` on
    any violation; returns ``d`` unchanged."""
    if not isinstance(d, dict):
        raise ValueError(f"snapshot must be a dict, got {type(d).__name__}")
    if d.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"snapshot schema {d.get('schema')!r} != {SNAPSHOT_SCHEMA!r}")
    for section, typ in (
        ("meta", dict), ("counters", dict), ("gauges", dict),
        ("histograms", dict), ("spans", dict), ("calibration", list),
    ):
        if not isinstance(d.get(section), typ):
            raise ValueError(f"snapshot[{section!r}] must be {typ.__name__}")
    for k, v in d["counters"].items():
        if not isinstance(k, str) or not isinstance(v, int):
            raise ValueError(f"counter {k!r}: {v!r} is not a str->int entry")
    for k, v in d["histograms"].items():
        missing = {"count", "sum", "min", "max"} - set(v)
        if missing:
            raise ValueError(f"histogram {k!r} missing fields {sorted(missing)}")
    for row in d["calibration"]:
        missing = {"key", "op", "backend", "predicted_s", "measured_s"} - set(row)
        if missing:
            raise ValueError(f"calibration row missing fields {sorted(missing)}")
    return d


def export_json(path: str, extra: Optional[dict] = None) -> str:
    """Write the validated snapshot (plus optional extra top-level keys)
    to ``path``; returns the path."""
    snap = validate_snapshot(snapshot())
    if extra:
        snap = {**snap, **extra}
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    return path
