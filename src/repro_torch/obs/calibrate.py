"""Cost-model calibration: predicted-vs-measured seconds per plan (port of
``repro.obs.calibrate``).

Two producers feed the table:

* **dispatch sites** (``core.ata``, ``core.strassen``, ``solve.lstsq``):
  with obs enabled, a planned call times itself end to end, synchronising
  the result's device, and records ``(plan, measured)`` against the plan's
  own ``predicted_s``;
* **the autotuner** (``tune.search.autotune``): each trial's floor against
  the candidate's prediction.

``report()`` renders the drift table per machine profile (backend):
``ratio = measured / predicted`` per plan key, plus the per-profile
geometric-mean drift — the numbers to fit ``tune.cost.MACHINES`` to.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional

__all__ = [
    "record",
    "record_pair",
    "rows",
    "drift_table",
    "report",
    "reset",
    "plan_label",
    "MAX_ROWS",
]

_LOCK = threading.Lock()
_ROWS: List[dict] = []

# calibration rows are append-per-dispatch; cap them like span events so a
# long-running process with obs left on cannot grow host memory unboundedly
MAX_ROWS = 10_000


def plan_label(plan) -> str:
    """Compact human-stable identity of one dispatch configuration — the
    calibration key. Deliberately *not* the cache key: no framework
    version, no dtype-tail noise; rows from different processes of one
    machine profile aggregate. Distributed plans append the mesh pool and
    the interleaving (a BFS plan and a psum plan at one shape must not
    aggregate into one drift row)."""
    shape = f"{plan.m}x{plan.n}" + (f"x{plan.k}" if plan.k != plan.n else "")
    tail = f"|{plan.method}" if plan.method else f"|{plan.leaf_dispatch}"
    devices = getattr(plan, "devices", 1)
    row_devices = getattr(plan, "row_devices", 1)
    if devices * row_devices > 1:
        cs = getattr(plan, "comm_schedule", None)
        tail += f"|P={devices}x{row_devices}|cs={cs or 'psum'}"
    return (
        f"{plan.op}|{shape}|b={plan.batch}|{plan.algorithm}"
        f"|nb={plan.n_base}{tail}"
    )


def record_pair(
    key: str,
    op: str,
    backend: str,
    predicted_s: float,
    measured_s: float,
    source: str = "dispatch",
) -> None:
    """Append one raw calibration row (already-resolved fields)."""
    row = {
        "key": key,
        "op": op,
        "backend": backend,
        "predicted_s": float(predicted_s),
        "measured_s": float(measured_s),
        "source": source,
    }
    with _LOCK:
        if len(_ROWS) < MAX_ROWS:
            _ROWS.append(row)


def record(plan, measured_s: float, source: str = "dispatch") -> None:
    """Record one ``(plan, measured)`` pair against the plan's own
    ``predicted_s``. Silently skipped when the plan carries no prediction
    (hand-built plans; the op-retargeted inner plans of ``solve.lstsq``)
    or the measurement is non-positive."""
    pred = getattr(plan, "predicted_s", None)
    if plan is None or pred is None or pred <= 0 or measured_s <= 0:
        return
    record_pair(
        plan_label(plan), plan.op, plan.backend, pred, measured_s, source
    )


def rows() -> List[dict]:
    with _LOCK:
        return [dict(r) for r in _ROWS]


def reset() -> None:
    with _LOCK:
        _ROWS.clear()


def drift_table(backend: Optional[str] = None) -> List[dict]:
    """Aggregate rows per (backend, key): min/median-free — the mean of
    per-row ratios plus the best (minimum) measured seconds, which is the
    noise-floor convention of the reference's ``tune.search.time_ratio``.
    Sorted by descending |log ratio| (worst drift first)."""
    by_key: dict = {}
    for r in rows():
        if backend is not None and r["backend"] != backend:
            continue
        g = by_key.setdefault(
            (r["backend"], r["key"]),
            {
                "backend": r["backend"], "key": r["key"], "op": r["op"],
                "n": 0, "predicted_s": r["predicted_s"],
                "measured_s": math.inf, "_log_ratio_sum": 0.0,
            },
        )
        g["n"] += 1
        g["measured_s"] = min(g["measured_s"], r["measured_s"])
        g["_log_ratio_sum"] += math.log(r["measured_s"] / r["predicted_s"])
    out = []
    for g in by_key.values():
        g["ratio"] = math.exp(g.pop("_log_ratio_sum") / g["n"])
        out.append(g)
    out.sort(key=lambda g: -abs(math.log(g["ratio"])))
    return out


def report() -> str:
    """The drift table rendered per machine profile, with a per-profile
    geometric-mean ratio — >1 means the model is optimistic (measured
    slower than predicted), <1 pessimistic."""
    table = drift_table()
    if not table:
        return "calibration: no predicted-vs-measured pairs recorded"
    lines = []
    for backend in sorted({g["backend"] for g in table}):
        rows_b = [g for g in table if g["backend"] == backend]
        gmean = math.exp(
            sum(math.log(g["ratio"]) for g in rows_b) / len(rows_b)
        )
        lines.append(
            f"calibration [{backend}] — {len(rows_b)} plan keys, "
            f"geomean measured/predicted = {gmean:.2f}"
        )
        width = max(len(g["key"]) for g in rows_b)
        lines.append(
            f"  {'plan':<{width}}  {'pred_s':>10}  {'meas_s':>10}  "
            f"{'ratio':>7}  {'n':>3}"
        )
        for g in rows_b:
            lines.append(
                f"  {g['key']:<{width}}  {g['predicted_s']:>10.3e}  "
                f"{g['measured_s']:>10.3e}  {g['ratio']:>7.2f}  {g['n']:>3}"
            )
    return "\n".join(lines)
