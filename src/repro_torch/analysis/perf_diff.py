"""Perf diffing: dry-run artifacts, and fresh-vs-committed BENCH rows
(port of ``repro.analysis.perf_diff``).

Dry-run mode (CLI):

    PYTHONPATH=src python -m repro_torch.analysis.perf_diff \
        results/dryrun/cmd__decode_32k__single.json \
        results/dryrun/cmd__decode_32k__single__bf16.json \
        --hypothesis "serving params in bf16 halves the memory term"

Bench mode (:func:`bench_diff` / :func:`print_bench_diff`): compare the
rows a benchmark module just produced against a committed baseline,
**report-only**: a regression prints a table line, it never fails the run.
Rows are matched by ``name``; the baseline's backend metadata is shown
when it differs, because a seconds delta across different machines is
noise, not signal.

Departure from the reference: ``_META_KEYS`` names ``torch_version``
where the reference names ``jax_version``: the port's rows record the
PyTorch that ran them. A dry-run record is priced by
``analysis.roofline.compose_cell``, at that module's rates (an NVIDIA
H100's).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.analysis.roofline import compose_cell

_META_KEYS = ("backend", "device_kind", "torch_version", "interpret")


def bench_diff(baseline_rows, fresh_rows):
    """Match BENCH rows by name; return diff records (fresh order).

    Each record: ``{name, base_s, new_s, delta_pct, meta_changed}`` —
    ``base_s``/``delta_pct`` are ``None`` for rows with no baseline (new
    benchmarks), ``meta_changed`` lists the backend-metadata keys on which
    the two rows disagree (absent key ≠ mismatch: pre-metadata baselines
    stay comparable).
    """
    base = {
        r["name"]: r
        for r in baseline_rows
        if isinstance(r, dict) and "name" in r and "seconds" in r
    }
    out = []
    for r in fresh_rows:
        if not isinstance(r, dict) or "name" not in r or "seconds" not in r:
            continue
        b = base.get(r["name"])
        rec = {
            "name": r["name"],
            "base_s": b["seconds"] if b else None,
            "new_s": r["seconds"],
            "delta_pct": None,
            "meta_changed": [],
        }
        if b and b["seconds"]:
            rec["delta_pct"] = (r["seconds"] - b["seconds"]) / b["seconds"] * 100.0
            rec["meta_changed"] = [
                k for k in _META_KEYS
                if k in b and k in r and b[k] != r[k]
            ]
        out.append(rec)
    return out


def print_bench_diff(key, records, print_fn=print):
    """Render :func:`bench_diff` records as a report-only table."""
    if not records:
        return
    print_fn(f"# perf diff vs committed BENCH_{key}.json (report-only)")
    print_fn("# name | baseline_us | fresh_us | delta | note")
    for r in records:
        if r["base_s"] is None:
            print_fn(f"# {r['name']} | - | {r['new_s']*1e6:.1f} | NEW | ")
            continue
        note = ",".join(r["meta_changed"])
        if note:
            note = f"metadata changed: {note}"
        # delta is None for a zero-seconds baseline (marker rows)
        delta = "n/a" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}%"
        print_fn(
            f"# {r['name']} | {r['base_s']*1e6:.1f} | {r['new_s']*1e6:.1f} "
            f"| {delta} | {note}"
        )


def summarize(rec):
    row = compose_cell(rec)
    mem = rec["artifacts"]["main"]["memory"]
    return {
        "compute_s": row["compute_s"],
        "memory_s": row["memory_s"],
        "collective_s": row["collective_s"],
        "dominant": row["dominant"],
        "roofline_fraction": row["roofline_fraction"],
        "useful_flop_ratio": row["useful_flop_ratio"],
        "peak_gib": mem.get("peak_bytes_est", 0) / 2**30,
        "coll_bytes": row["collective_bytes_per_dev"],
    }


def fmt_delta(a, b):
    if a == 0:
        return "n/a"
    return f"{(b - a) / a * 100:+.1f}%"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--hypothesis", default="")
    args = ap.parse_args(argv)
    with open(args.before) as f:
        b = summarize(json.load(f))
    with open(args.after) as f:
        a = summarize(json.load(f))
    print(f"**Hypothesis**: {args.hypothesis}")
    print("| term | before | after | Δ |")
    print("|---|---|---|---|")
    for k in ("compute_s", "memory_s", "collective_s"):
        print(f"| {k} | {b[k]:.4f} | {a[k]:.4f} | {fmt_delta(b[k], a[k])} |")
    print(f"| peak GiB/dev | {b['peak_gib']:.2f} | {a['peak_gib']:.2f} | "
          f"{fmt_delta(b['peak_gib'], a['peak_gib'])} |")
    print(f"| roofline frac | {b['roofline_fraction']:.4f} | "
          f"{a['roofline_fraction']:.4f} | "
          f"{fmt_delta(b['roofline_fraction'], a['roofline_fraction'])} |")
    print(f"| dominant | {b['dominant']} | {a['dominant']} | |")


if __name__ == "__main__":
    main()
