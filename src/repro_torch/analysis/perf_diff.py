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

Departures from the reference:

* ``_META_KEYS`` names ``torch_version`` where the reference names
  ``jax_version``: the port's rows record the PyTorch that ran them.
* A dry-run record is the reference's artifact: XLA's cost analysis of a
  program compiled for a TPU v5e mesh (``repro.launch.dryrun``, not
  ported). :func:`summarize` prices it as the reference's
  ``roofline.compose_cell`` does, at that TPU's published rates
  (:data:`_TPU_V5E`), which describe the record's target and not the
  port's device; the port's ``analysis.roofline`` carries no such rates.
"""

from __future__ import annotations

import argparse
import json

_META_KEYS = ("backend", "device_kind", "torch_version", "interpret")

# The dry-run records' target: one TPU v5e chip (bf16 FLOP/s, HBM bytes/s,
# ICI link bytes/s) and the chips of its two meshes, as the reference's
# roofline prices them.
_TPU_V5E = {"peak_flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9,
            "chips": {"single": 256, "multi": 512}}
_COLLECTIVE_FACTORS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                       "all-to-all": 1.0, "collective-permute": 1.0}
# the reference's assigned shapes: (seq_len, global_batch)
_SHAPES = {"train_4k": (4_096, 256), "prefill_32k": (32_768, 32),
           "decode_32k": (32_768, 128), "long_500k": (524_288, 1)}


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


# ---------------------------------------------------------------------------
# dry-run records: the reference's roofline composition (roofline.compose_cell)
# ---------------------------------------------------------------------------


def _cost_vec(artifact: dict) -> dict:
    v = {
        "flops": artifact["cost"].get("flops", 0.0),
        "bytes": artifact["cost"].get("bytes_accessed", 0.0),
    }
    for k in _COLLECTIVE_FACTORS:
        v[f"coll_{k}"] = float(artifact["collectives"].get(k, 0))
    return v


def _affine(v1: dict, v2: dict, n_layers: int) -> dict:
    out = {}
    for k in v1:
        layer = max(v2[k] - v1[k], 0.0)
        fix = max(v1[k] - layer, 0.0)
        out[k] = fix + n_layers * layer
    return out


def _hybrid(vg1: dict, vgs2: dict, vss2: dict, n_g: int, n_s: int) -> dict:
    out = {}
    for k in vg1:
        f_s = max(vgs2[k] - vg1[k], 0.0)
        f_fix = max(vss2[k] - 2 * f_s, 0.0)
        f_g = max(vg1[k] - f_fix, 0.0)
        out[k] = f_fix + n_g * f_g + n_s * f_s
    return out


def _model_flops_per_device(rec: dict) -> float:
    n = rec["active_params"]
    s, b = _SHAPES[rec["shape"]]
    if rec["mode"] == "train":
        total = 6.0 * n * b * s
    elif rec["mode"] == "prefill":
        total = 2.0 * n * b * s
    else:  # decode: one token per sequence
        total = 2.0 * n * b
    return total / _TPU_V5E["chips"][rec["mesh"]]


def _compose_cell(rec: dict) -> dict:
    """The roofline terms of one dry-run record that :func:`summarize`
    reads (the reference's ``compose_cell``)."""
    arts = rec["artifacts"]
    if rec["mode"] == "decode":
        vec = _cost_vec(arts.get("analysis_unrolled", arts["main"]))
    elif "analysis_g1" in arts:  # hybrid
        n_g = len(rec.get("global_attn_layers", []))
        vec = _hybrid(_cost_vec(arts["analysis_g1"]), _cost_vec(arts["analysis_gs2"]),
                      _cost_vec(arts["analysis_ss2"]), n_g, rec["num_layers"] - n_g)
    elif "analysis_l1" in arts:
        vec = _affine(_cost_vec(arts["analysis_l1"]), _cost_vec(arts["analysis_l2"]),
                      rec["num_layers"])
    else:  # no analysis variants: raw (loop-once — undercounts)
        vec = _cost_vec(arts["main"])

    coll_bytes = {k: vec[f"coll_{k}"] for k in _COLLECTIVE_FACTORS}
    coll_s = 0.0
    for kind, b in coll_bytes.items():   # the reference's order of rounding
        coll_s += _COLLECTIVE_FACTORS[kind] * b * 1.0 / _TPU_V5E["link_bw"]
    terms = {
        "compute_s": vec["flops"] / _TPU_V5E["peak_flops"],
        "memory_s": vec["bytes"] / _TPU_V5E["hbm_bw"],
        "collective_s": coll_s,
    }
    dominant = max(terms, key=terms.get)
    mf = _model_flops_per_device(rec)
    bound = max(terms.values())
    return {
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "collective_bytes_per_dev": coll_bytes,
        "useful_flop_ratio": round(mf / vec["flops"], 4) if vec["flops"] else 0.0,
        "roofline_fraction": (round((mf / _TPU_V5E["peak_flops"]) / bound, 4)
                              if bound else 0.0),
    }


def summarize(rec):
    row = _compose_cell(rec)
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
