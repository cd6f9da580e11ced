"""Inject dry-run + roofline tables into EXPERIMENTS.md (port of
``repro.analysis.fill_experiments``).

    PYTHONPATH=src python -m repro_torch.analysis.fill_experiments \
        --dryrun results/dryrun --experiments EXPERIMENTS.md

Departure: the dry-run table's "compile s" column is "trace s", the seconds
the port's dry-run took to trace the cell's main artifact on fake tensors
(there is no compile).
"""

from __future__ import annotations

import argparse
import re

from repro_torch.analysis.roofline import compose_cell, load_cells, render_markdown

__all__ = ["dryrun_table", "main"]


def dryrun_table(recs) -> str:
    hdr = ("| arch | shape | mesh | status | peak GiB/dev | trace s | "
           "collective schedule (per-dev MB: AR/AG/RS/A2A/CP) |\n"
           "|---|---|---|---|---|---|---|\n")
    lines = []
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(recs, key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"])):
        if r.get("variant_tag") or r.get("mode") == "gram":
            continue
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"skipped (documented) | - | - | - |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** | - | - | "
                f"{r.get('error','')[:80]} |"
            )
            continue
        a = r["artifacts"]["main"]
        mem = a["memory"].get("peak_bytes_est", 0) / 2**30
        c = a["collectives"]
        coll = "/".join(
            f"{c.get(k, 0)/2**20:.0f}"
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute")
        )
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{mem:.2f} | {a['trace_s']:.0f} | {coll} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun")
    ap.add_argument("--experiments", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)

    recs = load_cells(args.dryrun)
    recs_main = [r for r in recs if not r.get("variant_tag")]
    dr_table = dryrun_table(recs_main)
    rows = [compose_cell(r) for r in recs_main]
    rf_table = render_markdown([r for r in rows if r])

    with open(args.experiments) as f:
        text = f.read()
    text = re.sub(
        r"<!-- DRYRUN_TABLE -->.*?(?=\n## |\Z)",
        "<!-- DRYRUN_TABLE -->\n" + dr_table + "\n",
        text, flags=re.S,
    )
    text = re.sub(
        r"<!-- ROOFLINE_TABLE -->.*?(?=\n## |\Z)",
        "<!-- ROOFLINE_TABLE -->\n" + rf_table + "\n",
        text, flags=re.S,
    )
    with open(args.experiments, "w") as f:
        f.write(text)
    ok = sum(1 for r in recs_main if r["status"] == "ok")
    skip = sum(1 for r in recs_main if r["status"] == "skipped")
    err = sum(1 for r in recs_main if r["status"] == "error")
    print(f"EXPERIMENTS.md updated: {ok} ok, {skip} skipped, {err} errors")


if __name__ == "__main__":
    main()
