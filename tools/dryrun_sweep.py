"""Trace every (arch × shape) cell of the production meshes with the port's
dry-run, a few cells at a time, and print the sweep tables.

    PYTHONPATH=src python3 tools/dryrun_sweep.py [--mesh both] [--workers 6]
        [--device cuda] [--out results/dryrun] [--no-analysis] [--timeout 900]

``--mesh`` is ``single`` (16×16), ``multi`` (2×16×16) or ``both`` (the
default: every cell of one mesh, then of the other, one table each).

Each cell is one ``python -m repro_torch.launch.dryrun --arch A --shape S``
process (rank 0 on fake tensors over the fake process group: nothing is
allocated on the device); its record lands in ``--out``. The table gives,
for each cell: its status, the peak bytes a rank against an H100's 80 GB,
the useful-flop ratio and the dominant roofline term
(``analysis.roofline.compose_cell``, H100 data-sheet rates), the seconds
of the main trace and of the whole process; then the dry-run table of
``analysis.fill_experiments``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CARD_BYTES = 80e9   # one H100's memory (data sheet)


def _run(cell, args):
    arch, shape, mesh = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--device", args.device, "--out", args.out]
    if args.no_analysis:
        cmd.append("--no-analysis")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=args.timeout)
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-1:]
        code = proc.returncode
    except subprocess.TimeoutExpired:
        tail, code = [f"killed after {args.timeout} s"], None
        # a cell cut by the time limit is an error row of the tables
        with open(os.path.join(args.out, f"{arch}__{shape}__{mesh}.json"), "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh, "mode": "-",
                       "variant_tag": "", "status": "error", "error": tail[0],
                       "wall_s": args.timeout}, f)
    print(f"{arch} × {shape} × {mesh}: exit {code} in {time.perf_counter() - t0:.1f} s; {tail}",
          flush=True)


def sweep_table(recs) -> str:
    """One row a cell: peak a rank against the card, useful-flop ratio,
    dominant term, trace seconds of ``main``, the process's seconds."""
    from repro_torch.analysis.roofline import compose_cell

    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    lines = ["| arch | shape | status | peak GiB / rank | fits 80 GB | useful-flop ratio | "
             "dominant | trace s | wall s |", "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        if r["status"] != "ok":
            why = r.get("reason") or r.get("error", "")
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']}: {why[:70]} | - | - | - "
                         f"| - | - | {r.get('wall_s', '-')} |")
            continue
        row = compose_cell(r)
        main = r["artifacts"]["main"]
        peak = main["memory"]["peak_bytes_est"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {peak / 2**30:.2f} | "
            f"{'yes' if peak < CARD_BYTES else 'no'} | {row['useful_flop_ratio']:.4f} | "
            f"{row['dominant']} | {main['trace_s']:.1f} | {r['wall_s']} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    from repro_torch.analysis.fill_experiments import dryrun_table
    from repro_torch.analysis.roofline import load_cells
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a cell")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(arch, shape, mesh) for mesh in meshes for arch in sorted(ARCHS)
             for shape in SHAPES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.workers) as pool:
        for f in [pool.submit(_run, c, args) for c in cells]:
            f.result()
    print(f"swept {len(cells)} cells in {time.perf_counter() - t0:.1f} s with "
          f"{args.workers} workers")
    for mesh in meshes:
        recs = [r for r in load_cells(args.out) if r["mesh"] == mesh]
        table = sweep_table(recs)
        print(f"mesh {mesh}:")
        print(table)
        print(dryrun_table(recs))
        with open(os.path.join(args.out, f"sweep_{mesh}.md"), "w") as f:
            f.write(table)


if __name__ == "__main__":
    main()
