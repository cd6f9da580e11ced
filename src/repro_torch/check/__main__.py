"""CLI: ``python -m repro_torch.check`` — the contract gate of the port.

Traces the canonical plan grid on fake tensors (or, with
``--distributed``, the schedules of a gloo world of ranks; with
``--serve``, the server's bucket programs and a warmed steady-state loop),
runs the rule registry over every artifact, prints a summary, optionally
writes the JSON report (schema ``repro.check/v1``), and exits nonzero on
any unallowlisted error-severity finding.

It runs on the card: the grid traces fake CUDA tensors planned on the
``cuda_h100`` machine, and without a card it exits 2 unless ``--device
cpu`` asks for the CPU (the reference's ``cpu`` machine and the kernels'
plain versions). ``--lower`` is accepted and not applicable: the port
compiles no HLO.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static contract checks over traced plan artifacts.")
    ap.add_argument("--json", metavar="PATH", help="write the repro.check/v1 JSON report here")
    ap.add_argument("--quick", action="store_true",
                    help="three-artifact smoke subset instead of the grid")
    ap.add_argument("--distributed", action="store_true",
                    help="check the distributed schedules on a gloo world of ranks")
    ap.add_argument("--serve", action="store_true",
                    help="check the serve bucket programs + zero recaptures")
    ap.add_argument("--lower", action="store_true",
                    help="not applicable: the port compiles no HLO (accepted, ignored)")
    ap.add_argument("--rules", metavar="IDS", help="comma-separated rule ids (default: all)")
    ap.add_argument("--list", action="store_true", dest="list_rules",
                    help="list registered rules and exit")
    ap.add_argument("--device", default=None,
                    help="device to trace for (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.check import harness, rules

    if args.list_rules:
        for rid in rules.rule_ids():
            r = rules.REGISTRY[rid]
            first = r.doc.splitlines()[0] if r.doc else ""
            print(f"{rid:20s} [{r.severity}] {first}")
        return 0

    import torch

    from repro_torch.backend import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.check: no CUDA card; pass --device cpu to check the CPU path",
              file=sys.stderr)
        return 2
    ids = args.rules.split(",") if args.rules else None
    if args.distributed:
        report = harness.run_distributed(verbose=True, device=device)
    elif args.serve:
        report = harness.run_serve(verbose=True, device=device)
    else:
        report = harness.run_grid(rules=ids, lower=args.lower, quick=args.quick,
                                  verbose=True, device=device)
    print(report.summary())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=1, sort_keys=True)
        print(f"report written to {args.json}")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
