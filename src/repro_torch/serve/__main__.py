"""CLI: ``python -m repro_torch.serve`` — warm, smoke, and workload replay
(port of ``python -m repro.serve``).

    python -m repro_torch.serve --warm             # pre-warm the smoke lattice
    python -m repro_torch.serve --smoke            # the CI serve-smoke contract
    python -m repro_torch.serve --replay spec.json # run a recorded workload

The server runs on the card unless ``--device cpu`` is given. ``--smoke``
is the CI gate: it warms the shared smoke lattice (``engine.smoke_config``),
replays a deterministic mixed workload (``--requests``, default 100) of
ragged lstsq/whiten shapes through the queue, then **fails loudly**
(nonzero exit) unless every contract holds:

* every admitted request completed (drain leaves nothing behind),
* zero steady-state recaptures (``serve.retraces == 0``),
* a per-request bitwise parity spot-check against ``solve.lstsq`` under
  the request twin of the bucket plan, on the server's device,
* the obs snapshot validates and carries ``serve.*`` counters and the
  published percentile gauges.

A replay spec is JSON: ``{"seed": 0, "requests": [{"op", "m", "n", "r",
"ridge"?, "deadline_s"?}, ...], "buckets": [BucketSpec.to_json(), ...]?}``
— request *data* is generated from the seed (the spec records shapes and
knobs, not payloads). Omitted ``buckets`` means the smoke lattice.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _mixed_workload(n_requests: int, seed: int):
    """The deterministic smoke workload: ragged shapes spanning every
    smoke bucket, vector and matrix RHS, mixed ridges."""
    shapes = [
        # (op, m, n, r, ridge)  — r=0 means a 1-D (vector) rhs
        ("lstsq", 40, 32, 3, 0.0),
        ("lstsq", 48, 32, 4, 1e-3),
        ("lstsq", 90, 64, 8, 0.0),
        ("lstsq", 96, 64, 5, 1e-2),
        ("whiten", 48, 32, 4, 0.0),
        ("lstsq", 33, 32, 0, 0.0),
        ("lstsq", 64, 64, 2, 1e-3),
        ("whiten", 41, 32, 2, 1e-3),
    ]
    rng = np.random.default_rng(seed)
    for i in range(n_requests):
        op, m, n, r, ridge = shapes[i % len(shapes)]
        yield _make_request(rng, op, m, n, r, ridge)


def _make_request(rng, op, m, n, r, ridge, deadline_s=None, dtype="float32"):
    from repro_torch.serve.queue import Request

    a = rng.standard_normal((m, n)).astype(dtype)
    rows = m if op == "lstsq" else n
    b = (rng.standard_normal((rows,)).astype(dtype) if r == 0
         else rng.standard_normal((rows, r)).astype(dtype))
    return Request(op=op, a=a, b=b, ridge=ridge, deadline_s=deadline_s)


def _parity_spot_check(server, served, sample_every=7):
    """Bitwise-compare a sample of served lstsq tickets against the
    per-request reference on the server's device. Returns (checked,
    failures)."""
    import torch

    from repro_torch.solve import lstsq as solve_lstsq

    checked, failures = 0, []
    for i, ticket in enumerate(served):
        if ticket.request.op != "lstsq" or i % sample_every:
            continue
        req = ticket.request
        m = req.a.shape[0]
        r = 1 if req.b.ndim == 1 else req.b.shape[-1]
        twin = server.request_twin(ticket.bucket, m, r)
        ref = solve_lstsq(torch.as_tensor(req.a, device=server.device),
                          torch.as_tensor(req.b, device=server.device),
                          ridge=req.ridge, plan=twin).cpu().numpy()
        got = ticket.result()
        checked += 1
        if not (np.asarray(ref) == np.asarray(got)).all():
            failures.append(
                f"ticket {ticket.id} ({ticket.bucket.label()}, m={m}, r={r})"
                f" max|Δ|={np.abs(np.asarray(ref) - np.asarray(got)).max():.3e}")
    return checked, failures


def _run_workload(server, requests):
    """Submit every request; returns (served tickets, rejected count)."""
    from repro_torch.serve.queue import Rejected

    served, rejected = [], 0
    for req in requests:
        try:
            served.append(server.submit(req))
        except Rejected:
            rejected += 1
    server.drain()
    return served, rejected


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Gram-as-a-service: plan-keyed micro-batching solve server.")
    ap.add_argument("--warm", action="store_true",
                    help="pre-warm the lattice (plans + captures) and report")
    ap.add_argument("--smoke", action="store_true",
                    help="the CI contract: warm + mixed workload + checks")
    ap.add_argument("--replay", metavar="SPEC.json",
                    help="run a recorded workload spec")
    ap.add_argument("--requests", type=int, default=100,
                    help="smoke workload size (default 100)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", metavar="PATH",
                    help="write the serve report JSON here")
    ap.add_argument("--device", default=None,
                    help="device of the server (default: repro_torch.backend.DEFAULT_DEVICE)")
    args = ap.parse_args(argv)
    if not (args.warm or args.smoke or args.replay):
        ap.error("pick one of --warm / --smoke / --replay")

    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import metrics as serve_metrics
    from repro_torch.serve.bucketing import BucketLattice, BucketSpec
    from repro_torch.serve.engine import Server, smoke_config

    cfg = smoke_config()
    replay_spec = None
    if args.replay:
        with open(args.replay) as f:
            replay_spec = json.load(f)
        if replay_spec.get("buckets"):
            import dataclasses

            buckets = tuple(BucketSpec.from_json(d)
                            for d in replay_spec["buckets"])
            BucketLattice(buckets)  # validate before serving
            cfg = dataclasses.replace(cfg, buckets=buckets)

    server = Server(cfg, device=args.device)
    print(f"warming {len(cfg.buckets)} buckets on {server.device} ...", flush=True)
    warm_report = server.warm(verbose=True)
    print(f"warm total: {sum(warm_report.values()):.2f}s", flush=True)

    failures = []
    served = []
    rejected = 0
    parity_checked = 0
    reqs = []
    if args.smoke:
        reqs = list(_mixed_workload(args.requests, args.seed))
        served, rejected = _run_workload(server, reqs)
        parity_checked, parity_failures = _parity_spot_check(server, served)
        failures += parity_failures
        if parity_checked == 0:
            failures.append("parity spot-check covered zero requests")
    elif args.replay:
        rng = np.random.default_rng(replay_spec.get("seed", args.seed))
        reqs = [
            _make_request(rng, d["op"], d["m"], d["n"], d.get("r", 1),
                          d.get("ridge", 0.0), d.get("deadline_s"),
                          d.get("dtype", "float32"))
            for d in replay_spec["requests"]
        ]
        served, rejected = _run_workload(server, reqs)

    if args.smoke or args.replay:
        not_done = [t.id for t in served if not t.done()]
        if not_done:
            failures.append(f"{len(not_done)} tickets never served: {not_done[:5]}")
        if server.retraces():
            failures.append(f"steady state rebuilt or recaptured {server.retraces()} times")
        gauges = serve_metrics.publish_percentiles()
        try:
            snap = obs_metrics.validate_snapshot(obs_metrics.snapshot())
            if not any(k.startswith("serve.") for k in snap["counters"]):
                failures.append("obs snapshot carries no serve.* counters")
            if not any(k.startswith("serve.latency.") for k in snap["gauges"]):
                failures.append("obs snapshot carries no serve latency gauges")
        except ValueError as e:
            failures.append(f"obs snapshot invalid: {e}")
        summary = serve_metrics.percentiles("request") or {}
        print(f"served {len(served)} requests ({rejected} rejected), "
              f"{server.retraces()} recaptures, parity {parity_checked} checked")
        if summary:
            print("request latency: "
                  + ", ".join(f"{k}={summary[k]*1e3:.2f}ms"
                              for k in ("p50", "p95", "p99")))
        del gauges

    if args.out:
        report = {
            "schema": "repro.serve/v1",
            "mode": ("smoke" if args.smoke else
                     "replay" if args.replay else "warm"),
            "warm_seconds": warm_report,
            "served": len(served),
            "rejected": rejected,
            "parity_checked": parity_checked,
            "failures": failures,
            "stats": server.stats(),
        }
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True, default=float)
        print(f"report written to {args.out}")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("serve smoke OK" if args.smoke else "ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
