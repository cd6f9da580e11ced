"""``python -m repro_torch.obs [--device cpu] [--out PATH]`` — the obs smoke
run (port of ``python -m repro.obs``).

One planned ``plan → ata → lstsq`` pipeline with tracing on, on the card
unless ``--device cpu`` is given, then:

* the metrics snapshot is non-empty and schema-valid
  (``metrics.validate_snapshot``), with plan-cache (``tune.cache.*``) and
  dispatch (``dispatch.*``) counters;
* spans exist for the recursion levels of a forced-recursing batched plan
  and for the solve front door (``solve.*``);
* the calibration table holds a predicted-vs-measured row for ``ata`` and
  for ``solve``;
* the snapshot is written to ``PATH`` (default ``BENCH_obs_torch.json``)
  and the calibration drift report printed.

Exit code 0 only if every check holds; a failed check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch import obs


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs", description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="device of the operands (default: repro_torch.backend.DEFAULT_DEVICE)")
    p.add_argument("--out", default="BENCH_obs_torch.json", help="snapshot path")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    import numpy as np
    import torch

    from repro_torch import tune
    from repro_torch.backend import planner_key, resolve_device
    from repro_torch.core.ata import ata
    from repro_torch.solve.lstsq import lstsq

    device = resolve_device(args.device)
    m, n, r = 192, 96, 4
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.standard_normal((m, r)), dtype=torch.float32, device=device)
    backend, dtype = planner_key(a)

    obs.metrics.reset()
    obs.trace.reset()
    obs.calibrate.reset()
    obs.enable()
    try:
        # 1. the planner front door (plan-cache counters)
        plan = tune.plan(op="ata", m=m, n=n, dtype=dtype, out="packed", backend=backend)

        # 2. planned ata, and one forced-recursing plan so that recursion
        # levels show in the spans whatever the planner picks at this size
        gram = ata(a, out="packed")
        rec_plan = dataclasses.replace(plan, algorithm="strassen", n_base=32,
                                       leaf_dispatch="batched", source="analytic")
        gram_rec = ata(a, plan=rec_plan, out="packed")
        np.testing.assert_allclose(gram.to_dense().cpu().numpy(),
                                   gram_rec.to_dense().cpu().numpy(), rtol=2e-4, atol=2e-4)

        # 3. the planned solve front door
        x = lstsq(a, b, ridge=1e-3)
        _check(tuple(x.shape) == (n, r), f"lstsq returned shape {tuple(x.shape)}")
        snap = obs.metrics.validate_snapshot(obs.metrics.snapshot())
    finally:
        obs.disable()

    counters = snap["counters"]
    _check(bool(counters), "metrics snapshot has no counters")
    _check(any(k.startswith("tune.cache.") for k in counters),
           "no plan-cache counters in snapshot: " + ", ".join(sorted(counters)))
    _check(any(k.startswith("dispatch.") for k in counters),
           "no dispatch counters in snapshot: " + ", ".join(sorted(counters)))
    spans = snap["spans"]
    levels = {k for k in spans if ".encode.L" in k or ".rec." in k}
    _check(bool(levels), "no recursion-level spans recorded: " + ", ".join(sorted(spans)))
    _check(any(k.startswith("solve.") for k in spans), f"no solve spans: {sorted(spans)}")
    cal_ops = {row["op"] for row in snap["calibration"]}
    _check({"ata", "solve"} <= cal_ops,
           f"calibration rows cover {sorted(cal_ops)}, want ata + solve")

    obs.metrics.export_json(args.out)
    print(obs.report())
    print(f"obs smoke OK on {device}: {len(counters)} counters, {len(spans)} span names, "
          f"{len(snap['calibration'])} calibration rows -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
