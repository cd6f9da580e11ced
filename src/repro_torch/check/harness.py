"""Tracing harnesses: the canonical plan grid, the distributed sweep and
the serving layer (port of ``repro.check.harness``).

:func:`canonical_plans` enumerates the (op × algorithm × leaf_dispatch ×
out × engine × dtype) grid — all three leaf dispatches, plain and kernel
engines, dense and packed outputs, both solver methods, plus a bfloat16
row per product op so the ``acc-dtype`` rule has sub-float32 operands to
police — on the reference's shapes, so the labels are the reference's.
Shapes are rectangular (``m ≠ n ≠ k``) on purpose: several rules' shape
discriminators need the dims distinguishable, and ``n_base=32`` forces a
depth-2 ATA tree / depth-1 Strassen tree so every budget has a real
recursion to count. :func:`run_grid` traces each plan with fake tensors on
the card (or the CPU) and runs the registry.

:func:`distributed_plans` / :func:`bfsdfs_plans` / :func:`run_distributed`
are the multi-rank half: a gloo world started by ``launch.mesh.spawn``;
each rank traces its own program of the tile-parallel, rowshard and
BFS/DFS schedules with ``make_fx(..., tracing_mode="real")`` — one real
run, in which the ``c10d`` collectives are recorded as nodes and the
``collective_bytes.<kind>`` counters of ``launch/collectives.py`` count
what it moved — and checks it against the packed/structural rules plus
``collective-budget``.

:func:`run_serve` traces every bucket program of a server with fake
tensors, then serves a warmed :class:`~repro_torch.serve.engine.Server`
and holds it to zero recaptures.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.check import rules as _rules
from repro_torch.check.artifacts import Artifact, plan_label, trace_fn, trace_plan
from repro_torch.check.findings import Allow, Finding, Report

__all__ = [
    "CANONICAL_SHAPE", "DEFAULT_ALLOWLIST",
    "canonical_plans", "run_grid", "distributed_plans", "bfsdfs_plans",
    "run_distributed", "run_serve",
]

# (m, n, k): rectangular; n_base forces L=2 on the ATA tree, L=1 on the
# gemm tree; packed_block gives a real 4-stripe packed grid at n=128.
CANONICAL_SHAPE = dict(m=192, n=128, k=64, n_base=32, packed_block=32)

# Intentional violations, suppressed by policy rather than by weakening a
# rule. Empty, as the reference's: every canonical CPU artifact is clean.
DEFAULT_ALLOWLIST: List[Allow] = []

# The card's grid adds one: its solve plan takes the kernels (``cuda_h100``),
# and the trsm kernel reads the right-hand side's transpose row by row, so
# ``ops.trsm`` copies each (k, block) tile of ``cᵀ`` once (counted in
# ``kernels.copy.trsm``) — k = 64 over the 32-tile bound here. A copy of
# the right-hand side's size, never of ``A`` or the gram; the reference's
# grid traces no kernel solve.
CARD_ALLOWLIST: List[Allow] = DEFAULT_ALLOWLIST + [
    Allow(rule="no-full-transpose", artifact="solve:*:kern:*:factor",
          reason="trsm kernel reads the right-hand side transposed: one (k, block) "
                 "copy a diagonal solve, kernels.copy.trsm"),
]


def canonical_plans(backend: str = "cpu") -> List:
    """The canonical plan grid (see module docstring), its base plans from
    the ``backend`` machine of the cost model (``"cpu"``: the reference's
    machine; ``"cuda"``: ``cuda_h100``)."""
    from repro_torch.tune import cost

    m, n, k = (CANONICAL_SHAPE[d] for d in ("m", "n", "k"))
    nb, pb = CANONICAL_SHAPE["n_base"], CANONICAL_SHAPE["packed_block"]

    def mk(base, **kw):
        kw.setdefault("n_base", nb)
        kw.setdefault("packed_block", pb)
        return dataclasses.replace(base, **kw)

    ata = cost.default_plan("ata", m, n, backend=backend)
    gemm = cost.default_plan("gemm_tn", m, n, k, backend=backend)
    solve = cost.default_plan("solve", m, n, k, out="packed", backend=backend)

    plans = []
    # the product grid: all three leaf dispatches × both engines × both outs
    for uk in (False, True):
        for ld in ("unrolled", "batched", "fused"):
            for out in ("dense", "packed"):
                plans.append(mk(ata, algorithm="strassen", leaf_dispatch=ld,
                                use_kernels=uk, out=out))
            plans.append(mk(gemm, algorithm="strassen", leaf_dispatch=ld, use_kernels=uk))
    # algorithm row: the single classical dot and the winograd variant
    plans.append(mk(ata, algorithm="dense", leaf_dispatch="unrolled", use_kernels=False))
    plans.append(mk(gemm, algorithm="dense", leaf_dispatch="unrolled", use_kernels=False))
    plans.append(mk(ata, algorithm="winograd", leaf_dispatch="unrolled",
                    use_kernels=False, out="packed"))
    # bf16 row: sub-f32 operands — the acc-dtype rule's real quarry
    plans.append(mk(ata, algorithm="strassen", leaf_dispatch="unrolled",
                    use_kernels=False, dtype="bfloat16"))
    plans.append(mk(gemm, algorithm="strassen", leaf_dispatch="unrolled",
                    use_kernels=False, dtype="bfloat16"))
    # the solve path: both methods, packed-native
    plans.append(mk(solve, algorithm="strassen", method="factor"))
    plans.append(mk(solve, algorithm="strassen", method="cg"))
    return plans


def _quick_plans(backend: str = "cpu") -> List:
    """A three-artifact subset for smoke tests: one plan per op, its first
    plain-path plan (a ``cuda_h100`` solve plan takes the kernels, so on
    the card the solve's is its first plan)."""
    picks = {}
    for p in canonical_plans(backend):
        if p.op not in picks or (picks[p.op].use_kernels and not p.use_kernels):
            picks[p.op] = p
    return list(picks.values())


def run_grid(plans: Optional[Sequence] = None, *, rules: Optional[Sequence[str]] = None,
             allowlist: Optional[Sequence[Allow]] = None, lower: bool = False,
             quick: bool = False, verbose: bool = False, device=None) -> Report:
    """Trace every plan on fake tensors on ``device`` (None: the card) and
    run the registry over each artifact. The default grid is planned on
    the device's machine. ``lower`` is not applicable (no HLO)."""
    from repro_torch.backend import resolve_device

    dev = resolve_device(device)
    if plans is None:
        plans = _quick_plans(dev.type) if quick else canonical_plans(dev.type)
    if allowlist is None:
        allowlist = CARD_ALLOWLIST if dev.type == "cuda" else DEFAULT_ALLOWLIST
    report = Report(allowlist, device=str(dev))
    for plan in plans:
        if verbose:
            print(f"  tracing {plan_label(plan)}", flush=True)
        art = trace_plan(plan, lower=lower, device=dev)
        _rules.run(art, rules=rules, allowlist=report.allowlist, report=report)
    return report


# ---------------------------------------------------------------------------
# distributed sweep: a gloo world of ranks from launch.mesh.spawn
# ---------------------------------------------------------------------------

# m sized so the per-rank rowshard slab (m/4 rows) still recurses past
# the cutoff — a sub-cutoff slab is a legitimate single-leaf gram whose
# (n, n) base tile the no-dense-square rule rightly exempts.
_DIST_SHAPE = dict(m=1024, n=512, n_base=64)
_DIST_RULES = ("no-dense-square", "no-vmap-of-pallas", "acc-dtype", "collective-budget")


def distributed_plans(devices: int) -> List:
    """Tile-parallel and rowshard plans (dense + packed) for ``devices``."""
    from repro_torch.tune import cost

    m, n, nb_cut = _DIST_SHAPE["m"], _DIST_SHAPE["n"], _DIST_SHAPE["n_base"]
    # default_plan's distributed branch resolves (nb, tile_w) through the
    # same tiling search ata_tile_parallel uses internally
    return [dataclasses.replace(cost.default_plan("ata", m, n, out=out, devices=devices,
                                                  backend="cpu"),
                                algorithm="strassen", n_base=nb_cut)
            for out in ("dense", "packed")]


def bfsdfs_plans(devices: int, row_devices: int) -> List:
    """BFS/DFS plans (dense + packed) for a (row, task) 2-axis mesh: the
    top BFS-containing candidate of ``cost.candidates`` for the harness
    shape and mesh, so the artifact runs the schedule the front door would
    dispatch, and the collective-budget rule gates its one-chunk
    reduce-scatter payload."""
    from repro_torch.tune import cost

    m, n, nb_cut = _DIST_SHAPE["m"], _DIST_SHAPE["n"], _DIST_SHAPE["n_base"]
    plans = []
    for out in ("dense", "packed"):
        cands = cost.candidates("ata", m, n, out=out, devices=devices,
                                row_devices=row_devices, backend="cpu")
        top_b = next((p for p in cands if p.comm_schedule and "B" in p.comm_schedule), None)
        if top_b is not None:
            plans.append(dataclasses.replace(top_b, n_base=nb_cut))
    return plans


def _rank_program(schedule: str, plan, mesh, a):
    """This rank's callable of one schedule and the operand view it takes."""
    from repro_torch.core.distributed import ata_bfs_dfs, ata_tile_parallel, gram_rowshard

    if schedule == "tile":
        return (lambda x: ata_tile_parallel(x, mesh, task_axis="model", n_base=plan.n_base,
                                            nb=plan.nb, out=plan.out)), a
    if schedule == "bfsdfs":
        return (lambda x: ata_bfs_dfs(x, mesh, task_axis="model", row_axis="data",
                                      interleaving=plan.comm_schedule, n_base=plan.n_base,
                                      nb=plan.nb, packed_block=plan.packed_block,
                                      out=plan.out)), mesh.local_block(a, ("data", None))
    return (lambda x: gram_rowshard(x, "model", mesh=mesh, n_base=plan.n_base, out=plan.out,
                                    packed_block=plan.packed_block)), \
        mesh.local_block(a, ("model", None))


def _check_rank(rank: int, world: int, device: str):
    """One rank of :func:`run_distributed`: trace and run every schedule's
    program (``make_fx``, real mode) and check it; returns ``[(label,
    rules, findings)]`` in the order every rank runs them."""
    import numpy as np
    import torch

    from repro_torch.core.symmetric import default_block_size
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import metrics

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((_DIST_SHAPE["m"], _DIST_SHAPE["n"]),
                                            dtype=np.float32), device=dev)
    mesh = make_mesh((world,), ("model",), backend="gloo", device=dev)
    cases = []
    for plan in distributed_plans(world):
        cases.append(("tile", plan, mesh))
        if plan.m % world == 0:
            # rowshard has no stripe tiling of its own: its reduction payload
            # is the replicated result — the packed block grid; the artifact
            # is the per-rank program, so the plan carries the local rows
            bn = default_block_size(plan.n, plan.packed_block)
            cases.append(("rowshard", dataclasses.replace(
                plan, m=plan.m // world, nb=-(-plan.n // bn), tile_w=bn), mesh))
    if world >= 4 and world % 4 == 0:
        # a row axis of 4 keeps the per-rank slab (m/4 = 256 rows) apart
        # from the (n, n) square the no-dense-square rule hunts
        mesh2 = make_mesh((4, world // 4), ("data", "model"), backend="gloo", device=dev)
        cases += [("bfsdfs", plan, mesh2) for plan in bfsdfs_plans(world // 4, 4)]
    results = []
    for schedule, plan, m in cases:
        fn, view = _rank_program(schedule, plan, m, a)
        before = metrics.counters("collective_bytes.")
        graph = trace_fn(fn, view, tracing_mode="real")
        moved = {k.removeprefix("collective_bytes."): v - before.get(k, 0)
                 for k, v in metrics.counters("collective_bytes.").items()}
        art = Artifact(label=f"{schedule}:{plan_label(plan)}", graph=graph, plan=plan,
                       collective_bytes=moved)
        found = [f for rid in _DIST_RULES for f in _rules.REGISTRY[rid].fn(art)]
        results.append((art.label, list(_DIST_RULES), found))
    return results


def _merge(report: Report, label: str, ids, findings) -> None:
    """Record one artifact checked elsewhere (a rank): partition its
    findings by the report's allowlist, count them as ``rules.run`` does."""
    from repro_torch.obs import metrics

    for f in report.add(findings):
        metrics.inc(f"check.findings.{f.rule}")
        if f.severity == "error":
            metrics.inc("check.violations")
    metrics.inc("check.rules_run", len(ids))
    metrics.inc("check.artifacts")
    report.record_artifact(label, ids, len(findings))


def run_distributed(*, world: int = 4, allowlist: Optional[Sequence[Allow]] = None,
                    verbose: bool = False, device=None,
                    timeout_s: float = 300.0) -> Report:
    """Check the distributed schedules on a gloo world of ``world`` ranks
    (``launch.mesh.spawn``), each with its tensors on ``device`` (None: the
    card; gloo takes CUDA tensors too). Every rank traces and runs each
    program; the report records each artifact once, with the findings of
    every rank."""
    from repro_torch.backend import resolve_device
    from repro_torch.launch.mesh import spawn

    if world < 2:
        raise ValueError("run_distributed needs a world of 2 ranks or more")
    device = str(resolve_device(device))
    report = Report(DEFAULT_ALLOWLIST if allowlist is None else allowlist,
                    device=f"{device} x{world} (gloo)")
    ranks = spawn(_check_rank, world, backend="gloo", timeout_s=timeout_s, args=(device,))
    for i, (label, ids, _) in enumerate(ranks[0]):
        if verbose:
            print(f"  traced {label} on {world} ranks", flush=True)
        _merge(report, label, ids, [f for r in ranks for f in r[i][2]])
    return report


# ---------------------------------------------------------------------------
# serving layer
# ---------------------------------------------------------------------------


def _serve_expected_dots(spec, sp, device) -> int:
    """Closed-form count of library product nodes of one bucket program,
    the reference's batched pipeline: each stage is one batched dispatch
    whose count is the unbatched one's. The gram takes the gram plan's
    (none on the kernel path); the Cholesky walk and the substitutions
    take the solve closed form's factor band, plus for lstsq one ``Aᵀb``;
    whiten buckets take ONE substitution pass and no ``Aᵀb``. On the card
    ``Aᵀb`` and every Schur product are ``gemm_tn`` launches, no product
    node, at every ``m``.
    """
    gram_plan = dataclasses.replace(sp, op="ata", k=sp.n)
    gram = 0 if sp.use_kernels else _rules.expected_dots(gram_plan)
    if device.type == "cuda":
        return gram
    nbk = -(-sp.n // _rules._packed_bn(sp))
    band = (nbk - 1) + max(nbk - 2, 0)
    if spec.op == "lstsq":
        return gram + 1 + band + 2 * (nbk - 1)
    return gram + band + (nbk - 1)


# the serve-path rule set: the packed/structural contracts the bucket
# programs must honor (dot-budget rides the explicit override above;
# launch-budget self-gates on batched plans)
_SERVE_RULES = ("no-dense-square", "acc-dtype", "no-vmap-of-pallas", "dot-budget",
                "launch-budget")


def run_serve(*, config=None, steady_batches: int = 2, verbose: bool = False,
              device=None) -> Report:
    """Check the serve layer on ``device`` (None: the card): trace every
    bucket program of the (smoke) lattice with fake tensors against the
    packed/structural rules, then serve a warmed steady-state loop and
    assert **zero recaptures**.

    The traced program IS the program a flush runs (``Server.
    bucket_callable``'s pipeline — on the card the one its CUDA graph
    captured), on the bucket's static operands. The artifact carries the
    *batched* plan plus the ``expected_dots`` override of
    :func:`_serve_expected_dots`.

    The recapture half is dynamic by nature: a warmed :class:`Server`
    serves ``steady_batches`` full flushes per bucket; any ``serve.retraces``
    growth, or a bucket whose program was built more than once, lands as a
    ``serve-no-retrace`` finding.
    """
    import numpy as np
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.serve.engine import Server, serve_abstract_args, smoke_config
    from repro_torch.serve.queue import Request

    if config is None:
        config = smoke_config()
    server = Server(config, device=device)
    report = Report(DEFAULT_ALLOWLIST, device=str(server.device))
    for spec in server.buckets:
        if verbose:
            print(f"  tracing serve:{spec.label()}", flush=True)
        fn, sp = server.bucket_callable(spec)
        with FakeTensorMode():
            args = serve_abstract_args(spec, server.device)
        art = Artifact(label=f"serve:{spec.label()}", graph=trace_fn(fn.run, *args),
                       plan=dataclasses.replace(sp, batch=spec.batch),
                       overrides={"expected_dots": _serve_expected_dots(spec, sp,
                                                                        server.device)})
        _rules.run(art, rules=_SERVE_RULES, allowlist=report.allowlist, report=report)

    # steady state: warm, then flush full batches in counter mode (the
    # engine raises under strict_retrace; the harness wants a Finding)
    if verbose:
        print("  warming serve steady-state loop", flush=True)
    server = Server(dataclasses.replace(config, strict_retrace=False), device=device)
    server.warm()
    before = server.retraces()
    rng = np.random.default_rng(0)
    for spec in server.buckets:
        for _ in range(steady_batches):
            for _i in range(spec.batch):
                a = rng.standard_normal((spec.m, spec.n)).astype(spec.dtype)
                rows = spec.m if spec.op == "lstsq" else spec.n
                b = rng.standard_normal((rows, spec.r)).astype(spec.dtype)
                server.submit(Request(op=spec.op, a=a, b=b))
    server.drain()
    findings = []
    grew = server.retraces() - before
    rebuilt = sorted(label for label, prog in server.stats()["programs"].items()
                     if prog["builds"] != 1)
    if grew or rebuilt:
        findings.append(Finding(
            rule="serve-no-retrace",
            message=f"steady-state loop recaptured {grew} times after the warm pass; "
                    f"buckets built more than once: {rebuilt}",
            artifact="serve:steady-state"))
    report.add(findings)
    report.record_artifact("serve:steady-state", ["serve-no-retrace"], len(findings))
    return report
