"""The rule registry: the repo's structural invariants as machine checks
over FX graphs (port of ``repro.check.rules``).

Every rule is a function ``(Artifact) -> list[Finding]`` registered under a
stable id, the reference's eight. Rules are *self-gating*: each decides
from the artifact's plan (or ``overrides``) whether it applies, and returns
``[]`` when it doesn't — so the runner can always throw the whole registry
at every artifact.

================== ========================================================
``no-dense-square``   packed paths never materialize an ``(n, n)`` /
                      ``(n_pad, n_pad)`` square (paper Prop. 4.2's low(C)).
``no-operand-stacks`` fused dispatch never materializes a ``7``-multiple
                      leaf *operand* stack — combines live in the kernel's
                      prologue or are gathered per leaf.
``dot-budget``        the count of library product nodes (``aten.mm``,
                      ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``)
                      equals the closed form of the plain dispatch.
``launch-budget``     the count of kernel nodes (``repro_torch.*``, one
                      launch each) equals the closed form and never exceeds
                      ``cost.dispatch_calls``.
``no-full-transpose`` the TN contract: no transposed view above tile
                      granularity is materialized (it feeds ``clone``,
                      ``_to_copy`` or ``copy_``), except the one dense-ATA
                      root mirror.
``acc-dtype``         every product node stores at ≥ the plan's
                      accumulator width (float32).
``no-vmap-of-pallas`` registered for the reference's id; never fires (the
                      port batches kernels through their leading grid dim
                      and never vmaps one).
``collective-budget`` reduction-collective bytes of a real run (all-reduce
                      + reduce-scatter, per rank) stay within the
                      ``cost.retrieval_bytes`` payload the planner prices;
                      BFS-containing plans get the one-chunk budget.
================== ========================================================

Views (operators whose output aliases an input: ``view``, ``slice``,
``transpose``, ``expand``…) materialize nothing, so the shape rules skip
them and ``no-full-transpose`` follows them to the copy that does.
Override keys (``Artifact.overrides``) let plan-less call sites pin rule
parameters; each rule documents the keys it reads. Intentional violations
are suppressed through the report-level allowlist
(:class:`repro_torch.check.findings.Allow`), never by weakening a rule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.check.artifacts import Artifact, is_kernel, node_name, node_outputs
from repro_torch.check.findings import Allow, Finding, Report

__all__ = ["Rule", "REGISTRY", "rule", "run", "run_many", "rule_ids", "DOT_OPS",
           "COPY_OPS", "expected_dots", "expected_launches"]

# the library's product operators, as make_fx records them (matmul and
# einsum decompose into these)
DOT_OPS = frozenset({"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.dot",
                     "aten.mv"})
# operators that materialize their (possibly transposed) input
COPY_OPS = frozenset({"aten.clone", "aten.contiguous", "aten._to_copy", "aten.copy_",
                      "aten.copy"})
# the transposes make_fx records (``.T``, ``.mT`` decompose into these)
_TRANSPOSES = frozenset({"aten.t", "aten.transpose", "aten.permute"})


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    doc: str
    fn: Callable[[Artifact], List[Finding]]


REGISTRY: Dict[str, Rule] = {}


def rule(rule_id: str, severity: str = "error"):
    """Register a rule function under ``rule_id``."""

    def deco(fn):
        REGISTRY[rule_id] = Rule(rule_id, severity, (fn.__doc__ or "").strip(), fn)
        return fn

    return deco


def rule_ids() -> List[str]:
    return sorted(REGISTRY)


# ---------------------------------------------------------------------------
# shared plan geometry
# ---------------------------------------------------------------------------


def _finding(art: Artifact, rule_id: str, message: str, site=None, shape=None) -> Finding:
    return Finding(
        rule=rule_id, message=message, artifact=art.label,
        severity=REGISTRY[rule_id].severity if rule_id in REGISTRY else "error",
        primitive=site.name if site else None,
        path=site.path if site else (),
        eqn_index=site.index if site else None,
        shape=tuple(shape) if shape is not None else None,
    )


def _is_view(node) -> bool:
    return bool(getattr(node.target, "is_view", False))


def _depth(plan) -> int:
    """Recursion depth of the plan's product tree (0 for algorithm='dense'
    and for trees the cutoff covers entirely)."""
    from repro_torch.core.strassen import tree_depth

    if plan.algorithm == "dense":
        return 0
    dims = (plan.m, plan.n, plan.k) if plan.op == "gemm_tn" else (plan.m, plan.n)
    return tree_depth(dims, plan.n_base)


def _packed_bn(plan) -> int:
    """Effective packed block (the grid clamp every producer shares)."""
    from repro_torch.core.symmetric import default_block_size

    return default_block_size(plan.n, plan.packed_block)


def _ceil_half(d: int, times: int) -> int:
    for _ in range(times):
        d = (d + (d & 1)) // 2
    return d


def _itemsize(dtype_str: str) -> int:
    import torch

    return getattr(torch, dtype_str).itemsize


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


@rule("no-dense-square")
def no_dense_square(art: Artifact) -> List[Finding]:
    """Packed paths must never materialize a dense ``(n, n)`` or padded
    ``(n_pad, n_pad)`` square — the whole point of packed retrieval.

    Applies to plans with ``out='packed'`` (op='solve' included: the gram,
    factor, and substitutions are all packed-native). A degenerate
    single-block grid (``bn ≥ n``) legitimately holds the square as its one
    block, so the rule requires a real block grid; a single-leaf gram's one
    ``(n, n)`` base tile is legal too. Views are skipped (they materialize
    nothing). On the kernel path, kernel outputs that fit inside one of
    the plan's blocks are leaf tiles, not a gram square. Overrides:
    ``forbidden_squares`` — explicit set of (r, c) trailing shapes.
    """
    plan = art.plan
    forbidden = art.overrides.get("forbidden_squares")
    block_pad = 0
    if forbidden is None:
        if plan is None or plan.out != "packed":
            return []
        n = plan.n
        bn = _packed_bn(plan)
        if bn >= n:
            return []        # single-block grid: the square IS the block
        if plan.op != "solve" and _depth(plan) == 0:
            return []        # single-leaf gram: one (n, n) base tile is legal
        n_pad = -(-n // bn) * bn
        forbidden = {(n, n), (n_pad, n_pad)}
        if plan.use_kernels:
            block_pad = max(plan.syrk_blocks + plan.gemm_blocks)
    forbidden = {tuple(s) for s in forbidden}
    out = []
    for site in art.sites():
        if _is_view(site.node):
            continue
        outs = node_outputs(site.node)
        if (block_pad and is_kernel(site.node)
                and all(max(tuple(v.shape)[-2:] or (0,)) <= block_pad for v in outs)):
            continue         # leaf tiles of a launch, bounded by the plan's blocks
        for v in outs:
            shape = tuple(v.shape)
            if shape[-2:] in forbidden:
                out.append(_finding(
                    art, "no-dense-square",
                    f"dense square {shape} materialized on a packed path", site, shape))
    return out


@rule("no-operand-stacks")
def no_operand_stacks(art: Artifact) -> List[Finding]:
    """Fused dispatch must not materialize leaf *operand* stacks.

    The fused-leaf contract (``kernels/__init__.py``): operand ± combines
    happen in the kernel prologue (or per leaf on the plain path) — never
    as a cross-leaf ``(…·7^i, m_L, n_L)`` stack in memory. The
    discriminator is exact: Strassen operand stacks carry a leading-dim
    product divisible by 7, while the legal block-major relayouts are
    power-of-two-leading and the ATA diagonal stack is ``4^L``-leading.
    Product/decode stacks (trailing ``(n_L, k_L)``) are excluded — those
    the fused dispatch *does* materialize, by design. Views are skipped.

    Applies to ``leaf_dispatch='fused'`` product plans with depth ≥ 1.
    """
    plan = art.plan
    if plan is None or plan.leaf_dispatch != "fused" or plan.op not in ("ata", "gemm_tn"):
        return []
    lv = _depth(plan)
    if lv == 0:
        return []
    m_l, n_l = _ceil_half(plan.m, lv), _ceil_half(plan.n, lv)
    if plan.op == "gemm_tn":
        k_l = _ceil_half(plan.k, lv)
        forbidden = {(m_l, n_l), (m_l, k_l)} - {(n_l, k_l)}
    else:
        # both operands of the off-diagonal leaves are A-blocks; the
        # product tile is (n_l, n_l), excluded when indistinguishable
        forbidden = {(m_l, n_l)} - {(n_l, n_l)}
    if not forbidden:
        return []            # square leaves: operand ≡ product shape
    out = []
    for site in art.sites():
        if _is_view(site.node):
            continue
        for v in node_outputs(site.node):
            shape = tuple(v.shape)
            if len(shape) < 3 or shape[-2:] not in forbidden:
                continue
            lead = math.prod(shape[:-2])
            if lead > 1 and lead % 7 == 0:
                out.append(_finding(
                    art, "no-operand-stacks",
                    f"materialized operand stack {shape} under fused "
                    f"dispatch (leading {lead} ≡ 0 mod 7)", site, shape))
    return out


def _cg_iters(plan) -> int:
    from repro_torch.tune import defaults

    return min(plan.n, defaults.CG_MAX_ITERS)


def expected_dots(plan) -> Optional[int]:
    """Closed-form count of library product nodes of the plain dispatch,
    or None when the rule has no exact form (see ``dot-budget``)."""
    from repro_torch.tune import cost

    if plan.op in ("ata", "gemm_tn"):
        lv = _depth(plan)
        if lv == 0:
            return 1                       # one classical product, any dispatch
        if plan.op == "ata":
            s, g = cost._ata_leaves(plan.m, plan.n, plan.n_base)
            return {"unrolled": s + g, "batched": 2, "fused": g + 1}[plan.leaf_dispatch]
        leaves = cost._strassen_leaves(plan.m, plan.n, plan.k, plan.n_base)
        return {"unrolled": leaves, "batched": 1, "fused": leaves}[plan.leaf_dispatch]
    if plan.op == "solve":
        if plan.method == "cg":
            # one A·p a trip: the port runs the loop eagerly, so each trip
            # is in the graph (the reference traces the body once). Aᵀb
            # and Aᵀ(A·p) are the TN product pinned to the plan's cutoff,
            # whose leaves a pinned call hands to the kernel wrappers
            # (``ops.bases``): launch nodes, not products.
            return _cg_iters(plan)
        # factor: gram + Aᵀb + the blocked factor/substitution products
        # (per block column: one Schur update against the finished panel
        # row, one cross-panel update, and one update per substitution pass)
        gram_plan = dataclasses.replace(plan, op="ata", k=plan.n)
        gram = expected_dots(gram_plan)
        nbk = -(-plan.n // _packed_bn(plan))
        return gram + 1 + (nbk - 1) + max(nbk - 2, 0) + 2 * (nbk - 1)
    return None


@rule("dot-budget")
def dot_budget(art: Artifact) -> List[Finding]:
    """The graph's count of library product nodes (``aten.mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``dot``, ``mv``) must equal the closed-form
    leaf count the cost model prices.

    This is the cost model cross-checked against the program it prices:
    unrolled = one product per leaf (``cost._ata_leaves`` /
    ``cost._strassen_leaves`` — exactly ``cost.dispatch_calls``), batched =
    O(1) batched products, fused = one per off-diagonal leaf plus the
    gathered diagonal syrk. Solve plans get the gram's form plus the
    factor/substitution band (method='factor') or every CG trip's ``A·p``
    (method='cg'; the port's loop runs eagerly, so the graph holds each
    trip, and its TN products are kernel launches). Applies to plain-path plans
    (``use_kernels=False``, unbatched); the kernel path is budgeted by
    ``launch-budget``. Override: ``expected_dots``.
    """
    plan = art.plan
    expected = art.overrides.get("expected_dots")
    if expected is None:
        if plan is None or plan.use_kernels or plan.batch:
            return []
        expected = expected_dots(plan)
        if expected is None:
            return []
    got = sum(1 for s in art.sites() if s.name in DOT_OPS)
    if got == expected:
        return []
    return [_finding(
        art, "dot-budget",
        f"graph dispatches {got} product nodes; the closed form predicts {expected}")]


def expected_launches(plan) -> Optional[int]:
    """Closed-form count of kernel nodes of a product plan on the kernel
    path (unrolled = one launch per leaf; batched = one per engine; fused =
    one per level plus the gathered diagonal), or None for other plans."""
    from repro_torch.tune import cost

    if not plan.use_kernels or plan.batch or plan.op not in ("ata", "gemm_tn"):
        return None
    lv = _depth(plan)
    if lv == 0:
        return 1
    if plan.op == "ata":
        s, g = cost._ata_leaves(plan.m, plan.n, plan.n_base)
        return {"unrolled": s + g, "batched": 2, "fused": lv + 1}[plan.leaf_dispatch]
    leaves = cost._strassen_leaves(plan.m, plan.n, plan.k, plan.n_base)
    return {"unrolled": leaves, "batched": 1, "fused": 1}[plan.leaf_dispatch]


@rule("launch-budget")
def launch_budget(art: Artifact) -> List[Finding]:
    """Kernel-path plans: the count of kernel nodes (``repro_torch.*``, one
    launch of a hand-written kernel each) must equal the closed form
    (unrolled = one launch per leaf; batched = one per engine; fused = one
    per level plus the gathered diagonal) and never exceed the
    ``cost.dispatch_calls`` budget the planner prices. Applies to product
    plans with ``use_kernels=True``. Overrides: ``expected_launches``,
    ``launch_ceiling``.
    """
    from repro_torch.tune import cost

    plan = art.plan
    expected = art.overrides.get("expected_launches")
    budget = art.overrides.get("launch_ceiling")
    if expected is None:
        if plan is None:
            return []
        expected = expected_launches(plan)
        if expected is None:
            return []
        budget = cost.dispatch_calls(plan.op, plan.algorithm, plan.m, plan.n, plan.k,
                                     plan.n_base, plan.leaf_dispatch)
    got = sum(1 for s in art.sites() if is_kernel(s.node))
    out = []
    if got != expected:
        out.append(_finding(
            art, "launch-budget",
            f"graph dispatches {got} kernel launches; the closed form predicts {expected}"))
    if budget is not None and got > budget:
        out.append(_finding(
            art, "launch-budget",
            f"{got} kernel launches exceed the priced dispatch_calls budget {budget}"))
    return out


def _swaps_last_two(node) -> bool:
    """Whether a transpose-like node exchanges its input's last two dims."""
    name = node_name(node)
    if name not in _TRANSPOSES:
        return False
    out = node_outputs(node)
    if not out:
        return False
    nd = len(out[0].shape)
    if name == "aten.t":
        return nd == 2
    if name == "aten.transpose":
        dims = {d % nd for d in node.args[1:3]}
        return dims == {nd - 2, nd - 1}
    perm = [d % nd for d in node.args[1]]
    return nd >= 2 and perm[-2:] == [nd - 1, nd - 2]


def _materialized(node) -> list:
    """The copy nodes that materialize ``node``'s output, followed through
    views."""
    found, todo, seen = [], list(node.users), set()
    while todo:
        user = todo.pop()
        if user in seen:
            continue
        seen.add(user)
        if node_name(user) in COPY_OPS:
            found.append(user)
        elif _is_view(user):
            todo.extend(user.users)
    return found


@rule("no-full-transpose")
def no_full_transpose(art: Artifact) -> List[Finding]:
    """The TN contract: no transpose above tile granularity is
    materialized.

    ``Aᵀ`` is never formed (paper §3): a transposed view of the last two
    dims whose trailing shape exceeds the tile bound may be read in place
    (a product or an elementwise op takes it as it is) but must not reach
    a copy (``clone``/``contiguous``, ``_to_copy``, ``copy_``), followed
    through further views — such a copy is what the kernel wrappers make
    of a strided operand on the card (``kernels.copy.<name>``). The only
    one allowed, for dense-output ATA, is ONE ``(n, n)`` root mirror.
    Overrides: ``max_transpose_dim`` (tile bound; plans default to
    ``max(n_base, packed block)``), ``mirror_budget``, ``mirror_shape``.
    """
    plan = art.plan
    max_dim = art.overrides.get("max_transpose_dim")
    budget = art.overrides.get("mirror_budget")
    mirror_shape = None
    if plan is not None:
        if max_dim is None:
            max_dim = max(plan.n_base, _packed_bn(plan))
        if budget is None:
            budget = 1 if (plan.op == "ata" and plan.out == "dense") else 0
        mirror_shape = (plan.n, plan.n)
    if max_dim is None:
        return []
    budget = budget or 0
    mirror_shape = art.overrides.get("mirror_shape", mirror_shape)
    out, mirrors = [], 0
    for site in art.sites():
        if not _swaps_last_two(site.node):
            continue
        shape = tuple(node_outputs(site.node)[0].shape)
        if max(shape[-2:]) <= max_dim:
            continue
        for copy in _materialized(site.node):
            if shape[-2:] == mirror_shape and mirrors < budget:
                mirrors += 1
                continue
            out.append(_finding(
                art, "no-full-transpose",
                f"transpose of {shape} exceeds the {max_dim}-tile bound and is "
                f"materialized by {node_name(copy)}", site, shape))
    return out


@rule("acc-dtype")
def acc_dtype(art: Artifact) -> List[Finding]:
    """Every library product node must accumulate at the plan accumulator
    width.

    A product's output dtype is its accumulation dtype (PyTorch sums a
    bfloat16 product in float32 but stores bfloat16, and the next product
    reads that rounding), so the rule checks it against the accumulator
    (float32, or the operand dtype when that is wider). A bfloat16 operand
    reaching ``matmul`` without a cast to float32 shows up here. Kernel
    nodes sum in float32 by construction and may store bfloat16 by
    request, so they are not products here. Override: ``min_acc_itemsize``.
    """
    plan = art.plan
    required = art.overrides.get("min_acc_itemsize")
    if required is None:
        required = max(4, _itemsize(plan.dtype)) if plan is not None else 4
    out = []
    for site in art.sites():
        if site.name not in DOT_OPS:
            continue
        v = node_outputs(site.node)[0]
        if not v.dtype.is_floating_point:
            continue
        if v.dtype.itemsize < required:
            out.append(_finding(
                art, "acc-dtype",
                f"product accumulates at {str(v.dtype).removeprefix('torch.')} "
                f"({v.dtype.itemsize} B < required {required} B) — missing a cast "
                f"to float32 on the call site", site, tuple(v.shape)))
    return out


@rule("no-vmap-of-pallas")
def no_vmap_of_pallas(art: Artifact) -> List[Finding]:
    """Kernel batching goes through the native leading grid dimension —
    one launch for the whole batch — never through ``vmap`` of a kernel.

    Registered under the reference's id and always clean: no module of the
    port calls ``torch.vmap``, and every wrapper takes the batch as its
    kernel's leading grid dimension, so there is nothing to find (the
    reference reads ``vmapped_dims`` off a ``pallas_call`` equation; an FX
    node of a kernel has no such field). The rule is kept so allowlists
    and ``--rules`` lists carry over. Applies to every artifact.
    """
    del art
    return []


@rule("collective-budget")
def collective_budget(art: Artifact) -> List[Finding]:
    """Distributed plans: per-rank reduction-collective bytes must stay
    within the retrieval payload the planner prices.

    The tile schedule all-reduces the ``(T, w, w)`` stack and the rowshard
    path all-reduces the replicated result — in both cases the
    reduction-class payload (all-reduce + reduce-scatter) is bounded by
    ``cost.retrieval_bytes(out, nb, w)``. A BFS-containing
    ``comm_schedule`` gets the far tighter scatter budget: the tri-direct
    reduce-scatter's whole reduction payload is ONE ``T_pad/P``-tile chunk
    per rank (``ceil(T/P)·w²``), so a BFS artifact whose reduction bytes
    regress to the full stack fails. Reads ``Artifact.collective_bytes``
    (the ``collective_bytes.<kind>`` counters of one real run of the rank's
    program; no graph needed) and a plan with a multi-rank pool and a
    resolved ``nb``/``tile_w``. Overrides: ``collective_budget_bytes``,
    ``collective_slack`` (default 1.0).
    """
    from repro_torch.tune import cost

    plan = art.plan
    if art.collective_bytes is None:
        return []
    budget = art.overrides.get("collective_budget_bytes")
    if budget is None:
        if plan is None or plan.nb is None or plan.tile_w is None:
            return []
        pool = plan.devices * max(getattr(plan, "row_devices", 1), 1)
        if pool <= 1:
            return []
        cs = getattr(plan, "comm_schedule", None)
        if cs and "B" in cs:
            t_total = plan.nb * (plan.nb + 1) // 2
            budget = -(-t_total // pool) * plan.tile_w * plan.tile_w * _itemsize(plan.dtype)
        else:
            budget = cost.retrieval_bytes(plan.out, plan.nb, plan.tile_w,
                                          _itemsize(plan.dtype))
    slack = art.overrides.get("collective_slack", 1.0)
    by_kind = art.collective_bytes
    ar, rs = by_kind.get("all-reduce", 0), by_kind.get("reduce-scatter", 0)
    reduction = ar + rs
    if reduction <= slack * budget:
        return []
    return [_finding(
        art, "collective-budget",
        f"reduction collectives move {reduction} B/rank (all-reduce {ar}, "
        f"reduce-scatter {rs}) > priced retrieval payload {budget} B × slack {slack}")]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def run(artifact: Artifact, rules: Optional[Sequence[str]] = None,
        allowlist: Sequence[Allow] = (), report: Optional[Report] = None) -> Report:
    """Run ``rules`` (default: the whole registry) over one artifact.

    Findings are partitioned by ``allowlist`` into the returned
    :class:`Report`; violation counters land in the ``repro_torch.obs``
    registry (``check.*``, the reference's names).
    """
    from repro_torch.obs import metrics

    if report is None:
        report = Report(allowlist)
    ids = list(rules) if rules is not None else rule_ids()
    unknown = [i for i in ids if i not in REGISTRY]
    if unknown:
        raise KeyError(f"unknown rule ids {unknown}; have {rule_ids()}")
    n = 0
    for rid in ids:
        found = REGISTRY[rid].fn(artifact)
        kept = report.add(found)
        n += len(found)
        metrics.inc("check.rules_run")
        for f in kept:
            metrics.inc(f"check.findings.{f.rule}")
            if f.severity == "error":
                metrics.inc("check.violations")
    metrics.inc("check.artifacts")
    report.record_artifact(artifact.label, ids, n)
    return report


def run_many(artifacts: Sequence[Artifact], rules: Optional[Sequence[str]] = None,
             allowlist: Sequence[Allow] = ()) -> Report:
    report = Report(allowlist)
    for art in artifacts:
        run(art, rules=rules, allowlist=allowlist, report=report)
    return report
