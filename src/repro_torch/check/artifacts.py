"""Traced artifacts and the one canonical FX-graph traversal (port of
``repro.check.artifacts``).

An :class:`Artifact` is what the rules see: an FX graph
(``torch.fx.GraphModule``, from ``make_fx``) in place of the reference's
jaxpr, plus, for a distributed program, the ``collective_bytes.<kind>``
counters of one real run in place of its compiled HLO text, together with
the governing :class:`repro_torch.tune.cost.Plan` — the closed-form
predictions the budget rules compare the program against. ``overrides``
lets a call site without a full plan pin individual rule parameters; see
:mod:`repro_torch.check.rules` for the keys each rule reads.

:func:`walk_nodes` is the single traversal: it yields every operator node
of the graph and descends into the graphs of higher-order operators and
submodules. Each ``repro_torch.*`` node — one launch of a hand-written
kernel (``kernels/_library.py``) — is opaque, as the reference's
``pallas_call`` bodies are: the structural invariants the rules police
(dense squares, operand stacks, full transposes, dispatch counts) are
wrapper-level properties.

:func:`trace_plan` is the harness entry: it traces the exact callable the
autotuner times (``tune.apply.build_callable``) on fake operands of the
plan's shape (:func:`abstract_args`) with ``make_fx(...,
tracing_mode="fake")``, so the program the checker sees IS the program the
plan dispatches, kernels included, and nothing runs or is allocated. On a
CUDA device the trace takes the card's path: the wrappers' strided-operand
copies and the potrf/trsm split appear as nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.kernels._library import NAMESPACE

__all__ = ["Artifact", "NodeSite", "EqnSite", "walk_nodes", "walk_eqns", "node_name",
           "node_outputs", "is_kernel", "abstract_args", "plan_label", "trace_plan",
           "trace_fn"]


@dataclasses.dataclass(frozen=True)
class NodeSite:
    """One operator node plus its provenance in the traversal."""

    path: Tuple[str, ...]   # enclosing operator or submodule names, outermost first
    index: int              # node index within its own graph
    node: Any               # torch.fx.Node

    @property
    def name(self) -> str:
        return node_name(self.node)


# the reference's name for a traversal site
EqnSite = NodeSite


@dataclasses.dataclass
class Artifact:
    """One traced program under one plan — the unit the rules analyze."""

    label: str
    graph: Any                          # torch.fx.GraphModule
    plan: Optional[Any] = None          # repro_torch.tune.cost.Plan
    # per-rank bytes by collective kind from one real run (the
    # ``collective_bytes.<kind>`` counters of ``launch/collectives.py``)
    collective_bytes: Optional[Dict[str, int]] = None
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def sites(self) -> Iterator[NodeSite]:
        return walk_nodes(self.graph)


def node_name(node) -> str:
    """``aten.mm``, ``repro_torch.syrk``, ``c10d.allreduce_``: the
    operator of a node without its overload, or the method / module name."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return str(packet)
    return getattr(target, "__name__", str(target))


def node_outputs(node) -> list:
    """The tensors (fake or real) a node produced, from ``node.meta``."""
    val = node.meta.get("val")
    vals = val if isinstance(val, (tuple, list)) else (val,)
    return [v for v in vals if hasattr(v, "shape") and hasattr(v, "dtype")]


def is_kernel(node) -> bool:
    """Whether the node is one launch of a hand-written kernel (an operator
    of ``kernels/_library.py``)."""
    return node_name(node).startswith(NAMESPACE + ".")


def _subgraphs(owner, node) -> Iterator[Tuple[str, Any]]:
    """(name, graph) of every graph a node reaches: a ``call_module``'s
    submodule, or the ``get_attr`` submodules a higher-order operator takes
    (``cond``, ``while_loop``, ``wrap``)."""
    import torch.fx

    if node.op == "call_module":
        sub = owner.get_submodule(node.target)
        if isinstance(sub, torch.fx.GraphModule):
            yield str(node.target), sub
        return
    for arg in node.all_input_nodes:
        if arg.op == "get_attr":
            sub = getattr(owner, arg.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                yield node_name(node), sub


def walk_nodes(graph, *, _path: Tuple[str, ...] = ()) -> Iterator[NodeSite]:
    """Yield every operator node (``call_function``, ``call_method``,
    ``call_module``) of ``graph`` (a ``GraphModule``) and of the graphs it
    reaches, depth-first. Inputs, constants and the output are not
    operators and are skipped; kernel nodes have no body to enter."""
    for i, node in enumerate(graph.graph.nodes):
        if node.op not in ("call_function", "call_method", "call_module"):
            continue
        yield NodeSite(_path, i, node)
        for name, sub in _subgraphs(graph, node):
            yield from walk_nodes(sub, _path=_path + (name,))


# the reference's name for the traversal
walk_eqns = walk_nodes


def abstract_args(plan, device=None) -> tuple:
    """Fake operands on ``device`` (None: ``backend.DEFAULT_DEVICE``, the
    card) matching ``tune.apply.build_callable(plan)``'s signature — the
    shapes the autotuner would time. No memory is allocated."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.backend import resolve_device

    dev = resolve_device(device)
    dt = getattr(torch, plan.dtype)
    lead = (plan.batch,) if plan.batch else ()
    with FakeTensorMode():
        a = torch.empty(lead + (plan.m, plan.n), dtype=dt, device=dev)
        if plan.op in ("gemm_tn", "solve"):
            return (a, torch.empty(lead + (plan.m, plan.k), dtype=dt, device=dev))
    return (a,)


def plan_label(plan) -> str:
    """Stable artifact label for a plan — the allowlist's match key, equal
    to the reference's for the same plan."""
    parts = [
        plan.op, plan.algorithm, plan.leaf_dispatch,
        "kern" if plan.use_kernels else "xla", plan.out,
        f"{plan.m}x{plan.n}x{plan.k}", plan.dtype,
    ]
    if plan.method:
        parts.append(plan.method)
    if plan.devices > 1:
        parts.append(f"dist{plan.devices}")
    return ":".join(parts)


def _tensors(out):
    """A program's result as tensors: a packed matrix traces as its block
    stack (FX graphs return tensors)."""
    blocks = getattr(out, "blocks", None)
    if blocks is not None:
        return blocks
    if isinstance(out, (tuple, list)):
        return type(out)(_tensors(x) for x in out)
    return out


def trace_fn(fn, *args, tracing_mode: str = "fake"):
    """``make_fx`` of ``fn(*args)``: an FX ``GraphModule`` of every operator
    the call dispatches (``tracing_mode='real'`` runs it, collectives
    included)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(lambda *xs: _tensors(fn(*xs)), tracing_mode=tracing_mode)(*args)


def trace_plan(plan, *, lower: bool = False, label: Optional[str] = None,
               device=None) -> Artifact:
    """Trace ``build_callable(plan)`` on fake operands on ``device`` (None:
    the card) into an :class:`Artifact`. ``lower`` is accepted for the
    reference's signature and not applicable: the port compiles no HLO
    (its kernels are built ahead, its other operators run eagerly)."""
    del lower
    from repro_torch.tune import apply

    graph = trace_fn(apply.build_callable(plan), *abstract_args(plan, device))
    return Artifact(label=label or plan_label(plan), graph=graph, plan=plan)
