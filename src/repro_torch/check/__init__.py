"""``repro_torch.check`` — static analysis of traced programs against the
repo's structural contracts (port of ``repro.check``).

The paper's advantage (14/3·n^log2(7) flops, transpose-free TN leaves,
packed-symmetric output, O(levels) dispatch) only survives in a traced
program if structural invariants hold. This package checks them on FX
graphs of the port's programs (``make_fx``), in which each hand-written
kernel launch is one ``repro_torch.*`` node (``kernels/_library.py``):

* :mod:`repro_torch.check.findings` — :class:`Finding` / :class:`Allow` /
  :class:`Report`: structured violations with node provenance, the
  allowlist, and the JSON report (schema ``repro.check/v1``).
* :mod:`repro_torch.check.artifacts` — :class:`Artifact`, the canonical
  :func:`walk_nodes` traversal (the reference's ``walk_eqns``), and
  :func:`trace_plan` (traces the exact callable the autotuner times, on
  fake tensors).
* :mod:`repro_torch.check.rules` — the registry and the eight rules.
* :mod:`repro_torch.check.harness` — the canonical plan grid, the
  distributed sweep (a gloo world) and the serving layer.

CLI: ``python -m repro_torch.check [--json PATH] [--device cpu]`` — nonzero
exit on violations; on the card unless ``--device cpu``.
"""

from repro_torch.check.artifacts import (
    Artifact,
    abstract_args,
    plan_label,
    trace_plan,
    walk_eqns,
    walk_nodes,
)
from repro_torch.check.findings import REPORT_SCHEMA, Allow, Finding, Report
from repro_torch.check.harness import (
    DEFAULT_ALLOWLIST,
    bfsdfs_plans,
    canonical_plans,
    distributed_plans,
    run_distributed,
    run_grid,
    run_serve,
)
from repro_torch.check.rules import REGISTRY, rule, rule_ids, run, run_many

__all__ = [
    "Artifact", "Allow", "Finding", "Report", "REPORT_SCHEMA",
    "REGISTRY", "DEFAULT_ALLOWLIST",
    "abstract_args", "plan_label", "trace_plan", "walk_eqns", "walk_nodes",
    "rule", "rule_ids", "run", "run_many",
    "canonical_plans", "run_grid", "distributed_plans", "bfsdfs_plans",
    "run_distributed", "run_serve",
]
