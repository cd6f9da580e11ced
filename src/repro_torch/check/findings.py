"""Structured findings, the allowlist, and the check report (port of
``repro.check.findings``).

A :class:`Finding` is one rule violation pinned to a traced artifact: rule
id, severity, a human message, and the offending node's provenance (the
operator's name, the enclosing-graph path, the node's index, its output
shape; the reference's ``primitive``/``path``/``eqn_index`` fields keep
their names).
Findings are plain frozen data — the analyzer never raises on a violation;
it *reports*, and the CLI turns unallowlisted errors into a nonzero exit.

The allowlist is the mechanism for *intentional* violations: an
:class:`Allow` entry names a rule id and an ``fnmatch`` pattern over
artifact labels, plus a mandatory reason (the policy mirror of the
``# repro.check: allow(<rule-id>)`` comments at the source sites — see
DESIGN.md §9). Allowlisted findings stay in the report (auditable) but do
not fail the run. The JSON report keeps the reference's schema
``repro.check/v1``; its ``meta`` names PyTorch's version and the device
the program was traced for.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Iterable, List, Optional, Sequence, Tuple

__all__ = ["Finding", "Allow", "Report", "REPORT_SCHEMA", "SEVERITIES"]

REPORT_SCHEMA = "repro.check/v1"
SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation on one traced artifact."""

    rule: str
    message: str
    artifact: str = ""
    severity: str = "error"
    # node provenance: the operator that produced the offending value (e.g.
    # 'aten.mm', 'repro_torch.syrk'), the enclosing-graph path (the
    # higher-order operators or submodules it sits in) and the node's index
    # within its own graph — enough to find it in a printed FX graph.
    primitive: Optional[str] = None
    path: Tuple[str, ...] = ()
    eqn_index: Optional[int] = None
    shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}"
            )

    @property
    def provenance(self) -> str:
        """``<top> eqn#12 (aten.clone)`` — where in the FX graph (the
        reference's format, node index in place of equation index)."""
        where = "/".join(self.path) or "<top>"
        eqn = f" eqn#{self.eqn_index}" if self.eqn_index is not None else ""
        prim = f" ({self.primitive})" if self.primitive else ""
        return f"{where}{eqn}{prim}"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["path"] = list(self.path)
        d["shape"] = list(self.shape) if self.shape is not None else None
        d["provenance"] = self.provenance
        return d


@dataclasses.dataclass(frozen=True)
class Allow:
    """One allowlist entry: rule id + artifact-label pattern + reason."""

    rule: str
    artifact: str = "*"          # fnmatch pattern over artifact labels
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        return self.rule == f.rule and fnmatch.fnmatch(f.artifact, self.artifact)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Report:
    """Accumulates findings across artifacts, partitioned by the allowlist.

    ``violations`` (error-severity, not allowlisted) drive the CLI exit
    code; everything — including allowlisted findings — lands in the JSON
    report for audit.
    """

    def __init__(self, allowlist: Sequence[Allow] = (), *, device: str = "unknown"):
        self.allowlist: List[Allow] = list(allowlist)
        self.device = device              # what the artifacts were traced for
        self.findings: List[Finding] = []
        self.allowlisted: List[Finding] = []
        self.artifacts: List[dict] = []   # {label, rules, findings} per artifact

    def add(self, findings: Iterable[Finding]) -> List[Finding]:
        """Partition ``findings`` by the allowlist; returns the kept ones."""
        kept = []
        for f in findings:
            if any(a.matches(f) for a in self.allowlist):
                self.allowlisted.append(f)
            else:
                self.findings.append(f)
                kept.append(f)
        return kept

    def record_artifact(self, label: str, rules: Sequence[str],
                        n_findings: int) -> None:
        self.artifacts.append(
            {"label": label, "rules": list(rules), "findings": n_findings}
        )

    @property
    def violations(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def exit_code(self) -> int:
        return 1 if self.violations else 0

    def merge(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.allowlisted.extend(other.allowlisted)
        self.artifacts.extend(other.artifacts)
        return self

    def to_json(self) -> dict:
        import torch

        meta = {"backend": self.device.split(":")[0], "device": self.device,
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda}
        return {
            "schema": REPORT_SCHEMA,
            "meta": meta,
            "artifacts": self.artifacts,
            "findings": [f.to_json() for f in self.findings],
            "allowlisted": [f.to_json() for f in self.allowlisted],
            "allowlist": [a.to_json() for a in self.allowlist],
            "counts": {
                "artifacts": len(self.artifacts),
                "findings": len(self.findings),
                "violations": len(self.violations),
                "allowlisted": len(self.allowlisted),
            },
        }

    def summary(self) -> str:
        lines = [
            f"repro_torch.check: {len(self.artifacts)} artifacts, "
            f"{len(self.findings)} findings "
            f"({len(self.violations)} violations, "
            f"{len(self.allowlisted)} allowlisted)"
        ]
        for f in self.findings:
            lines.append(
                f"  [{f.severity}] {f.rule} @ {f.artifact}: {f.message}"
                f"  [{f.provenance}]"
            )
        return "\n".join(lines)
