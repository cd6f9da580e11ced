"""Analytic models of the port (port of ``repro.analysis``).

The dry-run roofline on an H100 and the write-traffic models that the
planner's cost model (``repro_torch.tune.cost``) prices (``roofline``),
the report-only perf diff (``perf_diff``) and the tables of the dry-run
sweep (``fill_experiments``). The reference's ``hlo`` module reads XLA's
HLO text and has no counterpart; its ``COLLECTIVE_KINDS`` and
``collective_seconds`` live in ``roofline``.
"""

from repro_torch.analysis import roofline

__all__ = ["roofline"]
