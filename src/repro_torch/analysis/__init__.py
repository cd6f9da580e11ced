"""Analytic models of the port (port of ``repro.analysis``).

The write-traffic models that the planner's cost model
(``repro_torch.tune.cost``) prices (``roofline``) and the report-only perf
diff (``perf_diff``); the rest of the reference's ``analysis`` package
(the dry-run roofline, ``fill_experiments``) waits for its slice.
"""

from repro_torch.analysis import roofline

__all__ = ["roofline"]
