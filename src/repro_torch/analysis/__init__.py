"""Analytic models of the port (port of ``repro.analysis``).

Only the write-traffic models that the planner's cost model
(``repro_torch.tune.cost``) prices are here so far; the rest of the
reference's ``analysis`` package waits for its slice (ROADMAP A9).
"""

from repro_torch.analysis import roofline

__all__ = ["roofline"]
