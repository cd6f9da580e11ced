"""Tunables of the port. Only the static defaults exist so far; the
planner of ``repro.tune`` is not ported yet (see ROADMAP.md)."""

from repro_torch.tune import defaults

__all__ = ["defaults"]
