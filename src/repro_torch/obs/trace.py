"""Nestable span API — the tracing half of ``repro_torch.obs`` (port of
``repro.obs.trace``).

A *span* names one region of the dispatch pipeline: a recursion level, a
batched or fused leaf launch, a kernel wrapper, the solve front door.
Spans sit on the paths unconditionally, but

* **disabled (the default)** — :func:`span` returns one shared no-op
  context manager: no allocation beyond the call itself and no effect on
  what runs, so instrumented paths compute bitwise what they computed
  without it (tested in ``tests/test_torch_obs.py``).
* **enabled** (:func:`enable` / ``REPRO_OBS=1``) — each span records an
  event into a bounded in-process buffer (name, depth, attrs) and wraps the
  region in ``torch.profiler.record_function`` (so a ``torch.profiler``
  trace carries the same names) and, once CUDA is initialised, in an NVTX
  range (``torch.cuda.nvtx.range_push``/``range_pop``).

Spans do not time anything: PyTorch returns before the device finishes, so
a host clock around a span measures the enqueue. Measured time lives at the
dispatch sites (``repro_torch.obs.calibrate``) and in profiler traces the
annotations label.
"""

from __future__ import annotations

import os
import threading
from collections import Counter

import torch

__all__ = [
    "enable",
    "disable",
    "enabled",
    "span",
    "span_counts",
    "span_events",
    "reset",
    "MAX_EVENTS",
]

_ENABLED = os.environ.get("REPRO_OBS", "") == "1"
_LOCK = threading.Lock()
_COUNTS: Counter = Counter()          # span name -> times entered
_EVENTS: list = []                    # ordered (name, depth, attrs), bounded
_DEPTH = threading.local()

# events beyond this are counted but not stored — an unrolled 7^L recursion
# must never grow host memory without bound just because tracing is on.
MAX_EVENTS = 10_000


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Turn span recording on (and the profiler and NVTX annotations)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop recorded spans (tests; between runs)."""
    with _LOCK:
        _COUNTS.clear()
        _EVENTS.clear()


def span_counts() -> dict:
    """{span name: times entered} since the last :func:`reset`."""
    with _LOCK:
        return dict(_COUNTS)


def span_events() -> list:
    """Ordered recorded events ``(name, depth, attrs)`` (bounded by
    ``MAX_EVENTS``; counts in :func:`span_counts` are always complete)."""
    with _LOCK:
        return list(_EVENTS)


class _NullSpan:
    """The shared disabled-mode span: enters and exits with no effect."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_record", "_nvtx")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        depth = getattr(_DEPTH, "v", 0)
        _DEPTH.v = depth + 1
        with _LOCK:
            _COUNTS[self.name] += 1
            if len(_EVENTS) < MAX_EVENTS:
                _EVENTS.append((self.name, depth, self.attrs))
        self._record = torch.profiler.record_function(self.name)
        self._record.__enter__()
        # an NVTX range only where CUDA already runs: a span never
        # initialises CUDA itself
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._record.__exit__(*exc)
        _DEPTH.v = getattr(_DEPTH, "v", 1) - 1
        return False


def span(name: str, **attrs):
    """Context manager naming one region of the dispatch pipeline.

    ``name`` is a dotted path (``"ata.encode.L2"``, ``"kernels.syrk"``);
    keyword attrs ride along into the event buffer (small static values
    only — shapes, leaf counts, dispatch kinds; never tensors).
    """
    if not _ENABLED:
        return _NULL
    return _Span(name, attrs)
