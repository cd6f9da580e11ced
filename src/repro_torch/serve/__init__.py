"""``repro_torch.serve`` — Gram-as-a-service: the batched solve server
(port of ``repro.serve``).

The fifth architectural layer (algorithms → planner → kernels → solvers →
**server**): a request front door that turns the port's planned packed
normal-equations stack into a serving path. Heterogeneous ``lstsq`` /
``whiten`` requests are bucketed by **plan key** (exact feature dimension
``n``, banded row count ``m`` and RHS count ``r``, dtype — see
:mod:`repro_torch.serve.bucketing`; the reference's lattice on every
device), micro-batched per bucket, and each
flush runs as ONE pre-built batched program — on the card one captured
CUDA graph replay — whose per-request results are bitwise-equal to
per-request ``solve.lstsq`` under the same plan.

The serving economics the layer exists for: a cold request pays plan +
kernel-library build + the first eager run + the capture; after
:meth:`Server.warm` every configured bucket's plan is resolved (one
plan-cache file read via ``tune.cache.warm``) and its program captured, so
a request pays a dictionary lookup plus one replay — and the steady-state
loop performs **zero recaptures**, asserted per dispatch, not hoped: a
replay calls no kernel wrapper, so any wrapper launch during a flush's
program counts in ``serve.retraces`` (and the engine raises).

Modules:

* :mod:`repro_torch.serve.bucketing` — the bucket lattice, pad/crop rules,
  the bitwise-parity contract.
* :mod:`repro_torch.serve.queue` — bounded admission queue: deadline-aware
  admission, explicit reject-with-retry-after backpressure, and the
  max-wait/max-batch flush policy.
* :mod:`repro_torch.serve.engine` — ``Server``: pre-warm pass, the batched
  bucket programs (CUDA graphs on the card), the steady-state dispatch
  loop.
* :mod:`repro_torch.serve.metrics` — ``serve.*`` counters/gauges into
  ``repro_torch.obs`` plus p50/p95/p99 latency reservoirs.

Quickstart (``python -m repro_torch.serve --smoke`` is the CI smoke; add
``--device cpu`` off the card):

    from repro_torch import serve
    srv = serve.Server(serve.smoke_config())    # on the card
    srv.warm()                                  # plans + captures, off the request path
    t = srv.submit(serve.Request(op="lstsq", a=a, b=b))
    srv.drain()
    x = t.result()                              # == solve.lstsq(a, b, plan) bitwise
    print(serve.metrics.latency_summary())      # p50/p95/p99 per bucket
"""

from __future__ import annotations

from repro_torch.serve import bucketing, metrics
from repro_torch.serve.bucketing import BucketLattice, BucketSpec
from repro_torch.serve.engine import Server, ServeConfig, smoke_config
from repro_torch.serve.queue import FlushPolicy, Rejected, Request, Ticket

__all__ = [
    "bucketing",
    "metrics",
    "BucketLattice",
    "BucketSpec",
    "Server",
    "ServeConfig",
    "smoke_config",
    "FlushPolicy",
    "Rejected",
    "Request",
    "Ticket",
]
