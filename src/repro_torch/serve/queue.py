"""Bounded admission queue with deadline-aware admission and flush policy
(port of ``repro.serve.queue``; pure Python, no tensor anywhere).

Admission is where a serving layer earns its latency SLO: a request that
cannot be served in time must be **rejected at the door with a concrete
retry hint**, never silently queued into a blown deadline. Three reject
reasons, all explicit (:class:`Rejected` carries ``reason`` and
``retry_after_s``):

* ``no-bucket`` — the request's ``(op, m, n, r, dtype)`` maps to no
  configured bucket. Retrying is pointless (``retry_after_s=None``); the
  lattice is the server's published contract.
* ``capacity`` — the bounded queue is full. This is backpressure, not
  failure: ``retry_after_s`` is the flush policy's ``max_wait_s`` (by then
  at least one waiting batch must have flushed and freed depth).
* ``deadline`` — the request's budget is smaller than the worst-case wait
  it could see (``max_wait_s``, the policy's flush guarantee), so it could
  miss before ever launching. Rejecting up front costs one dictionary
  lookup; accepting would cost a full solve that nobody can use.

Flushing (:meth:`MicroBatchQueue.due`) follows the classic micro-batching
pair: a bucket flushes when it reaches its static batch width B
(**max-batch**: a full launch, zero padding waste) or when its oldest
request has waited ``max_wait_s`` (**max-wait**: bounded queueing latency,
the tail flushes ragged and the engine pads the empty slots). The queue
never launches anything itself — it only decides *what is due*; the
engine owns dispatch so the queue stays trivially testable with a fake
clock (every entry point takes ``now``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import metrics as _obs
from repro_torch.serve.bucketing import BucketLattice, BucketSpec

__all__ = ["Request", "Ticket", "Rejected", "FlushPolicy", "MicroBatchQueue"]


@dataclasses.dataclass
class Request:
    """One inbound problem: ``lstsq`` (a (m,n), b (m,r)) or ``whiten``
    (a (m,n), v=b (n,r)). ``deadline_s`` is a relative latency budget in
    seconds from submission (None = no SLO). ``ridge`` is per-request —
    the engine feeds it as a batched input of the bucket's program, so
    mixing ridges inside one flush is free."""

    op: str
    a: Any
    b: Any
    ridge: float = 0.0
    deadline_s: Optional[float] = None

    def shape_key(self) -> Tuple[str, int, int, int, str]:
        m, n = self.a.shape
        r = 1 if self.b.ndim == 1 else self.b.shape[-1]
        return (self.op, m, n, r, str(self.a.dtype))


class Rejected(Exception):
    """Admission refusal. ``retry_after_s`` is the backpressure contract:
    a float means "resubmit after this many seconds"; None means the
    request can never be admitted as posed (no-bucket)."""

    def __init__(self, reason: str, retry_after_s: Optional[float] = None):
        self.reason = reason
        self.retry_after_s = retry_after_s
        hint = (f"; retry after {retry_after_s:.3f}s"
                if retry_after_s is not None else "")
        super().__init__(f"request rejected ({reason}){hint}")


_ticket_ids = itertools.count()


class Ticket:
    """The caller's handle for one admitted request."""

    def __init__(self, request: Request, bucket: BucketSpec, enqueued_at: float):
        self.id = next(_ticket_ids)
        self.request = request
        self.bucket = bucket
        self.enqueued_at = enqueued_at
        self.latency_s: Optional[float] = None   # submit → result, filled
        self.deadline_missed = False             # by the engine at completion
        self._result: Any = None
        self._done = False

    def done(self) -> bool:
        return self._done

    def set_result(self, value: Any) -> None:
        self._result = value
        self._done = True

    def result(self) -> Any:
        if not self._done:
            raise RuntimeError(
                f"ticket {self.id} not served yet — pump() or drain() first")
        return self._result


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """max-wait/max-batch: flush a bucket at its static batch width, or
    when its oldest request has waited ``max_wait_s`` — whichever first.
    ``max_wait_s`` is therefore both the queueing-latency bound and the
    capacity-reject retry hint."""

    max_wait_s: float = 0.010

    def __post_init__(self):
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")


class MicroBatchQueue:
    """Per-bucket FIFO lanes behind one bounded total depth."""

    def __init__(self, lattice: BucketLattice, *, capacity: int = 256,
                 policy: Optional[FlushPolicy] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.lattice = lattice
        self.capacity = capacity
        self.policy = policy or FlushPolicy()
        self._lanes: Dict[BucketSpec, List[Ticket]] = {}
        self._depth = 0

    # -- admission -----------------------------------------------------------

    def offer(self, request: Request, now: float) -> Ticket:
        """Admit or raise :class:`Rejected` (see module docstring)."""
        spec = self.lattice.bucket_for(*request.shape_key())
        if spec is None:
            _obs.inc("serve.requests.rejected.no-bucket")
            raise Rejected("no-bucket", retry_after_s=None)
        if (request.deadline_s is not None
                and request.deadline_s < self.policy.max_wait_s):
            _obs.inc("serve.requests.rejected.deadline")
            raise Rejected("deadline", retry_after_s=None)
        if self._depth >= self.capacity:
            _obs.inc("serve.requests.rejected.capacity")
            raise Rejected("capacity", retry_after_s=self.policy.max_wait_s)
        ticket = Ticket(request, spec, enqueued_at=now)
        self._lanes.setdefault(spec, []).append(ticket)
        self._depth += 1
        _obs.inc("serve.requests.accepted")
        _obs.set_gauge("serve.queue.depth", self._depth)
        return ticket

    # -- flush selection -----------------------------------------------------

    def due(self, now: float, *, force: bool = False
            ) -> List[Tuple[BucketSpec, List[Ticket]]]:
        """Pop every flushable batch: full lanes always; aged (or, with
        ``force``, all nonempty) lanes ragged. Each batch is at most the
        bucket's static width B, FIFO within its lane."""
        batches = []
        for spec in list(self._lanes):
            lane = self._lanes[spec]
            while lane:
                full = len(lane) >= spec.batch
                aged = now - lane[0].enqueued_at >= self.policy.max_wait_s
                if not (full or aged or force):
                    break
                take = lane[:spec.batch]
                del lane[:spec.batch]
                self._depth -= len(take)
                batches.append((spec, take))
            if not lane:
                del self._lanes[spec]
        if batches:
            _obs.set_gauge("serve.queue.depth", self._depth)
        return batches

    # -- introspection -------------------------------------------------------

    def depth(self) -> int:
        return self._depth

    def lane_depths(self) -> Dict[str, int]:
        return {spec.label(): len(lane) for spec, lane in self._lanes.items()}
