"""The serve engine: pre-warmed, capture-once batched bucket dispatch (port
of ``repro.serve.engine``).

One :class:`Server` owns the lattice, the queue, and one **batched bucket
program** per :class:`BucketSpec`. The program is the packed
normal-equations pipeline of ``solve.lstsq`` over a leading batch dim,
composed so that each request slice is **bitwise-equal** to the
per-request ``solve.lstsq`` answer under the request-shaped twin of the
bucket plan (``tests/test_torch_serve.py`` holds the property suite):

    a32  = a.to(float32)                       # lstsq's own cast
    gram = ata_batched(a32, plan=⟨bucket ata plan, batch=B⟩, out='packed')
    gram = gram.add_scaled_identity(ridge[:, None, None, None])
    L    = cholesky(gram, plan=sp)             # ONE batched packed walk
    rhs  = Aᵀb (core.strassen._dot_tn)         # ONE batched product
    x    = solve_cholesky(L, rhs, base_trsm=per_slice_trsm)   # whiten: forward only

the reference's batched program, on every device. On the card each stage
sums an entry in an order that depends on neither the batch index, the
batch size, the entry's zero rows nor its zero right-hand-side columns:
the gram is one ``syrk`` launch, whose chunks of rows padding cannot move
(``kernels.syrk.syrk_splits``); ``Aᵀb`` and every Schur product of the
walk and of the substitutions are ``gemm_tn`` launches, one ``fmaf`` chain
per output over ascending rows, each column on its own; ``potrf`` and
``trsm`` solve a stack entry as a single tile
(``tools/serve_invariance.py`` holds each stage against the request's
own). The diagonal substitution solves loop the batch
(:func:`per_slice_trsm`), as the reference does. ``ridge`` is a per-entry
input, always added: mixing ridges in one flush costs nothing, and adding
0.0 on the gram diagonal is bitwise-transparent (gram diagonals are sums
of squares, never −0.0).

**On a CUDA device the program is one captured CUDA graph** with a private
memory pool. It reads static device buffers that a flush fills with one
non-blocking copy from pinned host memory, and writes a static output
that the flush copies back once. :meth:`Server.warm` builds each bucket
off the request path: the plan (one ``tune.cache.warm`` read), one eager
run of the pipeline (it builds and loads the kernel library, sets the
kernels' shared-memory attributes, fills the device tables and cuBLAS's
workspace, none of which may happen while capturing), the capture, and
one replay checked bitwise against the eager run. A failed capture or
replay raises: there is no eager fallback on the card. The program keeps
a strong reference to every device table the capture read
(``backend.holding_tables``), so the tables' LRU may drop them without
freeing memory a graph still reads. Replays run no Python, so the kernel
wrappers' counters do not see them: the program records the
``ops.launches`` delta of its capture and counts its replays.

**On the CPU**, and only when asked (``device="cpu"``), the program is the
same pipeline run eagerly on numpy-backed tensors; its one build (the
first run) is counted the same way.

Ragged tails fill their empty slots by **replicating the first real
request** — zero-filled slots would feed a singular gram to the factor.
Fill slots are work, counted (``serve.padded_slots``) and cropped, never
returned.

**The zero-recapture contract is asserted, not hoped**: each bucket's
program is built once, by :meth:`Server.warm` or by its first dispatch.
After that a flush on the card is one replay, which calls no kernel
wrapper, so the engine holds the wrappers' launch count
(``ops.launches``) still across every run of a program: growth means
kernel work ran eagerly (or was captured again) on the request path. The
engine adds the growth to ``serve.retraces`` and (by default) raises. On
the CPU the program is the eager pipeline by design, and its wrappers run
their plain versions, which count nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.obs import metrics as _obs
from repro_torch.serve import metrics as serve_metrics
from repro_torch.serve.bucketing import (
    BucketLattice,
    BucketSpec,
    crop_result,
    make_buckets,
    pad_operands,
)
from repro_torch.serve.queue import FlushPolicy, MicroBatchQueue, Request, Ticket

__all__ = ["ServeConfig", "Server", "smoke_config", "per_slice_trsm",
           "serve_abstract_args"]


def per_slice_trsm(l, c, *, transpose: bool):
    """Diagonal-tile substitution solves ``L·y = c`` (``transpose=False``)
    or ``Lᵀ·y = c``, one unbatched ``ops.trsm`` call per batch slice.

    The reference loops the batch here because XLA's rank-3 triangular
    solve rounds differently from its rank-2 one. The port's trsm kernel
    solves a stack entry in the same order as a single tile, but the
    solves stay one call a slice, as in the reference.
    """
    from repro_torch.solve.triangular import _left_solve

    if l.ndim == 2:
        return _left_solve(l, c, transpose=transpose)
    if l.ndim != 3:
        raise ValueError(f"per_slice_trsm expects (B, bn, bn), got {tuple(l.shape)}")
    return torch.stack([_left_solve(l[i], c[i], transpose=transpose)
                        for i in range(l.shape[0])], 0)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The server's published contract: which buckets exist and how the
    queue behaves. ``packed_block``/``n_base`` override the planner's
    choice uniformly; ``strict_retrace=False`` downgrades the
    zero-recapture assertion to a counter (never in production — tests
    only)."""

    buckets: Tuple[BucketSpec, ...]
    capacity: int = 256
    max_wait_s: float = 0.010
    cache_file: Optional[str] = None
    packed_block: Optional[int] = None
    n_base: Optional[int] = None
    strict_retrace: bool = True


def smoke_config(**overrides) -> ServeConfig:
    """The CI-scale config: the reference's small mixed lattice — the CLI
    ``--smoke`` and ``chip_smoke.py`` phase ``serve`` serve exactly these
    buckets."""
    buckets = (
        make_buckets(ops=("lstsq",), n_values=(32, 64), m_bands=(48, 96),
                     r_bands=(4, 8), batch=4)
        + make_buckets(ops=("whiten",), n_values=(32,), m_bands=(48,),
                       r_bands=(4,), batch=4)
    )
    kw = dict(buckets=buckets, capacity=64, max_wait_s=0.005)
    kw.update(overrides)
    return ServeConfig(**kw)


def serve_abstract_args(spec: BucketSpec, device=None) -> tuple:
    """Example ``(a, b, ridge)`` of the bucket program's static shapes on
    ``device`` (None: ``backend.DEFAULT_DEVICE``), zeros; the counterpart
    of the reference's ``ShapeDtypeStruct`` triple."""
    dev = backend.resolve_device(device)
    b_rows = spec.m if spec.op == "lstsq" else spec.n
    dtype = getattr(torch, spec.dtype)
    return (
        torch.zeros((spec.batch, spec.m, spec.n), dtype=dtype, device=dev),
        torch.zeros((spec.batch, b_rows, spec.r), dtype=dtype, device=dev),
        torch.zeros((spec.batch,), dtype=torch.float32, device=dev),
    )


def _pipeline(spec: BucketSpec, sp):
    """The batched pipeline of one bucket (module docstring) as a function
    of ``(a, b, ridge)`` tensors of the bucket's static shapes."""
    from repro_torch.core.ata import ata_batched
    from repro_torch.core.strassen import _dot_tn
    from repro_torch.solve.cholesky import cholesky
    from repro_torch.solve.triangular import solve_cholesky, solve_triangular

    # the gram plan of the batched pipeline — exactly lstsq's derivation
    # (op='ata', k=n, packed, method/predicted cleared) plus the batch dim
    ata_plan = dataclasses.replace(
        sp, op="ata", k=sp.n, out="packed", method=None, predicted_s=None,
        batch=spec.batch)

    def run(a, b, ridge):
        a32 = a.to(torch.float32)
        b32 = b.to(torch.float32)
        gram = ata_batched(a32, plan=ata_plan, out="packed", packed_block=sp.packed_block)
        gram = gram.add_scaled_identity(ridge.reshape(-1, 1, 1, 1))
        f = cholesky(gram, plan=sp)
        if spec.op == "lstsq":
            rhs = _dot_tn(a32, b32, torch.float32)   # Aᵀb batched, Aᵀ never formed
            return solve_cholesky(f, rhs, plan=sp, base_trsm=per_slice_trsm)
        # whiten: z = L⁻¹·v — forward substitution only
        return solve_triangular(f, b32, transpose=False, plan=sp, base_trsm=per_slice_trsm)

    return run


def _slots(shape, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flat, view)``: a float32 buffer and its ``shape`` view. A
    ``(B, rows, cols)`` view's entries start 256 bytes apart at least, so
    that each entry meets the kernels with the alignment of a fresh tensor,
    as its twin's does. The flat buffer is what a flush copies."""
    if len(shape) == 1:
        flat = torch.zeros(shape, dtype=torch.float32, **kw)
        return flat, flat
    B, rows, cols = shape
    stride = -(-rows * cols // 64) * 64
    flat = torch.zeros(B * stride, dtype=torch.float32, **kw)
    return flat, flat.as_strided(shape, (stride, cols, 1))


class _BucketProgram:
    """One bucket's pre-built batched program on one device (module
    docstring): staging buffers the flush fills, the pipeline, and on the
    card its captured graph."""

    def __init__(self, spec: BucketSpec, sp, device: torch.device):
        self.spec = spec
        self.device = device
        self.cuda = device.type == "cuda"
        self.run = _pipeline(spec, sp)
        b_rows = spec.m if spec.op == "lstsq" else spec.n
        shapes = ((spec.batch, spec.m, spec.n), (spec.batch, b_rows, spec.r), (spec.batch,))
        # host staging (pinned on the card) and, on the card, the graph's
        # static inputs of the same layout
        self._host = [_slots(s, pin_memory=self.cuda) for s in shapes]
        self._dev = [_slots(s, device=device) for s in shapes] if self.cuda else None
        self.builds = 0            # pipeline builds: eager first run (CPU) or captures (card)
        self.replays = 0           # flushes run by the program since it was built
        self.capture_launches: Optional[Dict[str, int]] = None  # ops.launches of the capture
        self.warm_s: Dict[str, float] = {}
        self._graph = None
        self._out = None
        self._tables: list = []    # device tables the graph reads, kept alive here

    def staging(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """numpy views ``(a (B, m, n), b (B, rows, r), ridge (B,))`` of the
        staging buffers: the flush writes the batch here."""
        return tuple(view.numpy() for _, view in self._host)

    def _inputs(self):
        return tuple(view for _, view in (self._dev if self.cuda else self._host))

    def build(self) -> None:
        """Build the program from what the staging buffers hold: on the CPU
        one eager run; on the card one eager run, the capture, and one
        replay held bitwise against the eager run. Raises if any fails; only
        a build that succeeds counts."""
        t0 = time.perf_counter()
        if self.cuda:
            with torch.cuda.device(self.device):
                self._capture(t0)
        else:
            self.run(*self._inputs())
            self.warm_s = {"eager_s": time.perf_counter() - t0}
        self.builds += 1

    def _capture(self, t0: float) -> None:
        from repro_torch.kernels import ops

        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._upload()
            eager = self.run(*self._inputs())
            stream.synchronize()
            t1 = time.perf_counter()
            before = dict(ops.launches)
            graph = torch.cuda.CUDAGraph()
            with backend.holding_tables() as held, torch.cuda.graph(graph, stream=stream):
                out = self.run(*self._inputs())
            launches = {k: ops.launches[k] - before[k] for k in before}
            stream.synchronize()
            t2 = time.perf_counter()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph.replay()
        if not torch.equal(out, eager):
            raise RuntimeError(f"bucket {self.spec.label()}: the captured graph's replay "
                               "differs from the eager run of the same inputs")
        self._graph, self._out, self._tables = graph, out, held
        self.capture_launches = launches
        self.warm_s = {"eager_s": t1 - t0, "capture_s": t2 - t1}

    def _upload(self) -> None:
        for (host, _), (dev, _) in zip(self._host, self._dev):
            dev.copy_(host, non_blocking=True)

    def __call__(self) -> np.ndarray:
        """Run the program on the staged batch; returns the ``(B, n, r)``
        result as a fresh numpy array (one device-to-host copy)."""
        if not self.builds:
            raise RuntimeError(f"bucket {self.spec.label()} has no built program")
        if not self.cuda:
            out = self.run(*self._inputs()).numpy()
        else:
            with torch.cuda.device(self.device):
                self._upload()
                self._graph.replay()
                out = self._out.cpu().numpy()
        self.replays += 1
        return out

    def stats(self) -> dict:
        rep = {"builds": self.builds, "replays": self.replays, **self.warm_s}
        if self.capture_launches is not None:
            rep["launches_per_replay"] = {k: v for k, v in self.capture_launches.items() if v}
            rep["launches_replayed"] = {k: v * self.replays
                                        for k, v in rep["launches_per_replay"].items()}
        return rep


class Server:
    """Gram-as-a-service: submit → bucket → micro-batch → one replay.

    ``device`` (None: ``backend.DEFAULT_DEVICE``, the card) is where every
    bucket program runs; it serves its config's lattice as it stands."""

    def __init__(self, config: ServeConfig, *,
                 clock: Callable[[], float] = time.perf_counter, device=None):
        self.config = config
        self.clock = clock
        self.device = backend.resolve_device(device)
        self.buckets: Tuple[BucketSpec, ...] = tuple(config.buckets)
        self.lattice = BucketLattice(self.buckets)
        self.queue = MicroBatchQueue(
            self.lattice, capacity=config.capacity,
            policy=FlushPolicy(max_wait_s=config.max_wait_s))
        self._plans: Dict[BucketSpec, object] = {}
        self._fns: Dict[BucketSpec, _BucketProgram] = {}
        self._warm_s: Dict[BucketSpec, float] = {}
        self.warmed = False

    # -- plan + program construction ----------------------------------------

    def bucket_plan(self, spec: BucketSpec):
        """The bucket's (unbatched) solve plan for this server's device —
        planner-resolved, pinned to the factor method (the batched pipeline
        IS the factor path; a cg plan would break the parity contract's
        reference)."""
        plan = self._plans.get(spec)
        if plan is None:
            from repro_torch import tune

            sp = tune.plan(op="solve", m=spec.m, n=spec.n, k=spec.r,
                           dtype=spec.dtype, out="packed", backend=self.device.type,
                           cache_file=self.config.cache_file)
            repl = {"method": "factor", "predicted_s": None}
            if self.config.packed_block is not None:
                repl["packed_block"] = self.config.packed_block
            if self.config.n_base is not None:
                repl["n_base"] = self.config.n_base
            plan = dataclasses.replace(sp, **repl)
            self._plans[spec] = plan
        return plan

    def request_twin(self, spec: BucketSpec, m: int, r: int):
        """The parity reference's plan: the bucket plan re-shaped to one
        request — what per-request ``solve.lstsq`` must be called with to
        reproduce a bucketed slice bit for bit."""
        return dataclasses.replace(self.bucket_plan(spec), m=m, k=r)

    def bucket_callable(self, spec: BucketSpec) -> Tuple[_BucketProgram, object]:
        """(the bucket's program, unbatched solve plan); the program is
        built by :meth:`warm` or by the bucket's first dispatch."""
        fn = self._fns.get(spec)
        sp = self.bucket_plan(spec)
        if fn is None:
            fn = _BucketProgram(spec, sp, self.device)
            self._fns[spec] = fn
        return fn, sp

    # -- pre-warm ------------------------------------------------------------

    def warm(self, *, verbose: bool = False) -> Dict[str, float]:
        """Populate the plan cache AND build every bucket, off the request
        path: one bulk plan-cache read (``tune.cache.warm``), then per
        bucket one eager run on a dummy batch and, on the card, the capture
        and its checked replay. Returns {bucket label: warm seconds}."""
        from repro_torch.tune import cache as tune_cache

        # ONE cache-file read resolves every bucket's plan key into the
        # planner memo; the per-bucket plan() calls below are memo hits.
        tune_cache.warm(
            [dict(op="solve", m=s.m, n=s.n, k=s.r, dtype=s.dtype,
                  out="packed", backend=self.device.type) for s in self.buckets],
            cache_file=self.config.cache_file)

        report = {}
        for spec in self.buckets:
            fn, _sp = self.bucket_callable(spec)
            # a well-conditioned dummy: eye(m, n) plus a small seeded
            # perturbation has full column rank, so the factor path builds
            # against a non-singular gram, and the replay check compares
            # arithmetic on values that are not all zeros and ones
            rng = np.random.default_rng(0)
            a, b, ridge = fn.staging()
            a[:] = np.eye(spec.m, spec.n, dtype=np.float32)
            a += np.float32(1e-2) * rng.standard_normal(a.shape, dtype=np.float32)
            b[:] = rng.standard_normal(b.shape, dtype=np.float32)
            ridge[:] = 0.0
            t0 = self.clock()
            fn.build()
            dt = self.clock() - t0
            self._warm_s[spec] = dt
            _obs.observe("serve.warm.seconds", dt)
            report[spec.label()] = dt
            if verbose:
                print(f"  warmed {spec.label()} in {dt:.3f}s", flush=True)
        self.warmed = True
        return report

    # -- request path --------------------------------------------------------

    def submit(self, request: Request) -> Ticket:
        """Admit one request (may raise :class:`Rejected`) and dispatch any
        bucket its arrival filled."""
        now = self.clock()
        ticket = self.queue.offer(request, now)
        self.pump()
        return ticket

    def pump(self, *, force: bool = False) -> int:
        """Dispatch every due batch; returns the number of flushes."""
        batches = self.queue.due(self.clock(), force=force)
        for spec, tickets in batches:
            self._dispatch(spec, tickets)
        return len(batches)

    def drain(self) -> None:
        """Force-flush until the queue is empty (every ticket resolved)."""
        while self.queue.depth():
            self.pump(force=True)

    # -- the flush -----------------------------------------------------------

    def _dispatch(self, spec: BucketSpec, tickets: List[Ticket]) -> None:
        # batch assembly is NUMPY end to end, straight into the program's
        # staging buffers (pinned on the card): the device sees one copy in,
        # one replay, one copy out
        fn, _sp = self.bucket_callable(spec)
        a_stk, b_stk, ridge = fn.staging()
        vectors = []
        pad_rows = pad_cols = 0
        for i, t in enumerate(tickets):
            req = t.request
            b_np = np.asarray(req.b)
            vec = b_np.ndim == 1
            vectors.append(vec)
            b2 = b_np[:, None] if vec else b_np
            m, r = req.a.shape[0], b2.shape[-1]
            pad_operands(spec, req.a, b2, out=(a_stk[i], b_stk[i]))
            ridge[i] = req.ridge
            pad_rows += spec.m - m
            pad_cols += spec.r - r
        fill = spec.batch - len(tickets)
        if fill:
            # replicate a REAL request into the empty slots: a zero design
            # matrix would hand the factor a singular gram. Fill slices are
            # work, never returned.
            a_stk[len(tickets):] = a_stk[0]
            b_stk[len(tickets):] = b_stk[0]
            ridge[len(tickets):] = ridge[0]
            _obs.inc("serve.padded_slots", fill)
            _obs.inc("serve.flushes.ragged")
        _obs.inc("serve.flushes")
        _obs.inc("serve.padded_rows", pad_rows)
        _obs.inc("serve.padded_cols", pad_cols)

        from repro_torch.kernels import ops

        t0 = self.clock()
        if not fn.builds:
            # cold dispatch (no warm pass): the first flush builds (and on
            # the card captures) by design, before the count below
            fn.build()
        launched = sum(ops.launches.values())
        out_np = fn()
        serve_metrics.record_latency("dispatch", self.clock() - t0)

        self._assert_no_retrace(spec, sum(ops.launches.values()) - launched)

        done_at = self.clock()
        for i, t in enumerate(tickets):
            r = 1 if vectors[i] else t.request.b.shape[-1]
            x = crop_result(spec, out_np[i], r)
            t.set_result(x[:, 0] if vectors[i] else x)
            t.latency_s = done_at - t.enqueued_at
            serve_metrics.record_latency("request", t.latency_s)
            serve_metrics.record_latency(f"request.{spec.label()}",
                                         t.latency_s)
            dl = t.request.deadline_s
            if dl is not None and t.latency_s > dl:
                t.deadline_missed = True
                _obs.inc("serve.deadline_missed")
            _obs.inc("serve.requests.completed")

    def _assert_no_retrace(self, spec: BucketSpec, grew: int) -> None:
        """``grew``: kernel wrapper launches during one run of the bucket's
        program, which a replay never makes."""
        if grew:
            _obs.inc("serve.retraces", grew)
            if self.config.strict_retrace:
                raise RuntimeError(
                    f"bucket {spec.label()} launched {grew} kernels eagerly on the "
                    "request path; the zero-recapture contract is broken")

    # -- introspection -------------------------------------------------------

    def retraces(self) -> int:
        return _obs.get("serve.retraces")

    def stats(self) -> dict:
        """One JSON-serializable serving snapshot; ``programs`` carries each
        bucket's builds, replays and, on the card, the kernel launches of
        one replay (the wrappers' counters do not see replays)."""
        return {
            "device": str(self.device),
            "buckets": [s.label() for s in self.buckets],
            "warmed": self.warmed,
            "warm_seconds": {s.label(): t for s, t in self._warm_s.items()},
            "queue_depth": self.queue.depth(),
            "lane_depths": self.queue.lane_depths(),
            "counters": _obs.counters("serve."),
            "latency": serve_metrics.latency_summary(),
            "programs": {s.label(): fn.stats() for s, fn in self._fns.items()},
        }
