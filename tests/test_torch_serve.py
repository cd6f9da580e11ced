"""``repro_torch.serve`` on the CPU, against ``repro.serve`` and against
itself.

* The cases of ``tests/test_serve.py`` on ``device="cpu"``, the check
  harness's included (``repro_torch.check.harness.run_serve``).
* Equal to the reference, exactly: the lattice (fields, keys, labels,
  JSON), routing, ``pad_operands``'s bits, the queue's decisions and reject
  reasons on a fake clock, and the ``serve.*`` counters of one seeded
  workload run through both servers.
* Close to the reference: each served result within a relative
  ``max(1e-4, 8·κ·eps32)`` of the reference's, κ the float64 condition
  number of the request's ridge gram — 1e-4 is ``test_torch_solve``'s
  ``lstsq`` tolerance, which well-conditioned requests meet; the smoke
  workload's square and near-square requests (``m = 33, n = 32``; ``m = n =
  64``) have κ up to ~1e5, where the two float32 pipelines (XLA's dots
  against MKL's, the same blocked algorithm) may part by ``κ·eps``.
* Bitwise inside the port: every served slice equals the port's own
  per-request twin (``lstsq(plan=request_twin)`` and the whiten pipeline).
* The lattice's surface is the reference's on every device: the spec's
  fields, the module's names, admission, and a server on a CUDA device
  serving its config's buckets as they stand (``tests/test_torch_cuda.py``
  holds the padded stages bitwise on the card).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.obs import metrics as ref_obs
from repro.serve import bucketing as ref_bucketing
from repro.serve import engine as ref_engine
from repro.serve import queue as ref_queue
from repro.serve.__main__ import _mixed_workload as ref_mixed_workload
from repro.serve.__main__ import _run_workload as ref_run_workload
from repro_torch import backend
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import bucketing as port_bucketing
from repro_torch.serve import metrics as serve_metrics
from repro_torch.serve import queue as port_queue
from repro_torch.serve.__main__ import _mixed_workload, _run_workload
from repro_torch.serve.bucketing import (
    BucketLattice,
    BucketSpec,
    crop_result,
    make_buckets,
    pad_operands,
)
from repro_torch.serve.engine import (
    Server,
    ServeConfig,
    per_slice_trsm,
    serve_abstract_args,
    smoke_config,
)
from repro_torch.serve.queue import Rejected, Request

ROOT = Path(__file__).resolve().parents[1]
EPS32 = 1.19e-7
CPU = "cpu"

# ---------------------------------------------------------------------------
# bucketing


def test_bucket_spec_validation():
    with pytest.raises(ValueError):
        BucketSpec(op="qr", m=8, n=8, r=1, batch=1)
    with pytest.raises(ValueError):
        BucketSpec(op="lstsq", m=4, n=8, r=1, batch=1)  # m < n
    with pytest.raises(ValueError):
        BucketSpec(op="lstsq", m=8, n=8, r=0, batch=1)


def test_bucket_admission_rules():
    s = BucketSpec(op="lstsq", m=48, n=32, r=4, batch=4)
    assert s.admits("lstsq", 48, 32, 4, "float32")
    assert s.admits("lstsq", 33, 32, 1, "float32")   # m, r band up
    assert not s.admits("lstsq", 49, 32, 4, "float32")   # m over capacity
    assert not s.admits("lstsq", 48, 33, 4, "float32")   # n is exact
    assert not s.admits("lstsq", 48, 32, 5, "float32")   # r over capacity
    assert not s.admits("whiten", 48, 32, 4, "float32")  # op is exact
    assert not s.admits("lstsq", 48, 32, 4, "float64")   # dtype is exact
    exact = BucketSpec(op="lstsq", m=48, n=32, r=4, batch=4, exact_m=True)
    assert exact.admits("lstsq", 48, 32, 2, "float32")
    assert not exact.admits("lstsq", 40, 32, 2, "float32")  # no m banding


def test_make_buckets_marks_recursing_grams_exact_m():
    specs = make_buckets(ops=("lstsq",), n_values=(32, 128), m_bands=(128,),
                         r_bands=(4,), batch=2, n_base=64)
    by_n = {s.n: s for s in specs}
    assert not by_n[32].exact_m       # single-leaf gram: m-padding is bitwise
    assert by_n[128].exact_m          # recursing gram: padding moves the split
    # m bands below n are skipped, and an all-skipped lattice is an error
    assert all(s.m >= s.n for s in
               make_buckets(n_values=(32,), m_bands=(16, 48), batch=1))
    with pytest.raises(ValueError):
        make_buckets(n_values=(64,), m_bands=(32,), batch=1)


def test_lattice_routes_to_tightest_bucket():
    lattice = BucketLattice(make_buckets(
        ops=("lstsq",), n_values=(32,), m_bands=(48, 96), r_bands=(4, 8),
        batch=4, n_base=64))
    assert lattice.bucket_for("lstsq", 40, 32, 3).key == \
        ("lstsq", 48, 32, 4, "float32")
    assert lattice.bucket_for("lstsq", 50, 32, 3).key == \
        ("lstsq", 96, 32, 4, "float32")
    assert lattice.bucket_for("lstsq", 40, 32, 5).key == \
        ("lstsq", 48, 32, 8, "float32")
    assert lattice.bucket_for("lstsq", 40, 64, 3) is None   # unknown n
    assert lattice.bucket_for("lstsq", 97, 32, 3) is None   # over every band
    with pytest.raises(ValueError):
        BucketLattice([BucketSpec(op="lstsq", m=8, n=8, r=1, batch=1)] * 2)


def test_pad_operands_is_numpy_zero_padding():
    spec = BucketSpec(op="lstsq", m=48, n=32, r=4, batch=4)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 32)).astype(np.float32)
    b = rng.standard_normal((40, 3)).astype(np.float32)
    a_pad, b_pad = pad_operands(spec, a, b)
    assert isinstance(a_pad, np.ndarray) and isinstance(b_pad, np.ndarray)
    assert a_pad.shape == (48, 32) and b_pad.shape == (48, 4)
    np.testing.assert_array_equal(a_pad[:40], a)
    assert not a_pad[40:].any() and not b_pad[40:].any()
    assert not b_pad[:, 3:].any()
    np.testing.assert_array_equal(crop_result(spec, b_pad, 3), b_pad[:, :3])
    # whiten's rhs lives in feature space: rows pad to n, not m
    wspec = BucketSpec(op="whiten", m=48, n=32, r=4, batch=4)
    _, v_pad = pad_operands(wspec, a, rng.standard_normal((32, 2)))
    assert v_pad.shape == (32, 4)
    for bad_a, bad_b in [(rng.standard_normal((40, 33)), b),    # wrong n
                         (rng.standard_normal((49, 32)), b),    # m over
                         (a, rng.standard_normal((40, 5)))]:    # r over
        with pytest.raises(ValueError):
            pad_operands(spec, bad_a, bad_b)


def test_pad_operands_into_staging_slots():
    """``out=`` writes the same zero-padded bits into dirty float32 slots,
    casting float64 as the pipeline's own float32 cast would."""
    spec = BucketSpec(op="lstsq", m=48, n=32, r=4, batch=4)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((40, 32))
    b = rng.standard_normal((40, 3))
    slots = (np.full((48, 32), 7.0, np.float32), np.full((48, 4), 7.0, np.float32))
    got = pad_operands(spec, a, b, out=slots)
    assert got[0] is slots[0] and got[1] is slots[1]
    for x, y in zip(got, pad_operands(spec, a.astype(np.float32), b.astype(np.float32))):
        np.testing.assert_array_equal(x, y)


def test_bucket_spec_json_roundtrip():
    s = BucketSpec(op="whiten", m=96, n=64, r=8, batch=2, dtype="float64",
                   exact_m=True)
    assert BucketSpec.from_json(json.loads(json.dumps(s.to_json()))) == s


# ---------------------------------------------------------------------------
# the lattice, routing and padding against the reference, exactly

LATTICES = [
    dict(ops=("lstsq",), n_values=(32, 64), m_bands=(48, 96), r_bands=(4, 8), batch=4),
    dict(ops=("whiten",), n_values=(32,), m_bands=(48,), r_bands=(4,), batch=4),
    dict(ops=("lstsq", "whiten"), n_values=(32, 128, 600), m_bands=(16, 128, 700, 4096),
         r_bands=(1, 8, 64), batch=8, dtype="float64"),
    dict(ops=("lstsq",), n_values=(32, 128), m_bands=(128,), r_bands=(4,), batch=2,
         n_base=64),
]


@pytest.mark.parametrize("kw", LATTICES, ids=lambda kw: "-".join(map(str, kw["n_values"])))
def test_lattice_fields_labels_json_equal_reference(kw):
    ref = ref_bucketing.make_buckets(**kw)
    got = make_buckets(**kw)
    assert [s.to_json() for s in got] == [dataclasses.asdict(s) for s in ref]
    assert [s.label() for s in got] == [s.label() for s in ref]
    assert [s.key for s in got] == [s.key for s in ref]
    # the reference's JSON reads into the port's spec as it is
    assert tuple(BucketSpec.from_json(json.loads(json.dumps(s.to_json()))) for s in ref) == got
    assert [s.key for s in BucketLattice(got).specs] == \
        [s.key for s in ref_bucketing.BucketLattice(ref).specs]


def test_smoke_config_equals_reference():
    ref, got = ref_engine.smoke_config(), smoke_config()
    assert [s.to_json() for s in got.buckets] == [dataclasses.asdict(s) for s in ref.buckets]
    assert (got.capacity, got.max_wait_s, got.strict_retrace) == \
        (ref.capacity, ref.max_wait_s, ref.strict_retrace)
    server = Server(got, device=CPU)
    assert server.buckets == got.buckets and server.device == torch.device(CPU)


def test_routing_equals_reference():
    kw = LATTICES[0]
    ref = ref_bucketing.BucketLattice(ref_bucketing.make_buckets(**kw))
    got = BucketLattice(make_buckets(**kw))
    for op in ("lstsq", "whiten"):
        for m in (1, 31, 32, 33, 47, 48, 49, 64, 95, 96, 97):
            for n in (31, 32, 64):
                for r in (1, 3, 4, 5, 8, 9):
                    for dt in ("float32", "float64"):
                        rs = ref.bucket_for(op, m, n, r, dt)
                        gs = got.bucket_for(op, m, n, r, dt)
                        assert (rs and rs.key) == (gs and gs.key), (op, m, n, r, dt)


def test_pad_operands_bits_equal_reference():
    rng = np.random.default_rng(2)
    for op, m, r, dt in (("lstsq", 40, 3, np.float32), ("lstsq", 48, 4, np.float64),
                         ("whiten", 33, 1, np.float32)):
        spec = BucketSpec(op=op, m=48, n=32, r=4, batch=4, dtype=np.dtype(dt).name)
        rspec = ref_bucketing.BucketSpec(**spec.to_json())
        a = rng.standard_normal((m, 32)).astype(dt)
        b = rng.standard_normal((m if op == "lstsq" else 32, r)).astype(dt)
        for x, y in zip(pad_operands(spec, a, b), ref_bucketing.pad_operands(rspec, a, b)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# the lattice's surface is the reference's on every device


@pytest.mark.parametrize("what", ["fields", "names", "admits", "server_on_cuda"])
def test_bucketing_surface_equals_reference(what):
    """``BucketSpec``'s fields (names and defaults), ``serve.bucketing``'s
    ``__all__`` and every admission decision equal the reference's, and a
    server on a CUDA device serves its config's buckets as they stand: the
    card adds no rule of its own to the lattice."""
    if what == "fields":
        got = [(f.name, f.default) for f in dataclasses.fields(BucketSpec)]
        assert got == [(f.name, f.default) for f in dataclasses.fields(ref_bucketing.BucketSpec)]
    elif what == "names":
        assert port_bucketing.__all__ == ref_bucketing.__all__
    elif what == "admits":
        for s in make_buckets(**LATTICES[2]):
            rs = ref_bucketing.BucketSpec(**s.to_json())
            for op in ("lstsq", "whiten"):
                for m in (1, 16, 17, 128, 129, 700, 701, 4096, 4097):
                    for r in (1, 7, 8, 9, 64, 65):
                        args = (op, m, s.n, r, s.dtype)
                        assert s.admits(*args) == rs.admits(*args), (s.label(), args)
    else:
        lattice = (make_buckets(ops=("lstsq",), n_values=(256, 512), m_bands=(512, 8192),
                                r_bands=(1, 8, 64), batch=8)
                   + make_buckets(ops=("whiten",), n_values=(1024,), m_bands=(4096,),
                                  r_bands=(64,), batch=4))
        server = Server(ServeConfig(buckets=lattice), device="cuda")
        assert server.buckets == lattice
        assert [s.key for s in server.lattice.specs] == \
            [s.key for s in ref_bucketing.BucketLattice(
                [ref_bucketing.BucketSpec(**s.to_json()) for s in lattice]).specs]


def test_dot_tn_one_column_equals_the_column_of_a_wider_product():
    """``Aᵀb`` for one column is the first column of the two-column product,
    bitwise, so a vector right-hand side rounds like the same column beside
    others (the banded ``r`` of the CPU lattice relies on it)."""
    from repro_torch.core.strassen import _dot_tn

    rng = np.random.default_rng(3)
    for m, n, r in ((33, 32, 4), (48, 32, 8), (67, 64, 8), (96, 64, 4)):
        a = torch.as_tensor(rng.standard_normal((m, n)).astype(np.float32))
        b = torch.as_tensor(rng.standard_normal((m, r)).astype(np.float32))
        wide = _dot_tn(a, b, torch.float32)
        assert torch.equal(_dot_tn(a, b[:, :1], torch.float32), wide[:, :1])
        assert torch.equal(_dot_tn(a, b[:, :2], torch.float32), wide[:, :2])


def test_holding_tables_keeps_what_the_lru_drops():
    from repro_torch.backend import device_table, holding_tables

    with holding_tables() as held:
        t = device_table(("serve_test_hold", 0), CPU, lambda: np.arange(5))
        assert device_table(("serve_test_hold", 0), CPU, lambda: np.arange(7)) is t  # a hit
    device_table(("serve_test_hold", 1), CPU, lambda: np.arange(3))       # outside: not held
    assert len(held) == 2 and all(x is t for x in held)


# ---------------------------------------------------------------------------
# queue (fake clock), and its decisions against the reference's


def _queue(capacity=8, max_wait_s=0.01, batch=3, ref=False):
    bmod, qmod = (ref_bucketing, ref_queue) if ref else (port_bucketing, port_queue)
    lattice = bmod.BucketLattice(bmod.make_buckets(
        ops=("lstsq",), n_values=(8,), m_bands=(8, 16), r_bands=(2,),
        batch=batch, n_base=64))
    return qmod.MicroBatchQueue(lattice, capacity=capacity,
                                policy=qmod.FlushPolicy(max_wait_s=max_wait_s))


def _lstsq_req(rng, m, n, r):
    return port_queue.Request(op="lstsq", a=rng.standard_normal((m, n), np.float32),
                              b=rng.standard_normal((m, r), np.float32))


def _req(m=8, n=8, r=2, ref=False, **kw):
    return (ref_queue if ref else port_queue).Request(
        op="lstsq", a=np.zeros((m, n), np.float32), b=np.zeros((m, r), np.float32), **kw)


def test_queue_max_batch_flush_and_fifo():
    q = _queue(batch=3)
    tickets = [q.offer(_req(), now=0.0) for _ in range(3)]
    assert q.depth() == 3
    batches = q.due(0.0)
    assert len(batches) == 1 and q.depth() == 0
    assert [t.id for _, lane in batches for t in lane] == \
        [t.id for t in tickets]                      # FIFO within the lane


def test_queue_max_wait_flushes_ragged():
    q = _queue(max_wait_s=0.01, batch=3)
    q.offer(_req(), now=0.0)
    assert q.due(0.005) == []                        # young: not due yet
    batches = q.due(0.02)                            # aged past max_wait
    assert len(batches) == 1 and len(batches[0][1]) == 1
    q.offer(_req(), now=1.0)
    assert len(q.due(1.0, force=True)) == 1          # force drains young lanes


def test_queue_reject_reasons_and_retry_hints():
    q = _queue(capacity=2, max_wait_s=0.01)
    with pytest.raises(Rejected) as e:
        q.offer(_req(n=9), now=0.0)                  # no bucket for n=9
    assert e.value.reason == "no-bucket" and e.value.retry_after_s is None
    with pytest.raises(Rejected) as e:
        q.offer(_req(deadline_s=0.001), now=0.0)     # budget < max_wait
    assert e.value.reason == "deadline"
    q.offer(_req(), now=0.0)
    q.offer(_req(), now=0.0)
    with pytest.raises(Rejected) as e:
        q.offer(_req(), now=0.0)                     # bounded depth
    assert e.value.reason == "capacity"
    assert e.value.retry_after_s == pytest.approx(0.01)  # the flush bound


def test_queue_lane_depths_track_buckets():
    q = _queue(batch=3)
    q.offer(_req(m=8), now=0.0)
    q.offer(_req(m=16), now=0.0)
    depths = q.lane_depths()
    assert sum(depths.values()) == 2 and len(depths) == 2


def _queue_trace(ref):
    """One fake-clock script of offers and flushes: every admission
    decision (bucket or reason, retry hint) and every due batch (bucket,
    request positions), in order."""
    q = _queue(capacity=3, max_wait_s=0.01, batch=3, ref=ref)
    script = [(0.0, dict(m=8)), (0.001, dict(m=16)), (0.002, dict(m=12, r=1)),
              (0.003, dict(n=9)), (0.004, dict(m=8, deadline_s=0.005)),
              (0.005, dict(m=8, deadline_s=0.5)), (0.006, dict(m=17)),
              (0.007, dict(m=3)), (0.008, dict(m=8)), (0.009, dict(m=9)),
              (0.0095, dict(m=8)), (0.0097, dict(m=16))]
    trace, pos = [], {}
    for i, (now, kw) in enumerate(script):
        try:
            t = q.offer(_req(ref=ref, **kw), now=now)
            pos[t.id] = i
            trace.append(("ok", t.bucket.label()))
        except (Rejected, ref_queue.Rejected) as e:
            trace.append((e.reason, e.retry_after_s))
        for now_due in ((now, now + 0.0105) if i % 4 == 3 else (now,)):
            for spec, lane in q.due(now_due):
                trace.append(("due", now_due, spec.label(), [pos[t.id] for t in lane]))
        trace.append(("depths", sorted(q.lane_depths().items()), q.depth()))
    for spec, lane in q.due(1.0, force=True):
        trace.append(("due", "force", spec.label(), [pos[t.id] for t in lane]))
    return trace


def test_queue_decisions_equal_reference():
    ref, got = _queue_trace(True), _queue_trace(False)
    assert got == ref
    reasons = {t[0] for t in got}
    assert {"ok", "no-bucket", "deadline", "capacity", "due"} <= reasons


# ---------------------------------------------------------------------------
# serve metrics


def test_percentile_interpolation_and_reservoir_bound():
    assert np.isnan(serve_metrics.percentile([], 50))
    vals = list(map(float, range(100)))
    assert serve_metrics.percentile(vals, 50) == pytest.approx(49.5)
    assert serve_metrics.percentile(vals, 99) == pytest.approx(98.01)
    serve_metrics.reset()
    for i in range(serve_metrics.RESERVOIR_SIZE + 100):
        serve_metrics.record_latency("boundcheck", float(i))
    got = serve_metrics.samples("boundcheck")
    assert len(got) == serve_metrics.RESERVOIR_SIZE
    assert got[0] == 100.0                           # oldest samples evicted
    serve_metrics.reset()


def test_publish_percentiles_lands_in_obs_snapshot():
    serve_metrics.reset()
    for v in (0.001, 0.002, 0.003):
        serve_metrics.record_latency("pubcheck", v)
    published = serve_metrics.publish_percentiles()
    assert published["serve.latency.pubcheck.p50"] == pytest.approx(0.002)
    snap = obs_metrics.validate_snapshot(obs_metrics.snapshot())
    assert "serve.latency.pubcheck.p95" in snap["gauges"]
    summary = serve_metrics.percentiles("pubcheck")
    assert summary["count"] == 3 and summary["mean"] == pytest.approx(0.002)
    serve_metrics.reset()


# ---------------------------------------------------------------------------
# engine: the bitwise parity property suite (on the CPU)


@pytest.fixture(scope="module")
def warm_server():
    server = Server(smoke_config(), device=CPU)
    server.warm()
    return server


def _lstsq_ref(server, ticket):
    """The parity reference: per-request ``solve.lstsq`` under the request
    twin of the bucket plan (the published contract of the serving layer)."""
    from repro_torch.solve import lstsq

    req = ticket.request
    m = req.a.shape[0]
    r = 1 if req.b.ndim == 1 else req.b.shape[-1]
    twin = server.request_twin(ticket.bucket, m, r)
    return lstsq(torch.as_tensor(req.a), torch.as_tensor(req.b), ridge=req.ridge,
                 plan=twin).numpy()


def _whiten_ref(server, ticket):
    """Unbatched whiten pipeline: z = L⁻¹·v from the packed factor of the
    (ridge-shifted) gram, under the request twin."""
    from repro_torch.core.ata import ata
    from repro_torch.solve import cholesky, solve_triangular

    req = ticket.request
    sp = server.bucket_plan(ticket.bucket)
    twin = server.request_twin(ticket.bucket, req.a.shape[0], req.b.shape[-1])
    ata_plan = dataclasses.replace(twin, op="ata", k=twin.n, out="packed",
                                   method=None, predicted_s=None)
    gram = ata(torch.as_tensor(req.a, dtype=torch.float32), plan=ata_plan, out="packed",
               packed_block=sp.packed_block)
    gram = gram.add_scaled_identity(req.ridge)
    f = cholesky(gram, plan=twin)
    return solve_triangular(f, torch.as_tensor(req.b, dtype=torch.float32),
                            transpose=False, plan=twin).numpy()


def _twin(server, ticket):
    return (_lstsq_ref if ticket.request.op == "lstsq" else _whiten_ref)(server, ticket)


def test_mixed_workload_parity_is_bitwise(warm_server):
    """The headline property: ragged m/r, vector rhs, mixed ridges, both
    ops — every served slice bitwise-equals its per-request twin."""
    served, rejected = _run_workload(warm_server, _mixed_workload(24, 11))
    assert rejected == 0 and all(t.done() for t in served)
    assert warm_server.retraces() == 0
    for t in served:
        np.testing.assert_array_equal(_twin(warm_server, t), np.asarray(t.result()),
                                      err_msg=t.bucket.label())


def test_parity_at_exact_bucket_edges(warm_server):
    """Requests at exact capacity (no padding) and one row/col inside it
    (maximal pad-then-crop) meet the same bitwise contract."""
    rng = np.random.default_rng(5)
    for m, r in [(48, 4), (47, 3), (96, 8), (33, 1)]:
        a = rng.standard_normal((m, 32)).astype(np.float32)
        b = rng.standard_normal((m, r)).astype(np.float32)
        t = warm_server.submit(Request(op="lstsq", a=a, b=b, ridge=1e-4))
        warm_server.drain()
        np.testing.assert_array_equal(_lstsq_ref(warm_server, t), np.asarray(t.result()),
                                      err_msg=f"m={m} r={r}")
        assert t.result().shape == (32, r)


def test_vector_rhs_roundtrip(warm_server):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((40, 32)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    t = warm_server.submit(Request(op="lstsq", a=a, b=b))
    warm_server.drain()
    assert t.result().shape == (32,)                 # 1-D in, 1-D out
    np.testing.assert_array_equal(_lstsq_ref(warm_server, t),
                                  np.asarray(t.result()))


def test_float64_requests_share_the_contract():
    """An f64 bucket serves f64 payloads; parity stays bitwise because
    both paths share lstsq's f32 compute cast."""
    cfg = ServeConfig(
        buckets=(BucketSpec(op="lstsq", m=48, n=32, r=2, batch=2,
                            dtype="float64"),),
        capacity=8, max_wait_s=0.005)
    server = Server(cfg, device=CPU)
    server.warm()
    rng = np.random.default_rng(7)
    a = rng.standard_normal((40, 32))
    b = rng.standard_normal((40, 2))
    t = server.submit(Request(op="lstsq", a=a, b=b, ridge=1e-3))
    server.drain()
    np.testing.assert_array_equal(_lstsq_ref(server, t),
                                  np.asarray(t.result()))
    assert server.retraces() == 0


def test_ragged_flush_replicates_a_real_request(warm_server):
    """A lone request in a width-4 bucket flushes with 3 replicated fill
    slots (counted, cropped, never returned) and still matches its ref."""
    before = obs_metrics.get("serve.padded_slots")
    rng = np.random.default_rng(8)
    a = rng.standard_normal((40, 32)).astype(np.float32)
    b = rng.standard_normal((40, 2)).astype(np.float32)
    t = warm_server.submit(Request(op="lstsq", a=a, b=b))
    warm_server.drain()
    assert obs_metrics.get("serve.padded_slots") - before == 3
    np.testing.assert_array_equal(_lstsq_ref(warm_server, t),
                                  np.asarray(t.result()))


def test_warm_arms_the_retrace_floor(warm_server):
    """Warm builds every bucket's program once; a flush after it launches
    nothing outside the program (on the CPU the plain versions count
    nothing at all)."""
    from repro_torch.kernels import ops

    assert warm_server.warmed
    for spec in warm_server.buckets:
        assert warm_server.bucket_callable(spec)[0].builds == 1   # one build per bucket
    launched, retraces = dict(ops.launches), warm_server.retraces()
    rng = np.random.default_rng(11)
    warm_server.submit(_lstsq_req(rng, 40, 32, 2))
    warm_server.drain()
    assert ops.launches == launched and warm_server.retraces() == retraces
    stats = warm_server.stats()
    assert set(stats["warm_seconds"]) == {s.label() for s in warm_server.buckets}
    assert stats["device"] == CPU
    assert all(p["builds"] == 1 for p in stats["programs"].values())


def test_retrace_assertion_raises_strict_counts_lenient(warm_server, monkeypatch):
    """A flush whose program launches a kernel through a wrapper (eager
    work on the request path, which a replay never does) is counted in
    ``serve.retraces`` and raises under ``strict_retrace``; lenient, it
    is counted and served."""
    from repro_torch.kernels import ops

    start = obs_metrics.get("serve.retraces")
    launched = dict(ops.launches)
    spec = warm_server.lattice.bucket_for("lstsq", 40, 32, 2)
    fn, _ = warm_server.bucket_callable(spec)
    real = fn.run

    def eager_launch(*args):
        ops.launches["syrk"] += 1                   # as a wrapper launching its kernel
        return real(*args)

    monkeypatch.setattr(fn, "run", eager_launch)
    rng = np.random.default_rng(13)
    with pytest.raises(RuntimeError, match="zero-recapture"):
        warm_server.submit(_lstsq_req(rng, 40, 32, 2))
        warm_server.drain()
    assert obs_metrics.get("serve.retraces") == start + 1
    lenient = Server(dataclasses.replace(warm_server.config,
                                         strict_retrace=False), device=CPU)
    lenient._plans = warm_server._plans
    lenient._fns = warm_server._fns
    t = lenient.submit(_lstsq_req(rng, 40, 32, 2))
    lenient.drain()                                  # counts, no raise
    assert t.done() and obs_metrics.get("serve.retraces") == start + 2
    # the counters are process-global: undo the simulated launches so later
    # tests (and fresh servers) still see a clean steady state
    ops.launches.update(launched)
    obs_metrics.inc("serve.retraces", start - obs_metrics.get("serve.retraces"))


def test_server_propagates_admission_rejects(warm_server):
    with pytest.raises(Rejected):
        warm_server.submit(_req(m=8, n=8, r=2))      # n=8 not in the lattice


def test_deadline_missed_is_flagged(warm_server):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((40, 32)).astype(np.float32)
    b = rng.standard_normal((40, 2)).astype(np.float32)
    dl = warm_server.config.max_wait_s               # admissible, but tight
    t = warm_server.submit(Request(op="lstsq", a=a, b=b, deadline_s=dl))
    time.sleep(2 * dl)                               # age past the budget
    warm_server.drain()
    assert t.done() and t.deadline_missed
    assert t.latency_s > dl


def test_cold_dispatch_builds_once_and_sets_the_floor():
    """No warm pass: the first flush builds its bucket's program; the next
    flush of that bucket builds nothing, and neither counts as a
    recapture."""
    spec = BucketSpec(op="whiten", m=48, n=32, r=4, batch=2)
    server = Server(ServeConfig(buckets=(spec,), capacity=8, max_wait_s=0.005), device=CPU)
    retraces = server.retraces()
    rng = np.random.default_rng(10)
    for _ in range(2):
        t = server.submit(Request(op="whiten", a=rng.standard_normal((41, 32), np.float32),
                                  b=rng.standard_normal((32, 3), np.float32)))
        server.drain()
        np.testing.assert_array_equal(_whiten_ref(server, t), t.result())
    fn, _ = server.bucket_callable(spec)
    assert fn.builds == 1 and fn.replays == 2 and server.retraces() == retraces


def test_per_slice_trsm_and_abstract_args():
    """``per_slice_trsm`` solves each slice as the unbatched left solve
    does; ``serve_abstract_args`` gives the program's static shapes."""
    from repro_torch.solve.triangular import _left_solve

    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 16, 16)).astype(np.float32)
    low = torch.as_tensor(np.tril(x) + 4 * np.eye(16, dtype=np.float32))
    c = torch.as_tensor(rng.standard_normal((3, 16, 5)).astype(np.float32))
    for tr in (False, True):
        got = per_slice_trsm(low, c, transpose=tr)
        for i in range(3):
            assert torch.equal(got[i], _left_solve(low[i], c[i], transpose=tr))
        assert torch.equal(per_slice_trsm(low[1], c[1], transpose=tr), got[1])
    with pytest.raises(ValueError):
        per_slice_trsm(low[None], c[None], transpose=False)
    a, b, ridge = serve_abstract_args(BucketSpec(op="whiten", m=48, n=32, r=4, batch=2,
                                                 dtype="float64"), device=CPU)
    assert (a.shape, b.shape, ridge.shape) == ((2, 48, 32), (2, 32, 4), (2,))
    assert a.dtype == torch.float64 and ridge.dtype == torch.float32 and a.device.type == CPU


# ---------------------------------------------------------------------------
# against the reference's server: counters exactly, results closely


def _counter_delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def both_runs():
    """One seeded mixed workload (32 requests) through ``repro.serve`` and
    through the port on the CPU: the tickets and the ``serve.*`` counter
    deltas of each."""
    with jax.enable_x64(False):
        # a clock that never moves: lanes flush at their width or when
        # drained, never by age, so both servers flush the same batches
        ref = ref_engine.Server(ref_engine.smoke_config(), clock=lambda: 0.0)
        ref.warm()
        before = ref_obs.counters("serve.")
        ref_served, ref_rej = ref_run_workload(ref, ref_mixed_workload(32, 21))
        ref_counts = _counter_delta(before, ref_obs.counters("serve."))
    port = Server(smoke_config(), device=CPU, clock=lambda: 0.0)
    port.warm()
    before = obs_metrics.counters("serve.")
    served, rej = _run_workload(port, _mixed_workload(32, 21))
    counts = _counter_delta(before, obs_metrics.counters("serve."))
    return (ref_served, ref_rej, ref_counts), (port, served, rej, counts)


def test_serve_counters_equal_reference(both_runs):
    (ref_served, ref_rej, ref_counts), (_, served, rej, counts) = both_runs
    assert rej == ref_rej == 0 and len(served) == len(ref_served) == 32
    assert counts == ref_counts
    assert counts["serve.requests.completed"] == 32 and "serve.retraces" not in counts
    assert [t.bucket.label() for t in served] == [t.bucket.label() for t in ref_served]


def test_results_close_to_reference(both_runs):
    """Each result within ``max(1e-4, 8·κ·eps32)`` (relative, normwise) of
    the reference's, κ the float64 condition number of the request's ridge
    gram (module docstring)."""
    (ref_served, _, _), (_, served, _, _) = both_runs
    worst = 0.0
    for t, rt in zip(served, ref_served):
        np.testing.assert_array_equal(t.request.a, rt.request.a)
        a64 = t.request.a.astype(np.float64)
        kappa = np.linalg.cond(a64.T @ a64 + t.request.ridge * np.eye(a64.shape[1]))
        got, want = np.asarray(t.result(), np.float64), np.asarray(rt.result(), np.float64)
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        bound = max(1e-4, 8 * kappa * EPS32)
        assert rel <= bound, (t.bucket.label(), t.request.a.shape, rel, kappa)
        if bound == 1e-4:
            worst = max(worst, rel)
    assert worst > 0.0 or all(np.array_equal(t.result(), r.result())
                              for t, r in zip(served, ref_served))


def test_both_runs_bitwise_to_port_twins(both_runs):
    _, (port, served, _, _) = both_runs
    for t in served:
        np.testing.assert_array_equal(_twin(port, t), t.result(), err_msg=t.bucket.label())


# ---------------------------------------------------------------------------
# CLI


_TINY = ServeConfig(
    buckets=(BucketSpec(op="lstsq", m=48, n=32, r=4, batch=2),),
    capacity=8, max_wait_s=0.005)


def test_check_harness_run_serve_is_clean():
    from repro_torch.check import harness

    report = harness.run_serve(config=_TINY, steady_batches=1, device=CPU)
    assert report.exit_code == 0, report.summary()
    labels = [a["label"] for a in report.artifacts]
    assert any(lb.startswith("serve:lstsq") for lb in labels)
    assert "serve:steady-state" in labels


def test_cli_smoke_gate_in_process(tmp_path):
    from repro_torch.serve.__main__ import main

    out = tmp_path / "serve_report.json"
    assert main(["--smoke", "--requests", "16", "--device", CPU, "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["schema"] == "repro.serve/v1"
    assert report["served"] == 16 and not report["failures"]
    assert report["parity_checked"] > 0
    assert report["stats"]["counters"].get("serve.retraces", 0) == 0
    assert report["stats"]["device"] == CPU
    # the reference's report, key for key: the card refuses nothing of the lattice
    assert set(report) == {"schema", "mode", "warm_seconds", "served", "rejected",
                           "parity_checked", "failures", "stats"}


def test_cli_smoke_subprocess(tmp_path):
    """``python -m repro_torch.serve --smoke --device cpu`` in a process of
    its own, which loads neither JAX nor the reference."""
    out = tmp_path / "report.json"
    code = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "sys.argv = ['repro_torch.serve', '--smoke', '--requests', '24', '--device', 'cpu', "
            f"'--out', {str(out)!r}]; runpy.run_module('repro_torch.serve', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serve smoke OK" in proc.stdout
    assert json.loads(out.read_text())["served"] == 24
    bad = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--device", "cpu"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""}, timeout=120)
    assert bad.returncode != 0                       # no mode picked: a usage error


def test_default_device_is_the_card():
    assert Server(smoke_config()).device == backend.resolve_device(None) == torch.device("cuda")
