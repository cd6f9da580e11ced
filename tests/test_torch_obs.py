"""The port's observability layer (``repro_torch.obs``) against the
reference's ``repro.obs``, on the CPU.

With obs on in both packages, the same call gives the same span names and
counts (and the same nesting), and the same dispatch / leaf / solve
counters. The reference's default bases launch no kernel, so against them
``kernels.*`` spans and counters are left out; against a reference plan
with ``use_kernels=True`` (its Pallas kernels in interpret mode) they are
compared too. The reference's CG loop is a ``fori_loop``, whose body is
traced once, so a span or counter inside it counts one trace there and one
per iteration in the port's Python loop; the CG comparison scales those
entries by the iteration count. Outputs are bitwise equal with obs on and
off. Every reference call runs inside a scoped ``jax.enable_x64``. No
tolerance applies: everything compared here is an exact count or bitwise.
"""

from __future__ import annotations

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import ata as jata
from repro.core import strassen_tn as jstrassen
from repro.solve.lstsq import lstsq as jlstsq
from repro.tune import cost as jcost
from repro_torch import obs as tobs
from repro_torch.core import ata, strassen_tn
from repro_torch.solve import lstsq

COUNTERS = ("dispatch.", "ata.leaves.", "gemm_tn.leaves", "solve.")


def _reset():
    for m in (jobs, tobs):
        m.trace.reset()
        m.metrics.reset()
        m.calibrate.reset()


@pytest.fixture
def obs_on():
    """obs enabled in both packages for one test; off and empty after it
    (the registries are per process and other test files share a worker)."""
    _reset()
    jobs.enable()
    tobs.enable()
    yield
    jobs.disable()
    tobs.disable()
    _reset()


def _record(m, kernels):
    """(span counts, (name, depth) sequence, counters, gauges) of package
    ``m`` since the last reset; ``kernels.*`` only if ``kernels``."""
    keep = (lambda k: True) if kernels else (lambda k: not k.startswith("kernels."))
    prefixes = COUNTERS + (("kernels.",) if kernels else ())
    return (
        {k: v for k, v in m.trace.span_counts().items() if keep(k)},
        [(name, depth) for name, depth, _ in m.trace.span_events() if keep(name)],
        {k: v for k, v in m.metrics.counters().items() if k.startswith(prefixes)},
        m.metrics.gauges(),
    )


def _same_record(run_ref, run_port, *, kernels=False, x64=False, loop=None):
    """Runs both and compares their records. ``loop = (trips, {name: count
    in one traced body})`` scales the reference's loop-body entries from
    one trace to ``trips`` executions (its events are then not compared:
    the reference has no per-iteration events)."""
    _reset()
    with jax.enable_x64(x64):
        np.asarray(run_ref())
    ref = _record(jobs, kernels)
    run_port()
    port = _record(tobs, kernels)
    spans, counters = dict(ref[0]), dict(ref[2])
    if loop is not None:
        trips, body = loop
        for table in (spans, counters):
            for name, count in body.items():
                if name in table:
                    table[name] += (trips - 1) * count
    assert port[0] == spans, (port[0], spans)
    if loop is None:
        assert port[1] == ref[1]
    assert port[2] == counters, (port[2], counters)
    assert port[3] == ref[3], (port[3], ref[3])
    assert ref[0], "the reference recorded no span"


def _inputs(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched"])
@pytest.mark.parametrize("out", ["dense", "packed"])
def test_ata_spans_and_counters_match_reference(obs_on, leaf_dispatch, out):
    a = _inputs((70, 52), 1)
    _same_record(
        lambda: _dense(jata(jnp.asarray(a), n_base=16, leaf_dispatch=leaf_dispatch, out=out)),
        lambda: ata(torch.as_tensor(a), n_base=16, leaf_dispatch=leaf_dispatch, out=out))


def test_ata_fused_gather_spans_match_reference_float64(obs_on):
    """float64 takes the fused dispatch's gather path in both packages (no
    kernel takes float64; the reference's default has no kernel)."""
    a = _inputs((70, 52), 2, np.float64)
    _same_record(
        lambda: jata(jnp.asarray(a), n_base=16, leaf_dispatch="fused", acc_dtype=jnp.float64),
        lambda: ata(torch.as_tensor(a), n_base=16, leaf_dispatch="fused",
                    acc_dtype=torch.float64),
        x64=True)


def _kernel_plan(op, m, n, k, leaf_dispatch, out="dense"):
    """A reference plan that runs its Pallas kernels (interpret mode on the
    CPU), pinned to the port's static defaults but for ``n_base``, with no
    prediction (so no calibration row)."""
    return dataclasses.replace(
        jcost.default_plan(op, m, n, k, out=out), algorithm="strassen", n_base=16,
        use_kernels=True, leaf_dispatch=leaf_dispatch, syrk_blocks=(64, 64),
        gemm_blocks=(64, 64, 64), predicted_s=None)


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
def test_ata_kernel_path_spans_match_reference_kernel_plan(obs_on, leaf_dispatch):
    """The port's default bases are its kernels' wrappers; against the
    reference's kernel plan everything matches, ``kernels.*`` included —
    for the fused dispatch, one ``ata.fused_dot.L<ℓ>`` span and one
    ``gemm_tn_fused`` call per level, one ``syrk_gather`` call."""
    a = _inputs((64, 48), 3)
    plan = _kernel_plan("ata", 64, 48, None, leaf_dispatch, out="packed")
    _same_record(
        lambda: _dense(jata(jnp.asarray(a), plan=plan, out="packed")),
        lambda: ata(torch.as_tensor(a), n_base=16, leaf_dispatch=leaf_dispatch, out="packed"),
        kernels=True)
    if leaf_dispatch == "fused":
        spans = tobs.trace.span_counts()
        assert spans["ata.fused_dot.L1"] == spans["ata.fused_dot.L2"] == 1
        assert tobs.metrics.get("kernels.launch.gemm_tn_fused") == 2
        assert tobs.metrics.get("kernels.launch.syrk_gather") == 1


def _dense(x):
    return x.to_dense() if hasattr(x, "to_dense") else x


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
def test_strassen_tn_spans_and_counters_match_reference(obs_on, leaf_dispatch):
    a, b = _inputs((70, 52), 4), _inputs((70, 40), 5)
    _same_record(
        lambda: jstrassen(jnp.asarray(a), jnp.asarray(b), n_base=16, leaf_dispatch=leaf_dispatch),
        lambda: strassen_tn(torch.as_tensor(a), torch.as_tensor(b), n_base=16,
                            leaf_dispatch=leaf_dispatch))


@pytest.mark.parametrize("method", ["factor", "cg"])
def test_lstsq_spans_and_counters_match_reference(obs_on, method):
    """Both methods pinned: solve.lstsq, the factor path's stage spans or
    the CG span with iters + 1 TN products, and the solve counters and the
    CG iteration gauge."""
    a, b = _inputs((600, 520), 6), _inputs((600, 3), 7)
    body = {"strassen_tn": 1, "dispatch.gemm_tn.unrolled": 1, "gemm_tn.leaves": 1}
    _same_record(
        lambda: jlstsq(jnp.asarray(a), jnp.asarray(b), ridge=1e-2, method=method, iters=12),
        lambda: lstsq(torch.as_tensor(a), torch.as_tensor(b), ridge=1e-2, method=method,
                      iters=12),
        loop=(12, body) if method == "cg" else None)
    spans = tobs.trace.span_counts()
    assert spans["solve.lstsq"] == 1
    if method == "cg":
        assert spans["solve.cg"] == 1 and spans["strassen_tn"] == 13
        assert tobs.metrics.gauges()["solve.cg.iters"] == 12.0
    else:
        assert spans["solve.gram"] == spans["solve.cholesky"] == spans["solve.substitution"] == 1


def _calls():
    a, b = _inputs((90, 70), 8), _inputs((90, 3), 9)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    outs = [ata(ta, n_base=16, leaf_dispatch=ld, out="packed").blocks
            for ld in ("unrolled", "batched", "fused")]
    outs.append(strassen_tn(ta, tb, n_base=16, leaf_dispatch="fused"))
    outs += [lstsq(ta, tb, ridge=1e-2, method=m) for m in ("factor", "cg")]
    return outs


def test_outputs_bitwise_equal_with_obs_on_and_off():
    off = _calls()
    tobs.enable()
    try:
        on = _calls()
        assert tobs.trace.span_counts()
    finally:
        tobs.disable()
        _reset()
    for x, y in zip(off, on):
        assert torch.equal(x, y)


def test_no_calibration_rows_without_a_plan(obs_on):
    """Pinned calls (``n_base`` or ``method`` given) carry no plan, so no
    dispatch opens a measurement and no row is recorded."""
    _calls()
    assert tobs.calibrate.rows() == []
    assert tobs.dispatch_start(None, torch.zeros(2)) is None


def test_port_snapshot_passes_both_validators(obs_on, tmp_path):
    _calls()
    snap = tobs.metrics.snapshot()
    assert jobs.metrics.validate_snapshot(snap) is snap
    assert tobs.metrics.validate_snapshot(snap) is snap
    assert snap["schema"] == jobs.metrics.SNAPSHOT_SCHEMA == "repro.obs/v1"
    assert snap["meta"] == {"backend": "cpu", "torch_version": torch.__version__,
                            "device": "cpu"}
    assert snap["spans"]["ata"] == 4            # three ata calls and lstsq's gram
    assert snap["counters"]["dispatch.solve.cg"] == 1
    path = tobs.metrics.export_json(str(tmp_path / "obs.json"), extra={"run": "test"})
    back = json.loads(open(path).read())
    assert back["run"] == "test" and jobs.metrics.validate_snapshot(back)


def test_validate_snapshot_rejects_what_the_reference_rejects():
    good = tobs.metrics.snapshot()
    bad = [
        [],
        {**good, "schema": "other"},
        {**good, "counters": []},
        {**good, "counters": {"x": 1.5}},
        {**good, "histograms": {"h": {"count": 1}}},
        {**good, "calibration": [{"key": "k"}]},
    ]
    for d in bad:
        with pytest.raises(ValueError):
            tobs.metrics.validate_snapshot(d)
        with pytest.raises(ValueError):
            jobs.metrics.validate_snapshot(d)


def test_metrics_registry_matches_reference():
    _reset()
    for m in (jobs, tobs):
        m.metrics.inc("a.b")
        m.metrics.inc("a.b", 4)
        m.metrics.inc("c", 0)
        m.metrics.set_gauge("g", 3)
        for v in (2.0, -1.0, 5.5):
            m.metrics.observe("h", v)
    for fn in ("counters", "gauges", "histograms"):
        assert getattr(tobs.metrics, fn)() == getattr(jobs.metrics, fn)()
    assert tobs.metrics.get("a.b") == 5 and tobs.metrics.counters("a.") == {"a.b": 5}
    _reset()
    assert tobs.metrics.counters() == {}


def test_disabled_span_is_one_shared_noop():
    assert not tobs.enabled()
    s1, s2 = tobs.span("x"), tobs.span("y", a=1)
    assert s1 is s2
    with s1 as got:
        assert got is s1
    assert tobs.trace.span_counts() == {} and tobs.trace.span_events() == []


def test_span_events_are_bounded(obs_on):
    for _ in range(tobs.trace.MAX_EVENTS + 7):
        with tobs.span("tick"):
            pass
    assert tobs.trace.MAX_EVENTS == jobs.trace.MAX_EVENTS == 10_000
    assert len(tobs.trace.span_events()) == tobs.trace.MAX_EVENTS
    assert tobs.trace.span_counts() == {"tick": tobs.trace.MAX_EVENTS + 7}


def test_span_names_reach_the_profiler(obs_on):
    """An enabled span wraps its region in torch.profiler.record_function,
    so a profiler trace carries its name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.span("obs.test.region"):
            torch.ones(8) + 1
    assert "obs.test.region" in {e.key for e in prof.key_averages()}


def test_repro_obs_environment_switch():
    import os
    import subprocess
    import sys

    code = "import repro_torch.obs as o; print(o.enabled())"
    env = {**os.environ, "REPRO_OBS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.stdout.strip() == "True", out.stderr
    env["REPRO_OBS"] = "0"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.stdout.strip() == "False", out.stderr


def _plan(predicted_s):
    return types.SimpleNamespace(op="ata", m=8, n=8, k=8, batch=0, algorithm="strassen",
                                 n_base=512, method=None, leaf_dispatch="unrolled",
                                 backend="cpu", predicted_s=predicted_s)


def test_dispatch_measurement_with_a_plan(obs_on, monkeypatch):
    """What the planner feeds: a plan with a prediction opens a
    measurement and records one row; without a prediction, or while
    torch.compile traces the call, nothing is measured; a closed
    measurement never synchronises."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    x = torch.ones(3)
    assert tobs.dispatch_finish(_plan(1e-3), None, x) is x
    t0 = tobs.dispatch_start(_plan(1e-3), x)
    assert t0 is not None
    assert tobs.dispatch_finish(_plan(1e-3), t0, x) is x
    rows = tobs.calibrate.rows()
    assert len(rows) == 1 and rows[0]["key"] == jobs.calibrate.plan_label(_plan(1e-3))
    assert tobs.dispatch_start(_plan(None), x) is None
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert tobs.dispatch_start(_plan(1e-3), x) is None
    assert synced == []          # CPU result: no device to wait for
    tobs.disable()
    assert tobs.dispatch_start(_plan(1e-3), x) is None


def test_calibration_report_matches_reference():
    _reset()
    for m in (jobs, tobs):
        m.calibrate.record(_plan(2e-3), 4e-3)
        m.calibrate.record(_plan(2e-3), 1e-3)
        m.calibrate.record_pair("k2", "gemm_tn", "cpu", 1.0, 1.0)
        m.calibrate.record(_plan(None), 1.0)
    assert tobs.calibrate.rows() == jobs.calibrate.rows()
    assert tobs.calibrate.drift_table() == jobs.calibrate.drift_table()
    assert tobs.report() == jobs.report()
    _reset()
    assert "no predicted-vs-measured" in tobs.report()
