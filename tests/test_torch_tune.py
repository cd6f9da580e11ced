"""The port's planner (``repro_torch.tune``) against the reference's
(``repro.tune``) on the CPU.

* The cost model: ``candidates``, ``analytic_plan``, ``default_plan``,
  ``dispatch_calls``, ``solve_dispatch_calls`` and the roofline traffic
  models equal the reference's for ``backend='cpu'``, field for field
  (``predicted_s`` within rel 1e-12).
* Unpinned front doors on CPU tensors resolve to the reference's plan and
  agree with the reference's unpinned calls within ``8·√k·eps·max|ref|``.
* The ``cuda`` machine, the plan cache (ports of the reference's tests),
  the autotuner, pinned against planned calls, and the obs smoke entry
  point.

Each reference call runs under a scoped ``jax.enable_x64(False)``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.analysis import roofline as jroof
from repro.core.ata import ata as jata
from repro.core.strassen import strassen_tn as jstrassen
from repro.solve.lstsq import lstsq as jlstsq
from repro.tune import cache as jcache
from repro.tune import cost as jcost
from repro_torch import obs as tobs
from repro_torch import tune
from repro_torch.analysis import roofline as troof
from repro_torch.core import ata, strassen_tn
from repro_torch.core.strassen import resolve_tunables
from repro_torch.solve import lstsq
from repro_torch.tune import cost, defaults
from repro_torch.tune.cache import load_cache, plan_key, save_cache

ROOT = Path(__file__).resolve().parents[1]
EPS32 = 1.19e-7


@pytest.fixture(autouse=True)
def _fresh_memo(tmp_path, monkeypatch):
    """Keep every test away from the user's cache files and the memos."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref_plans.json"))
    tune.cache.clear_memo()
    jcache.clear_memo()
    yield
    tune.cache.clear_memo()
    jcache.clear_memo()


def _same_plans(got, want):
    """Port plans equal the reference's field for field; predicted_s within
    rel 1e-12."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = g.to_json(), w.to_json()
        gp, wp = gd.pop("predicted_s"), wd.pop("predicted_s")
        assert gd == wd
        assert (gp is None) == (wp is None)
        if gp is not None:
            assert math.isclose(gp, wp, rel_tol=1e-12, abs_tol=0.0), (gp, wp)


# --- the cost model against the reference's ---------------------------------

_SHAPES = {
    "ata": [(192, 96, None), (1000, 300, None), (777, 333, None), (4096, 4096, None),
            (16384, 4096, None)],
    "gemm_tn": [(192, 96, 64), (1000, 300, 17), (4096, 4096, 4096), (16384, 4096, 8)],
    "solve": [(192, 96, 4), (1000, 300, 3), (4096, 4096, 1), (16384, 4096, 8)],
}
_GRID = [(op, m, n, k, batch, out)
         for op, shapes in _SHAPES.items() for m, n, k in shapes
         for batch in ((0,) if op == "solve" else (0, 3))
         for out in {"ata": ("dense", "packed"), "gemm_tn": ("dense",),
                     "solve": ("packed",)}[op]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("op,m,n,k,batch,out", _GRID)
def test_candidates_equal_reference(op, m, n, k, batch, out, dtype):
    kw = dict(batch=batch, dtype=dtype, out=out, backend="cpu")
    with jax.enable_x64(False):
        want = jcost.candidates(op, m, n, k, **kw)
    _same_plans(cost.candidates(op, m, n, k, **kw), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("op,m,n,k,batch,out", _GRID[::3])
def test_analytic_and_default_plan_equal_reference(op, m, n, k, batch, out, dtype):
    kw = dict(batch=batch, dtype=dtype, out=out, backend="cpu")
    with jax.enable_x64(False):
        want = [jcost.analytic_plan(op, m, n, k, **kw), jcost.default_plan(op, m, n, k, **kw)]
    _same_plans([cost.analytic_plan(op, m, n, k, **kw), cost.default_plan(op, m, n, k, **kw)],
                want)


@pytest.mark.parametrize("op,m,n,k", [("ata", 8192, 8192, 8192), ("ata", 1000, 300, 300),
                                      ("gemm_tn", 4096, 4096, 4096), ("gemm_tn", 777, 333, 129)])
@pytest.mark.parametrize("n_base", [64, 128, 512, 1024])
@pytest.mark.parametrize("algorithm", ["dense", "strassen", "winograd"])
@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
def test_dispatch_calls_equal_reference(op, m, n, k, n_base, algorithm, leaf_dispatch):
    args = (op, algorithm, m, n, k, n_base, leaf_dispatch)
    assert cost.dispatch_calls(*args) == jcost.dispatch_calls(*args)


@pytest.mark.parametrize("n", [1, 96, 129, 1000, 4096])
@pytest.mark.parametrize("bn", [32, 120, 128, 256])
def test_solve_dispatch_calls_and_traffic_equal_reference(n, bn):
    assert cost.solve_dispatch_calls(n, bn) == jcost.solve_dispatch_calls(n, bn)
    for itemsize in (2, 4, 8):
        for mode in ("packed", "dual", "mirror"):
            assert (troof.syrk_write_traffic(n, bn, mode, itemsize)
                    == jroof.syrk_write_traffic(n, bn, mode, itemsize))
        for mode in ("packed", "dense"):
            assert (troof.potrf_write_traffic(n, bn, mode, itemsize)
                    == jroof.potrf_write_traffic(n, bn, mode, itemsize))
            assert (troof.normal_eq_write_traffic(n, bn, 8, mode=mode, itemsize=itemsize)
                    == jroof.normal_eq_write_traffic(n, bn, 8, mode=mode, itemsize=itemsize))
        assert troof.trsm_write_traffic(n, 8, itemsize) == jroof.trsm_write_traffic(n, 8, itemsize)
    # the seconds helpers take the rate; at the reference's rate they agree
    assert math.isclose(troof.syrk_write_seconds(n, bn, "packed", jroof.HBM_BW),
                        jroof.syrk_write_seconds(n, bn, "packed"), rel_tol=1e-12)
    assert math.isclose(troof.normal_eq_write_seconds(n, bn, 8, jroof.HBM_BW),
                        jroof.normal_eq_write_seconds(n, bn, 8), rel_tol=1e-12)


def test_flop_split_matches_counters():
    from repro_torch.core.reference import ata_flops, strassen_tn_flops

    for algo in ("strassen", "winograd"):
        mult, adds = cost._flop_split("ata", algo, 1024, 768, 768, 128)
        assert mult + adds == ata_flops(1024, 768, 128, winograd=algo == "winograd")
    mult, adds = cost._flop_split("gemm_tn", "strassen", 512, 384, 256, 64)
    assert mult + adds == strassen_tn_flops(512, 384, 256, 64)


def test_distributed_requests_raise():
    """Distributed requests resolve through the planner's distributed
    branch as the reference's do (the full grid is in
    ``tests/test_torch_distributed.py``); a malformed interleaving raises
    in both packages."""
    from repro import tune as jtune
    from repro.core.distributed import bfs_dfs_assignment as jassign
    from repro_torch.core.distributed import bfs_dfs_assignment

    for kw in (dict(devices=4), dict(row_devices=2), dict(devices=4, row_devices=2)):
        for fn, jfn in ((cost.candidates, jcost.candidates),
                        (cost.default_plan, jcost.default_plan)):
            got, want = fn("ata", 512, 512, **kw), jfn("ata", 512, 512, **kw)
            assert (got if isinstance(got, list) else [got]) == [
                cost.Plan.from_json(p.to_json()) for p in (want if isinstance(want, list)
                                                           else [want])]
    got = tune.plan(op="ata", m=512, n=512, devices=8, backend="cpu")
    assert got == cost.Plan.from_json(
        jtune.plan(op="ata", m=512, n=512, devices=8, backend="cpu").to_json())
    for fn in (bfs_dfs_assignment, jassign):
        with pytest.raises(ValueError, match="interleaving"):
            fn(4, 2, "BX")


# --- unpinned front doors resolve as the reference's do ---------------------


def _ref_record(fn):
    """Run a reference call with obs on: (result, calibration keys,
    dispatch counters)."""
    jobs.metrics.reset()
    jobs.trace.reset()
    jobs.calibrate.reset()
    jobs.enable()
    try:
        with jax.enable_x64(False):
            out = fn()
    finally:
        jobs.disable()
    keys = [r["key"] for r in jobs.calibrate.rows()]
    return out, keys, jobs.metrics.counters("dispatch.")


def _port_record(fn):
    tobs.metrics.reset()
    tobs.trace.reset()
    tobs.calibrate.reset()
    tobs.enable()
    try:
        out = fn()
    finally:
        tobs.disable()
    keys = [r["key"] for r in tobs.calibrate.rows()]
    return out, keys, tobs.metrics.counters("dispatch.")


def _close(got, want, k):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = 8 * math.sqrt(k) * EPS32 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(300, 200), (1040, 1030)])
@pytest.mark.parametrize("out", ["dense", "packed"])
def test_unpinned_ata_resolves_like_reference(shape, out):
    a = _inputs(shape, 1)

    def dense(x):
        return x.to_dense() if out == "packed" else x

    want, jkeys, jcount = _ref_record(lambda: np.asarray(dense(jata(jnp.asarray(a), out=out))))
    got, tkeys, tcount = _port_record(lambda: dense(ata(torch.as_tensor(a), out=out)))
    assert tkeys == jkeys and len(tkeys) == 1
    assert tcount == jcount
    _close(got.numpy(), want, shape[0])


@pytest.mark.parametrize("m,n,k", [(300, 200, 150), (2100, 1100, 1100)])
def test_unpinned_strassen_tn_resolves_like_reference(m, n, k):
    a, b = _inputs((m, n), 2), _inputs((m, k), 3)
    want, jkeys, jcount = _ref_record(
        lambda: np.asarray(jstrassen(jnp.asarray(a), jnp.asarray(b))))
    got, tkeys, tcount = _port_record(lambda: strassen_tn(torch.as_tensor(a), torch.as_tensor(b)))
    assert tkeys == jkeys and len(tkeys) == 1
    assert tcount == jcount
    _close(got.numpy(), want, m)


def test_unpinned_lstsq_resolves_like_reference():
    a, b = _inputs((600, 300), 4), _inputs((600, 3), 5)
    want, jkeys, jcount = _ref_record(
        lambda: np.asarray(jlstsq(jnp.asarray(a), jnp.asarray(b), ridge=1e-3)))
    got, tkeys, tcount = _port_record(
        lambda: lstsq(torch.as_tensor(a), torch.as_tensor(b), ridge=1e-3))
    assert tkeys == jkeys == ["solve|600x300x3|b=0|strassen|nb=512|factor"]
    assert tcount == jcount
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4


def test_unpinned_calls_on_cpu_tensors_plan_for_the_cpu(monkeypatch):
    seen = []
    real = tune.cache.plan

    def spy(*args, **kw):
        p = real(*args, **kw)
        seen.append(p)
        return p

    monkeypatch.setattr(tune, "plan", spy)
    a = torch.as_tensor(_inputs((64, 48), 6))
    ata(a)
    strassen_tn(a.bfloat16(), a.bfloat16())
    lstsq(a.double(), a[:, :2].double())
    assert [(p.op, p.backend, p.dtype, p.use_kernels) for p in seen] == [
        ("ata", "cpu", "float32", False), ("gemm_tn", "cpu", "bfloat16", False),
        ("solve", "cpu", "float64", False)]


# --- the cuda machine -------------------------------------------------------


def test_cuda_machine_parameters():
    m = cost.machine_for("cuda")
    assert m.name == "cuda_h100" and m.kernels is True
    assert (m.peak_flops, m.hbm_bw, m.launch_overhead_s) == (67e12, 3.35e12, 35e-6)
    assert (m.d_half, m.add_word_cost, m.stack_word_cost) == (128, 1.0, 2.0)
    assert m.device_memory_bytes == 80e9 and m.budget_single_device
    # the reference's single-device planner has no memory budget; its cpu
    # machine's 2 GB budget prices only the distributed schedules
    cpu = cost.machine_for("cpu")
    assert cpu.device_memory_bytes == 2e9 and not cpu.budget_single_device
    assert cost.machine_for("tpu").name == "cpu"


def _peak(p):
    """The model's peak bytes of a plan (a solve plan: its packed gram)."""
    op, k = ("ata", p.n) if p.op == "solve" else (p.op, p.k)
    return cost.peak_bytes(op, p.algorithm, p.m, p.n, k, p.n_base, p.leaf_dispatch,
                           batch=p.batch, dtype=p.dtype, kernels=p.use_kernels)


@pytest.mark.parametrize("op,m,n,k,batch,out", [
    ("ata", 32768, 32768, None, 0, "packed"), ("ata", 32768, 32768, None, 0, "dense"),
    ("ata", 16384, 16384, None, 4, "dense"), ("gemm_tn", 32768, 32768, 32768, 0, "dense"),
    ("solve", 32768, 32768, 8, 0, "packed"), ("solve", 65536, 32768, 8, 0, "packed")])
def test_cuda_plans_fit_the_card(op, m, n, k, batch, out):
    """Every candidate the cuda machine offers, its argmin and a solve's
    factor pipeline fit in the card's 80 GB; without the budget a batched
    tree the card cannot hold would lead at the square shapes."""
    mach = cost.machine_for("cuda")
    plans = cost.candidates(op, m, n, k, batch=batch, out=out, backend="cuda")
    assert plans and all(_peak(p) <= mach.device_memory_bytes for p in plans)
    assert cost.analytic_plan(op, m, n, k, batch=batch, out=out, backend="cuda") == plans[0]
    if op == "solve":
        assert {p.method for p in plans} == {"factor", "cg"}
    elif m == n == (k or n):
        # the model's fastest tree, unfiltered, is a batched one over budget
        kk = n if k is None else k
        fast = min(((a, nb, ld) for a in ("strassen", "winograd")
                    for nb in defaults.N_BASE_CANDIDATES for ld in ("batched", "unrolled")),
                   key=lambda c: cost.predict_seconds(op, c[0], m, n, kk, c[1], batch=batch,
                                                      machine=mach, blocks=(128, 128),
                                                      leaf_dispatch=c[2]))
        assert fast[2] == "batched"
        assert cost.peak_bytes(op, fast[0], m, n, kk, fast[1], "batched",
                               batch=batch) > mach.device_memory_bytes
        assert all(p.leaf_dispatch != "batched" for p in plans)


def test_peak_bytes_orders_the_dispatches():
    """Dense holds operand and output only; at ata 8192² the batched tree
    holds its leaf operand stacks on top of the fused tree's products, and
    the unrolled recursion least of the recursing dispatches."""
    args = ("ata", "strassen", 8192, 8192, 8192, 512)
    assert cost.peak_bytes("ata", "dense", 8192, 8192, 8192, 512) == 2 * 8192 * 8192 * 4
    unrolled, batched, fused = (cost.peak_bytes(*args, ld)
                                for ld in ("unrolled", "batched", "fused"))
    assert unrolled < fused < batched
    # the two operand stacks (1430 leaves of 512², twice each) are the gap
    assert batched - fused == 2 * 2 * 1430 * 512 * 512 * 4
    # a batch scales it; bfloat16 operands halve the stacks, not the products
    assert cost.peak_bytes(*args, "batched", batch=3) == 3 * batched
    assert batched - cost.peak_bytes(*args, "batched", dtype="bfloat16") \
        == 2 * 1430 * 512 * 512 * 4 + 8192 * 8192 * 2 + 16 * 16 * 512 * 512 * 2
    # a ragged operand is root-padded: one more operand's worth, twice unrolled
    pad = 8192 * 8192 * 4
    assert cost.peak_bytes("ata", "strassen", 8190, 8192, 8192, 512, "batched") \
        - batched == pad - 2 * 8192 * 4
    assert cost.peak_bytes("ata", "strassen", 8190, 8192, 8192, 512) - unrolled \
        == 2 * pad - 2 * 8192 * 4 - 8192 * 4
    # without the fused kernels the fused ATA also combines level 1's operands
    assert cost.peak_bytes(*args, "fused", kernels=False) - fused == 4 * 7 ** 3 * 512 * 512 * 4


def test_memory_filter_keeps_the_least_when_nothing_fits(monkeypatch):
    tiny = dataclasses.replace(cost.machine_for("cuda"), device_memory_bytes=1.0)
    monkeypatch.setitem(cost.MACHINES, "cuda", lambda: tiny)
    plans = cost.candidates("ata", 4096, 4096, backend="cuda")
    assert len(plans) == 1 and plans[0].algorithm == "dense"


@pytest.mark.parametrize("op,m,n,k", [("ata", 8192, 8192, None), ("ata", 1000, 300, None),
                                      ("gemm_tn", 4096, 4096, 4096), ("solve", 16384, 4096, 8),
                                      ("gemm_tn", 16384, 4096, 8)])
def test_cuda_candidates_never_fuse_winograd(op, m, n, k):
    plans = cost.candidates(op, m, n, k, backend="cuda", out="packed" if op != "gemm_tn" else "dense")
    assert plans and all(p.use_kernels and p.backend == "cuda" for p in plans)
    assert not any(p.leaf_dispatch == "fused" and p.algorithm == "winograd" for p in plans)
    if op != "solve" and min(m, n, k or n) > min(defaults.N_BASE_CANDIDATES):
        # a shape some cutoff recurses on is offered under every dispatch
        assert {p.leaf_dispatch for p in plans} == set(defaults.LEAF_DISPATCH_CANDIDATES)


def test_cuda_machine_prices_the_engine_tile():
    mach = cost.machine_for("cuda")
    args = ("ata", "strassen", 4096, 4096, 4096, 512)
    at_128 = cost.predict_seconds(*args, machine=mach, blocks=(128, 128))
    p = [c for c in cost.candidates("ata", 4096, 4096, backend="cuda")
         if (c.algorithm, c.n_base, c.leaf_dispatch) == ("strassen", 512, "unrolled")][0]
    assert math.isclose(p.predicted_s, at_128, rel_tol=1e-12)


def test_dense_plan_widens_n_base_to_the_operand():
    p = dataclasses.replace(cost.analytic_plan("ata", 1000, 700, backend="cuda"),
                            algorithm="dense", n_base=512)
    assert resolve_tunables(p, None, None, None, op="ata", m=1000, n=700)[1] == 1000
    g = cost.analytic_plan("gemm_tn", 4096, 4096, 4096, backend="cuda")
    assert g.algorithm == "dense"
    assert resolve_tunables(g, None, None, None, op="gemm_tn", m=4096, n=4096, k=4096)[1] == 4096
    # a cuda plan on CPU tensors runs the wrappers' plain versions: one leaf
    a = torch.as_tensor(_inputs((1000, 700), 7))
    tobs.metrics.reset()
    got = ata(a, plan=p)
    assert tobs.metrics.get("ata.leaves.syrk") == 1
    assert tobs.metrics.get("kernels.launch.syrk") == 1
    np.testing.assert_allclose(got.numpy(), (a.T @ a).numpy(), rtol=1e-4, atol=1e-2)


# --- the plan cache (ports of the reference's tests/test_tune.py) -----------


def test_plan_key_names_the_runtime():
    key = plan_key("ata", 640, 640, 640, 0, "float32", "dense", "cpu")
    assert key == (f"v4|ata|m=640|n=640|k=640|b=0|float32|dense|cpu|p=1|r=1|dev=cpu"
                   f"|torch={torch.__version__}")
    if not torch.cuda.is_available():
        assert plan_key("ata", 8, 8, 8, 0, "float32", "dense", "cuda").endswith(
            f"|cuda|p=1|r=1|dev=cuda|torch={torch.__version__}")
    # plan(backend=None) plans for backend.DEFAULT_DEVICE
    assert tune.plan(op="ata", m=256, n=256).backend == "cuda"


def test_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert tune.cache.cache_path().endswith("/.cache/repro_torch/tune_plans.json")
    assert tune.cache.cache_path() != jcache.cache_path()


def test_plan_deterministic_and_json_roundtrip(tmp_path):
    p1 = tune.plan(op="ata", m=777, n=333, out="packed", backend="cpu")
    tune.cache.clear_memo()
    assert tune.plan(op="ata", m=777, n=333, out="packed", backend="cpu") == p1
    assert cost.Plan.from_json(json.loads(json.dumps(p1.to_json()))) == p1
    path = str(tmp_path / "c.json")
    key = plan_key("ata", 777, 333, 333, 0, "float32", "packed", "cpu")
    save_cache({key: dataclasses.replace(p1, source="measured")}, path)
    assert load_cache(path)[key] == dataclasses.replace(p1, source="measured")


def test_out_invariant_algorithm_choice():
    for backend in ("cpu", "cuda"):
        for m, n in [(300, 200), (1024, 1024), (4096, 512), (8192, 8192)]:
            pd = tune.plan(op="ata", m=m, n=n, out="dense", backend=backend)
            pp = tune.plan(op="ata", m=m, n=n, out="packed", backend=backend)
            assert (pd.algorithm, pd.n_base, pd.leaf_dispatch) == (
                pp.algorithm, pp.n_base, pp.leaf_dispatch)


def test_measured_cache_entry_is_served(tmp_path):
    path = str(tmp_path / "c.json")
    analytic = tune.plan(op="ata", m=640, n=640, backend="cpu", cache_file=path)
    key = plan_key("ata", 640, 640, 640, 0, "float32", "dense", "cpu")
    save_cache({key: dataclasses.replace(analytic, n_base=128, source="measured",
                                         measured_s=1e-3)}, path)
    tune.cache.clear_memo()
    served = tune.plan(op="ata", m=640, n=640, backend="cpu", cache_file=path)
    assert served.n_base == 128 and served.source == "cache"


def test_corrupt_cache_file_and_entries_are_tolerated_and_counted(tmp_path, caplog):
    path = str(tmp_path / "broken.json")
    Path(path).write_text("{not json")
    before = tune.cache.cache_stats()
    assert tune.plan(op="ata", m=512, n=256, backend="cpu", cache_file=path).source == "analytic"
    assert tune.cache.cache_stats()["load_failure"] - before["load_failure"] == 1

    good = dataclasses.replace(tune.plan(op="ata", m=640, n=320, backend="cpu"),
                               source="measured")
    key_good = plan_key("ata", 640, 320, 320, 0, "float32", "dense", "cpu")
    Path(path).write_text(json.dumps({"schema": "v4", "plans": {
        key_good: good.to_json(),
        "k_truncated": {"op": "ata", "m": 1, "n": 1},          # KeyError
        "k_not_a_dict": "garbage string entry",                # ValueError
        "k_schema_drift": dict(good.to_json(), bogus=1),       # TypeError
    }}))
    before = tune.cache.cache_stats()
    loaded = load_cache(path)
    assert set(loaded) == {key_good} and loaded[key_good] == good
    assert tune.cache.cache_stats()["skipped_entries"] - before["skipped_entries"] == 3
    assert "skipped 3 undeserializable entries" in caplog.text
    tune.cache.clear_memo()
    assert tune.plan(op="ata", m=640, n=320, backend="cpu", cache_file=path).source == "cache"


def test_old_schema_cache_files_still_load_and_serve(tmp_path):
    key_now = plan_key("ata", 640, 640, 640, 0, "float32", "dense", "cpu")
    for old in ("v1", "v2", "v3"):
        path = str(tmp_path / f"{old}.json")
        p = dataclasses.replace(tune.plan(op="ata", m=640, n=640, backend="cpu"), n_base=128,
                                source="measured", measured_s=1e-3)
        key_old = (old + "|" + key_now.split("|", 1)[1]).replace("|r=1", "")
        entry = p.to_json()
        del entry["comm_schedule"], entry["row_devices"]
        if old == "v1":
            del entry["method"]
        Path(path).write_text(json.dumps({"schema": old, "plans": {key_old: entry}}))
        before = tune.cache.cache_stats()["migrated"]
        loaded = load_cache(path)
        assert set(loaded) == {key_now}
        assert tune.cache.cache_stats()["migrated"] - before == 1
        assert loaded[key_now].comm_schedule is None and loaded[key_now].n_base == 128
        tune.cache.clear_memo()
        served = tune.plan(op="ata", m=640, n=640, backend="cpu", cache_file=path)
        assert served.source == "cache" and served.n_base == 128


def test_unknown_leaf_dispatch_and_comm_schedule_are_sanitized(tmp_path):
    path = str(tmp_path / "future.json")
    key = plan_key("ata", 640, 640, 640, 0, "float32", "dense", "cpu")
    p = dataclasses.replace(tune.plan(op="ata", m=640, n=640, backend="cpu"), n_base=256,
                            leaf_dispatch="hypercube", comm_schedule="BQX", source="measured",
                            measured_s=1e-3)
    Path(path).write_text(json.dumps({"schema": "v4", "plans": {key: p.to_json()}}))
    before = tune.cache.cache_stats()["sanitized"]
    loaded = load_cache(path)[key]
    assert (loaded.leaf_dispatch, loaded.comm_schedule, loaded.n_base) == ("unrolled", None, 256)
    assert tune.cache.cache_stats()["sanitized"] - before == 2
    # a valid interleaving string is kept verbatim
    Path(path).write_text(json.dumps({"schema": "v4", "plans": {
        key: dataclasses.replace(p, leaf_dispatch="batched", comm_schedule="BDB").to_json()}}))
    assert load_cache(path)[key].comm_schedule == "BDB"
    # and the served plan runs
    Path(path).write_text(json.dumps({"schema": "v4", "plans": {key: p.to_json()}}))
    tune.cache.clear_memo()
    served = tune.plan(op="ata", m=640, n=640, backend="cpu", cache_file=path)
    assert served.source == "cache" and served.leaf_dispatch == "unrolled"
    a = torch.as_tensor(_inputs((96, 80), 7))
    np.testing.assert_allclose(ata(a, plan=served).numpy(), (a.T @ a).numpy(), rtol=2e-4,
                               atol=2e-4)


def test_warm_reads_the_file_once_and_seeds_the_memo(tmp_path, monkeypatch):
    path = str(tmp_path / "c.json")
    analytic = tune.plan(op="solve", m=96, n=64, k=8, out="packed", backend="cpu",
                         cache_file=path)
    key = plan_key("solve", 96, 64, 8, 0, "float32", "packed", "cpu")
    save_cache({key: dataclasses.replace(analytic, source="measured")}, path)
    tune.cache.clear_memo()
    reads = []
    real = tune.cache.load_cache
    monkeypatch.setattr(tune.cache, "load_cache", lambda p=None: reads.append(p) or real(p))
    before = tune.cache.cache_stats()
    hit, miss = tune.warm([dict(op="solve", m=96, n=64, k=8, out="packed", backend="cpu"),
                           dict(op="ata", m=256, n=128, backend="cpu")], cache_file=path)
    after = tune.cache.cache_stats()
    assert reads == [path]
    assert (after["warm_hit"] - before["warm_hit"], after["warm_miss"] - before["warm_miss"]) == (1, 1)
    assert hit.source == "cache" and miss.source == "analytic" and miss.op == "ata"
    assert tune.plan(op="solve", m=96, n=64, k=8, out="packed", backend="cpu",
                     cache_file=path) is hit
    assert tune.cache.cache_stats()["memo_hit"] - after["memo_hit"] == 1
    assert reads == [path]   # the memo hit read nothing


def test_warm_never_clobbers_and_validates_specs():
    first = tune.plan(op="solve", m=48, n=32, k=4, out="packed", backend="cpu")
    before = tune.cache.cache_stats()["warm_memo"]
    (warmed,) = tune.warm([dict(op="solve", m=48, n=32, k=4, out="packed", backend="cpu")])
    assert warmed is first and tune.cache.cache_stats()["warm_memo"] - before == 1
    with pytest.raises(ValueError, match="unknown op"):
        tune.warm([dict(op="qr", m=8, n=8)])
    with pytest.raises(ValueError, match="unbatched"):
        tune.warm([dict(op="solve", m=8, n=8, batch=4)])
    with pytest.raises(TypeError, match="unknown keys"):
        tune.warm([dict(op="ata", m=8, n=8, block_size=32)])
    with pytest.raises(ValueError, match="unknown op"):
        tune.plan(op="qr", m=8, n=8)


def test_cache_prefetch_is_warm_and_lazily_exported():
    assert tune.cache.cache_prefetch is tune.cache.warm
    assert tune.warm is tune.cache.warm and tune.Plan is cost.Plan
    assert set(tune.__all__) <= set(dir(tune))


# --- the autotuner ----------------------------------------------------------


def test_autotune_keeps_default_unless_candidate_beats_margin(monkeypatch):
    base = cost.default_plan("ata", 96, 96)

    def paired(ratio):
        return lambda *a, **kw: (ratio, ratio, 1.0)

    monkeypatch.setattr(tune.search, "time_fn", lambda *a, **kw: 1.0)
    monkeypatch.setattr(tune.search, "time_ratio", paired(1.10))
    kept = tune.search.autotune("ata", 96, 96, max_candidates=3)
    assert tune.search._same_dispatch(kept, base) and kept.source == "measured"
    monkeypatch.setattr(tune.search, "time_ratio", paired(2.0))
    tuned = tune.search.autotune("ata", 96, 96, max_candidates=3)
    assert not tune.search._same_dispatch(tuned, base)
    assert tuned.baseline_s == 2.0 and tuned.measured_s == 1.0


def test_autotune_winner_persists_and_refreshes_the_memo(tmp_path, monkeypatch):
    path = str(tmp_path / "c.json")
    monkeypatch.setattr(tune.search, "time_fn", lambda *a, **kw: 1.0)
    monkeypatch.setattr(tune.search, "time_ratio", lambda *a, **kw: (2.0, 2.0, 1.0))
    before = tune.plan(op="ata", m=160, n=160, backend="cpu", cache_file=path)
    tuned = tune.plan(op="ata", m=160, n=160, backend="cpu", autotune=True, cache_file=path)
    after = tune.plan(op="ata", m=160, n=160, backend="cpu", cache_file=path)
    assert before.source == "analytic" and tuned.source == "measured"
    assert after is tuned
    tune.cache.clear_memo()
    again = tune.plan(op="ata", m=160, n=160, backend="cpu", autotune=True, cache_file=path)
    assert again.source == "cache"
    assert (again.algorithm, again.n_base, again.leaf_dispatch) == (
        tuned.algorithm, tuned.n_base, tuned.leaf_dispatch)


def test_autotune_measures_on_the_cpu(tmp_path):
    """A real (unpatched) autotune of a tiny ata on CPU tensors: measured,
    persisted, and each trial a calibration row."""
    path = str(tmp_path / "tuned.json")
    tobs.calibrate.reset()
    p = tune.plan(op="ata", m=96, n=96, backend="cpu", autotune=True, cache_file=path)
    assert p.source == "measured" and p.measured_s > 0 and p.baseline_s > 0
    rows = tobs.calibrate.rows()
    assert rows and all(r["source"] == "autotune" and r["backend"] == "cpu" for r in rows)
    assert json.loads(Path(path).read_text())["plans"]


def test_operands_follow_the_plan():
    p = cost.default_plan("gemm_tn", 12, 8, 5, batch=2, dtype="bfloat16")
    a, b = tune.search._operands(p)
    assert a.shape == (2, 12, 8) and b.shape == (2, 12, 5) and a.dtype == torch.bfloat16
    assert a.device.type == "cpu"
    (x,) = tune.search._operands(cost.default_plan("ata", 12, 8, dtype="float64"))
    assert x.dtype == torch.float64 and torch.equal(
        x, torch.as_tensor(np.random.default_rng(0).standard_normal((12, 8))))


# --- pinned against planned --------------------------------------------------


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_pinned_call_equals_call_on_a_plan_of_its_tunables(backend):
    a = torch.as_tensor(_inputs((200, 160), 8))
    b = torch.as_tensor(_inputs((200, 96), 9))
    p = dataclasses.replace(tune.plan(op="ata", m=200, n=160, backend=backend),
                            algorithm="winograd", n_base=64, leaf_dispatch="unrolled")
    assert torch.equal(ata(a, plan=p), ata(a, n_base=64, variant="winograd"))
    for ld in ("unrolled", "batched", "fused"):
        g = dataclasses.replace(tune.plan(op="gemm_tn", m=200, n=160, k=96, backend=backend),
                                algorithm="strassen", n_base=32, leaf_dispatch=ld)
        assert torch.equal(strassen_tn(a, b, plan=g),
                           strassen_tn(a, b, n_base=32, variant="strassen", leaf_dispatch=ld))


@pytest.mark.parametrize("ld", ["unrolled", "batched", "fused"])
def test_packed_plan_equals_dense_plan_bitwise(ld):
    a = torch.as_tensor(_inputs((300, 200), 10))
    p = dataclasses.replace(tune.plan(op="ata", m=300, n=200, backend="cpu"),
                            algorithm="strassen", n_base=64, leaf_dispatch=ld)
    assert torch.equal(ata(a, plan=p, out="packed").to_dense(), ata(a, plan=p))
    # unpinned: the packed and dense plans run the same recursion
    assert torch.equal(ata(a, out="packed").to_dense(), ata(a))


def test_pinning_leaf_dispatch_alone_keeps_the_planner(monkeypatch):
    calls = []
    real = tune.cache.plan
    monkeypatch.setattr(tune, "plan", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    a = torch.as_tensor(_inputs((96, 64), 11))
    ata(a, leaf_dispatch="batched")
    ata(a, packed_block=32, out="packed")
    assert len(calls) == 2
    ata(a, n_base=32)
    ata(a, variant="winograd")
    strassen_tn(a, a, n_base=16)
    lstsq(a, a[:, :2], method="factor")
    assert len(calls) == 2


def test_lstsq_follows_a_solve_plan():
    a = torch.as_tensor(_inputs((400, 150), 12))
    b = torch.as_tensor(_inputs((400, 2), 13))
    for method in ("factor", "cg"):
        p = dataclasses.replace(tune.plan(op="solve", m=400, n=150, k=2, out="packed",
                                          backend="cpu"), method=method)
        tobs.metrics.reset()
        x = lstsq(a, b, ridge=1e-3, plan=p)
        assert tobs.metrics.get(f"dispatch.solve.{method}") == 1
        ad, bd = a.double(), b.double()
        x64 = torch.linalg.solve(ad.T @ ad + 1e-3 * torch.eye(150, dtype=torch.float64),
                                 ad.T @ bd)
        assert float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64)) <= 1e-4


# --- python -m repro_torch.obs ------------------------------------------------


def test_obs_smoke_entry_point_on_the_cpu(tmp_path):
    out = tmp_path / "obs.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "", "HOME": str(tmp_path),
           "REPRO_TORCH_TUNE_CACHE": str(tmp_path / "plans.json")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--device", "cpu",
                          "--out", str(out)], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "obs smoke OK on cpu" in res.stdout
    snap = tobs.metrics.validate_snapshot(json.loads(out.read_text()))
    assert {r["op"] for r in snap["calibration"]} >= {"ata", "solve"}
    assert all(r["backend"] == "cpu" for r in snap["calibration"])
    jobs.metrics.validate_snapshot(json.loads(out.read_text()))
