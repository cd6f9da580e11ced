"""The port's plain modules of the analytic layer against the reference:
``repro_torch.core.task_tree`` (the paper's task-tree scheduler) and
``repro_torch.analysis.perf_diff`` (the report-only perf diff). Both are
plain Python, so the results must be equal, not close."""

from __future__ import annotations

import dataclasses
import json
import sys

import pytest

from repro.analysis import perf_diff as jdiff
from repro.core import task_tree as jtt
from repro_torch.analysis import perf_diff as tdiff
from repro_torch.core import task_tree as ttt

MODES = ("shared", "distributed")


@pytest.mark.parametrize("p", list(range(1, 70)) + [128, 255, 256, 257, 512, 1000, 4096])
def test_ell_equals_the_reference(p):
    assert ttt.ell_distributed(p) == jtt.ell_distributed(p)
    assert ttt.ell_shared(p) == jtt.ell_shared(p)


@pytest.mark.parametrize("fn", ["ell_distributed", "ell_shared"])
def test_ell_rejects_zero_processes(fn):
    with pytest.raises(ValueError):
        getattr(ttt, fn)(0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,n", [(64, 64), (100, 37), (256, 256), (1000, 512), (7, 3)])
@pytest.mark.parametrize("p", [1, 2, 3, 5, 8, 16, 37, 64])
def test_task_tree_equals_the_reference(mode, m, n, p):
    """The leaf tasks field for field and in order, their LPT assignment,
    the flop sums and the kind/weight model."""
    got = ttt.build_task_tree(m, n, p, mode=mode)
    want = jtt.build_task_tree(m, n, p, mode=mode)
    assert [dataclasses.asdict(t) for t in got] == [dataclasses.asdict(t) for t in want]
    assert [t.weight() for t in got] == [t.weight() for t in want]
    assert ttt.task_flops(got) == jtt.task_flops(want)
    got_b = ttt.assign_tasks(got, p)
    want_b = jtt.assign_tasks(want, p)
    assert [[dataclasses.asdict(t) for t in b] for b in got_b] == [
        [dataclasses.asdict(t) for t in b] for b in want_b]


@pytest.mark.parametrize("mode", MODES)
def test_task_tree_min_dim_equals_the_reference(mode):
    for min_dim in (1, 4, 16, 64):
        got = ttt.build_task_tree(256, 256, 40, mode=mode, min_dim=min_dim)
        want = jtt.build_task_tree(256, 256, 40, mode=mode, min_dim=min_dim)
        assert [dataclasses.asdict(t) for t in got] == [dataclasses.asdict(t) for t in want]


@pytest.mark.parametrize("mode", MODES)
def test_modeled_speedup_equals_the_reference(mode):
    for n in (512, 4096):
        for p in (1, 2, 3, 4, 7, 8, 16, 31, 32):
            assert ttt.modeled_speedup(n, p, mode=mode) == jtt.modeled_speedup(n, p, mode=mode)


# --- perf_diff ----------------------------------------------------------------


def _bench_rows():
    base = [
        {"name": "a", "seconds": 1.0, "backend": "cpu", "interpret": True},
        {"name": "b", "seconds": 2.0, "device_kind": "x"},
        {"name": "marker", "seconds": 0.0},
        {"name": "gone", "seconds": 9.0},
        {"no_name": True},
        "not a row",
    ]
    fresh = [
        {"name": "a", "seconds": 2.5, "backend": "gpu", "interpret": False},
        {"name": "b", "seconds": 1.5, "device_kind": "x"},
        {"name": "marker", "seconds": 0.1},
        {"name": "new_row", "seconds": 3.0},
        {"name": "no_seconds"},
    ]
    return base, fresh


def test_bench_diff_equals_the_reference():
    base, fresh = _bench_rows()
    assert tdiff.bench_diff(base, fresh) == jdiff.bench_diff(base, fresh)
    assert tdiff.bench_diff([], fresh) == jdiff.bench_diff([], fresh)


def test_bench_diff_meta_keys_name_torch_version():
    """The one departure: the port's rows carry ``torch_version``."""
    assert tdiff._META_KEYS == tuple(
        "torch_version" if k == "jax_version" else k for k in jdiff._META_KEYS)
    base = [{"name": "a", "seconds": 1.0, "torch_version": "2.11"}]
    fresh = [{"name": "a", "seconds": 1.0, "torch_version": "2.13"}]
    (rec,) = tdiff.bench_diff(base, fresh)
    assert rec["meta_changed"] == ["torch_version"]


def test_print_bench_diff_equals_the_reference():
    base, fresh = _bench_rows()
    got, want = [], []
    tdiff.print_bench_diff("k", tdiff.bench_diff(base, fresh), print_fn=got.append)
    jdiff.print_bench_diff("k", jdiff.bench_diff(base, fresh), print_fn=want.append)
    assert got == want and len(got) == 6
    empty = []
    tdiff.print_bench_diff("k", [], print_fn=empty.append)
    assert empty == []


def _artifact(flops, nbytes, coll, peak=None):
    art = {"cost": {"flops": flops, "bytes_accessed": nbytes},
           "collectives": dict(coll), "memory": {}}
    if peak is not None:
        art["memory"]["peak_bytes_est"] = peak
    return art


def _records():
    """Dry-run records of each composition the roofline knows: decode
    (unrolled artifact), a uniform stack (l1/l2 layer differencing), a
    hybrid stack (g1/gs2/ss2) and a raw main artifact."""
    coll = {"all-reduce": 3.0e9, "all-gather": 1.5e9, "reduce-scatter": 0.7e9,
            "all-to-all": 0.0, "collective-permute": 2.5e8}
    base = dict(status="ok", arch="qwen1.5-0.5b", active_params=619_570_176,
                num_layers=24)
    decode = dict(base, mode="decode", shape="decode_32k", mesh="single", artifacts={
        "main": _artifact(1e12, 2e11, coll, 3 * 2**30),
        "analysis_unrolled": _artifact(2.2e12, 4.4e11, coll)})
    train = dict(base, mode="train", shape="train_4k", mesh="multi", artifacts={
        "main": _artifact(5e14, 7e12, coll, 41 * 2**30),
        "analysis_l1": _artifact(3.1e13, 2.2e11, coll),
        "analysis_l2": _artifact(5.3e13, 3.9e11, {k: 2 * v for k, v in coll.items()})})
    hybrid = dict(base, mode="prefill", shape="prefill_32k", mesh="single",
                  global_attn_layers=[0, 15, 31], num_layers=32, artifacts={
                      "main": _artifact(9e14, 3e12, coll, 17 * 2**30),
                      "analysis_g1": _artifact(6e13, 1e12, coll),
                      "analysis_gs2": _artifact(9e13, 1.7e12, coll),
                      "analysis_ss2": _artifact(1.1e14, 2.1e12, coll)})
    raw = dict(base, mode="train", shape="train_4k", mesh="single", artifacts={
        "main": _artifact(4e14, 0.0, {k: 0 for k in coll})})
    return [decode, train, hybrid, raw]


@pytest.mark.parametrize("i", range(4))
def test_summarize_equals_the_reference(i):
    rec = _records()[i]
    assert tdiff.summarize(rec) == jdiff.summarize(rec)


def test_fmt_delta_equals_the_reference():
    for a, b in ((0, 1.0), (1.0, 1.5), (2.0, 1.0), (3.0, 3.0)):
        assert tdiff.fmt_delta(a, b) == jdiff.fmt_delta(a, b)


def test_perf_diff_main_prints_the_reference_table(tmp_path, capsys, monkeypatch):
    before, after = tmp_path / "before.json", tmp_path / "after.json"
    recs = _records()
    before.write_text(json.dumps(recs[1]))
    after.write_text(json.dumps(recs[3]))
    args = [str(before), str(after), "--hypothesis", "bf16 halves the memory term"]
    tdiff.main(args)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["perf_diff", *args])
    jdiff.main()
    want = capsys.readouterr().out
    assert got == want and "| dominant |" in got
