"""The port's training substrate against the reference, on the CPU: the
data pipeline (``repro_torch.data.pipeline``), checkpoints
(``repro_torch.checkpoint.manager``), fault tolerance
(``repro_torch.runtime.fault_tolerance``) and the CLI trainer
(``python -m repro_torch.launch.train``), as ``tests/test_substrate.py``
tests the reference's.

Everything here is exact: batches and checkpoint files are bitwise equal
to the reference's, and a crashed and restarted run ends bitwise where an
uninterrupted one does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.configs.registry import get_smoke as jsmoke
from repro.data import pipeline as jdata
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke as tsmoke
from repro_torch.core.symmetric import SymmetricMatrix
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.runtime.fault_tolerance import Heartbeat, PreemptionGuard, run_with_restarts

SMALL = ("small", 64, 8, "train")
ARCHS = ["qwen1.5-0.5b", "gemma-7b", "musicgen-medium", "llava-next-mistral-7b"]


# --- data pipeline -----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equals_the_reference_bitwise(arch):
    """Every key, dtype and bit, by (seed, step), for each host slice and
    for overridden sequence lengths and batches; codebook and image
    batches included."""
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    jshape, tshape = jbase.ShapeConfig(*SMALL), tbase.ShapeConfig(*SMALL)
    for seed, step, host, hosts, kw in ((0, 0, 0, 1, {}), (7, 3, 1, 4, {}),
                                        (3, 11, 0, 2, {"seq_len": 33, "batch": 6})):
        want = jdata.make_batch(jcfg, jshape, seed, step, host, hosts, **kw)
        got = tdata.make_batch(tcfg, tshape, seed, step, host, hosts, **kw)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_make_batch_rejects_an_uneven_host_split():
    with pytest.raises(ValueError):
        tdata.make_batch(tsmoke("qwen1.5-0.5b"), tbase.ShapeConfig(*SMALL), 0, 0, 0, 3)


def test_synthetic_lm_stream_and_resume_equal_the_reference():
    """The prefetching stream from step 0, then resumed from its recorded
    state: the same batches as the reference's stream, bit for bit."""
    jcfg, tcfg = jsmoke("qwen1.5-0.5b"), tsmoke("qwen1.5-0.5b")
    jshape, tshape = jbase.ShapeConfig(*SMALL), tbase.ShapeConfig(*SMALL)
    it = tdata.SyntheticLM(tcfg, tshape, seed=3, start_step=0, prefetch=3)
    got = [next(it) for _ in range(4)]
    state = it.state()
    it.close()
    assert state == {"seed": 3, "next_step": 4}
    jit = jdata.SyntheticLM(jcfg, jshape, seed=3, start_step=0)
    want = [next(jit) for _ in range(4)]
    jit.close()
    it2 = tdata.SyntheticLM(tcfg, tshape, seed=state["seed"], start_step=state["next_step"])
    got.append(next(it2))
    it2.close()
    want.append(jdata.make_batch(jcfg, jshape, seed=3, step=4))
    for g, w in zip(got, want):
        assert all(np.array_equal(g[k], w[k]) for k in w)


# --- checkpoint --------------------------------------------------------------


def _tree(x=1.0):
    return {
        "w": torch.full((4, 3), x),
        "opt": {"m": torch.full((4, 3), 2 * x), "step": torch.tensor(5, dtype=torch.int32)},
    }


def _zeros_like(tree):
    return {"w": torch.zeros(4, 3), "opt": {"m": torch.zeros(4, 3),
                                             "step": torch.zeros((), dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(3.5)
    ckpt.save(10, tree, extra={"data_step": 10})
    restored, step = ckpt.restore(_zeros_like(tree))
    assert step == 10
    assert torch.equal(restored["w"], tree["w"]) and torch.equal(restored["opt"]["m"],
                                                                 tree["opt"]["m"])
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 5
    assert ckpt.extra()["data_step"] == 10


def test_checkpoint_keep_n_gc(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ckpt.save(s, _tree(float(s)))
    assert ckpt.steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    """An async save is a consistent cut: writing the tree after ``save``
    returns does not change what lands on disk."""
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(1.0)
    ckpt.save(1, tree, blocking=False)
    tree["w"].fill_(9.0)
    ckpt.wait()
    assert ckpt.latest_step() == 1
    restored, _ = ckpt.restore(_zeros_like(tree))
    assert torch.equal(restored["w"], torch.full((4, 3), 1.0))


def test_checkpoint_async_failure_is_raised(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"), keep=3)
    os.rmdir(ckpt.dir)
    (tmp_path / "c").write_text("a file where the directory was")
    ckpt.save(1, _tree(1.0), blocking=False)
    with pytest.raises(OSError):
        ckpt.wait()


def test_checkpoint_uncommitted_ignored(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    ckpt.save(1, _tree(1.0))
    # a crash mid-save: the directory exists but has no _COMMITTED marker
    os.makedirs(tmp_path / "step_000000002")
    os.makedirs(tmp_path / "step_000000003.tmp")
    assert ckpt.latest_step() == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        ckpt.restore({"w": torch.zeros((5,))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.zeros((4,))})


def test_checkpoint_files_equal_the_reference(tmp_path):
    """The same numpy tree through both managers: the same ``.npz`` (keys,
    dtypes, bits), the same step and extra; the port's ``meta.json`` names
    the leaves by key path."""
    rng = np.random.default_rng(0)
    tree = {"b": {"z": rng.standard_normal((3, 5)).astype(np.float32),
                  "a": np.arange(6, dtype=np.int32)},
            "a": rng.standard_normal((2,)).astype(np.float32),
            "c": [np.float32(1.5), np.zeros((2, 2), np.float64)]}
    JManager(str(tmp_path / "ref")).save(7, tree, extra={"e": 1})
    CheckpointManager(str(tmp_path / "port")).save(7, tree, extra={"e": 1})
    files = []
    for side in ("ref", "port"):
        with np.load(tmp_path / side / "step_000000007" / "shard_00000.npz") as z:
            files.append({k: z[k] for k in z.files})
        assert (tmp_path / side / "step_000000007" / "_COMMITTED").read_text() == "ok"
    want, got = files
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    meta = json.loads((tmp_path / "port" / "step_000000007" / "meta.json").read_text())
    ref_meta = json.loads((tmp_path / "ref" / "step_000000007" / "meta.json").read_text())
    assert (meta["step"], meta["num_leaves"], meta["extra"]) == (
        ref_meta["step"], ref_meta["num_leaves"], ref_meta["extra"])
    assert meta["treedef"] == ["['a']", "['b']['a']", "['b']['z']", "['c'][0]", "['c'][1]"]


def test_checkpoint_carries_packed_stats_and_numbers(tmp_path):
    """A packed ``SymmetricMatrix`` is one leaf (its blocks) and comes back
    as one; a Python number comes back as a number (the Shampoo state's
    slot of an Adam leaf is the integer 0)."""
    sym = SymmetricMatrix(torch.randn(2, 3, 4, 4), 8, 4)
    tree = {"s": sym, "slot": 0, "x": torch.ones(2, dtype=torch.float64)}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, tree)
    like = {"s": SymmetricMatrix(torch.zeros(2, 3, 4, 4), 8, 4), "slot": 0,
            "x": torch.zeros(2, dtype=torch.float64)}
    out, _ = ckpt.restore(like)
    assert isinstance(out["s"], SymmetricMatrix) and (out["s"].n, out["s"].bn) == (8, 4)
    assert torch.equal(out["s"].blocks, sym.blocks)
    assert out["slot"] == 0 and type(out["slot"]) is int
    assert out["x"].dtype == torch.float64 and torch.equal(out["x"], tree["x"])


# --- fault tolerance ---------------------------------------------------------


def test_preemption_guard_flag():
    g = PreemptionGuard(signals=())
    assert not g.preempted
    g.request()
    assert g.preempted


def test_preemption_guard_catches_sigterm_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5.0
        while not g.preempted and time.time() < deadline:
            time.sleep(0.01)
        assert g.preempted
    finally:
        g.restore()
    assert signal.getsignal(signal.SIGTERM) == before


def test_heartbeat_staleness(tmp_path):
    path = str(tmp_path / "hb")
    hb = Heartbeat(path, interval=0.05).start()
    time.sleep(0.15)
    assert not Heartbeat.is_stale(path, timeout=5.0)
    hb.stop()
    assert not hb._thread.is_alive()
    assert Heartbeat.is_stale(path, timeout=0.0)
    assert Heartbeat.is_stale(str(tmp_path / "missing"), timeout=5.0)


def test_heartbeat_reader_never_sees_a_partial_stamp(tmp_path):
    """A writer stamping as fast as it can and a reader parsing as fast as
    it can: every read parses (the stamp is replaced by a rename, never
    truncated in place)."""
    path = str(tmp_path / "hb")
    hb = Heartbeat(path, interval=0.0, process_index=3).start()
    try:
        while not os.path.exists(path):
            time.sleep(0.001)
        reads, deadline = 0, time.time() + 0.5
        while time.time() < deadline:
            with open(path) as f:
                idx, ts = f.read().split()
            assert idx == "3" and float(ts) > 0
            reads += 1
    finally:
        hb.stop()
    assert reads > 100
    assert os.listdir(tmp_path) == ["hb"]


def test_crash_restart_resumes_bitwise(tmp_path):
    """Kill at step 7, restart, and end where an uninterrupted run ends:
    checkpoints and step-indexed data give exact resume (the reference's
    test, on tensors)."""
    cfg, shape = tsmoke("qwen1.5-0.5b"), tbase.ShapeConfig(*SMALL)

    def run(crash_at):
        ckpt = CheckpointManager(str(tmp_path / f"c{crash_at}"), keep=2)

        def make_state():
            state = {"acc": torch.zeros(4), "step": torch.zeros((), dtype=torch.int64)}
            latest = ckpt.latest_step()
            if latest is not None:
                state, _ = ckpt.restore(state)
                return state, latest
            return state, 0

        def step_fn(state, step):
            batch = tdata.make_batch(cfg, shape, seed=9, step=step)
            delta = torch.as_tensor(batch["tokens"][:4, 0], dtype=torch.float32)
            return {"acc": state["acc"] + delta, "step": state["step"] + 1}

        return run_with_restarts(make_state, step_fn, ckpt, total_steps=20, save_every=5,
                                 inject_crash_at=crash_at)

    clean, r0 = run(crash_at=None)
    crashed, r1 = run(crash_at=7)
    assert r0 == 0 and r1 == 1
    assert torch.equal(clean["acc"], crashed["acc"])
    assert int(clean["step"]) == int(crashed["step"]) == 20


# --- the CLI trainer ---------------------------------------------------------


def _cli(out, *extra):
    return ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "32", "--save-every", "2", "--log-every", "1",
            "--out", str(out), *extra]


def _final_state(out):
    with np.load(os.path.join(out, "ckpt", "step_000000006", "shard_00000.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("optimizer", ["adamw", "shampoo"])
def test_cli_crash_and_restart_resumes_bitwise(tmp_path, monkeypatch, optimizer):
    """``python -m repro_torch.launch.train --smoke --device cpu`` in
    process: a run that crashes in step 5 and is started again resumes
    from the step-4 checkpoint and ends with the same state, bit for bit,
    as a run that never crashed, with the same losses logged for steps 5
    and 6."""
    straight = tmp_path / "straight"
    tlaunch.main(_cli(straight, "--optimizer", optimizer))

    real = tlaunch.make_train_step

    def crashing(*args, **kw):
        step_fn, opt = real(*args, **kw)

        def step(state, batch):
            if int(state["step"]) == 4:
                raise RuntimeError("injected failure in step 5")
            return step_fn(state, batch)

        return step, opt

    crashed = tmp_path / "crashed"
    monkeypatch.setattr(tlaunch, "make_train_step", crashing)
    with pytest.raises(RuntimeError, match="injected"):
        tlaunch.main(_cli(crashed, "--optimizer", optimizer))
    monkeypatch.setattr(tlaunch, "make_train_step", real)
    assert CheckpointManager(str(crashed / "ckpt")).latest_step() == 4
    tlaunch.main(_cli(crashed, "--optimizer", optimizer))

    want, got = _final_state(straight), _final_state(crashed)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    logs = [[json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
            for d in (straight, crashed)]
    assert [r["step"] for r in logs[1]] == [1, 2, 3, 4, 5, 6]
    assert [(r["loss"], r["grad_norm"]) for r in logs[1]] == [
        (r["loss"], r["grad_norm"]) for r in logs[0]]


def test_cli_refuses_a_mesh(tmp_path):
    """A data axis that does not divide the batch raises before any rank
    starts (the reference would shard the sequence); ``tests/
    test_torch_mesh.py`` trains on a mesh."""
    args = _cli(tmp_path, "--mesh", "3x1")
    assert "--batch" in args and int(args[args.index("--batch") + 1]) % 3
    with pytest.raises(ValueError, match="does not divide --batch"):
        tlaunch.main(args)


def test_cli_layers_cuts_the_depth(tmp_path):
    """``--layers 1`` trains the config's first layer at full width: each
    layer stack of the checkpoint holds one layer where the uncut run's
    holds the config's depth, and every other shape is the uncut run's."""
    tlaunch.main(_cli(tmp_path / "cut", "--steps", "2", "--layers", "1"))
    tlaunch.main(_cli(tmp_path / "full", "--steps", "2"))
    shapes = {}
    for d in ("cut", "full"):
        with np.load(os.path.join(tmp_path, d, "ckpt", "step_000000002", "shard_00000.npz")) as z:
            shapes[d] = {k: z[k].shape for k in z.files}
    n = tsmoke("qwen1.5-0.5b").num_layers
    assert n > 1 and shapes["cut"].keys() == shapes["full"].keys()
    cut = [k for k in shapes["full"] if shapes["cut"][k] != shapes["full"][k]]
    assert cut
    for k in cut:
        assert shapes["full"][k][0] == n and shapes["cut"][k] == (1, *shapes["full"][k][1:]), k


def test_cli_flags_cover_the_reference():
    """Every flag of the reference's trainer, with its default (the output
    directory's default is under the temporary directory), plus
    ``--device`` and ``--layers`` (off by default)."""
    from repro.launch import train as jlaunch

    want = {a.dest: a.default for a in jlaunch.build_argparser()._actions}
    got = {a.dest: a.default for a in tlaunch.build_argparser()._actions}
    assert set(got) == set(want) | {"device", "layers"}
    assert got["device"] == "cuda" and got["layers"] is None
    for k in set(want) - {"out", "help"}:
        assert got[k] == want[k], k
    assert dataclasses.asdict(tbase.OptimizerConfig()) == dataclasses.asdict(
        jbase.OptimizerConfig())
