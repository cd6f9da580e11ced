"""The port's optimizers (``repro_torch.optim``) against the reference
(``repro.optim``), on the CPU.

The same numpy inputs go through both packages; every reference call runs
inside a scoped ``jax.enable_x64(False)``, and reference state is carried
into the port with ``convert.tree_from_numpy``. CPU tensors run each
kernel's plain version.

Tolerances (normwise relative, ``‖port − ref‖ / ‖ref‖``, per leaf):

* schedules, AdamW, ``global_norm``, ``clip_by_global_norm``: ``1e-6`` —
  elementwise float32 arithmetic that may round an op differently;
* ``inverse_pth_root``: ``1e-4`` — 25 coupled-Newton steps of float32
  matmuls summed in another order;
* Shampoo: ``1e-4`` for ``precond_p=4`` and ``2e-3`` for ``precond_p=2``
  (the reference's own packed-vs-dense band, ``tests/test_solve.py``), on
  updates and on every state leaf; the port's p=4 packed and dense paths
  are bitwise equal, as the reference's are;
* PowerSGD: ``1e-4`` for two rounds of ``compress`` (whitening of a
  well-conditioned rank-4 factor) and the reference's bands for its
  properties;
* blocking and key paths: exact.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import qwen15_05b as jqwen
from repro.core.symmetric import SymmetricMatrix as JSym
from repro.optim import build as jbuild
from repro.optim import powersgd as jpsgd
from repro.optim import schedules as jsched
from repro.solve.cholesky import CholeskyFactor as JChol
from repro.tune import cache as jcache
from repro_torch import backend, tune
from repro_torch.backend import device_table
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen15_05b as tqwen
from repro_torch.convert import tree_from_numpy
from repro_torch.core import ata
from repro_torch.core.symmetric import SymmetricMatrix, _eye_mask, tri_index
from repro_torch.optim import _tree, build
from repro_torch.optim import powersgd as tpsgd
from repro_torch.optim import schedules as tsched
from repro_torch.solve.cholesky import CholeskyFactor, _pad_identity_mask, cholesky

# the packages export functions under their modules' names (adamw, shampoo)
jadamw_mod = importlib.import_module("repro.optim.adamw")
jshampoo_mod = importlib.import_module("repro.optim.shampoo")
tadamw_mod = importlib.import_module("repro_torch.optim.adamw")
tshampoo_mod = importlib.import_module("repro_torch.optim.shampoo")

ROOT = Path(__file__).resolve().parents[1]
REL_ELEMENTWISE = 1e-6
REL_NEWTON = 1e-4
REL_P4 = 1e-4
REL_P2 = 2e-3


@pytest.fixture(autouse=True)
def _fresh_memo(tmp_path, monkeypatch):
    """Unpinned calls plan from the analytic model of each package, never
    from a cache file outside the test."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref_plans.json"))
    tune.cache.clear_memo()
    jcache.clear_memo()
    yield
    tune.cache.clear_memo()
    jcache.clear_memo()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jx(tree):
    """A numpy tree as JAX float32 arrays."""
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_from_numpy(tree, device="cpu")


def _is_packed(x):
    return isinstance(x, (JSym, JChol))


def _dense_np(x):
    """A leaf as a float64 array: packed objects through the port's
    ``to_dense``, so the comparison never reads unspecified pad entries."""
    if isinstance(x, (SymmetricMatrix, CholeskyFactor)):
        return x.to_dense().double().numpy()
    return np.asarray(x.double() if isinstance(x, torch.Tensor) else x, np.float64)


def _assert_trees_close(port, ref, rel):
    """Same key paths in the same order (JAX's), every leaf within ``rel``
    (normwise), packed leaves of the same class."""
    rflat, _ = jax.tree_util.tree_flatten_with_path(ref, is_leaf=_is_packed)
    pflat, _ = _tree.tree_flatten_with_path(port)
    assert [jax.tree_util.keystr(k) for k, _ in rflat] == [k for k, _ in pflat]
    ref_port = _tree.tree_leaves(_t(ref))
    for (path, got), want in zip(pflat, ref_port):
        assert type(got) is type(want), (path, type(got), type(want))
        g, w = _dense_np(got), _dense_np(want)
        if g.ndim == 0 or np.linalg.norm(w) == 0:
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert _rel(g, w) <= rel, (path, _rel(g, w))


# ---------------------------------------------------------------------------
# tree helper, configs, converter
# ---------------------------------------------------------------------------


def _nested():
    rng = np.random.default_rng(0)
    return {"zeta": [rng.standard_normal(3), (rng.standard_normal(2), None)],
            "alpha": {"b": rng.standard_normal(4), "a": 7},
            "mid": ()}


def test_tree_paths_and_order_match_jax():
    tree = _nested()
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    pflat, treedef = _tree.tree_flatten_with_path(tree)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == [k for k, _ in pflat]
    assert all(a is b for (_, a), (_, b) in zip(jflat, pflat))
    back = treedef.unflatten([x for _, x in pflat])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert treedef.num_leaves == len(jflat)


def test_tree_flatten_up_to_and_map():
    tree = {"b": [1, 2], "a": 3}
    _, treedef = _tree.tree_flatten(tree)
    other = {"a": {"deep": 1}, "b": [(4,), None]}
    assert treedef.flatten_up_to(other) == [{"deep": 1}, (4,), None]
    assert _tree.tree_map(lambda x, y: (x, y), tree, other) == {
        "a": (3, {"deep": 1}), "b": [(1, (4,)), (2, None)]}
    with pytest.raises(ValueError):
        treedef.flatten_up_to({"a": 1, "c": [1, 2]})
    with pytest.raises(ValueError):
        treedef.unflatten([1, 2])


def test_tree_keeps_packed_objects_and_named_tuples_as_leaves():
    s = SymmetricMatrix.zeros(8, 8, device="cpu")
    st = tpsgd.PowerSGDState(q=torch.zeros(2, 1), error=torch.zeros(3, 2))
    leaves = _tree.tree_leaves({"s": s, "p": st, "f": CholeskyFactor.identity(8, 8, device="cpu")})
    assert [type(x).__name__ for x in leaves] == ["CholeskyFactor", "PowerSGDState",
                                                  "SymmetricMatrix"]


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_qwen_config_copies_the_reference(name):
    assert dataclasses.asdict(getattr(tqwen, name)) == dataclasses.asdict(getattr(jqwen, name))
    assert getattr(tqwen, name).num_params() == getattr(jqwen, name).num_params()


def test_base_config_copies_the_reference():
    for cls in ("MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig", "OptimizerConfig",
                "RunConfig"):
        jf = [(f.name, repr(f.default)) for f in dataclasses.fields(getattr(jbase, cls))]
        tf = [(f.name, repr(f.default)) for f in dataclasses.fields(getattr(tbase, cls))]
        assert jf == tf, cls
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("scan", [True, False])
def test_chip_smoke_param_shapes_match_the_reference_init(name, scan):
    """``chip_smoke.param_shapes`` against ``jax.eval_shape`` of the
    reference's ``transformer.init``: same key paths, same shapes (nothing
    is allocated, so the full 0.6 B tree is cheap)."""
    from repro.models import transformer

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    jcfg = dataclasses.replace(getattr(jqwen, name), scan_layers=scan)
    tcfg = dataclasses.replace(getattr(tqwen, name), scan_layers=scan)
    ref = jax.eval_shape(lambda k: transformer.init(k, jcfg), jax.random.key(0))
    want = [(jax.tree_util.keystr(k), tuple(x.shape))
            for k, x in jax.tree_util.tree_flatten_with_path(ref)[0]]
    got = _tree.tree_flatten_with_path(chip_smoke.param_shapes(tcfg),
                                       is_leaf=lambda x: type(x) is tuple and all(
                                           isinstance(i, int) for i in x))[0]
    assert got == want


def test_tree_from_numpy_carries_reference_state():
    """The reference's Shampoo (p=2, packed) state: packed stats and
    factors become the port's classes, the step a CPU int32 tensor."""
    params = {"w": np.ones((16, 8), np.float32), "embed": np.ones((4, 8), np.float32)}
    with jax.enable_x64(False):
        st = jshampoo_mod.shampoo(jsched.constant(1e-2), block=8, precond_p=2,
                                  gram_block=8).init(_jx(params))
    got = tree_from_numpy(st, device="cpu")
    sh = got["shampoo"]["w"]
    assert isinstance(sh["l"], SymmetricMatrix) and isinstance(sh["pl"], CholeskyFactor)
    assert got["shampoo"]["embed"] == 0
    assert got["step"].device.type == "cpu" and got["step"].dtype == torch.int32
    assert got["step"].ndim == 0
    assert torch.equal(sh["pl"].blocks, CholeskyFactor.identity(8, 8, batch=(2,),
                                                                 device="cpu").blocks)
    ref_ps = jpsgd.PowerSGDState(q=np.ones((3, 2)), error=np.zeros((4, 3)))
    ps = tree_from_numpy(ref_ps, device="cpu", named_tuples=(tpsgd.PowerSGDState,))
    assert isinstance(ps, tpsgd.PowerSGDState) and ps.q.shape == (3, 2)
    # a named tuple the caller does not name becomes a plain tuple
    plain = tree_from_numpy(ref_ps, device="cpu")
    assert type(plain) is tuple and plain[1].shape == (4, 3)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.warmup_cosine(1.0, 10, 100),
    lambda m: m.warmup_cosine(3e-4, 0, 7, final_frac=0.2),
], ids=["constant", "warmup_cosine", "no_warmup"])
def test_schedules_match_reference(make):
    jf, tf = make(jsched), make(tsched)
    for step in [0, 1, 5, 9, 10, 11, 55, 99, 100, 150]:
        with jax.enable_x64(False):
            want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.device.type == "cpu" and got.ndim == 0
        assert abs(float(got) - float(want)) <= REL_ELEMENTWISE * max(abs(float(want)), 1e-30)


def _small_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "blocks": [rng.standard_normal((4, 6)).astype(np.float32)]}


def test_adamw_matches_reference_over_five_steps():
    params = _small_tree(0)
    grads = [_small_tree(10 + i) for i in range(5)]
    with jax.enable_x64(False):
        jo = jadamw_mod.adamw(jsched.warmup_cosine(1e-2, 2, 10))
        js = jo.init(_jx(params))
        jp = _jx(params)
        jups = []
        for g in grads:
            u, js = jo.update(_jx(g), js, jp)
            jp = jadamw_mod.apply_updates(jp, u)
            jups.append(u)
    to = tadamw_mod.adamw(tsched.warmup_cosine(1e-2, 2, 10))
    tp = _t(params)
    ts = to.init(tp)
    for g, ju in zip(grads, jups):
        u, ts = to.update(_t(g), ts, tp)
        tp = tadamw_mod.apply_updates(tp, u)
        _assert_trees_close(u, ju, REL_ELEMENTWISE)
    _assert_trees_close(ts, js, REL_ELEMENTWISE)
    _assert_trees_close(tp, jp, REL_ELEMENTWISE)
    assert ts["step"].device.type == "cpu" and int(ts["step"]) == 5


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _small_tree(3)
    with jax.enable_x64(False):
        jn = np.asarray(jadamw_mod.global_norm(_jx(tree)))
        jc, _ = jadamw_mod.clip_by_global_norm(_jx(tree), max_norm)
    tn = tadamw_mod.global_norm(_t(tree))
    tc, tn2 = tadamw_mod.clip_by_global_norm(_t(tree), max_norm)
    assert _rel(tn, jn) <= REL_ELEMENTWISE and torch.equal(tn, tn2)
    _assert_trees_close(tc, jc, REL_ELEMENTWISE)
    if max_norm > 1e3:   # under the norm: unchanged
        _assert_trees_close(tc, _jx(tree), 0.0)
    else:
        assert float(tadamw_mod.global_norm(tc)) == pytest.approx(max_norm, rel=1e-6)


# ---------------------------------------------------------------------------
# Shampoo pieces
# ---------------------------------------------------------------------------


def _spd(rng, n, batch=()):
    x = rng.standard_normal((*batch, 3 * n, n)).astype(np.float32)
    return (np.swapaxes(x, -1, -2) @ x / (3 * n)).astype(np.float32)


@pytest.mark.parametrize("p", [2, 4])
def test_inverse_pth_root_matches_reference(p):
    rng = np.random.default_rng(p)
    a = _spd(rng, 24, (3,))
    with jax.enable_x64(False):
        want = np.stack([np.asarray(jshampoo_mod.inverse_pth_root(jnp.asarray(x), p))
                         for x in a])
    got = tshampoo_mod.inverse_pth_root(torch.as_tensor(a), p)
    assert _rel(got, want) <= REL_NEWTON
    # one matrix alone is the batch entry
    one = tshampoo_mod.inverse_pth_root(torch.as_tensor(a[1]), p)
    assert _rel(one, got[1]) <= REL_NEWTON
    # and it is the inverse p-th root (float64 eigendecomposition)
    w, v = np.linalg.eigh(a[0].astype(np.float64))
    exact = (v * (w + 1e-6 * w.mean()) ** (-1.0 / p)) @ v.T
    assert _rel(got[0], exact) <= 1e-3


@pytest.mark.parametrize("shape,block", [((96, 48), 32), ((24, 16, 64), 1024), ((7, 5, 9), 4),
                                         ((2816, 100), 1024), ((13,), 8), ((3, 10), 8)])
def test_blocking_matches_reference_exactly(shape, block):
    jpt = jshampoo_mod._plan(shape, block)
    tpt = tshampoo_mod._plan(shape, block)
    assert tuple(jpt) == tuple(tpt)
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with jax.enable_x64(False):
        jb = np.asarray(jshampoo_mod._to_blocks(jnp.asarray(g), jpt))
        jback = np.asarray(jshampoo_mod._from_blocks(jnp.asarray(jb), jpt, shape))
    tb = tshampoo_mod._to_blocks(torch.as_tensor(g), tpt)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(tshampoo_mod._from_blocks(tb, tpt, shape).numpy(), jback)
    np.testing.assert_array_equal(jback, g)


@pytest.mark.parametrize("path,shape", [
    ("['embed']", (100, 8)), ("['lm_head']", (8, 100)), ("['layers']['attn']['wq']", (2, 8, 4)),
    ("['b']", (8,)), ("['w']", (7, 100)), ("['w']", (100, 8)), ("['n']", (2, 4))])
def test_use_shampoo_matches_reference(path, shape):
    assert tshampoo_mod._use_shampoo(path, shape) == jshampoo_mod._use_shampoo(path, shape)


def test_precond_p3_raises():
    with pytest.raises(ValueError):
        tshampoo_mod.shampoo(tsched.constant(1e-2), precond_p=3)


# ---------------------------------------------------------------------------
# Shampoo end to end against the reference
# ---------------------------------------------------------------------------


def _shampoo_inputs():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((96, 48)).astype(np.float32),
              "embed": rng.standard_normal((40, 8)).astype(np.float32),
              "b": rng.standard_normal((48,)).astype(np.float32)}
    grads = [{k: np.random.default_rng(1 + i).standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for i in range(4)]
    return params, grads


def _run_both(params, grads, **kw):
    """The same steps through the reference and the port: per-step updates
    and the final states of both."""
    with jax.enable_x64(False):
        jo = jshampoo_mod.shampoo(jsched.constant(1e-2), **kw)
        js = jo.init(_jx(params))
        jus = []
        for g in grads:
            u, js = jo.update(_jx(g), js, _jx(params))
            jus.append(u)
    to = tshampoo_mod.shampoo(tsched.constant(1e-2), **kw)
    tp = _t(params)
    ts = to.init(tp)
    tus = []
    for g in grads:
        u, ts = to.update(_t(g), ts, tp)
        tus.append(u)
    return tus, ts, jus, js


@pytest.mark.parametrize("pinned", [True, False], ids=["n_base16", "planned"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("p", [2, 4])
def test_shampoo_matches_reference(p, packed, pinned):
    """4 steps, a refresh every 2, 32-blocks of a (96, 48) weight (3×2
    blocks, each gram a 2×2 packed grid of 16-blocks), an embedding and a
    bias (Adam): updates and every state leaf within the band."""
    params, grads = _shampoo_inputs()
    kw = dict(block=32, update_every=2, precond_p=p, packed_grams=packed, gram_block=16,
              n_base=16 if pinned else None)
    tus, ts, jus, js = _run_both(params, grads, **kw)
    rel = REL_P4 if p == 4 else REL_P2
    for tu, ju in zip(tus, jus):
        _assert_trees_close(tu, ju, rel)
    _assert_trees_close(ts, js, rel)
    sh = ts["shampoo"]
    assert sh["embed"] == 0 and sh["b"] == 0        # Adam fallback
    if packed:
        assert isinstance(sh["w"]["l"], SymmetricMatrix) and sh["w"]["l"].bn == 16
    want_pl = CholeskyFactor if (p == 2 and packed) else torch.Tensor
    assert isinstance(sh["w"]["pl"], want_pl) and isinstance(sh["w"]["pr"], want_pl)


@pytest.mark.parametrize("pinned", [True, False], ids=["n_base16", "planned"])
def test_shampoo_p4_packed_equals_dense_bitwise(pinned):
    """The reference's contract (``test_shampoo_p4_path_unchanged_bitwise``)
    in the port: packed stats change nothing of the p=4 update."""
    params, grads = _shampoo_inputs()
    outs = []
    for packed in (True, False):
        opt = tshampoo_mod.shampoo(tsched.constant(1e-2), block=32, update_every=2,
                                   packed_grams=packed, gram_block=16,
                                   n_base=16 if pinned else None)
        st = opt.init(_t(params))
        us = []
        for g in grads:
            u, st = opt.update(_t(g), st, _t(params))
            us.append(u)
        outs.append(us)
    for a, b in zip(*outs):
        for x, y in zip(_tree.tree_leaves(a), _tree.tree_leaves(b)):
            assert torch.equal(x, y)


def test_shampoo_p2_packed_within_band_of_dense():
    params, grads = _shampoo_inputs()
    outs = []
    for packed in (True, False):
        opt = tshampoo_mod.shampoo(tsched.constant(1e-2), block=32, update_every=2,
                                   precond_p=2, packed_grams=packed, gram_block=16, n_base=16)
        st = opt.init(_t(params))
        for g in grads:
            u, st = opt.update(_t(g), st, _t(params))
        outs.append(u["w"])
    assert _rel(outs[0], outs[1]) <= REL_P2


def test_shampoo_whole_slice_on_qwen_smoke_tree():
    """Shampoo p=2, packed, on the reference's ``transformer.init`` tree of
    qwen1.5-0.5b's SMOKE config (15 leaves: 10 Shampoo, and Adam for the
    embeddings and the three norms, whose leading dim is below 8), carried
    across by the converter, 3 steps with one refresh.

    16-blocks (packed grid of 2×2 8-blocks) keep every block's stats
    nearly square. Wider blocks of the narrow weights give rank-deficient
    stats, and at the default relative ridge (1e-6) their whitening
    amplifies float32 rounding in both packages alike: 64-blocks leave the
    two 3.8e-2 apart (ROADMAP C, "caveats about the reference")."""
    from repro.models import transformer

    with jax.enable_x64(False):
        jparams = transformer.init(jax.random.key(0), jqwen.SMOKE)
    params = jax.tree.map(np.asarray, jparams)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    grads = [treedef.unflatten([
        np.random.default_rng(100 * i + j).standard_normal(x.shape).astype(np.float32)
        for j, x in enumerate(leaves)]) for i in range(3)]
    kw = dict(block=16, update_every=2, precond_p=2, packed_grams=True, gram_block=8)
    tus, ts, jus, js = _run_both(params, grads, **kw)
    for tu, ju in zip(tus, jus):
        _assert_trees_close(tu, ju, REL_P2)
    _assert_trees_close(ts, js, REL_P2)
    flat, _ = _tree.tree_flatten_with_path(ts["shampoo"], is_leaf=lambda x: isinstance(x, dict)
                                           and "pl" in x)
    chosen = [k for k, v in flat if isinstance(v, dict)]
    assert len(chosen) == 10 and len(flat) == 15
    assert all(isinstance(v["pl"], CholeskyFactor) for _, v in flat if isinstance(v, dict))


@pytest.mark.parametrize("name", ["adamw", "shampoo"])
def test_build_from_optimizer_config(name):
    """``build`` reads the same fields as the reference's: one step of each
    agrees within the band."""
    cfg_kw = dict(name=name, lr=1e-2, warmup_steps=1, shampoo_block=32,
                  shampoo_update_every=1, shampoo_n_base=16)
    params, grads = _shampoo_inputs()
    with jax.enable_x64(False):
        jo = jbuild(jbase.OptimizerConfig(**cfg_kw), total_steps=10)
        ju, _ = jo.update(_jx(grads[0]), jo.init(_jx(params)), _jx(params))
    to = build(tbase.OptimizerConfig(**cfg_kw), total_steps=10)
    tu, _ = to.update(_t(grads[0]), to.init(_t(params)), _t(params))
    _assert_trees_close(tu, ju, REL_P4 if name == "shampoo" else REL_ELEMENTWISE)
    with pytest.raises(ValueError):
        build(tbase.OptimizerConfig(name="sgd"))


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------


def _low_rank_plus_noise(rng, m, n, r):
    u = rng.standard_normal((m, r)).astype(np.float32)
    v = rng.standard_normal((n, r)).astype(np.float32)
    return (u @ v.T + 0.1 * rng.standard_normal((m, n))).astype(np.float32)


@pytest.mark.parametrize("pinned", [True, False], ids=["n_base8", "planned"])
def test_powersgd_compress_matches_reference(pinned):
    """Two rounds with error feedback from the same ``q`` (the reference's,
    carried across)."""
    rng = np.random.default_rng(3)
    g = [_low_rank_plus_noise(rng, 64, 40, 4) for _ in range(2)]
    n_base = 8 if pinned else None
    with jax.enable_x64(False):
        jstate = jpsgd.init_state(jax.random.key(0), (64, 40), rank=4)
        tstate = tree_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu",
                                 named_tuples=(tpsgd.PowerSGDState,))
        for gi in g:
            jp, jq, jstate = jpsgd.compress(jnp.asarray(gi), jstate, n_base=n_base)
            tp, tq, tstate = tpsgd.compress(torch.as_tensor(gi), tstate, n_base=n_base)
            assert _rel(tp, jp) <= REL_P4 and _rel(tq, jq) <= REL_P4
            assert _rel(tstate.error, jstate.error) <= REL_P4
            assert _rel(tpsgd.decompress(tp, tq), jpsgd.decompress(jp, jq)) <= REL_P4
    assert isinstance(tstate, tpsgd.PowerSGDState)


def test_powersgd_whiten_packed_matches_dense_and_reference():
    rng = np.random.default_rng(14)
    p = rng.standard_normal((64, 8)).astype(np.float32)
    pt = torch.as_tensor(p)
    g_dense = pt.T @ pt
    w_dense = tpsgd._whiten(pt, g_dense)
    w_packed = tpsgd._whiten(pt, SymmetricMatrix.from_dense(g_dense, 8))
    np.testing.assert_allclose(w_packed.numpy(), w_dense.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose((w_packed.T @ w_packed).numpy(), np.eye(8), atol=1e-2)
    with jax.enable_x64(False):
        jw = jpsgd._whiten(jnp.asarray(p), jnp.asarray(g_dense.numpy()))
    assert _rel(w_dense, jw) <= REL_P4


def test_powersgd_rank_sufficient_exact():
    """If rank ≥ rank(G), compression is (nearly) lossless after one step."""
    r = np.random.default_rng(5)
    u = r.standard_normal((32, 4)).astype(np.float32)
    v = r.standard_normal((24, 4)).astype(np.float32)
    g = torch.as_tensor(u @ v.T)
    state = tpsgd.init_state(torch.Generator().manual_seed(0), g.shape, rank=8, device="cpu")
    p, q, state = tpsgd.compress(g, state, n_base=8)
    np.testing.assert_allclose(tpsgd.decompress(p, q).numpy(), g.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(state.error.numpy(), 0.0, atol=1e-3)


def test_powersgd_error_feedback_accumulates():
    r = np.random.default_rng(6)
    g = torch.as_tensor(r.standard_normal((32, 24)).astype(np.float32))
    state = tpsgd.init_state(torch.Generator().manual_seed(1), g.shape, rank=2, device="cpu")
    total_hat = torch.zeros_like(g)
    rels = []
    for i in range(30):
        p, q, state = tpsgd.compress(g, state, n_base=8)
        total_hat = total_hat + tpsgd.decompress(p, q)
        avg = total_hat / (i + 1)
        rels.append(float(torch.linalg.norm(avg - g) / torch.linalg.norm(g)))
    # the reference's bands (tests/test_optim.py)
    assert rels[-1] < 0.3, rels[-1]
    assert rels[-1] < rels[9] < rels[4]
    fb = tpsgd.error_feedback(state, g, tpsgd.decompress(p, q))
    assert torch.equal(fb.q, state.q)


def test_powersgd_orthonormal_p():
    r = np.random.default_rng(7)
    po = tpsgd._orthonormalize(torch.as_tensor(r.standard_normal((64, 6)).astype(np.float32)))
    np.testing.assert_allclose((po.T @ po).numpy(), np.eye(6), rtol=1e-3, atol=1e-3)


def test_powersgd_init_state_and_sharded_stub():
    gen = torch.Generator().manual_seed(4)
    st = tpsgd.init_state(gen, (10, 6), rank=3, device="cpu")
    assert st.q.shape == (6, 3) and st.error.shape == (10, 6) and not st.error.any()
    again = tpsgd.init_state(torch.Generator().manual_seed(4), (10, 6), rank=3, device="cpu")
    assert torch.equal(st.q, again.q)
    # compress_sharded on row shards: tests/test_torch_distributed.py


# ---------------------------------------------------------------------------
# static tables kept per (shape, device)
# ---------------------------------------------------------------------------


def test_packed_tables_are_made_once_per_shape_and_device():
    """The packed path's index tables and masks are kept: a second call at
    the same geometry returns the very same tensor (no new copy), another
    geometry a new one."""
    assert tri_index(5, torch.device("cpu"))[0] is tri_index(5, torch.device("cpu"))[0]
    assert tri_index(5, torch.device("cpu"))[0] is not tri_index(6, torch.device("cpu"))[0]
    m1 = _eye_mask(200, 104, torch.float32, torch.device("cpu"))
    assert m1 is _eye_mask(200, 104, torch.float32, torch.device("cpu"))
    assert m1 is not _eye_mask(200, 104, torch.float64, torch.device("cpu"))
    like = torch.zeros(104, 104)
    assert _pad_identity_mask(200, 2, 104, like)[0] is _pad_identity_mask(200, 2, 104, like)[0]
    made = []
    t1 = device_table(("test_table", 3), "cpu", lambda: made.append(1) or np.arange(3))
    t2 = device_table(("test_table", 3), "cpu", lambda: made.append(1) or np.arange(3))
    assert t1 is t2 and made == [1]


def test_device_cache_keeps_the_most_recent_values(monkeypatch):
    """One bounded cache holds every static table: a hit moves its value to
    the back, and the least recently used value goes beyond the bound."""
    monkeypatch.setattr(backend, "_TABLES", OrderedDict())
    monkeypatch.setattr(backend, "_TABLES_MAX", 3)
    made = []

    def get(k):
        return backend.device_cached(k, lambda: made.append(k) or object())

    first = get("a")
    get("b"), get("c")
    assert get("a") is first and made == ["a", "b", "c"]
    get("d")                      # "b" is now the least recently used
    assert list(backend._TABLES) == ["c", "a", "d"]
    get("b")
    assert made == ["a", "b", "c", "d", "b"] and len(backend._TABLES) == 3
    assert get("a") is first


def test_cached_tables_change_no_result():
    """A packed gram, its ridge and its Cholesky twice over: bitwise the
    same, and the same as the walk on a fresh dense copy."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((3, 90, 40)).astype(np.float32))
    outs = []
    for _ in range(2):
        g = ata(a[0], out="packed", packed_block=16, n_base=16)
        outs.append(cholesky(g.add_scaled_identity(0.5)).to_dense())
    assert torch.equal(outs[0], outs[1])
    dense = cholesky(ata(a[0], n_base=16) + 0.5 * torch.eye(40), packed_block=16).to_dense()
    assert torch.equal(outs[0], dense)
