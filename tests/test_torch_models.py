"""The port's configs and dense models (``repro_torch.configs``,
``repro_torch.models``) against the reference, on the CPU.

The same numpy inputs go through both packages; the reference's weights
are carried into the port with ``convert.params_from_reference``, and each
reference call runs inside a scoped ``jax.enable_x64(False)``.

Tolerances:

* configs, registry, ``input_specs`` and parameter shapes: equal;
* float32 layers and the forward pass: elementwise within
  ``8·√k·eps32·max|ref|``, with ``k`` the longest contraction of the call
  (``d_model``, ``d_ff`` or the sequence);
* bfloat16 forward: normwise relative ``2e-2`` (the reference's bfloat16
  band, ``tests/test_kernels.py``), as both round every product to
  bfloat16 but not in the same places.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference, tree_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as tT
from repro_torch.optim._tree import tree_flatten_with_path

EPS32 = float(np.finfo(np.float32).eps)
BF16_RTOL = 2e-2
ARCHS = ["qwen1.5-0.5b", "gemma-7b", "command-r-plus-104b"]
# the dense, text-modality configs the port runs
DENSE = ["qwen1.5-0.5b", "qwen1.5-4b", "gemma-7b", "command-r-plus-104b"]


def _tol(k, ref):
    return 8.0 * math.sqrt(k) * EPS32 * float(np.abs(ref).max())


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _ref_params(arch, seed=0, attn_only=False):
    """The reference's init of the SMOKE config (or of one attention
    block), as numpy."""
    cfg = jreg.get_smoke(arch)
    with jax.enable_x64(False):
        if attn_only:
            tree = JL.init_attn(jax.random.key(seed), cfg)
        else:
            tree = jT.init(jax.random.key(seed), cfg)
        return jax.tree.map(np.asarray, tree)


# --- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(jreg.ARCH_MODULES))
def test_configs_copy_the_reference(arch):
    for get in ("get_config", "get_smoke"):
        got, want = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_params() == want.num_params()
        assert got.active_params() == want.active_params()
        assert got.sub_quadratic == want.sub_quadratic


def test_registry_copies_the_reference():
    assert treg.ARCH_MODULES == jreg.ARCH_MODULES
    assert list(treg.ARCHS) == list(jreg.ARCHS) and list(treg.SMOKES) == list(jreg.SMOKES)
    for get in (treg.get_config, treg.get_smoke):
        with pytest.raises(KeyError):
            get("no-such-arch")


@pytest.mark.parametrize("arch", sorted(jreg.ARCH_MODULES))
def test_cell_supported_and_input_specs_equal_the_reference(arch):
    """Shapes equal the reference's ``ShapeDtypeStruct``s; dtypes are the
    same dtypes as torch's, on ``meta`` tensors."""
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    for name, shape in jbase.SHAPES.items():
        tshape = tbase.SHAPES[name]
        assert treg.cell_supported(tcfg, tshape) == jreg.cell_supported(jcfg, shape)
        for mode in (None, "train", "prefill", "decode"):
            got = treg.input_specs(tcfg, tshape, mode)
            want = jreg.input_specs(jcfg, shape, mode)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), (k, mode)
                assert got[k].device.type == "meta"
                assert str(got[k].dtype) == f"torch.{want[k].dtype}", (k, mode)


# --- parameter trees ---------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + [a for a in sorted(jreg.ARCH_MODULES) if a not in DENSE])
@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
@pytest.mark.parametrize("scan", [True, False])
def test_init_shapes_equal_the_reference(arch, which, scan):
    """The port's ``init`` on the ``meta`` device against ``jax.eval_shape``
    of the reference's: same key paths in the same order, same shapes,
    float32 (nothing is allocated, so the full configs are cheap)."""
    jcfg = dataclasses.replace(getattr(jreg, which)(arch), scan_layers=scan)
    tcfg = dataclasses.replace(getattr(treg, which)(arch), scan_layers=scan)
    ref = jax.eval_shape(lambda k: jT.init(k, jcfg), jax.random.key(0))
    want = [(jax.tree_util.keystr(k), tuple(x.shape))
            for k, x in jax.tree_util.tree_flatten_with_path(ref)[0]]
    flat, _ = tree_flatten_with_path(tT.init(None, tcfg, device="meta"))
    assert [(k, tuple(x.shape)) for k, x in flat] == want
    assert all(x.dtype == torch.float32 and x.device.type == "meta" for _, x in flat)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "deepseek-moe-16b", "hymba-1.5b",
                                  "musicgen-medium", "llava-next-mistral-7b"])
def test_families_of_later_slices_raise(arch):
    """Every family runs on one device now; what still waits for a later
    slice is a mesh (the sharding slice), for every family."""
    cfg = treg.get_smoke(arch)
    p = tT.init(None, cfg, device="meta")
    with pytest.raises(NotImplementedError, match="slice"):
        tT.init(None, cfg, object(), device="meta")
    with pytest.raises(NotImplementedError, match="slice"):
        tT.forward_train(p, {"tokens": torch.zeros((1, 4), dtype=torch.int32, device="meta")},
                         cfg, object())


@pytest.mark.parametrize("arch", sorted(jreg.ARCH_MODULES))
def test_params_from_reference_takes_every_config(arch):
    """A tree of the reference's SMOKE init structure (its
    ``jax.eval_shape``, filled with seeded numpy draws) crosses into the
    port unchanged, leaf for leaf; another config's tree is refused."""
    cfg = jreg.get_smoke(arch)
    rng = np.random.default_rng(0)
    ref = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                       jax.eval_shape(lambda k: jT.init(k, cfg), jax.random.key(0)))
    tp = params_from_reference(treg.get_smoke(arch), ref, device="cpu")
    got = tree_flatten_with_path(tp)[0]
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (k, x), (_, y) in zip(got, want):
        assert np.array_equal(x.numpy(), y), k
    other = "mamba2-1.3b" if arch != "mamba2-1.3b" else "qwen1.5-0.5b"
    with pytest.raises(ValueError, match="does not match"):
        params_from_reference(treg.get_smoke(other), ref, device="cpu")


def test_init_draws_are_seeded_and_scaled():
    cfg = treg.get_smoke("qwen1.5-0.5b")
    a = tT.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = tT.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (k, x), (_, y) in zip(tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]):
        assert torch.equal(x, y), k
    wq = a["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert not a["layers"]["attn"]["norm"].any() and not a["layers"]["attn"]["bq"].any()


def test_params_from_reference_checks_the_tree():
    ref = _ref_params("qwen1.5-0.5b")
    tp = params_from_reference(treg.get_smoke("qwen1.5-0.5b"), ref, device="cpu")
    assert np.array_equal(tp["embed"].numpy(), ref["embed"])
    with pytest.raises(ValueError, match="does not match"):
        params_from_reference(treg.get_smoke("gemma-7b"), ref, device="cpu")
    bad = dict(ref, final_norm=np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(treg.get_smoke("qwen1.5-0.5b"), bad, device="cpu")


# --- layers ------------------------------------------------------------------


def test_rms_norm_and_rope_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32) * 0.1
    pos = np.tile(np.arange(9), (2, 1)).astype(np.int32) * 7
    with jax.enable_x64(False):
        jn = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
        jr = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    tn = TL.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6)
    tr = TL.rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4)
    np.testing.assert_allclose(_np(tn), jn, rtol=0, atol=_tol(32, jn))
    np.testing.assert_allclose(_np(tr), jr, rtol=0, atol=_tol(32, jr))
    # bfloat16 in, bfloat16 out, statistics in float32
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert TL.rms_norm(xb, torch.as_tensor(w)).dtype == torch.bfloat16
    assert TL.rope(xb, torch.as_tensor(pos), 1e4).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_gated_equals_the_reference(arch):
    cfg = jreg.get_smoke(arch)
    with jax.enable_x64(False):
        p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.key(1), cfg.d_model, cfg.d_ff))
        x = np.random.default_rng(1).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
        want = np.asarray(JL.mlp_gated(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                       cfg.mlp_activation))
    got = TL.mlp_gated(tree_from_numpy(p, device="cpu"), torch.as_tensor(x), cfg.mlp_activation)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=_tol(cfg.d_ff, want))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("blocks", [None, (8, 4)], ids=["default_blocks", "q8_kv4"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_train_equals_the_reference(arch, blocks, window, monkeypatch):
    """Flash-chunked attention at the default blocks (one block) and at
    ``Q_BLOCK=8, KV_BLOCK=4`` (many blocks, the last ones short in the
    port and padded in the reference), causal and windowed; the
    reference's blocks are shrunk as ``tests/test_layers.py`` shrinks them."""
    if blocks is not None:
        for mod in (JL, TL):
            monkeypatch.setattr(mod, "Q_BLOCK", blocks[0])
            monkeypatch.setattr(mod, "KV_BLOCK", blocks[1])
    cfg = jreg.get_smoke(arch)
    p = _ref_params(arch, seed=2, attn_only=True)
    x = np.random.default_rng(2).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    with jax.enable_x64(False):
        want, (jk, jv) = JL.attention_train(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
                                            window=window, return_kv=True)
        want, jk = np.asarray(want), np.asarray(jk)
    got, (tk, _) = TL.attention_train(tree_from_numpy(p, device="cpu"), torch.as_tensor(x),
                                      treg.get_smoke(arch), window=window, return_kv=True)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=_tol(max(cfg.d_model, 37), want))
    np.testing.assert_allclose(_np(tk), jk, rtol=0, atol=_tol(cfg.d_model, jk))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_equals_the_reference(arch):
    """Logits of the whole SMOKE model with the reference's weights: float32
    within the scaled bound, bfloat16 within 2e-2 normwise; the auxiliary
    loss is a float32 zero in both."""
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    ref = _ref_params(arch)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    tp = params_from_reference(tcfg, ref, device="cpu")
    for dt in ("float32", "bfloat16"):
        with jax.enable_x64(False):
            jl, jaux = jT.forward_train(jax.tree.map(jnp.asarray, ref),
                                        {"tokens": jnp.asarray(toks)}, jcfg,
                                        compute_dtype=jnp.dtype(dt))
            want = np.asarray(jl.astype(jnp.float32))
        got, aux = tT.forward_train(tp, {"tokens": torch.as_tensor(toks)}, tcfg,
                                    compute_dtype=getattr(torch, dt))
        assert got.dtype == getattr(torch, dt) and got.shape == want.shape
        assert float(aux) == float(jaux) == 0.0 and aux.dtype == torch.float32
        if dt == "float32":
            k = max(jcfg.d_model, jcfg.d_ff, toks.shape[1])
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=_tol(k, want))
        else:
            assert _rel(_np(got), want) <= BF16_RTOL


def test_forward_train_unscanned_equals_scanned():
    """``scan_layers=False`` (a list of layer dicts) computes what the
    stacked tree does, bitwise."""
    cfg = treg.get_smoke("qwen1.5-0.5b")
    p = tT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    listed = dict(p, layers=[
        {g: {k: v[i] for k, v in d.items()} for g, d in p["layers"].items()}
        for i in range(cfg.num_layers)])
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                    generator=torch.Generator().manual_seed(1))}
    a, _ = tT.forward_train(p, toks, cfg, compute_dtype=torch.float32)
    b, _ = tT.forward_train(listed, toks, dataclasses.replace(cfg, scan_layers=False),
                            compute_dtype=torch.float32)
    assert torch.equal(a, b)


class _CountMM(TorchDispatchMode):
    """Counts the projections' products, and the backward ops that would
    write a whole layer stack for one layer's view (``select_backward``)."""

    def __init__(self):
        super().__init__()
        self.mm = 0
        self.select_backward = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        if func is torch.ops.aten.select_backward.default:
            self.select_backward += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_should():
    """The same loss and gradients under ``none``, ``dots`` and ``full``;
    ``dots`` saves the projections' products (no ``mm`` runs again in the
    backward pass), ``full`` recomputes them; the stacked layers get one
    gradient each, not one copy of the stack a layer."""
    cfg = treg.get_smoke("command-r-plus-104b")
    p0 = tT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    out = {}
    for remat in ("none", "dots", "full"):
        p = {k: v for k, v in p0.items()}
        flat, treedef = tree_flatten_with_path(p)
        leaves = [x.clone().requires_grad_(True) for _, x in flat]
        counter = _CountMM()
        with counter:
            logits, _ = tT.forward_train(treedef.unflatten(leaves), {"tokens": toks}, cfg,
                                         remat=remat, compute_dtype=torch.float32)
            loss = logits.float().square().mean()
            grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads, counter.mm)
        assert counter.select_backward == 0, remat
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for g, h in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, h)
    assert out["dots"][2] == out["none"][2] < out["full"][2]
    with pytest.raises(ValueError):
        tT.forward_train(p0, {"tokens": toks}, cfg, remat="some")
