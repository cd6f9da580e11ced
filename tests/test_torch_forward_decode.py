"""``forward_train`` and ``forward_decode`` of the port's models at all ten
SMOKE configs — the dense, MoE, SSM and hybrid families, text, audio and
vision inputs — against the reference on the CPU, and the mesh and
sequence-parallel options that wait for the sharding slice.

The reference's weights are carried into the port with
``convert.params_from_reference``; each reference call is jitted inside a
scoped ``jax.enable_x64(False)``. The port updates a decode cache in
place, so the port's steps get a cache of their own.

Tolerances: logits and caches in float32 elementwise within
``8·√k·eps32·max|ref|``, ``k`` the longest contraction of the model
(``d_model``, ``d_ff``, the expert width or ``d_inner``); the MoE's aux
loss relative 1e-6; shapes, dtypes and the cache's tree equal.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jT
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.models import transformer as tT
from repro_torch.optim._tree import tree_flatten_with_path

EPS32 = float(np.finfo(np.float32).eps)
ALL = sorted(jreg.ARCH_MODULES)


def _tol(k, ref):
    return 8.0 * math.sqrt(k) * EPS32 * float(np.abs(ref).max())


def _np(x):
    return x.detach().float().cpu().numpy()


def _k(cfg):
    """The longest contraction of a SMOKE model's call."""
    ssm = cfg.ssm.d_inner(cfg.d_model) if cfg.ssm else 0
    ff = cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff
    return max(cfg.d_model, ff, ssm, 64)


def _tokens(cfg, b, s, seed):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _smoke_batch(cfg, b=2, s=24, seed=0):
    """The reference smoke tests' batch (tests/test_models_smoke.py)."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "vision_text":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - cfg.num_patches)).astype(np.int32),
                "image_embeds": rng.standard_normal((b, cfg.num_patches, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": _tokens(cfg, b, s, seed)}


@pytest.mark.parametrize("arch", ALL)
def test_forward_and_decode_equal_the_reference(arch):
    """``forward_train`` (logits and aux) on the reference smoke tests'
    batch, and two ``forward_decode`` steps from ``init_cache`` (logits,
    cache), all float32, against the reference."""
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    with jax.enable_x64(False):
        ref = jax.tree.map(np.asarray, jax.jit(lambda k: jT.init(k, jcfg))(jax.random.key(2)))
    batch = _smoke_batch(jcfg)
    tp = params_from_reference(tcfg, ref, device="cpu")
    dec_toks = _tokens(jcfg, 2, 2, 3)
    with jax.enable_x64(False):
        jp = jax.tree.map(jnp.asarray, ref)
        jl, jaux = jax.jit(lambda p, b: jT.forward_train(p, b, jcfg, compute_dtype=jnp.float32))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        want = [np.asarray(jl)]
        cache = jT.init_cache(jcfg, 2, 16, dtype=jnp.float32)
        decode = jax.jit(lambda p, t, c, pos: jT.forward_decode(p, t, c, pos, jcfg,
                                                                compute_dtype=jnp.float32))
        for t in range(2):
            lg, cache = decode(jp, jnp.asarray(dec_toks[:, t:t + 1]), cache,
                               jnp.full((2,), t, jnp.int32))
            want.append(np.asarray(lg))
        want_cache = jax.tree.map(np.asarray, cache)
    tl, taux = tT.forward_train(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg,
                                compute_dtype=torch.float32)
    got = [tl]
    cache = tT.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(2):
        lg, out = tT.forward_decode(tp, torch.as_tensor(dec_toks[:, t:t + 1]), cache,
                                    torch.full((2,), t, dtype=torch.int32), tcfg,
                                    compute_dtype=torch.float32, unroll_layers=True)
        assert out is cache
        got.append(lg)
    assert taux.dtype == torch.float32 and abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=_tol(_k(jcfg), w))
    g = tree_flatten_with_path(cache)[0]
    w = jax.tree_util.tree_flatten_with_path(want_cache)[0]
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, x), (_, y) in zip(g, w):
        assert tuple(x.shape) == y.shape and x.dtype == torch.float32, path
        np.testing.assert_allclose(_np(x), y, rtol=0, atol=_tol(_k(jcfg), y), err_msg=path)


def test_mesh_and_sp_decode_raise():
    tcfg = treg.get_smoke("qwen1.5-0.5b")
    p = tT.init(None, tcfg, device="meta")
    cache = tT.init_cache(tcfg, 1, 4, device="meta")
    toks = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    for kw in ({"sp_decode": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="sharding slice"):
            tT.forward_decode(p, toks, cache, pos, tcfg, **kw)


def test_hybrid_windows_are_made_once_per_cache_length():
    """A scanned hybrid's per-layer windows (global layers ``max_seq + 1``)
    are made once per (config, length, device) and reused by every decode
    step, not copied to the device again each step."""
    tcfg = treg.get_smoke("hymba-1.5b")
    cpu = torch.device("cpu")
    w = tT._layer_windows(tcfg, 20, cpu)
    assert tT._layer_windows(tcfg, 20, cpu) is w
    assert [int(x) for x in w] == [21 if i in tcfg.global_attn_layers else tcfg.sliding_window
                                   for i in range(tcfg.num_layers)]
    assert tT._layer_windows(tcfg, 21, cpu) is not w
