"""The port's MoE and SSM layers (``repro_torch.models.moe``,
``repro_torch.models.ssm``) against the reference on the CPU.

The same numpy inputs go through both packages; weights are the
reference's, carried across with ``tree_from_numpy``. Each reference call runs
inside a scoped ``jax.enable_x64(False)``.

Tolerances:

* float32 layers: elementwise within ``8·√k·eps32·max|ref|``, with ``k``
  the longest contraction of the call (``d_model``, ``d_ff``, ``d_inner``
  or the sequence);
* the MoE's aux loss: relative 1e-6 (a mean of float32 products);
* the MoE's routing (which tokens each expert keeps, ties included) is
  compared exactly, through the output: a token routed differently would
  be off by a whole expert's output;
* bfloat16 MoE: normwise relative ``2e-2`` (the reference's bfloat16
  band);
* the SSD gradient at 50× decays: see its test.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.configs import registry as treg
from repro_torch.convert import tree_from_numpy
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS

EPS32 = float(np.finfo(np.float32).eps)
MOE_ARCHS = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]


def _tol(k, ref):
    return 8.0 * math.sqrt(k) * EPS32 * float(np.abs(ref).max())


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _np(x):
    return x.detach().float().cpu().numpy()


def _cfgs(arch, **moe_kw):
    """The reference's and the port's SMOKE config, MoE fields replaced."""
    j, t = jreg.get_smoke(arch), treg.get_smoke(arch)
    if moe_kw:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_kw))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_kw))
    return j, t


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- MoE ---------------------------------------------------------------------


def _moe_pair(jcfg, tcfg, x, p=None, seed=0, dtype="float32"):
    with jax.enable_x64(False):
        if p is None:
            p = jax.tree.map(np.asarray, JM.init_moe(jax.random.key(seed), jcfg))
        jy, jaux = JM.moe_layer(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x).astype(jnp.dtype(dtype)), jcfg)
        want, want_aux = np.asarray(jy.astype(jnp.float32)), float(jaux)
    got, aux = TM.moe_layer(tree_from_numpy(p, device="cpu"),
                            torch.as_tensor(x).to(getattr(torch, dtype)), tcfg)
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    return _np(got), float(aux), want, want_aux


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("tokens", [(2, 16), (3, 7)], ids=["2x16", "3x7"])
def test_moe_layer_equals_the_reference(arch, tokens):
    jcfg, tcfg = _cfgs(arch)
    x = _x((*tokens, jcfg.d_model), 1)
    got, aux, want, want_aux = _moe_pair(jcfg, tcfg, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(jcfg.moe.d_ff_expert, want))
    assert abs(aux - want_aux) <= 1e-6 * abs(want_aux)


def test_moe_zero_router_breaks_every_tie_like_the_reference():
    """A zero router gives every expert the same probability: the top-k
    choice and every capacity selection are ties, which both packages give
    to the lowest index."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    with jax.enable_x64(False):
        p = jax.tree.map(np.asarray, JM.init_moe(jax.random.key(2), jcfg))
    p = dict(p, router=np.zeros_like(p["router"]))
    x = _x((2, 12, jcfg.d_model), 3)
    got, aux, want, want_aux = _moe_pair(jcfg, tcfg, x, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(jcfg.moe.d_ff_expert, want))
    assert abs(aux - want_aux) <= 1e-6 * abs(want_aux)
    # every token goes to experts 0 and 1 (the lowest indices), and expert 0
    # keeps the first tokens up to its capacity: the rest are dropped there
    cap = TM.moe_capacity(24, jcfg.moe.num_experts, jcfg.moe.top_k, jcfg.moe.capacity_factor)
    assert cap < 24


@pytest.mark.parametrize("cf,seq", [(0.25, 32), (0.5, 48)])
def test_moe_capacity_drops_tokens_like_the_reference(cf, seq):
    """A capacity small enough that experts drop routed tokens."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=cf)
    x = _x((2, seq, jcfg.d_model), 4)
    t = 2 * seq
    cap = TM.moe_capacity(t, jcfg.moe.num_experts, jcfg.moe.top_k, cf)
    assert cap < t * jcfg.moe.top_k / jcfg.moe.num_experts   # some expert must drop
    got, aux, want, want_aux = _moe_pair(jcfg, tcfg, x, seed=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(jcfg.moe.d_ff_expert, want))
    assert abs(aux - want_aux) <= 1e-6 * abs(want_aux)
    assert TM.moe_capacity(t, 6, 2, cf) == JM.moe_capacity(t, 6, 2, cf)


def test_moe_bfloat16_and_repeatable():
    """bfloat16 tokens within 2e-2 normwise of the reference; two calls
    bitwise equal (the combine sums each token's slots in expert order)."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    x = _x((2, 16, jcfg.d_model), 6)
    got, _, want, _ = _moe_pair(jcfg, tcfg, x, seed=7, dtype="bfloat16")
    assert _rel(got, want) <= 2e-2
    p = tree_from_numpy(jax.tree.map(np.asarray, JM.init_moe(jax.random.key(7), jcfg)),
                        device="cpu")
    xb = torch.as_tensor(x).bfloat16()
    a, _ = TM.moe_layer(p, xb, tcfg)
    b, _ = TM.moe_layer(p, xb, tcfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_moe_mesh_raises():
    _, tcfg = _cfgs("deepseek-moe-16b")

    class _Mesh:
        shape = {"data": 1, "model": 2}

    p = TM.init_moe(None, tcfg, device="meta")
    for mesh in (_Mesh(), type("M", (), {"shape": {"model": 1}})()):
        with pytest.raises(NotImplementedError, match="sharding slice"):
            TM.moe_layer(p, torch.zeros((1, 2, tcfg.d_model), device="meta"), tcfg, mesh)
    assert TM.moe_layer(p, torch.zeros((1, 2, tcfg.d_model), device="meta"),
                        tcfg)[0].shape == (1, 2, 64)


# --- SSM ---------------------------------------------------------------------


def _ssm_cfgs(p_major, chunk=None):
    j, t = jreg.get_smoke("mamba2-1.3b"), treg.get_smoke("mamba2-1.3b")
    kw = {"p_major": p_major, **({"chunk": chunk} if chunk else {})}
    return (dataclasses.replace(j, ssm=dataclasses.replace(j.ssm, **kw)),
            dataclasses.replace(t, ssm=dataclasses.replace(t.ssm, **kw)))


def _ssm_params(jcfg, seed):
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, JS.init_ssm(jax.random.key(seed), jcfg))


def test_depthwise_causal_conv_equals_the_reference():
    x = _x((2, 11, 24), 0)
    w = _x((24, 4), 1)
    with jax.enable_x64(False):
        want = np.asarray(JS._depthwise_causal_conv(jnp.asarray(x), jnp.asarray(w)))
    got = _np(TS._depthwise_causal_conv(torch.as_tensor(x), torch.as_tensor(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(4, want))
    # tap K-1 multiplies the current token
    one = np.zeros((1, 3, 24), np.float32)
    one[0, 2] = 1.0
    out = _np(TS._depthwise_causal_conv(torch.as_tensor(one), torch.as_tensor(w)))
    np.testing.assert_array_equal(out[0, 2], w[:, -1])


@pytest.mark.parametrize("s", [64, 50, 7], ids=["two_chunks", "short_tail", "one_short"])
def test_ssd_chunked_equals_the_reference(s):
    """Chunk 32: S a multiple of the chunk, and not (the reference pads to
    whole chunks, the port takes a short last chunk)."""
    rng = np.random.default_rng(2)
    b_, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b_, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b_, s, h)))) * 0.5).astype(np.float32)
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    bb = rng.standard_normal((b_, s, n)).astype(np.float32)
    cc = rng.standard_normal((b_, s, n)).astype(np.float32)
    with jax.enable_x64(False):
        jy, jh = JS._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bb, cc)), 32)
        jy, jh = np.asarray(jy), np.asarray(jh)
    ty, th = TS._ssd_chunked(*(torch.as_tensor(v) for v in (x, dt, a, bb, cc)), 32)
    np.testing.assert_allclose(_np(ty), jy, rtol=0, atol=_tol(32 * n, jy))
    np.testing.assert_allclose(_np(th), jh, rtol=0, atol=_tol(s * n, jh))


@pytest.mark.parametrize("p_major", [False, True], ids=["h_major", "p_major"])
@pytest.mark.parametrize("s", [40, 2], ids=["s40", "s2_short_tail"])
def test_ssm_train_with_state_then_decode_equal_the_reference(p_major, s):
    """``ssm_train(return_state=True)`` (output, SSD state, pre-conv tail,
    left-padded when S < K-1) and then three ``ssm_decode`` steps from
    that state, in both head layouts."""
    jcfg, tcfg = _ssm_cfgs(p_major)
    p = _ssm_params(jcfg, 3)
    x = _x((2, s + 3, jcfg.d_model), 4)
    di = jcfg.ssm.d_inner(jcfg.d_model)
    with jax.enable_x64(False):
        jp = jax.tree.map(jnp.asarray, p)
        jy, (jh, jconv) = JS.ssm_train(jp, jnp.asarray(x[:, :s]), jcfg, return_state=True)
        want = [np.asarray(jy)]
        for t in range(s, s + 3):
            yt, jh, jconv = JS.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jh, jconv)
            want.append(np.asarray(yt))
        want += [np.asarray(jh), np.asarray(jconv)]
    tp = tree_from_numpy(p, device="cpu")
    ty, (th, tconv) = TS.ssm_train(tp, torch.as_tensor(x[:, :s]), tcfg, return_state=True)
    assert th.dtype == tconv.dtype == torch.float32
    assert tconv.shape == (2, jcfg.ssm.d_conv - 1, di + 2 * jcfg.ssm.d_state)
    got = [_np(ty)]
    for t in range(s, s + 3):
        yt, th, tconv = TS.ssm_decode(tp, torch.as_tensor(x[:, t:t + 1]), tcfg, th, tconv)
        got.append(_np(yt))
    got += [_np(th), _np(tconv)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=_tol(max(di, s), w))


def test_ssm_train_decode_teacher_forced_consistency():
    """Decoding token by token from a zero state reproduces ``ssm_train``
    over the whole sequence (the reference's
    ``test_ssd_chunked_matches_sequential_decode``), across chunks."""
    _, tcfg = _ssm_cfgs(True, chunk=8)
    tp = tree_from_numpy(_ssm_params(_ssm_cfgs(True, chunk=8)[0], 8), device="cpu")
    x = torch.as_tensor(_x((2, 20, tcfg.d_model), 9))
    full = TS.ssm_train(tp, x, tcfg)
    h, conv = TS.init_ssm_state(tcfg, 2, device="cpu")
    outs = []
    for t in range(20):
        y, h, conv = TS.ssm_decode(tp, x[:, t:t + 1], tcfg, h, conv)
        outs.append(y)
    got = torch.cat(outs, dim=1)
    np.testing.assert_allclose(_np(got), _np(full), rtol=0, atol=_tol(128, _np(full)))


@pytest.mark.parametrize("dt_scale", [1.0, 50.0], ids=["normal_decay", "long_decay"])
def test_ssd_gradient_finite_long_decay(dt_scale):
    """Large dt·A decays give finite gradients (mask before exp), as in the
    reference's test of the same name. At the normal scale the gradient is
    the reference's within the float32 bound; at 50× the gradient is
    ill-conditioned (the reference's own float32 gradient is ~1e-2 off
    its float64 one), so there the port's distance to the float64
    gradient must stay within twice the reference's."""
    jcfg, tcfg = _ssm_cfgs(False)
    p = _ssm_params(jcfg, 6)
    p = dict(p, dt_proj=p["dt_proj"] * dt_scale)
    x = _x((1, 64, jcfg.d_model), 7)

    def ref_grad(dtype):
        jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
        return np.asarray(jax.jit(jax.grad(lambda xx: JS.ssm_train(jp, xx, jcfg).sum()))(
            jnp.asarray(x, dtype)), np.float64)

    with jax.enable_x64(False):
        want = ref_grad(jnp.float32)
    with jax.enable_x64(True):
        want64 = ref_grad(jnp.float64)
    xt = torch.as_tensor(x).requires_grad_(True)
    (g,) = torch.autograd.grad(TS.ssm_train(tree_from_numpy(p, device="cpu"), xt, tcfg).sum(),
                               xt)
    assert torch.isfinite(g).all()
    g = g.numpy().astype(np.float64)
    if dt_scale == 1.0:
        np.testing.assert_allclose(g, want, rtol=0, atol=_tol(64 * 128, want))
    else:
        assert np.abs(g - want64).max() <= 2.0 * np.abs(want - want64).max()


def test_init_ssm_and_state_shapes():
    jcfg, tcfg = _ssm_cfgs(True)
    want = jax.eval_shape(lambda k: JS.init_ssm(k, jcfg), jax.random.key(0))
    got = TS.init_ssm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    with jax.enable_x64(False):
        ref = JS.init_ssm(jax.random.key(0), jcfg)
        # log(linspace(1, 16, H)): both libraries' linspace and log, within 2 ulp
        np.testing.assert_allclose(got["a_log"].numpy(), np.asarray(ref["a_log"]),
                                   rtol=2 * EPS32, atol=0)
    np.testing.assert_array_equal(got["d_skip"].numpy(), 1.0)
    jh, jc = JS.init_ssm_state(jcfg, 3)
    th, tc = TS.init_ssm_state(tcfg, 3, device="cpu")
    assert (tuple(th.shape), tuple(tc.shape)) == (jh.shape, jc.shape)
    with pytest.raises(NotImplementedError, match="sharding slice"):
        TS.ssm_train(got, torch.zeros((1, 2, tcfg.d_model)), tcfg,
                     mesh=type("M", (), {"shape": {"model": 4}})())
