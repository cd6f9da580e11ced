"""The port's train step (``repro_torch.train.train_step``) against the
reference's, on the CPU, at the SMOKE configs of qwen1.5-0.5b (QKV
biases), gemma-7b (GeGLU, tied embeddings, head_dim 32) and
command-r-plus-104b (GQA 8:2).

The reference's weights are carried into the port with
``convert.params_from_reference``; both take the same data batches
(``make_batch``), float32 compute and no remat, as
``tests/test_train_serve.py`` runs the reference; the reference's step is
jitted inside a scoped ``jax.enable_x64(False)``.

Tolerances:

* loss and global grad norm: relative ``1e-5`` (float32 sums of a few
  thousand terms in another order);
* updated parameters, compared by their update (new − old parameters,
  which is also the whole of a zero-initialized norm or bias): normwise
  relative ``1e-3`` per leaf. Adam's first step is ``g/(|g| + ε)``, which
  turns the ~1e-7 relative gradient difference of an element with ``|g|``
  near ``ε`` into a difference of order one, so the update is looser than
  the gradients;
* Shampoo runs two steps with ``shampoo_update_every=2``, so the second
  step refreshes the p = 4 preconditioners by coupled Newton, on 16-blocks
  (as ``tests/test_torch_optim.py``): at the default 1024-blocks the smoke
  leaves' stats are rank-deficient and the float32 refresh breaks down in
  both packages (ROADMAP C);
* microbatches 1 and 2: the reference's own ``rtol=2e-4, atol=2e-5``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import base as jbase
from repro.configs.registry import get_smoke as jsmoke
from repro.data.pipeline import make_batch
from repro.models import transformer as jT
from repro.train import train_step as jts
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke as tsmoke
from repro_torch.convert import params_from_reference
from repro_torch.models import transformer as tT
from repro_torch.optim._tree import tree_flatten_with_path
from repro_torch.train import train_step as tts

ARCHS = ["qwen1.5-0.5b", "gemma-7b", "command-r-plus-104b"]
SMALL = ("small", 64, 4, "train")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _runs(arch, opt, remat="none", micro=1, **opt_kw):
    jrun = jbase.RunConfig(model=jsmoke(arch), shape=jbase.ShapeConfig(*SMALL),
                           optimizer=jbase.OptimizerConfig(name=opt, lr=1e-3, warmup_steps=5,
                                                           **opt_kw),
                           remat=remat, microbatch=micro, compute_dtype="float32")
    trun = tbase.RunConfig(model=tsmoke(arch), shape=tbase.ShapeConfig(*SMALL),
                           optimizer=tbase.OptimizerConfig(name=opt, lr=1e-3, warmup_steps=5,
                                                           **opt_kw),
                           remat=remat, microbatch=micro, compute_dtype="float32")
    return jrun, trun


def _batch(arch, step, seed=0):
    return make_batch(jsmoke(arch), jbase.ShapeConfig(*SMALL), seed, step)


def _port_state(arch, trun, params, total_steps=50):
    step_fn, opt = tts.make_train_step(tsmoke(arch), None, trun, total_steps=total_steps)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    return step_fn, state


def test_cross_entropy_equals_the_reference_with_a_padded_vocab():
    """An iota-compare masked reduction over a vocab padded from 33 to 40
    columns; float64 logits stay float64 in the port (its float64 step is
    a float64 reference), where the reference casts them to float32."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    with jax.enable_x64(False):
        want = float(jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 33))
        want_g = np.asarray(jax.grad(lambda x: jts.cross_entropy(x, jnp.asarray(labels), 33))(
            jnp.asarray(logits)))
    x = torch.as_tensor(logits).requires_grad_(True)
    got = tts.cross_entropy(x, torch.as_tensor(labels), 33)
    (got_g,) = torch.autograd.grad(got, x)
    assert abs(float(got.detach()) - want) <= 1e-6 * abs(want)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-7)
    assert not got_g[..., 33:].any()
    assert tts.cross_entropy(torch.as_tensor(logits, dtype=torch.float64),
                             torch.as_tensor(labels), 33).dtype == torch.float64
    assert tts.cross_entropy(torch.as_tensor(logits).bfloat16(),
                             torch.as_tensor(labels), 33).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("opt,steps,kw", [
    ("adamw", 1, {}),
    ("shampoo", 2, {"shampoo_update_every": 2, "shampoo_block": 16}),
], ids=["adamw_1", "shampoo_2_refresh"])
def test_train_steps_equal_the_reference(arch, opt, steps, kw):
    jrun, trun = _runs(arch, opt, **kw)
    with jax.enable_x64(False):
        jstep, jopt = jts.make_train_step(jsmoke(arch), None, jrun, total_steps=50)
        jstep = jax.jit(jstep)
        jp = jT.init(jax.random.key(0), jsmoke(arch))
        js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
        jm = []
        for i in range(steps):
            js, m = jstep(js, {k: jnp.asarray(v) for k, v in _batch(arch, i).items()})
            jm.append({k: float(v) for k, v in m.items()})
        p0 = jax.tree.map(np.asarray, jp)
        want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, js["params"]))[0]
        assert int(js["step"]) == steps

    step_fn, state = _port_state(arch, trun, params_from_reference(tsmoke(arch), p0,
                                                                    device="cpu"))
    for i in range(steps):
        state, m = step_fn(state, {k: torch.as_tensor(v) for k, v in _batch(arch, i).items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - jm[i][key]) <= 1e-5 * abs(jm[i][key]), (i, key)
        assert float(m["aux"]) == jm[i]["aux"] == 0.0
    assert int(state["step"]) == steps and state["step"].device.type == "cpu"
    before = jax.tree_util.tree_flatten_with_path(p0)[0]
    got = tree_flatten_with_path(state["params"])[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (k, g), (_, w), (_, b) in zip(got, want, before):
        g = g.numpy()
        assert np.isfinite(g).all(), k
        assert _rel(g - b, w - b) <= 1e-3, k


def test_microbatch_grad_equivalence():
    """microbatch=2 gives (numerically) the same update as 1, as in the
    reference's ``test_microbatch_grad_equivalence``; the loss is the
    microbatches' mean."""
    arch = "qwen1.5-0.5b"
    p0 = tT.init(torch.Generator().manual_seed(2), tsmoke(arch), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(arch, 0, seed=1).items()}
    out = {}
    for micro in (1, 2):
        _, trun = _runs(arch, "adamw", micro=micro)
        step_fn, state = _port_state(arch, trun, p0)
        new, m = step_fn(state, batch)
        out[micro] = (new["params"], float(m["loss"]))
    for (k, a), (_, b) in zip(tree_flatten_with_path(out[1][0])[0],
                              tree_flatten_with_path(out[2][0])[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)
    assert abs(out[1][1] - out[2][1]) < 1e-4


def test_remat_modes_give_the_same_step():
    arch = "gemma-7b"
    p0 = tT.init(torch.Generator().manual_seed(4), tsmoke(arch), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(arch, 0).items()}
    res = {}
    for remat in ("none", "dots", "full"):
        _, trun = _runs(arch, "adamw", remat=remat)
        step_fn, state = _port_state(arch, trun, p0)
        new, m = step_fn(state, batch)
        res[remat] = (float(m["loss"]), float(m["grad_norm"]), new["params"]["embed"])
    for remat in ("dots", "full"):
        assert res[remat][:2] == res["none"][:2]
        assert torch.equal(res[remat][2], res["none"][2])


def test_train_step_decreases_loss():
    """25 AdamW steps on the synthetic stream lower the loss (the
    reference's ``test_train_step_decreases_loss``)."""
    arch = "qwen1.5-0.5b"
    _, trun = _runs(arch, "adamw")
    step_fn, state = _port_state(arch, trun, tT.init(torch.Generator().manual_seed(0),
                                                    tsmoke(arch), device="cpu"))
    losses = []
    for i in range(25):
        state, m = step_fn(state, {k: torch.as_tensor(v) for k, v in _batch(arch, i).items()})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert int(state["step"]) == 25


def test_a_mesh_is_not_ported_yet():
    _, trun = _runs("qwen1.5-0.5b", "adamw")
    with pytest.raises(NotImplementedError, match="sharding"):
        tts.make_train_step(tsmoke("qwen1.5-0.5b"), object(), trun)
