"""One AdamW train step of each model family and input the port added
beside the dense text models — MoE (deepseek-moe-16b), SSM (mamba2-1.3b),
hybrid (hymba-1.5b), audio (musicgen-medium) and vision (llava-next-
mistral-7b) — against the reference's jitted step, on the CPU, at the
SMOKE configs.

Both take the reference's weights (``convert.params_from_reference``), the
same data batch (``make_batch``), float32 compute and remat ``dots``; the
reference's step is jitted inside a scoped ``jax.enable_x64(False)``.

Tolerances:

* loss (with the MoE's aux term), aux and global grad norm: relative
  ``1e-5`` (float32 sums of a few thousand terms in another order);
* updates (new − old parameters), per leaf, normwise relative ``1e-3``
  over the elements whose gradient is at least ``1e-6`` (100 × Adam's
  ε) in magnitude. Adam's first step is ``g/(|g| + ε)``, which turns the
  ~3e-6 relative gradient difference of an element with ``|g|`` near ε
  into a difference of order one; the global grad norm above covers
  those elements' gradients;
* a leaf the loss does not use (a hybrid layer's ``ssm.norm``) gets a
  zero gradient and no update in both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.data.pipeline import make_batch
from repro.models import transformer as jT
from repro.train import train_step as jts
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.models import transformer as tT
from repro_torch.optim._tree import tree_flatten_with_path
from repro_torch.train import train_step as tts

SMALL = ("small", 32, 2, "train")
G_MIN = 1e-6


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _run(base, registry, arch):
    return base.RunConfig(model=registry.get_smoke(arch), shape=base.ShapeConfig(*SMALL),
                          optimizer=base.OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=5),
                          remat="dots", compute_dtype="float32")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b",
                                  "musicgen-medium", "llava-next-mistral-7b"])
def test_adamw_step_equals_the_reference(arch):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    batch = make_batch(jcfg, jbase.ShapeConfig(*SMALL), 0, 0)
    with jax.enable_x64(False):
        jstep, jopt = jts.make_train_step(jcfg, None, _run(jbase, jreg, arch), total_steps=50)
        jp = jax.jit(lambda k: jT.init(k, jcfg))(jax.random.key(0))
        js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
        js, jm = jax.jit(jstep)(js, {k: jnp.asarray(v) for k, v in batch.items()})
        jm = {k: float(v) for k, v in jm.items()}
        p0 = jax.tree.map(np.asarray, jp)
        want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, js["params"]))[0]

    trun = _run(tbase, treg, arch)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    step_fn, opt = tts.make_train_step(tcfg, None, trun, total_steps=50)
    params = params_from_reference(tcfg, p0, device="cpu")
    _, grads = tts.loss_and_grads(tts.make_loss_fn(tcfg, None, trun), params, tbatch)
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    state, m = step_fn(state, tbatch)
    for key in ("loss", "grad_norm", "aux"):
        assert abs(float(m[key]) - jm[key]) <= 1e-5 * abs(jm[key]), key
    assert (jm["aux"] > 0) == (tcfg.moe is not None)

    before = jax.tree_util.tree_flatten_with_path(p0)[0]
    got = tree_flatten_with_path(state["params"])[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (k, g), (_, w), (_, b), (_, gr) in zip(got, want, before,
                                               tree_flatten_with_path(grads)[0]):
        g, gr = g.numpy(), gr.numpy()
        assert np.isfinite(g).all(), k
        if not gr.any():                    # a leaf the loss does not use
            np.testing.assert_array_equal(g, b, err_msg=k)
            np.testing.assert_array_equal(w, b, err_msg=k)
            continue
        well = np.abs(gr) >= G_MIN
        assert _rel((g - b)[well], (w - b)[well]) <= 1e-3, k


def test_loss_and_grads_raises_for_a_leaf_cut_off_from_the_loss():
    """The hybrid's ``ssm.norm`` is the one leaf no loss reads: it gets a
    zero gradient. Any other leaf cut off from the loss (here the MLP's
    norm, detached) raises instead of training silently on zeros."""
    tcfg = treg.get_smoke("hymba-1.5b")
    trun = _run(tbase, treg, "hymba-1.5b")
    batch = {k: torch.as_tensor(v)
             for k, v in make_batch(tcfg, tbase.ShapeConfig(*SMALL), 0, 0).items()}
    params = tT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    loss_fn = tts.make_loss_fn(tcfg, None, trun)
    _, grads = tts.loss_and_grads(loss_fn, params, batch)
    assert not grads["layers"]["ssm"]["norm"].any()
    assert grads["layers"]["mlp"]["norm"].any()

    def cut(p, b):
        mlp = dict(p["layers"]["mlp"], norm=p["layers"]["mlp"]["norm"].detach())
        return loss_fn(dict(p, layers=dict(p["layers"], mlp=mlp)), b)

    with pytest.raises(RuntimeError, match=r"\['mlp'\]\['norm'\]"):
        tts.loss_and_grads(cut, params, batch)


def test_loss_and_grads_takes_precomputed_audio_embeds():
    """With the stub front end's frame ``embeds`` in place of tokens, an
    untied head's ``embed`` is read by no loss: a zero gradient, as in JAX,
    and no error."""
    tcfg = treg.get_smoke("musicgen-medium")
    trun = _run(tbase, treg, "musicgen-medium")
    b = make_batch(tcfg, tbase.ShapeConfig(*SMALL), 0, 0)
    rng = np.random.default_rng(0)
    batch = {"embeds": torch.as_tensor(rng.standard_normal((2, 32, tcfg.d_model), np.float32)),
             "labels": torch.as_tensor(b["labels"])}
    params = tT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    _, grads = tts.loss_and_grads(tts.make_loss_fn(tcfg, None, trun), params, batch)
    assert not grads["embed"].any() and grads["lm_head"].any()
