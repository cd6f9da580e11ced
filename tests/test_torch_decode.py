"""The port's serving path — ``attention_decode``, ``init_cache``, the
prefill cache, ``forward_decode``, ``train.serve_step`` and
``python -m repro_torch.launch.serve`` — against the reference on the
CPU (``tests/test_torch_forward_decode.py`` holds ``forward_train`` and
``forward_decode`` at all ten SMOKE configs).

The same numpy inputs go through both packages; the reference's weights
are carried into the port with ``convert.params_from_reference`` (the CLI
test carries the port's weights the other way), and each reference call
runs inside a scoped ``jax.enable_x64(False)``. The port updates a decode
cache in place, so every port call here gets a cache of its own.

Tolerances:

* shapes, dtypes, tree structure, prompts and greedy tokens: equal;
* float32 attention, logits and caches: elementwise within
  ``8·√k·eps32·max|ref|``, ``k`` the longest contraction of the call
  (``d_model``, ``d_ff``, ``d_inner`` or the sequence);
* the MoE's aux loss: relative 1e-6;
* teacher-forced decode against ``forward_train``: the reference's own
  ``rtol = atol = 2e-3`` (``tests/test_train_serve.py``);
* sampling: the draws are the port's own stream, so the test checks the
  mask, determinism by seed and the frequencies of 4000 draws against the
  softmax (each within 5 standard deviations).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import transformer as jT
from repro.train import serve_step as jS
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference, to_numpy, tree_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as tT
from repro_torch.optim._tree import tree_flatten_with_path, tree_map
from repro_torch.train import serve_step as tS

EPS32 = float(np.finfo(np.float32).eps)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = sorted(jreg.ARCH_MODULES)
TF_TOL = 2e-3


def _tol(k, ref):
    return 8.0 * math.sqrt(k) * EPS32 * float(np.abs(ref).max())


def _np(x):
    return x.detach().float().cpu().numpy()


def _k(cfg):
    """The longest contraction of a SMOKE model's call."""
    ssm = cfg.ssm.d_inner(cfg.d_model) if cfg.ssm else 0
    ff = cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff
    return max(cfg.d_model, ff, ssm, 64)


def _pair(arch, **kw):
    j, t = jreg.get_smoke(arch), treg.get_smoke(arch)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _ref_init(jcfg, seed=0):
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, jax.jit(lambda k: jT.init(k, jcfg))(jax.random.key(seed)))


def _tokens(cfg, b, s, seed):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _leaves_close(got, want, k, what):
    """Two caches (the port's tensors, the reference's arrays): the same key
    paths, shapes and dtypes, values within the bound."""
    g, w = tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w], what
    for (path, x), (_, y) in zip(g, w):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape and str(x.dtype) == f"torch.{y.dtype}", (what, path)
        np.testing.assert_allclose(_np(x), y.astype(np.float32), rtol=0,
                                   atol=_tol(k, y) if y.size else 0, err_msg=f"{what} {path}")


# --- attention_decode ----------------------------------------------------------


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "qwen1.5-0.5b"], ids=["gqa", "bias"])
@pytest.mark.parametrize("case", [
    ("absolute", 16, None, (3, 9)),
    ("ring", 8, 8, (5, 13)),                 # the second row has wrapped
    ("ring_before_wrap", 8, 8, (0, 7)),
    ("distance", 16, 5, (3, 12)),
    ("distance_as_data", 16, "tensor5", (3, 12)),
], ids=lambda c: c[0])
def test_attention_decode_equals_the_reference(arch, case):
    """One decode step against a cache of random contents in the three
    validity branches: an absolute cache (``window=None``), a ring
    buffer (``window == S_cache``, before and after it wraps) and an
    absolute cache masked by distance (an int, or a 0-d tensor as a
    scanned hybrid passes it). The port writes the new key and value into
    the caches it is given and returns them."""
    _, s_cache, window, pos = case
    jcfg, tcfg = _pair(arch)
    rng = np.random.default_rng(1)
    with jax.enable_x64(False):
        p = jax.tree.map(np.asarray, JL.init_attn(jax.random.key(2), jcfg))
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, s_cache, jcfg.num_kv_heads, jcfg.head_dim))
              .astype(np.float32) for _ in range(2))
    pos = np.asarray(pos, np.int32)
    with jax.enable_x64(False):
        jw = jnp.asarray(5, jnp.int32) if window == "tensor5" else window
        jo, jk, jv = JL.attention_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                         jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
                                         window=jw)
        want = [np.asarray(a) for a in (jo, jk, jv)]
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    tw = torch.tensor(5, dtype=torch.int32) if window == "tensor5" else window
    to, rk, rv = TL.attention_decode(tree_from_numpy(p, device="cpu"), torch.as_tensor(x), tcfg,
                                     tk, tv, torch.as_tensor(pos), window=tw)
    assert rk is tk and rv is tv                         # written in place
    for g, w, k in zip((to, rk, rv), want, (s_cache * jcfg.head_dim, jcfg.d_model, jcfg.d_model)):
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=_tol(k, w))


# --- caches ------------------------------------------------------------------


@pytest.mark.parametrize("arch,scan", [(a, True) for a in ALL] + [("hymba-1.5b", False)])
def test_init_cache_equals_the_reference(arch, scan):
    jcfg, tcfg = _pair(arch, scan_layers=scan)
    want = jT.init_cache(jcfg, 3, 20, dtype=jnp.float32)
    got = tT.init_cache(tcfg, 3, 20, dtype=torch.float32, device="cpu")
    _leaves_close(got, want, 1, "init_cache")
    assert all(not x.any() for _, x in tree_flatten_with_path(got)[0])
    # a shape-only mesh gives the global cache; on a rank's mesh a cache
    # length the model axis does not divide is whole on every rank, and so
    # is a batch the data axes do not divide (as the reference keeps them)
    from repro_torch.launch.mesh import AbstractMesh

    got = tT.init_cache(tcfg, 4, 20, mesh=AbstractMesh((2, 2), ("data", "model")),
                        dtype=torch.float32, device="meta")
    want = jax.eval_shape(lambda: jT.init_cache(jcfg, 4, 20, dtype=jnp.float32))
    assert [tuple(x.shape) for _, x in tree_flatten_with_path(got)[0]] == [
        x.shape for x in jax.tree.leaves(want)]
    for batch, max_seq in ((4, 21), (3, 20)):
        whole = tT.init_cache(tcfg, batch, max_seq, mesh=AbstractMesh((2, 2), ("data", "model")),
                              device="meta")
        mine = tT.init_cache(tcfg, batch, max_seq, mesh=_RankView((2, 2)), device="meta")
        for (key, w), (_, m) in zip(tree_flatten_with_path(whole)[0],
                                    tree_flatten_with_path(mine)[0]):
            b_dim = w.dim() - (3 if key.endswith("['conv']") else 4)
            assert m.shape[b_dim] == (2 if batch == 4 else 3), key
            if key.endswith("['k']") or key.endswith("['v']"):
                assert m.shape[-3] == w.shape[-3] if max_seq == 21 else True, key


class _RankView:
    """Rank 0's view of a (data, model) mesh, with no process group: enough
    for the checks that raise before any collective."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = 0
        self.coords = {"data": 0, "model": 0}

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        return 0


@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", {}),
    ("mamba2-1.3b", {}),
    ("hymba-1.5b", {"sliding_window": 8}),
    ("hymba-1.5b", {"sliding_window": 8, "scan_layers": False}),   # ring caches
    ("musicgen-medium", {}),
    ("deepseek-moe-16b", {}),
], ids=["dense", "ssm", "hybrid_scanned", "hybrid_unscanned_ring", "audio", "moe"])
def test_prefill_cache_equals_the_reference(arch, kw):
    """``forward_train(return_cache=True)`` at 2 × 21 tokens into a cache of
    30 slots: logits, aux and the cache leaf for leaf (padded absolute
    slots, rings on the unscanned hybrid's windowed layers, the SSD state
    and the pre-conv tail)."""
    jcfg, tcfg = _pair(arch, **kw)
    ref = _ref_init(jcfg, 1)
    toks = _tokens(jcfg, 2, 21, 2)
    with jax.enable_x64(False):
        jl, jaux, jc = jax.jit(lambda p, t: jT.forward_train(
            p, {"tokens": t}, jcfg, compute_dtype=jnp.float32, return_cache=True,
            cache_len=30))(jax.tree.map(jnp.asarray, ref), jnp.asarray(toks))
        jl, jaux, jc = np.asarray(jl), float(jaux), jax.tree.map(np.asarray, jc)
    with torch.no_grad():
        tl, taux, tc = tT.forward_train(params_from_reference(tcfg, ref, device="cpu"),
                                        {"tokens": torch.as_tensor(toks)}, tcfg,
                                        compute_dtype=torch.float32, return_cache=True,
                                        cache_len=30)
    np.testing.assert_allclose(_np(tl), jl, rtol=0, atol=_tol(_k(jcfg), jl))
    assert abs(float(taux) - jaux) <= 1e-6 * abs(jaux)
    _leaves_close(tc, jc, _k(jcfg), "prefill cache")


# --- the serve steps -----------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "hymba-1.5b", "musicgen-medium"])
def test_prefill_then_decode_matches_forward(arch):
    """The reference's ``test_prefill_then_decode_matches_forward``: prefill
    24 tokens, decode 7 teacher-forced; every step's logits within 2e-3 of
    ``forward_train`` over the whole sequence, and within the float32
    bound of the reference's own steps."""
    jcfg, tcfg = _pair(arch)
    ref = _ref_init(jcfg, 3)
    b, s_p, s = 2, 24, 32
    toks = _tokens(jcfg, b, s, 4)
    with jax.enable_x64(False):
        jp = jax.tree.map(jnp.asarray, ref)
        lg, cache = jax.jit(jS.make_prefill_step(jcfg, compute_dtype=jnp.float32, cache_len=s))(
            jp, {"tokens": jnp.asarray(toks[:, :s_p])})
        want = [np.asarray(lg)]
        dec = jax.jit(jS.make_decode_step(jcfg, compute_dtype=jnp.float32))
        for t in range(s_p, s - 1):
            lg, cache = dec(jp, jnp.asarray(toks[:, t:t + 1]), cache, jnp.full((b,), t, jnp.int32))
            want.append(np.asarray(lg))
    tp = params_from_reference(tcfg, ref, device="cpu")
    with torch.no_grad():
        full, _ = tT.forward_train(tp, {"tokens": torch.as_tensor(toks)}, tcfg,
                                   compute_dtype=torch.float32)
    lg, cache = tS.make_prefill_step(tcfg, compute_dtype=torch.float32, cache_len=s)(
        tp, {"tokens": torch.as_tensor(toks[:, :s_p])})
    got = [lg]
    dec = tS.make_decode_step(tcfg, compute_dtype=torch.float32)
    for t in range(s_p, s - 1):
        lg, cache = dec(tp, torch.as_tensor(toks[:, t:t + 1]), cache,
                        torch.full((b,), t, dtype=torch.int32))
        got.append(lg)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g[:, 0]), _np(full[:, s_p - 1 + i]), rtol=TF_TOL,
                                   atol=TF_TOL, err_msg=f"{arch} step {i}")
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=_tol(_k(jcfg), w))


def test_sample_logits_mask_greedy_and_distribution():
    logits = torch.tensor([[[0.1, 3.0, 0.2, 9.9]]])          # (B=1, 1, V=4)
    assert int(tS.sample_logits(logits, None, temperature=0.0)[0, 0]) == 3
    # padded-vocab mask: index 3 is padding → argmax must avoid it
    tok = tS.sample_logits(logits, None, temperature=0.0, vocab_real=3)
    assert int(tok[0, 0]) == 1 and tok.dtype == torch.int32 and tok.shape == (1, 1)
    with jax.enable_x64(False):
        assert int(jS.sample_logits(jnp.asarray(logits.numpy()), jax.random.key(0), 0.0,
                                    vocab_real=3)[0, 0]) == 1
    # ties: the first maximum, in both
    tie = torch.tensor([[[1.0, 5.0, 5.0, 0.0]]])
    assert int(tS.sample_logits(tie, None, 0.0)[0, 0]) == 1
    # sampling: within the real vocab, seeded, and distributed as the softmax
    draws = lambda seed, n: tS.sample_logits(                # noqa: E731
        logits.expand(n, 1, 4), torch.Generator().manual_seed(seed), 2.0, vocab_real=3)
    a, b = draws(5, 4000), draws(5, 4000)
    assert torch.equal(a, b) and not torch.equal(a, draws(6, 4000))
    assert int(a.max()) <= 2 and a.shape == (4000, 1)
    p = torch.softmax(logits[0, 0, :3] / 2.0, -1).numpy()
    freq = np.bincount(a.numpy().ravel(), minlength=3) / 4000
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / 4000)), (freq, p)
    # audio logits (B, 1, K, V) → (B, 1, K) ids
    assert tS.sample_logits(torch.zeros((2, 1, 4, 8)), None, 0.0).shape == (2, 1, 4)


# --- the CLI -------------------------------------------------------------------


def test_pad_slots_is_the_reference():
    rng = np.random.default_rng(0)
    real = rng.integers(0, 64, size=(2, 8)).astype(np.int32)
    np.testing.assert_array_equal(tserve._pad_slots(real, 4), jserve._pad_slots(real, 4))
    assert tserve._pad_slots(real, 2) is real


def test_serve_cli_matches_the_reference(tmp_path):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` in a
    subprocess, greedy at float32, 6 requests through 4 slots (a ragged
    tail): its prompts are the reference CLI's stream, and its greedy
    tokens are the reference's prefill/decode/``sample_logits`` on the
    same weights (the port's seeded ``init``, carried into the reference)."""
    arch, seed, p_len, g_len, b, n_req = "qwen1.5-0.5b", 3, 8, 6, 4, 6
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--requests", str(n_req), "--batch", str(b), "--prompt-len",
         str(p_len), "--gen-len", str(g_len), "--temperature", "0", "--seed", str(seed),
         "--compute-dtype", "float32", "--out", str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith(f"served 4/{n_req} requests ({4 * (g_len - 1)} tokens")
    assert lines[1].startswith(f"served 6/{n_req} requests ({6 * (g_len - 1)} tokens")
    assert lines[2].startswith("throughput:")
    res = json.loads(out.read_text())
    prompts, tokens = np.asarray(res["prompts"]), np.asarray(res["tokens"])
    assert tokens.shape == (n_req, g_len) and len(res["decode_ms"]) == 2 * (g_len - 1)

    # the reference CLI's prompt stream and greedy loop, on the port's weights
    cfg = jreg.get_smoke(arch)
    params = tree_map(to_numpy, tT.init(torch.Generator().manual_seed(seed),
                                        treg.get_smoke(arch), device="cpu"))
    rng = np.random.default_rng(seed)
    want_prompts, want_tokens = [], []
    with jax.enable_x64(False):
        jp = jax.tree.map(jnp.asarray, params)
        prefill = jax.jit(jS.make_prefill_step(cfg, compute_dtype=jnp.float32,
                                               cache_len=p_len + g_len))
        decode = jax.jit(jS.make_decode_step(cfg, compute_dtype=jnp.float32))
        served = 0
        while served < n_req:
            n = min(b, n_req - served)
            real = rng.integers(0, cfg.vocab_size, (n, p_len))
            lg, cache = prefill(jp, {"tokens": jnp.asarray(jserve._pad_slots(real, b),
                                                           jnp.int32)})
            tok = jS.sample_logits(lg, None, 0.0, cfg.vocab_size)
            outs, pos = [tok], jnp.full((b,), p_len, jnp.int32)
            for _ in range(g_len - 1):
                lg, cache = decode(jp, tok, cache, pos)
                tok = jS.sample_logits(lg, None, 0.0, cfg.vocab_size)
                outs.append(tok)
                pos = pos + 1
            want_prompts.append(real)
            want_tokens.append(np.asarray(jnp.concatenate(outs, axis=1))[:n])
            served += n
    np.testing.assert_array_equal(prompts, np.concatenate(want_prompts))
    np.testing.assert_array_equal(tokens, np.concatenate(want_tokens))


def test_serve_cli_mesh_raises():
    """A data axis that does not divide the slots raises before any rank
    starts (``tests/test_torch_mesh.py`` serves on a mesh)."""
    with pytest.raises(ValueError, match="does not divide the 4 slots"):
        tserve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--mesh", "3x1",
                     "--batch", "4"])
