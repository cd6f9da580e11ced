"""Tensor-parallel dense layers on the CPU: one gloo world of 4 ranks
(``launch.mesh.spawn``, CPU tensors) holding the meshes (1, 4), (2, 2) and
(4, 1) over the axes ("data", "model"), each rank computing with its
blocks of ``held(param_specs)`` (the reference's layout), against one
rank's computation on the same weights.

Configs (SMOKE): qwen1.5-0.5b (q/k/v biases), gemma-7b (tied head,
geglu), command-r-plus-104b (8 q / 2 kv heads: the kv projections fall
back to ``d_model`` at ``model = 4``), ``q6`` (qwen with 6 heads of 6 kv:
q, k, v and wo fall back at ``model = 4``), hymba-1.5b (context-parallel
attention), mamba2-1.3b and qwen2-moe-a2.7b (expert parallelism and the
shared MLP).

Every rank draws the weights with ``transformer.init`` on its own mesh
(its blocks of the draws one rank makes on the padded tree); the parent
draws the whole padded tree with the same seed and computes the single
rank's results with the port (no mesh): the loss and gradients of the
global batch (each data shard on its own and averaged, which is the
global mean for every family but the MoE, whose meshed routing at
``model > 1`` takes each data shard's capacity, as in the reference), two
AdamW steps, a prefill and three decode steps. Tolerance: float32,
``8·√k·eps·max|ref|`` per leaf or tensor, ``k`` the longest contraction
(``d_ff``, the padded vocab, the global batch's tokens).

The repairs: a batch-1 meshed train step (mamba2, hymba; the sequence
sharded over data), batch-1 decodes with caches whole over data and, at
(1, 4) with a length the ``model`` axis does not divide, whole over
``model``; the MoE at (4, 1) routed over the global batch against the
reference's no-mesh ``moe_layer`` on the global batch, where capacity
binds (the per-shard routing drops other tokens).
"""

from __future__ import annotations

import dataclasses
import pickle
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import AbstractMesh

SEED = 26
WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
AXES = ("data", "model")
SPAWN_TIMEOUT_S = 300.0
B, S = 4, 16                    # the train batch
SP, STEPS = 12, 3               # the prefill's length, then decode steps
CASES = ("qwen1.5-0.5b", "gemma-7b", "command-r-plus-104b", "q6", "hymba-1.5b",
         "mamba2-1.3b", "qwen2-moe-a2.7b")
TP_MESHES = ("1x4", "2x2")
EPS32 = float(np.finfo(np.float32).eps)
# C6: one sequence of 32, sharded over data; caches of odd lengths
B1_SEQ = 32
B1_ARCHS = ("mamba2-1.3b", "hymba-1.5b")
B1_DECODE = {("qwen1.5-0.5b", "1x4"): 18, ("hymba-1.5b", "1x4"): 18,
             ("mamba2-1.3b", "2x2"): 17, ("qwen1.5-0.5b", "2x2"): 17}
# C7: 16 sequences of 8 over four data ranks
MOE_B, MOE_S = 16, 8


def _cfg(name, lib="repro_torch"):
    import importlib

    reg = importlib.import_module(f"{lib}.configs.registry")
    if name == "q6":
        return dataclasses.replace(reg.get_smoke("qwen1.5-0.5b"), d_model=96, num_heads=6,
                                   num_kv_heads=6)
    if name == "moe-tight":
        # capacity that binds: a quarter of the tokens' top-k slots an expert
        cfg = reg.get_smoke("qwen2-moe-a2.7b")
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    cfg = reg.get_smoke(name)
    if name == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, cp_attention=True)
    return cfg


def _run(cfg):
    from repro_torch.configs import base

    return base.RunConfig(model=cfg, shape=base.ShapeConfig("tp", S, B, "train"),
                          compute_dtype="float32", remat="none",
                          optimizer=base.OptimizerConfig(name="adamw"))


def _tokens(cfg, rng, b, s):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _inputs(name, mesh_name):
    rng = np.random.default_rng([SEED, CASES.index(name) if name in CASES else 9,
                                 list(MESHES).index(mesh_name)])
    cfg = _cfg(name)
    toks = _tokens(cfg, rng, B, S + 1)
    prompt = _tokens(cfg, rng, B, SP)
    nxt = [_tokens(cfg, rng, B, 1) for _ in range(STEPS)]
    return dict(batch={"tokens": toks[:, :-1], "labels": toks[:, 1:]}, prompt=prompt, next=nxt)


def _np(x):
    return x.detach().cpu().numpy()


def _flat(tree):
    from repro_torch.optim._tree import tree_flatten_with_path

    return [(k, _np(v)) for k, v in tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# the rank bodies
# ---------------------------------------------------------------------------


def _mesh_train(cfg, mesh, batch, steps=2):
    """The meshed loss, gradients (averaged over data, gathered) and
    parameters after ``steps`` AdamW steps, from the rank's own init."""
    from repro_torch.launch import collectives as C
    from repro_torch.models import transformer as T
    from repro_torch.optim._tree import tree_map
    from repro_torch.parallel.sharding import (batch_input_specs, gather_tree, held,
                                               local_block, param_specs)
    from repro_torch.train.train_step import (init_state, loss_and_grads, make_loss_fn,
                                              make_train_step)

    run = _run(cfg)
    params = T.init(torch.Generator().manual_seed(SEED), cfg, mesh, device="cpu")
    specs = held(param_specs(mesh, cfg), cfg, mesh)
    d = mesh.shape["data"]
    whole = {k: torch.as_tensor(v) for k, v in batch.items()}
    where = batch_input_specs(mesh, whole)
    block = {k: local_block(x, mesh, where[k]) for k, x in whole.items()}
    seq = ("data",) if d > 1 and where["tokens"][0] is None else None
    m, g = loss_and_grads(make_loss_fn(cfg, mesh, run, seq_axes=seq), params, block)
    g = tree_map(lambda x: C.all_reduce(x, mesh.group("data")) / d, g)
    out = dict(grads=_flat(gather_tree(g, mesh, specs)),
               bytes=sum(x.numel() * x.element_size() for _, x in _flat_t(params)),
               blocks=[(k, tuple(x.shape)) for k, x in _flat_t(params)],
               init=_flat(gather_tree(params, mesh, specs)))
    step, opt = make_train_step(cfg, mesh, run, total_steps=50)
    state = init_state(cfg, mesh, run, opt, params)
    losses = []
    for _ in range(steps):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    out.update(losses=losses, params=_flat(gather_tree(state["params"], mesh, specs)))
    return out


def _flat_t(tree):
    from repro_torch.optim._tree import tree_flatten_with_path

    return tree_flatten_with_path(tree)[0]


def _mesh_serve(cfg, mesh, prompt, nxt, cache_len, rows=True):
    """The meshed prefill and decode steps' logits (the rank's rows
    gathered over data; whole rows where the batch is whole)."""
    from repro_torch.launch.collectives import all_gather_dim
    from repro_torch.models import transformer as T
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    params = T.init(torch.Generator().manual_seed(SEED), cfg, mesh, device="cpu")
    d = mesh.shape["data"]
    b = prompt.shape[0]
    sl = (slice(mesh.axis_index("data") * (b // d), (mesh.axis_index("data") + 1) * (b // d))
          if rows else slice(None))
    prefill = make_prefill_step(cfg, mesh, torch.float32, cache_len=cache_len)
    decode = make_decode_step(cfg, mesh, torch.float32, sp_decode=True, cache_len=cache_len)
    lg, cache = prefill(params, {"tokens": torch.as_tensor(prompt)[sl]})
    outs = [lg]
    for i, t in enumerate(nxt):
        pos = torch.full((outs[0].shape[0],), prompt.shape[1] + i, dtype=torch.int32)
        lg, cache = decode(params, torch.as_tensor(t)[sl], cache, pos)
        outs.append(lg)
    out = torch.cat(outs, 1)
    if rows and d > 1:
        out = all_gather_dim(out, mesh, "data", 0)
    return _np(out)


def _case_tp(meshes, inp):
    out = {}
    for name in CASES:
        cfg = _cfg(name)
        for mesh_name in TP_MESHES:
            mesh = meshes[mesh_name]
            x = inp["tp"][(name, mesh_name)]
            res = _mesh_train(cfg, mesh, x["batch"])
            res["serve"] = _mesh_serve(cfg, mesh, x["prompt"], x["next"], SP + STEPS)
            out[(name, mesh_name)] = res
    return out


def _case_b1(meshes, inp):
    out = {}
    for name in B1_ARCHS:
        cfg = _cfg(name)
        batch = inp["b1"]["train"][name]
        out[("train", name)] = _mesh_train(cfg, meshes["2x2"], batch, steps=1)
    for (name, mesh_name), cache_len in B1_DECODE.items():
        cfg = _cfg(name)
        x = inp["b1"]["decode"][(name, mesh_name)]
        out[("decode", name, mesh_name)] = _mesh_serve(cfg, meshes[mesh_name], x["prompt"],
                                                       x["next"], cache_len, rows=False)
    return out


def _case_moe(meshes, inp):
    from repro_torch.launch.collectives import all_gather_dim
    from repro_torch.models import moe as MOE

    cfg = _cfg("moe-tight")
    mesh = meshes["4x1"]
    p = {k: torch.as_tensor(v) for k, v in inp["moe"]["p"].items()}
    x = torch.as_tensor(inp["moe"]["x"])
    n = MOE_B // 4
    mine = x[mesh.axis_index("data") * n:(mesh.axis_index("data") + 1) * n]
    y, aux = MOE.moe_layer(p, mine, cfg, mesh)
    return dict(y=_np(all_gather_dim(y, mesh, "data", 0)), aux=float(aux))


def _rank(rank: int, world: int, path: str) -> dict:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh

    with open(path, "rb") as f:
        inp = pickle.load(f)
    meshes = {name: make_mesh(shape, AXES, backend="gloo", device="cpu")
              for name, shape in MESHES.items()}
    out = {"tp": _case_tp(meshes, inp), "b1": _case_b1(meshes, inp),
           "moe": _case_moe(meshes, inp)}
    out["_jax_loaded"] = "jax" in sys.modules or "repro" in sys.modules
    return out


# ---------------------------------------------------------------------------
# the parent: one rank's results with the port, the reference's for C7
# ---------------------------------------------------------------------------


def _one_rank_train(cfg, mesh_shape, batch, steps=2):
    """One rank, no mesh, on the padded weights: each data shard's loss and
    gradients averaged (the global batch's for every family but the MoE),
    then ``steps`` AdamW steps."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import apply_updates
    from repro_torch.optim._tree import tree_map
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.train.train_step import loss_and_grads, make_loss_fn, make_train_step

    run = _run(cfg)
    params = T.init(torch.Generator().manual_seed(SEED), cfg,
                    AbstractMesh(mesh_shape, AXES), device="cpu")
    d = mesh_shape[0]
    b = batch["tokens"].shape[0]
    shards = [{k: torch.as_tensor(v)[i * (b // d):(i + 1) * (b // d)] for k, v in batch.items()}
              for i in range(d)] if b % d == 0 else [{k: torch.as_tensor(v)
                                                       for k, v in batch.items()}]
    loss_fn = make_loss_fn(cfg, None, run)

    def grads(p):
        parts = [loss_and_grads(loss_fn, p, s) for s in shards]
        g = tree_map(lambda *x: sum(x) / len(x), *[g for _, g in parts])
        return float(sum(m["loss"] for m, _ in parts) / len(parts)), g

    _, opt = make_train_step(cfg, None, run, total_steps=50)
    state = opt.init(params)
    init = _flat(params)
    loss0, g0 = grads(params)
    losses = []
    for i in range(steps):
        loss, g = (loss0, g0) if i == 0 else grads(params)
        g, gn = clip_by_global_norm(g, 1.0)
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
        losses.append((loss, float(gn)))
    return dict(grads=_flat(g0), losses=losses, params=_flat(params), init=init,
                bytes=sum(x.nbytes for _, x in init))


def _one_rank_serve(cfg, mesh_shape, prompt, nxt, cache_len, per_shard):
    from repro_torch.models import transformer as T
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    params = T.init(torch.Generator().manual_seed(SEED), cfg,
                    AbstractMesh(mesh_shape, AXES), device="cpu")
    d = mesh_shape[0] if per_shard else 1
    b = prompt.shape[0]
    outs = []
    for i in range(d):
        sl = slice(i * (b // d), (i + 1) * (b // d))
        prefill = make_prefill_step(cfg, None, torch.float32, cache_len=cache_len)
        decode = make_decode_step(cfg, None, torch.float32)
        lg, cache = prefill(params, {"tokens": torch.as_tensor(prompt)[sl]})
        steps = [lg]
        for j, t in enumerate(nxt):
            pos = torch.full((lg.shape[0],), prompt.shape[1] + j, dtype=torch.int32)
            lg, cache = decode(params, torch.as_tensor(t)[sl], cache, pos)
            steps.append(lg)
        outs.append(torch.cat(steps, 1))
    return _np(torch.cat(outs, 0))


def _ref_moe():
    """C7's inputs and the reference's no-mesh MoE on the global batch and
    on each of four shards (JAX)."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jM
    from repro.models import transformer as jT

    cfg = _cfg("moe-tight", "repro")
    with jax.enable_x64(False):
        tree = jax.jit(lambda k: jT.init(k, cfg, None))(jax.random.key(SEED))
        p = {k: np.asarray(v[0]) for k, v in tree["layers"]["moe"].items() if k != "norm"}
        rng = np.random.default_rng(SEED + 7)
        x = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
        y, aux = jM.moe_layer(p, jnp.asarray(x), cfg, None)
        shards = [jM.moe_layer(p, jnp.asarray(xs), cfg, None) for xs in np.split(x, 4)]
    return dict(p=p, x=x), dict(y=np.asarray(y), aux=float(aux),
                                y_shards=np.concatenate([np.asarray(a) for a, _ in shards]),
                                aux_shards=float(np.mean([float(b) for _, b in shards])))


def _refs():
    inp = {"tp": {}, "b1": {"train": {}, "decode": {}}}
    ref = {"tp": {}, "b1": {}}
    for name in CASES:
        cfg = _cfg(name)
        for mesh_name in TP_MESHES:
            x = _inputs(name, mesh_name)
            inp["tp"][(name, mesh_name)] = x
            shape = MESHES[mesh_name]
            r = _one_rank_train(cfg, shape, x["batch"])
            r["serve"] = _one_rank_serve(cfg, shape, x["prompt"], x["next"], SP + STEPS,
                                         per_shard=cfg.moe is not None)
            ref["tp"][(name, mesh_name)] = r
    rng = np.random.default_rng(SEED + 3)
    for name in B1_ARCHS:
        cfg = _cfg(name)
        toks = _tokens(cfg, rng, 1, B1_SEQ + 1)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        inp["b1"]["train"][name] = batch
        ref["b1"][("train", name)] = _one_rank_train(cfg, MESHES["2x2"], batch, steps=1)
    for (name, mesh_name), cache_len in B1_DECODE.items():
        cfg = _cfg(name)
        prompt = _tokens(cfg, rng, 1, cache_len - STEPS)
        nxt = [_tokens(cfg, rng, 1, 1) for _ in range(STEPS)]
        inp["b1"]["decode"][(name, mesh_name)] = dict(prompt=prompt, next=nxt)
        ref["b1"][("decode", name, mesh_name)] = _one_rank_serve(
            cfg, MESHES[mesh_name], prompt, nxt, cache_len, per_shard=False)
    inp["moe"], ref["moe"] = _ref_moe()
    return inp, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inp, ref = _refs()
    path = str(tmp / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    ranks = tmesh.spawn(_rank, WORLD, backend="gloo", timeout_s=SPAWN_TIMEOUT_S, args=(path,))
    return dict(ranks=ranks, ref=ref)


def _k(cfg, tokens: int) -> int:
    from repro_torch.models.transformer import padded_vocab

    return max(cfg.d_model, cfg.d_ff or 0, tokens,
               padded_vocab(cfg, AbstractMesh((1, 4), AXES)) * max(cfg.num_codebooks, 1))


def _tol(k: int, ref) -> float:
    return 8 * np.sqrt(k) * EPS32 * max(float(np.abs(ref).max()), 1e-30)


def _close(got, want, k, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= _tol(k, want), (what, err, _tol(k, want))


def _params_close(got, want, k):
    """The parameters after the AdamW steps: within the tolerance of the
    leaf's largest entry, or, for the leaves whose entries are all of the
    steps' size (the zero-initialized norms and biases, where Adam's
    ``g / (|g| + eps)`` turns the gradients' rounding near ``eps`` into
    steps of the step size's order), their update within the normwise
    bound of ``tests/test_torch_mesh.py`` (1e-3; 1e-2 for the key bias,
    whose gradient is zero in exact arithmetic)."""
    for (key, a), (_, b), (_, b0) in zip(got["params"], want["params"], want["init"]):
        err = float(np.abs(np.float64(a) - b).max())
        if err <= _tol(k, b):
            continue
        upd = np.linalg.norm(np.float64(a) - b) / max(np.linalg.norm(np.float64(b) - b0), 1e-30)
        assert not np.abs(b0).any(), (key, err, _tol(k, b))
        assert upd <= (1e-2 if key.endswith("['bk']") else 1e-3), (key, upd)


def test_ranks_never_load_jax(world):
    assert not any(r["_jax_loaded"] for r in world["ranks"])


@pytest.mark.parametrize("mesh_name", TP_MESHES)
@pytest.mark.parametrize("name", CASES)
def test_train_matches_one_rank(world, name, mesh_name):
    """Loss, gradients and two AdamW steps of the tensor-parallel blocks
    against one rank's on the same weights."""
    got = world["ranks"][0]["tp"][(name, mesh_name)]
    want = world["ref"]["tp"][(name, mesh_name)]
    k = _k(_cfg(name), B * S)
    assert [a for a, _ in got["init"]] == [a for a, _ in want["init"]]
    for (key, a), (_, b) in zip(got["init"], want["init"]):
        np.testing.assert_array_equal(a, b, err_msg=f"init {key}")
    for (key, a), (_, b) in zip(got["grads"], want["grads"]):
        _close(a, b, k, f"grad {key}")
    for (l1, g1), (l2, g2) in zip(got["losses"], want["losses"]):
        assert abs(l1 - l2) <= _tol(k, l2), (l1, l2)
        assert abs(g1 - g2) <= _tol(k, g2), (g1, g2)
    _params_close(got, want, k)
    for r in world["ranks"][1:]:
        assert r["tp"][(name, mesh_name)]["losses"] == got["losses"]


@pytest.mark.parametrize("mesh_name", TP_MESHES)
@pytest.mark.parametrize("name", CASES)
def test_prefill_and_decode_match_one_rank(world, name, mesh_name):
    got = world["ranks"][0]["tp"][(name, mesh_name)]["serve"]
    want = world["ref"]["tp"][(name, mesh_name)]["serve"]
    assert got.shape[1] == STEPS + 1
    _close(got, want, _k(_cfg(name), SP + STEPS), "prefill/decode logits")
    for r in world["ranks"][1:]:
        np.testing.assert_array_equal(r["tp"][(name, mesh_name)]["serve"], got)


@pytest.mark.parametrize("mesh_name", TP_MESHES)
@pytest.mark.parametrize("name", CASES)
def test_block_bytes(world, name, mesh_name):
    """Each rank's blocks are its share of ``global_shape``: the gathered
    blocks are the single rank's tree, and every split leaf is a 1/M (or
    1/D) block."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import held, param_specs, spec_leaves

    cfg = _cfg(name)
    mesh = AbstractMesh(MESHES[mesh_name], AXES)
    whole = [(k, tuple(x.shape)) for k, x in
             _flat_t(T.init(None, cfg, mesh, device="meta"))]
    specs = spec_leaves(held(param_specs(mesh, cfg), cfg, mesh))
    for r in world["ranks"]:
        blocks = r["tp"][(name, mesh_name)]["blocks"]
        assert [k for k, _ in blocks] == [k for k, _ in whole]
        for (key, blk), (_, full), spec in zip(blocks, whole, specs):
            want = list(full)
            for d, axes in enumerate(spec):
                if axes is not None:
                    want[d] //= mesh.axis_size(axes)
            assert tuple(blk) == tuple(want), key
    m = MESHES[mesh_name][1]
    one = world["ref"]["tp"][(name, mesh_name)]["bytes"]
    assert world["ranks"][0]["tp"][(name, mesh_name)]["bytes"] < one
    if name == "qwen1.5-0.5b":
        assert world["ranks"][0]["tp"][(name, mesh_name)]["bytes"] <= one / m + one * 0.01


@pytest.mark.parametrize("name", B1_ARCHS)
def test_batch1_train_step_at_2x2(world, name):
    """C6: one sequence, sharded over the data axes, at (2, 2)."""
    got = world["ranks"][0]["b1"][("train", name)]
    want = world["ref"]["b1"][("train", name)]
    k = _k(_cfg(name), B1_SEQ)
    for (key, a), (_, b) in zip(got["grads"], want["grads"]):
        _close(a, b, k, f"grad {key}")
    (l1, g1), = got["losses"]
    (l2, g2), = want["losses"]
    assert abs(l1 - l2) <= _tol(k, l2) and abs(g1 - g2) <= _tol(k, g2)
    _params_close(got, want, k)


@pytest.mark.parametrize("name,mesh_name", sorted(B1_DECODE))
def test_batch1_decode(world, name, mesh_name):
    """C6: a batch of one, whole on every data rank; at (1, 4) a cache
    length the model axis does not divide, whole on every rank."""
    got = world["ranks"][0]["b1"][("decode", name, mesh_name)]
    want = world["ref"]["b1"][("decode", name, mesh_name)]
    _close(got, want, _k(_cfg(name), B1_DECODE[(name, mesh_name)]), "logits")


def test_moe_global_routing_at_4x1(world):
    """C7: at (4, 1) the MoE routes the global batch with one capacity, as
    the reference's no-mesh path: outputs and aux equal it, where the
    per-shard routing (the old rule) drops other tokens."""
    got = world["ranks"][0]["moe"]
    want = world["ref"]["moe"]
    # capacity binds: routing each shard alone gives another result
    assert float(np.abs(want["y_shards"] - want["y"]).max()) > 1e-3
    k = _cfg("moe-tight").d_model
    _close(got["y"], want["y"], k, "y")
    assert abs(got["aux"] - want["aux"]) <= _tol(k, want["aux"])
    for r in world["ranks"][1:]:
        assert r["moe"]["aux"] == got["aux"]


# ---------------------------------------------------------------------------
# the held specs, with no process group
# ---------------------------------------------------------------------------

ALL = sorted(__import__("repro_torch.configs.registry", fromlist=["ARCHS"]).ARCHS)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (16, 16)], ids=["1x4", "2x2", "16x16"])
@pytest.mark.parametrize("arch", ALL)
def test_held_specs_are_the_reference_param_specs(arch, mesh_shape):
    """Every leaf's held spec is the reference's ``param_specs`` entry for
    entry where the model axis divides the leaf's dim (every leaf of the
    registry's configs, full and SMOKE, on these meshes)."""
    import jax
    from jax.sharding import PartitionSpec

    from repro.configs.registry import get_config as jget, get_smoke as jsmoke
    from repro.parallel import sharding as jsh

    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.parallel.sharding import held, param_specs, spec_leaves

    mesh = AbstractMesh(mesh_shape, AXES)
    for jcfg, cfg in ((jget(arch), get_config(arch)), (jsmoke(arch), get_smoke(arch))):
        want = [tuple(s) for s in jax.tree.leaves(jsh.param_specs(mesh, jcfg),
                                                  is_leaf=lambda x: isinstance(x, PartitionSpec))]
        got = [tuple(s) for s in spec_leaves(held(param_specs(mesh, cfg), cfg, mesh))]
        assert got == want


def test_held_whole_where_the_axis_does_not_divide():
    """A leaf whose dim the model axis does not divide is held whole: the
    MLP of a d_ff of 100 at model = 8 keeps only its other entries."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.parallel.sharding import P, held, param_specs

    cfg = dataclasses.replace(get_smoke("qwen1.5-0.5b"), d_ff=100)
    mesh = AbstractMesh((1, 8), AXES)
    specs = param_specs(mesh, cfg)
    h = held(specs, cfg, mesh)
    assert specs["layers"]["mlp"]["wg"] == P(None, None, "model")
    assert h["layers"]["mlp"]["wg"] == P(None, None, None)
    assert h["layers"]["mlp"]["wd"] == P(None, None, None)
    assert h["layers"]["attn"]["wq"] == specs["layers"]["attn"]["wq"]
    assert h["embed"] == P("model", None)


def test_qwen_parameter_bytes_a_rank_at_1x4():
    """qwen1.5-0.5b at full width: a rank's parameter bytes at (1, 4) are
    at most 0.27 of one rank's."""
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import held, param_specs, spec_leaves

    cfg = get_config("qwen1.5-0.5b")
    mesh = AbstractMesh((1, 4), AXES)
    leaves = [x for _, x in _flat_t(T.init(None, cfg, mesh, device="meta"))]
    specs = spec_leaves(held(param_specs(mesh, cfg), cfg, mesh))
    one = sum(x.numel() for _, x in _flat_t(T.init(None, cfg, device="meta")))
    mine = sum(x.numel() // math.prod(mesh.axis_size(a) for a in s if a is not None)
               for x, s in zip(leaves, specs))
    assert mine <= 0.27 * one, mine / one
