"""The port's mesh paths on the CPU: one gloo world of 4 ranks
(``launch.mesh.spawn``, CPU tensors) holding the meshes (2, 2), (1, 4) and
(4, 1) over the axes ("data", "model"), against the reference's no-mesh
functions on the same numpy inputs.

The world starts once for the module; every rank runs every case and the
parent holds rank 0's results (gathered to full arrays on the ranks)
against the reference. The rank bodies live at module level and this
module imports JAX and ``repro`` only inside the parent's functions, so
the ranks never load them (each rank reports whether it did). Weights
cross from the reference through ``convert.params_from_reference`` and
``runtime.elastic.reshard_tree``.

Tolerances:

* context-parallel attention and sequence-parallel decode against
  ``attention_train``/``attention_decode``: ``2e-4`` absolute (the
  reference's own band for its sequence-parallel tests); the caches (the
  prefill's k/v, the decode's written slot) ``1e-5``; the gradients of the
  context-parallel attention (the sum of its output against a seeded
  cotangent) ``2e-4`` relative to each gradient's largest entry;
* the hybrid model's ``forward_train`` (context-parallel attention, the
  split SSD) and its prefill then two decode steps: ``5e-3`` absolute on
  the logits;
* the MoE (expert parallelism, and the TP fallback) against the
  reference's no-mesh ``moe_layer`` on the padded weights applied to each
  data shard (each shard routes with its own capacity): ``2e-5`` absolute
  on the output and ``aux``, gradients ``1e-4`` relative to their largest
  entry;
* the tensor-parallel SSD against the port's unsplit SSD on the same
  rank: its state and conv tail bitwise, its output (the ranks' partial
  ``out_proj`` products summed) within ``8·√k·eps·max|y|``;
* the train step at (2, 2) against the reference's
  ``make_train_step(mesh=None)`` on the padded weights and the global
  batch: loss and grad norm relative ``1e-5``, each parameter's update
  normwise relative ``1e-3`` (``tests/test_torch_train.py``'s bounds),
  except the key bias ``bk``: its gradient is zero in exact arithmetic (it
  adds the same ``q·b`` to every score of a query), so in float32 it is
  rounding noise, which the data-parallel mean rounds differently, and
  Adam's first step ``g/(|g| + ε)`` turns the noise near ``ε`` into
  updates of order the step size; it is held to ``1e-2``;
* the ZeRO-1 AdamW update and Shampoo's owned stats, factors and updates
  (p = 2, packed, a refresh at step 2): bitwise against the unsharded
  update on the same gradients, block for block;
* ``save`` on (2, 2) then ``restore_sharded`` on (4, 1): bitwise.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh

SEED = 24
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
SPAWN_TIMEOUT_S = 240.0
CP_TOL, CACHE_TOL, FWD_TOL = 2e-4, 1e-5, 5e-3
MOE_TOL, MOE_GRAD_REL = 2e-5, 1e-4
B, S = 2, 16                        # the CP attention's input
SP_B, SP_S = 4, 16                  # the SP decode's batch and cache length
HYB_B, HYB_S = 2, 48                # the hybrid's batch and prompt (> window 32)
MOE_B, MOE_S = 4, 8
AUX_COEF = 0.5                      # the aux term's weight in the MoE's objective
TRAIN_ARCHS = ("qwen1.5-0.5b", "hymba-1.5b")
OPT_BLOCK = 40                      # Shampoo's block: wq's 13 blocks do not split over 2


def _cfgs(arch, lib, **kw):
    """A SMOKE config of ``lib`` ("repro" or "repro_torch"), with the
    hybrid's context-parallel attention on."""
    import importlib

    reg = importlib.import_module(f"{lib}.configs.registry")
    cfg = reg.get_smoke(arch)
    if arch == "hymba-1.5b":
        kw = {"cp_attention": True, **kw}
    return dataclasses.replace(cfg, **kw)


def _moe_tp(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, sharding="tp"))


def _p_split(cfg):
    """The hybrid with 6 SSD heads: 4 ranks split P, not H."""
    return dataclasses.replace(cfg, d_model=48, num_heads=3, num_kv_heads=1)


# ---------------------------------------------------------------------------
# the rank bodies (run in the spawned processes)
# ---------------------------------------------------------------------------


def _t(x, grad=False):
    t = torch.as_tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _np(x):
    return x.detach().cpu().numpy()


def _dp(mesh):
    from repro_torch.parallel.sharding import P

    return P(("data",))


def _rows(x, mesh):
    """This rank's rows (dim 0 over data)."""
    from repro_torch.parallel.sharding import local_block

    return local_block(x, mesh, _dp(mesh))


def _all_rows(x, mesh):
    from repro_torch.launch.collectives import all_gather_dim

    return all_gather_dim(x.detach(), mesh, "data", 0)


def _data_sum(x, mesh):
    from repro_torch.launch import collectives as C

    return C.all_reduce(x.detach(), mesh.group("data"))


def _layer_specs(cfg, mesh, part):
    """The held specs of one layer's ``part`` (``"attn"``, ``"ssm"``,
    ``"moe"``): a scanned stack's specs without their layer dim."""
    from repro_torch.parallel.sharding import P, held, param_specs

    specs = held(param_specs(mesh, cfg), cfg, mesh)["layers"][part]
    return {k: P(*s[1:]) for k, s in specs.items()}


def _block_of(p, specs, mesh, grad=False):
    """This rank's blocks of a layer's whole weights under ``specs``."""
    from repro_torch.parallel.sharding import local_block

    return {k: (local_block(_t(v), mesh, specs[k]).clone().requires_grad_(True) if grad
                else local_block(_t(v), mesh, specs[k]).clone()) for k, v in p.items()}


def _case_cp(meshes, inp):
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import gather

    cfg = _cfgs("hymba-1.5b", "repro_torch")
    out = {}
    for name in ("2x2", "1x4"):
        mesh = meshes[name]
        specs = _layer_specs(cfg, mesh, "attn")
        for w in (None, 8):
            p = _block_of(inp["cp"]["p"], specs, mesh, grad=True)
            x = _rows(_t(inp["cp"]["x"]), mesh).clone().requires_grad_(True)
            y, (k, v) = L.attention_train_cp(p, x, cfg, mesh, window=w, return_kv=True)
            loss = (y * _rows(_t(inp["cp"]["r"]), mesh)).sum()
            grads = torch.autograd.grad(loss, [*p.values(), x])
            out[(name, w)] = dict(
                y=_np(_all_rows(y, mesh)), k=_np(_all_rows(k, mesh)), v=_np(_all_rows(v, mesh)),
                grads={key: _np(gather(_data_sum(g, mesh), mesh, specs[key]))
                       for key, g in zip(p, grads)},
                gx=_np(_all_rows(grads[-1], mesh)))
    return out


def _case_sp(meshes, inp):
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import P, gather, local_block

    cfg = _cfgs("command-r-plus-104b", "repro_torch")
    out = {}
    for name in ("2x2", "1x4"):
        mesh = meshes[name]
        spec = P("data", "model")
        for wcase, (w, pos) in inp["sp"]["cases"].items():
            p = _block_of(inp["sp"]["p"], _layer_specs(cfg, mesh, "attn"), mesh)
            ck = local_block(_t(inp["sp"]["ck"]), mesh, spec).clone()
            cv = local_block(_t(inp["sp"]["cv"]), mesh, spec).clone()
            y, ck, cv = L.attention_decode_sp(p, _rows(_t(inp["sp"]["x"]), mesh), cfg, ck, cv,
                                              _rows(_t(pos), mesh), mesh, window=w)
            out[(name, wcase)] = dict(y=_np(_all_rows(y, mesh)), ck=_np(gather(ck, mesh, spec)),
                                      cv=_np(gather(cv, mesh, spec)))
    return out


def _held_params(cfg, tree, mesh):
    from repro_torch.convert import params_from_reference
    from repro_torch.parallel.sharding import held, param_specs
    from repro_torch.runtime.elastic import reshard_tree

    full = params_from_reference(cfg, tree, device="cpu", mesh=mesh)
    return reshard_tree(full, mesh, held(param_specs(mesh, cfg), cfg, mesh))


def _case_hybrid(meshes, inp):
    from repro_torch.models import transformer as T
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    cfg = _cfgs("hymba-1.5b", "repro_torch")
    mesh = meshes["2x2"]
    params = _held_params(cfg, inp["hybrid"]["params"], mesh)
    toks = _rows(_t(inp["hybrid"]["tokens"]), mesh)
    with torch.no_grad():
        logits, _ = T.forward_train(params, {"tokens": toks}, cfg, mesh,
                                    compute_dtype=torch.float32)
    # the rank's vocab block of the logits, gathered
    logits = T.gather_vocab(logits, cfg, mesh, T.padded_vocab(cfg, mesh))
    prefill = make_prefill_step(cfg, mesh, torch.float32, cache_len=HYB_S + 4)
    decode = make_decode_step(cfg, mesh, torch.float32, sp_decode=True)
    lg, cache = prefill(params, {"tokens": toks})
    steps = [_np(_all_rows(lg, mesh))]
    for i, nxt in enumerate(inp["hybrid"]["next"]):
        pos = torch.full((toks.shape[0],), HYB_S + i, dtype=torch.int32)
        lg, cache = decode(params, _rows(_t(nxt), mesh), cache, pos)
        steps.append(_np(_all_rows(lg, mesh)))
    return dict(logits=_np(_all_rows(logits, mesh)), steps=steps)


def _case_ssd(meshes, inp):
    from repro_torch.models import ssm as SSM
    from repro_torch.parallel.sharding import local_block

    out = {}
    for name, cfg in (("2x2", _cfgs("hymba-1.5b", "repro_torch")),
                      ("1x4", _p_split(_cfgs("hymba-1.5b", "repro_torch")))):
        mesh = meshes[name]
        gen = torch.Generator().manual_seed(SEED)
        p = SSM.init_ssm(gen, cfg, device="cpu")
        x = torch.randn((2, 40, cfg.d_model), generator=gen)
        y1, (h1, c1) = SSM.ssm_train(p, x, cfg, return_state=True)
        specs = _layer_specs(cfg, mesh, "ssm")
        mine = {k: local_block(v, mesh, specs[k]).clone() for k, v in p.items()}
        y2, (h2, c2) = SSM.ssm_train(mine, x, cfg, return_state=True, mesh=mesh)
        dim, m = SSM._split(cfg, mesh)
        j = mesh.axis_index("model")
        n, nc = h1.shape[dim] // m, c1.shape[-1] // m
        out[name] = dict(split="heads" if dim == 1 else "p",
                         y=bool(torch.equal(y1, y2)),
                         h=bool(torch.equal(h1.narrow(dim, j * n, n), h2)),
                         conv=bool(torch.equal(c1[..., j * nc:(j + 1) * nc], c2)),
                         y_max_diff=float((y1 - y2).abs().max()),
                         h_max_diff=float((h1.narrow(dim, j * n, n) - h2).abs().max()),
                         y_max=float(y1.abs().max()), h_max=float(h1.abs().max()))
    return out


def _case_moe(meshes, inp):
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import P, gather, local_block

    out = {}
    for name, tp in (("2x2", False), ("1x4", False), ("2x2", True)):
        mesh = meshes[name]
        cfg = _cfgs("qwen2-moe-a2.7b", "repro_torch")
        cfg = _moe_tp(cfg) if tp else cfg
        key = (name, "tp" if tp else "ep")
        full = {k: _t(v) for k, v in inp["moe"][key]["p"].items()}
        especs = ({k: P("model") for k in ("wg", "wu", "wd")} if not tp else
                  {"wg": P(None, None, "model"), "wu": P(None, None, "model"),
                   "wd": P(None, "model")})
        p = {k: (local_block(v, mesh, especs[k]) if k in especs else v)
             .clone().requires_grad_(True) for k, v in full.items()}
        x = _rows(_t(inp["moe"][key]["x"]), mesh).clone().requires_grad_(True)
        y, aux = MOE.moe_layer(p, x, cfg, mesh)
        d = mesh.shape["data"]
        # each data rank's loss is a term of the objective, its gradients
        # averaged over the data ranks (as the train step does)
        loss = (y * _rows(_t(inp["moe"][key]["r"]), mesh)).sum() + AUX_COEF * aux
        grads = torch.autograd.grad(loss, [*p.values(), x])
        g = {k: gather(_data_sum(gr, mesh) / d, mesh, especs.get(k, P()))
             for k, gr in zip(p, grads)}
        out[key] = dict(
            y=_np(_all_rows(y, mesh)), aux=float(aux), grads={k: _np(v) for k, v in g.items()},
            gx=_np(_all_rows(grads[-1], mesh) / d), local_experts=int(p["wg"].shape[0]))
    return out


def _port_run(cfg, opt_name="adamw"):
    from repro_torch.configs import base

    return base.RunConfig(model=cfg, shape=base.ShapeConfig("small", S, 4, "train"),
                          compute_dtype="float32", remat="none",
                          optimizer=base.OptimizerConfig(name=opt_name))


def _case_train(meshes, inp, ckpt_dir):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel.sharding import gather_tree, named
    from repro_torch.train.train_step import held_state_specs, init_state, make_train_step

    out = {}
    mesh = meshes["2x2"]
    for arch in TRAIN_ARCHS:
        cfg = _cfgs(arch, "repro_torch")
        run = _port_run(cfg)
        step, opt = make_train_step(cfg, mesh, run, total_steps=50)
        params = _held_params(cfg, inp["train"][arch]["params"], mesh)
        state = init_state(cfg, mesh, run, opt, params)
        batch = {k: _t(v) for k, v in inp["train"][arch]["batch"].items()}
        state, m = step(state, batch)
        specs = held_state_specs(cfg, mesh, run, opt, params)
        full = gather_tree(state["params"], mesh, specs["params"])
        out[arch] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         params=[(k, _np(v)) for k, v in _flat(full)])
        if arch != "qwen1.5-0.5b":
            continue
        # save on (2, 2), restore on (4, 1)
        ckpt = CheckpointManager(ckpt_dir)
        ckpt.save(1, state, shardings=named(mesh, specs))
        want = _flat(gather_tree(state, mesh, specs))
        mesh4 = meshes["4x1"]
        p4 = _held_params(cfg, inp["train"][arch]["params"], mesh4)
        like = init_state(cfg, mesh4, run, opt, p4)
        specs4 = held_state_specs(cfg, mesh4, run, opt, p4)
        restored, at = ckpt.restore_sharded(like, named(mesh4, specs4))
        got = _flat(gather_tree(restored, mesh4, specs4))
        out["restore"] = dict(
            step=at, n=len(want), keys=[k for k, _ in got] == [k for k, _ in want],
            bitwise=all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                        for (_, a), (_, b) in zip(got, want)),
            block=tuple(restored["opt"]["m"]["embed"].shape),
            full=tuple(gather_tree(state["params"], mesh, specs["params"])["embed"].shape))
    return out


def _flat(tree):
    from repro_torch.optim._tree import tree_flatten_with_path

    return [(k, getattr(v, "blocks", v)) for k, v in tree_flatten_with_path(tree)[0]]


def _case_optim(meshes, inp):
    """The ZeRO-1 AdamW update and Shampoo's owned blocks against the
    unsharded updates on the same gradients, bitwise."""
    from repro_torch.optim import build
    from repro_torch.optim.shampoo import shampoo
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.sharding import (gather_tree, held, local_block, param_specs,
                                               spec_leaves)
    from repro_torch.runtime.elastic import reshard_tree
    from repro_torch.train.train_step import held_state_specs

    cfg = _cfgs("qwen1.5-0.5b", "repro_torch")
    out = {}
    for name in ("2x2", "4x1"):
        mesh = meshes[name]
        for opt_name in ("adamw", "shampoo"):
            run = _port_run(cfg, opt_name)
            if opt_name == "adamw":
                opt = build(run.optimizer, 50)
            else:
                opt = shampoo(warmup_cosine(1e-3, 2, 50), block=OPT_BLOCK, update_every=2,
                              precond_p=2)
            blocks = _held_params(cfg, inp["train"]["qwen1.5-0.5b"]["params"], mesh)
            specs = held_state_specs(cfg, mesh, run, opt, blocks)["opt"]
            # the optimizer sees whole leaves (the train step gathers the
            # tensor-parallel blocks before the update)
            params = gather_tree(blocks, mesh, held(param_specs(mesh, cfg), cfg, mesh))
            s_full = opt.init(params)
            s_blk = reshard_tree(s_full, mesh, specs)
            m_specs = spec_leaves(specs["m"])
            rng = np.random.default_rng(SEED + 5)
            same, owned = [], {}
            for _ in range(2):
                g = _tree_like(params, rng)
                u_full, s_full = opt.update(g, s_full, params)
                if opt_name == "adamw":
                    cut = lambda t: _map2(lambda x, s: local_block(x, mesh, s), t, m_specs)
                    u_blk, s_blk = opt.update(cut(g), s_blk, cut(params))
                    u_specs = m_specs
                else:
                    u_blk, s_blk = opt.update(g, s_blk, params, mesh=mesh, specs=specs)
                    u_specs = _update_specs(params, specs)
                same += [torch.equal(local_block(a, mesh, s), b) for a, b, s in
                         zip(_leaves(u_full), _leaves(u_blk), u_specs)]
            want = _flat(s_full)
            got = _flat(s_blk)
            sp = spec_leaves(specs)
            bits = [torch.equal(local_block(a, mesh, s), b) if torch.is_tensor(a) else a == b
                    for (_, a), (_, b), s in zip(want, got, sp)]
            if opt_name == "shampoo":
                owned = {k: (int(b.shape[0]), int(a.shape[0])) for (k, a), (_, b) in
                         zip(want, got) if k.endswith("['l']")}
            out[(name, opt_name)] = dict(updates=all(same), n_updates=len(same),
                                         state=all(bits), n_state=len(bits), owned=owned)
    return out


def _tree_like(params, rng):
    from repro_torch.optim._tree import tree_map

    return tree_map(lambda p: torch.as_tensor(
        rng.standard_normal(tuple(p.shape)).astype(np.float32) * 1e-2), params)


def _leaves(tree):
    from repro_torch.optim._tree import tree_leaves

    return tree_leaves(tree)


def _map2(fn, tree, specs):
    from repro_torch.optim._tree import tree_flatten

    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([fn(x, s) for x, s in zip(leaves, specs)])


def _update_specs(params, specs):
    from repro_torch.optim._tree import tree_flatten
    from repro_torch.parallel.sharding import spec_leaves

    s_leaves = tree_flatten(params)[1].flatten_up_to(specs["shampoo"])
    return [s["mom"] if isinstance(s, dict) else m
            for s, m in zip(s_leaves, spec_leaves(specs["m"]))]


def _rank(rank: int, world: int, path: str, ckpt_dir: str) -> dict:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh

    with open(path, "rb") as f:
        inp = pickle.load(f)
    meshes = {name: make_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
              for name, shape in MESHES.items()}
    out = {}
    for case, fn in (("cp", _case_cp), ("sp", _case_sp), ("hybrid", _case_hybrid),
                     ("ssd", _case_ssd), ("moe", _case_moe), ("optim", _case_optim)):
        t0 = time.perf_counter()
        out[case] = fn(meshes, inp)
        out[case + "_s"] = time.perf_counter() - t0
    out["train"] = _case_train(meshes, inp, ckpt_dir)
    out["_jax_loaded"] = "jax" in sys.modules or "repro" in sys.modules
    return out


# ---------------------------------------------------------------------------
# the parent: inputs and references (JAX), one spawn, one test per case
# ---------------------------------------------------------------------------


def _ref_init(jcfg, mesh=None):
    import jax

    from repro.models import transformer as jT

    return jax.tree.map(np.asarray, jax.jit(lambda k: jT.init(k, jcfg, mesh))(
        jax.random.key(SEED)))


def _refs():
    """Inputs (numpy) and the reference's results."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import layers as jL
    from repro.models import moe as jM
    from repro.models import transformer as jT
    from repro.train import serve_step as jss
    from repro.train import train_step as jts

    rng = np.random.default_rng(SEED)
    f32 = np.float32
    inp, ref = {}, {}
    with jax.enable_x64(False):
        # context-parallel attention (hymba: 4 q / 2 kv heads)
        cfg = _cfgs("hymba-1.5b", "repro")
        p = {k: v[0] for k, v in _ref_init(cfg)["layers"]["attn"].items() if k != "norm"}
        x = rng.standard_normal((B, S, cfg.d_model)).astype(f32)
        r = rng.standard_normal((B, S, cfg.d_model)).astype(f32)
        inp["cp"] = dict(p=p, x=x, r=r)
        ref["cp"] = {}
        for w in (None, 8):
            y, (k, v) = jL.attention_train(p, jnp.asarray(x), cfg, window=w, return_kv=True)
            g = jax.grad(lambda p_, x_: jnp.sum(jL.attention_train(p_, x_, cfg, window=w) * r),
                         argnums=(0, 1))(p, jnp.asarray(x))
            ref["cp"][w] = dict(y=np.asarray(y), k=np.asarray(k), v=np.asarray(v),
                                grads=jax.tree.map(np.asarray, g[0]), gx=np.asarray(g[1]))

        # sequence-parallel decode (command-r-plus: 8 q / 2 kv heads)
        cfg = _cfgs("command-r-plus-104b", "repro")
        p = {k: v[0] for k, v in _ref_init(cfg)["layers"]["attn"].items() if k != "norm"}
        x = rng.standard_normal((SP_B, 1, cfg.d_model)).astype(f32)
        ck = rng.standard_normal((SP_B, SP_S, cfg.num_kv_heads, cfg.head_dim)).astype(f32)
        cv = rng.standard_normal((SP_B, SP_S, cfg.num_kv_heads, cfg.head_dim)).astype(f32)
        cases = {"none": (None, rng.integers(0, SP_S, SP_B).astype(np.int32)),
                 "window": (6, rng.integers(0, SP_S, SP_B).astype(np.int32)),
                 "ring": (SP_S, rng.integers(SP_S, 3 * SP_S, SP_B).astype(np.int32))}
        inp["sp"] = dict(p=p, x=x, ck=ck, cv=cv, cases=cases)
        ref["sp"] = {}
        for wcase, (w, pos) in cases.items():
            y, k2, v2 = jL.attention_decode(p, jnp.asarray(x), cfg, jnp.asarray(ck),
                                            jnp.asarray(cv), jnp.asarray(pos), window=w)
            ref["sp"][wcase] = dict(y=np.asarray(y), ck=np.asarray(k2), cv=np.asarray(v2))

        # the hybrid: forward_train, prefill and two decode steps, no mesh
        cfg = _cfgs("hymba-1.5b", "repro")
        mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
        params = _ref_init(cfg, mesh)
        toks = rng.integers(0, cfg.vocab_size, (HYB_B, HYB_S)).astype(np.int32)
        nxt = [rng.integers(0, cfg.vocab_size, (HYB_B, 1)).astype(np.int32) for _ in range(2)]
        inp["hybrid"] = dict(params=params, tokens=toks, next=nxt)
        logits, _ = jT.forward_train(params, {"tokens": jnp.asarray(toks)}, cfg, None,
                                     compute_dtype=jnp.float32)
        lg, cache = jss.make_prefill_step(cfg, None, jnp.float32, cache_len=HYB_S + 4)(
            params, {"tokens": jnp.asarray(toks)})
        steps = [np.asarray(lg)]
        decode = jss.make_decode_step(cfg, None, jnp.float32)
        for i, t in enumerate(nxt):
            lg, cache = decode(params, jnp.asarray(t), cache,
                               jnp.full((HYB_B,), HYB_S + i, jnp.int32))
            steps.append(np.asarray(lg))
        ref["hybrid"] = dict(logits=np.asarray(logits), steps=steps)

        # the MoE on the padded experts, each data shard on its own
        inp["moe"], ref["moe"] = {}, {}
        for name, tp in (("2x2", False), ("1x4", False), ("2x2", True)):
            cfg = _cfgs("qwen2-moe-a2.7b", "repro")
            cfg = _moe_tp(cfg) if tp else cfg
            mesh = tmesh.AbstractMesh(MESHES[name], ("data", "model"))
            p = {k: v[0] for k, v in _ref_init(cfg, mesh)["layers"]["moe"].items()
                 if k != "norm"}
            x = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)).astype(f32)
            r = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)).astype(f32)
            inp["moe"][(name, "tp" if tp else "ep")] = dict(p=p, x=x, r=r)
            d = MESHES[name][0]

            def objective(p_, x_):
                ys, auxs = [], []
                for xs in jnp.split(x_, d):
                    y, a = jM.moe_layer(p_, xs, cfg, None)
                    ys.append(y)
                    auxs.append(a)
                y = jnp.concatenate(ys)
                aux = jnp.mean(jnp.stack(auxs))
                return jnp.sum(y * r) / d + AUX_COEF * aux, (y, aux)

            (_, (y, aux)), g = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(
                p, jnp.asarray(x))
            ref["moe"][(name, "tp" if tp else "ep")] = dict(
                y=np.asarray(y), aux=float(aux), grads=jax.tree.map(np.asarray, g[0]),
                gx=np.asarray(g[1]), e_pad=p["wg"].shape[0])

        # the train step, no mesh, on the padded weights and the global batch
        inp["train"], ref["train"] = {}, {}
        mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
        for arch in TRAIN_ARCHS:
            cfg = _cfgs(arch, "repro")
            params = _ref_init(cfg, mesh)
            toks = rng.integers(0, cfg.vocab_size, (4, S + 1)).astype(np.int32)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            run = jbase.RunConfig(model=cfg, shape=jbase.ShapeConfig("small", S, 4, "train"),
                                  compute_dtype="float32", remat="none",
                                  optimizer=jbase.OptimizerConfig(name="adamw"))
            step, opt = jts.make_train_step(cfg, None, run, total_steps=50)
            state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
            new, m = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
            inp["train"][arch] = dict(params=params, batch=batch)
            ref["train"][arch] = dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=[(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
                        jax.tree_util.tree_flatten_with_path(new["params"])[0]],
                before=[np.asarray(v) for v in jax.tree.leaves(params)])
    return inp, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    inp, ref = _refs()
    path = str(tmp / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    t0 = time.perf_counter()
    ranks = tmesh.spawn(_rank, WORLD, backend="gloo", timeout_s=SPAWN_TIMEOUT_S,
                        args=(path, str(tmp / "ckpt")))
    return dict(ranks=ranks, ref=ref, seconds=time.perf_counter() - t0)


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _rel_max(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_ranks_never_load_jax(world):
    assert not any(r["_jax_loaded"] for r in world["ranks"])


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
@pytest.mark.parametrize("window", [None, 8], ids=["global", "window8"])
def test_context_parallel_attention(world, mesh_name, window):
    got = world["ranks"][0]["cp"][(mesh_name, window)]
    want = world["ref"]["cp"][window]
    _close(got["y"], want["y"], CP_TOL, "out")
    _close(got["k"], want["k"], CACHE_TOL, "k")
    _close(got["v"], want["v"], CACHE_TOL, "v")
    # the trap: each model rank's weight gradients cover its own queries
    for k, g in want["grads"].items():
        assert _rel_max(got["grads"][k], g) <= CP_TOL, k
    assert _rel_max(got["gx"], want["gx"]) <= CP_TOL
    for r in world["ranks"][1:]:
        np.testing.assert_array_equal(r["cp"][(mesh_name, window)]["y"], got["y"])


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
@pytest.mark.parametrize("wcase", ["none", "window", "ring"])
def test_sequence_parallel_decode(world, mesh_name, wcase):
    got = world["ranks"][0]["sp"][(mesh_name, wcase)]
    want = world["ref"]["sp"][wcase]
    _close(got["y"], want["y"], CP_TOL, "out")
    _close(got["ck"], want["ck"], CACHE_TOL, "cache k")
    _close(got["cv"], want["cv"], CACHE_TOL, "cache v")


def test_hybrid_forward_and_decode_at_2x2(world):
    got = world["ranks"][0]["hybrid"]
    want = world["ref"]["hybrid"]
    _close(got["logits"], want["logits"], FWD_TOL, "forward_train")
    assert len(got["steps"]) == len(want["steps"]) == 3
    for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
        _close(a, b, FWD_TOL, f"prefill/decode step {i}")


@pytest.mark.parametrize("mesh_name,split", [("2x2", "heads"), ("1x4", "p")])
def test_split_ssd_is_bitwise(world, mesh_name, split):
    """The state and conv tail of the tensor-parallel SSD are bitwise the
    unsplit SSD's blocks (the scan is per head and per P channel); its
    output sums the ranks' partial ``out_proj`` products, so it is held to
    ``8·√k·eps·max|y|`` with ``k`` = ``d_inner``."""
    for r in world["ranks"]:
        got = r["ssd"][mesh_name]
        assert got["split"] == split
        assert got["h"] and got["conv"], got
        k = 96 if split == "p" else 128
        assert got["y_max_diff"] <= 8 * np.sqrt(k) * np.finfo(np.float32).eps * got["y_max"]


@pytest.mark.parametrize("mesh_name,mode", [("2x2", "ep"), ("1x4", "ep"), ("2x2", "tp")])
def test_moe_on_a_mesh(world, mesh_name, mode):
    got = world["ranks"][0]["moe"][(mesh_name, mode)]
    want = world["ref"]["moe"][(mesh_name, mode)]
    m = MESHES[mesh_name][1]
    assert got["local_experts"] == (want["e_pad"] // m if mode == "ep" else want["e_pad"])
    _close(got["y"], want["y"], MOE_TOL, "y")
    assert abs(got["aux"] - want["aux"]) <= MOE_TOL
    for k, g in want["grads"].items():
        assert _rel_max(got["grads"][k], g) <= MOE_GRAD_REL, k
    assert _rel_max(got["gx"], want["gx"]) <= MOE_GRAD_REL


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_at_2x2(world, arch):
    got = world["ranks"][0]["train"][arch]
    want = world["ref"]["train"][arch]
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    assert [k for k, _ in got["params"]] == [k for k, _ in want["params"]]
    for (k, g), (_, w), b in zip(got["params"], want["params"], want["before"]):
        assert np.isfinite(g).all(), k
        assert _rel(g - b, w - b) <= (1e-2 if k.endswith("['bk']") else 1e-3), k
    for r in world["ranks"][1:]:
        assert r["train"][arch]["loss"] == got["loss"]


@pytest.mark.parametrize("mesh_name", ["2x2", "4x1"])
@pytest.mark.parametrize("opt", ["adamw", "shampoo"])
def test_sharded_optimizer_is_bitwise(world, mesh_name, opt):
    for r in world["ranks"]:
        got = r["optim"][(mesh_name, opt)]
        assert got["updates"] and got["n_updates"] > 0
        assert got["state"] and got["n_state"] > 0
    if opt == "shampoo":
        owned = world["ranks"][0]["optim"][(mesh_name, opt)]["owned"]
        d = MESHES[mesh_name][0]
        # blocks split over data where they divide it, else held by all
        assert any(mine * d == nb for mine, nb in owned.values())
        assert any(mine == nb and nb % d for mine, nb in owned.values())


def test_save_then_restore_on_another_mesh(world):
    got = world["ranks"][0]["train"]["restore"]
    assert got["step"] == 1 and got["keys"] and got["bitwise"] and got["n"] > 0
    # the (4, 1) rank holds a quarter of embed's ZeRO-1 moment
    assert got["block"] == (got["full"][0], got["full"][1] // 4)


def test_resume_fits_the_padded_vocab():
    """A run resumed on another ``model`` size: the padded vocab rows of
    ``embed`` and columns of ``lm_head`` (per codebook) are cropped or
    zero-filled, the real ones kept; other leaves pass through."""
    from repro_torch.launch.train import _fit_vocab

    cfg = dataclasses.replace(_cfgs("musicgen-medium", "repro_torch"), vocab_size=300)
    k = max(cfg.num_codebooks, 1)
    rng = np.random.default_rng(SEED)
    embed = rng.standard_normal((512, 8)).astype(np.float32)
    head = rng.standard_normal((8, k * 512)).astype(np.float32)
    fit = _fit_vocab(cfg)
    got = fit("['params']['embed']", embed, (384, 8))
    np.testing.assert_array_equal(got, embed[:384])
    back = fit("['opt']['m']['embed']", got, (512, 8))
    np.testing.assert_array_equal(back[:384], embed[:384])
    assert not back[384:].any()
    got = fit("['params']['lm_head']", head, (8, k * 384))
    np.testing.assert_array_equal(got.reshape(8, k, 384), head.reshape(8, k, 512)[..., :384])
    other = np.ones((3, 4), np.float32)
    assert fit("['params']['final_norm']", other, (3, 5)) is other
    with pytest.raises(ValueError, match="does not hold"):
        fit("['params']['embed']", embed, (256, 8))


def _cli_metrics(tmp, mesh):
    from repro_torch.launch import train as tlaunch

    out = tmp / f"run_{mesh}"
    tlaunch.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "3", "--batch", "4",
                  "--seq", "16", "--device", "cpu", "--log-every", "1", "--save-every", "2",
                  "--mesh", mesh, "--out", str(out)])
    import json

    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_on_a_mesh(tmp_path):
    """``--mesh 2x2 --device cpu`` trains the same steps as ``1x1`` (bfloat16
    compute: loss within 2e-2 relative), rank 0 alone logs."""
    one = _cli_metrics(tmp_path, "1x1")
    four = _cli_metrics(tmp_path, "2x2")
    assert [r["step"] for r in four] == [1, 2, 3]
    for a, b in zip(one, four):
        assert abs(a["loss"] - b["loss"]) <= 2e-2 * abs(a["loss"])
    assert (tmp_path / "run_2x2" / "ckpt" / "step_000000002" / "_COMMITTED").exists()


def test_serve_cli_on_a_mesh(tmp_path):
    """``--mesh 2x2 --device cpu`` serves the prompts of ``1x1`` with the
    same greedy float32 tokens."""
    from repro_torch.launch import serve as tserve

    args = ["--arch", "qwen1.5-0.5b", "--smoke", "--requests", "6", "--batch", "4",
            "--prompt-len", "8", "--gen-len", "6", "--temperature", "0", "--device", "cpu",
            "--compute-dtype", "float32"]
    one = tserve.main(args + ["--mesh", "1x1"])
    four = tserve.main(args + ["--mesh", "2x2"])
    np.testing.assert_array_equal(four["prompts"], one["prompts"])
    np.testing.assert_array_equal(four["tokens"], one["tokens"])
