"""The port's sharding rules (``repro_torch.parallel.sharding``), ZeRO-1 and
the train state's specs (``train.train_step``) and the elastic helpers
(``runtime.elastic``) against the reference's, with no process group.

The rules read only ``mesh.shape``, so both sides take the port's
shape-only ``launch.mesh.AbstractMesh`` for the production meshes (16, 16)
and (2, 16, 16) (the container's JAX has no ``AxisType``, which its own
``AbstractMesh`` needs for these rules). Shapes come from
``jax.eval_shape`` on the reference's side and from tensors on the
``meta`` device on the port's. Specs are compared exactly, entry for
entry, as tuples, in the leaf order both trees flatten in (dicts by sorted
key).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.launch.mesh import AbstractMesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _ref_leaves(tree):
    from jax.sharding import PartitionSpec

    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _port_leaves(tree):
    from repro_torch.parallel.sharding import spec_leaves

    return [tuple(s) for s in spec_leaves(tree)]


ARCHS = sorted(__import__("repro.configs.registry", fromlist=["ARCHS"]).ARCHS)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    from repro.configs.registry import get_config as jget
    from repro.parallel import sharding as jsh

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tT
    from repro_torch.parallel import sharding as tsh

    mesh = _mesh(mesh_name)
    want = jsh.param_specs(mesh, jget(arch))
    got = tsh.param_specs(mesh, get_config(arch))
    assert _port_leaves(got) == _ref_leaves(want)
    # one spec a parameter leaf, and the padded tree's shapes equal the
    # reference's init under the mesh
    params = tT.init(None, get_config(arch), mesh, device="meta")
    ref = jax.eval_shape(lambda k: __import__("repro.models.transformer", fromlist=["init"])
                         .init(k, jget(arch), mesh), jax.random.key(0))
    from repro_torch.optim._tree import tree_leaves

    assert [tuple(x.shape) for x in tree_leaves(params)] == [x.shape
                                                             for x in jax.tree.leaves(ref)]
    assert len(_port_leaves(got)) == len(tree_leaves(params))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    from repro.configs.registry import get_config as jget
    from repro.models import transformer as jT
    from repro.parallel import sharding as jsh

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tT
    from repro_torch.parallel import sharding as tsh

    mesh = _mesh(mesh_name)
    for batch, max_seq in ((128, 32768), (1, 1000), (6, 24)):
        jcache = jax.eval_shape(lambda: jT.init_cache(jget(arch), batch, max_seq, mesh,
                                                      dtype=jnp.bfloat16))
        tcache = tT.init_cache(get_config(arch), batch, max_seq, mesh, device="meta")
        want = jsh.cache_specs(mesh, jget(arch), jcache)
        got = tsh.cache_specs(mesh, get_config(arch), tcache)
        assert _port_leaves(got) == _ref_leaves(want), (batch, max_seq)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2"])
def test_batch_specs_equal_the_reference(mesh_name):
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.registry import input_specs as jinput
    from repro.configs.registry import get_config as jget
    from repro.parallel import sharding as jsh

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config, input_specs
    from repro_torch.parallel import sharding as tsh

    mesh = _mesh(mesh_name)
    for name in sorted(JSHAPES):
        assert tuple(tsh.batch_spec(mesh, SHAPES[name])) == tuple(jsh.batch_spec(mesh, JSHAPES[name]))
        assert (tuple(tsh.activation_spec(mesh, SHAPES[name]))
                == tuple(jsh.activation_spec(mesh, JSHAPES[name])))
        for arch in ARCHS:
            for mode in (None, "prefill", "decode"):
                try:
                    jin = jinput(jget(arch), JSHAPES[name], mode)
                except (ValueError, KeyError) as e:
                    with pytest.raises(type(e)):
                        input_specs(get_config(arch), SHAPES[name], mode)
                    continue
                tin = input_specs(get_config(arch), SHAPES[name], mode)
                want = jsh.batch_input_specs(mesh, jin)
                got = tsh.batch_input_specs(mesh, tin)
                assert sorted(got) == sorted(want)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, (arch, name, mode)
    long_ctx = {"tokens": torch.empty((1, 524288), dtype=torch.int32, device="meta")}
    assert tuple(tsh.batch_input_specs(mesh, long_ctx)["tokens"]) == tuple(
        jsh.batch_input_specs(mesh, {"tokens": jax.ShapeDtypeStruct((1, 524288),
                                                                     jnp.int32)})["tokens"])


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2"])
def test_pick_and_padding_equal_the_reference(mesh_name):
    from repro.parallel import sharding as jsh

    from repro_torch.parallel import sharding as tsh

    mesh = _mesh(mesh_name)
    for v in (256, 32001, 50280, 151936, 256000, 1):
        assert tsh.pad_vocab(v, mesh) == jsh.pad_vocab(v, mesh)
    for e in (1, 6, 60, 64, 66):
        assert tsh.pad_experts(e, mesh) == jsh.pad_experts(e, mesh)
    cands = [("data", "model"), "model", "data", None]
    for dim in (1, 2, 7, 16, 25, 32, 64, 256, 512):
        assert tsh.pick(mesh, dim, cands) == jsh.pick(mesh, dim, cands)
    assert tsh.data_axes(mesh) == jsh.data_axes(mesh)


def test_zero1_equals_the_reference():
    from jax.sharding import PartitionSpec as JP

    from repro.train.train_step import _zero1 as jzero1

    from repro_torch.parallel.sharding import P
    from repro_torch.train.train_step import _zero1

    mesh = _mesh("16x16")
    cases = [((None, None), (1024, 64)), (("model", None), (64, 1024)), ((None,), (7,)),
             ((None, "model", None), (24, 1024, 16)), ((), (48, 32)),
             ((None, None, "model"), (8, 8, 32))]
    for spec, shape in cases:
        assert tuple(_zero1(P(*spec), shape, mesh)) == tuple(jzero1(JP(*spec), shape, mesh))
    assert tuple(_zero1(P(None, None), (1024, 64), mesh)) == ("data", None)
    assert tuple(_zero1(P("model", None), (64, 1024), mesh)) == ("model", "data")
    assert tuple(_zero1(P(None), (7,), mesh)) == (None,)
    no_data = AbstractMesh((4,), ("model",))
    assert tuple(_zero1(P(None, None), (8, 8), no_data)) == (None, None)


def _state_spec_pair(arch, smoke, mesh, opt_kw):
    """(reference specs, port specs) of the train state."""
    from repro.configs import base as jbase
    from repro.configs.registry import get_config as jget, get_smoke as jsmoke
    from repro.models.transformer import init as jinit
    from repro.optim import schedules as jsched
    from repro.optim.adamw import adamw as jadamw
    from repro.optim.shampoo import shampoo as jshampoo
    from repro.train.train_step import state_specs as jstate_specs

    from repro_torch.configs import base as tbase
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.models.transformer import init
    from repro_torch.optim.adamw import adamw as tadamw
    from repro_torch.optim.shampoo import shampoo as tshampoo
    from repro_torch.train.train_step import state_specs

    name = opt_kw.pop("name")
    jcfg = jsmoke(arch) if smoke else jget(arch)
    tcfg = get_smoke(arch) if smoke else get_config(arch)
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.SHAPES["train_4k"],
                           optimizer=jbase.OptimizerConfig(name=name))
    trun = tbase.RunConfig(model=tcfg, shape=tbase.SHAPES["train_4k"],
                           optimizer=tbase.OptimizerConfig(name=name))
    sched = jsched.warmup_cosine(1e-3, 10, 100)
    if name == "adamw":
        jopt, topt = jadamw(sched), tadamw(sched)
    else:
        jopt, topt = jshampoo(sched, **opt_kw), tshampoo(sched, **opt_kw)
    p_abs = jax.eval_shape(lambda k: jinit(k, jcfg, mesh), jax.random.key(0))
    want = jstate_specs(jcfg, mesh, jrun, p_abs, jax.eval_shape(jopt.init, p_abs))
    params = init(None, tcfg, mesh, device="meta")
    got = state_specs(tcfg, mesh, trun, params, topt.init(params))
    return want, got


STATE_CASES = [(arch, True, opt) for arch in ("qwen1.5-0.5b", "qwen2-moe-a2.7b", "hymba-1.5b")
               for opt in ("adamw", "shampoo_packed_p4", "shampoo_packed_p2",
                           "shampoo_dense_p4")]
STATE_CASES += [("qwen1.5-0.5b", False, opt) for opt in ("adamw", "shampoo_packed_p4",
                                                         "shampoo_packed_p2")]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x2"])
@pytest.mark.parametrize("arch,smoke,opt", STATE_CASES)
def test_state_specs_equal_the_reference(arch, smoke, opt, mesh_name):
    """``state_specs`` for AdamW and Shampoo (packed p = 2 and 4, dense
    p = 4): every leaf's spec, in order; the packed (4-D) stat stacks
    shard their block dim over 'data' where it divides."""
    kw = {"adamw": dict(name="adamw"),
          "shampoo_packed_p4": dict(name="shampoo", block=16 if smoke else 1024),
          "shampoo_packed_p2": dict(name="shampoo", block=16 if smoke else 1024, precond_p=2),
          "shampoo_dense_p4": dict(name="shampoo", block=16 if smoke else 1024,
                                   packed_grams=False)}[opt]
    mesh = _mesh(mesh_name)
    want, got = _state_spec_pair(arch, smoke, mesh, dict(kw))
    for part in ("params", "step"):
        assert _port_leaves(got[part]) == _ref_leaves(want[part]), part
    for part in sorted(want["opt"]):
        assert _port_leaves(got["opt"][part]) == _ref_leaves(want["opt"][part]), part
    if opt.startswith("shampoo_packed"):
        four = [s for s in _port_leaves(got["opt"]["shampoo"]) if len(s) == 4]
        assert four and all(s[1:] == (None, None, None) for s in four)


def test_elastic_equals_the_reference():
    from repro.runtime import elastic as jel

    from repro_torch.runtime import elastic as tel

    assert tel.remesh_plan(256) == ((16, 16), ("data", "model"))
    assert tel.remesh_plan(128) == ((8, 16), ("data", "model"))
    assert tel.remesh_plan(24) == ((3, 8), ("data", "model"))
    assert tel.remesh_plan(1) == ((1, 1), ("data", "model"))
    for n in (1, 2, 3, 4, 6, 8, 12, 24, 100, 128, 256, 512):
        for prefer in (1, 4, 16):
            assert tel.remesh_plan(n, prefer) == jel.remesh_plan(n, prefer)
    assert tel.microbatches_for(256, 1, 16) == 16
    assert tel.microbatches_for(256, 1, 8) == 32
    for args in ((256, 2, 8), (64, 4, 4), (12, 3, 2)):
        assert tel.microbatches_for(*args) == jel.microbatches_for(*args)
    with pytest.raises(ValueError):
        tel.microbatches_for(250, 1, 16)


def test_named_and_held_specs():
    """``named`` pairs a mesh with each spec; ``held`` keeps every entry of
    ``param_specs`` where the ``model`` axis divides the dim (the dense
    weights as tensor-parallel blocks, the experts as the rank's experts),
    and drops a ``model`` entry where it does not."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke
    from repro_torch.parallel.sharding import NamedSharding, P, held, named, param_specs

    mesh = _mesh("2x2")
    cfg = get_smoke("qwen2-moe-a2.7b")
    specs = param_specs(mesh, cfg)
    ns = named(mesh, specs)
    assert isinstance(ns["embed"], NamedSharding) and ns["embed"] == (mesh, P("model", None))
    h = held(specs, cfg, mesh)
    assert h == specs
    assert h["embed"] == P("model", None)
    assert h["layers"]["moe"]["wg"] == P(None, "model", None, None)
    assert h["layers"]["attn"]["wq"] == P(None, None, "model", None)
    assert h["layers"]["shared_mlp"]["wd"] == P(None, "model", None)
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared=1, d_ff_expert=97))
    h = held(param_specs(mesh, odd), odd, mesh)
    assert h["layers"]["shared_mlp"]["wg"] == P(None, None, None)
    assert h["layers"]["attn"]["wq"] == P(None, None, "model", None)
