"""The port's distributed schedules (``repro_torch.core.distributed``,
``repro_torch.launch``) on the CPU, against the reference's single-device
functions, and the planner's distributed branch against the reference's.

* **Schedules.** Ranks are processes of ``launch.mesh.spawn`` (the
  ``spawn`` start method, a ``file://`` rendezvous in a temporary
  directory) over ``gloo`` with CPU tensors: world size 4 on meshes
  ``(4,)`` and ``(2, 2)``, world size 6 on ``(6,)`` and ``(3, 2)`` (a pool
  that is no power of two). Each world size starts once per module (a
  module-scoped fixture runs every case on every rank); each case is its
  own test. Every rank makes the same inputs from ``SEED`` with numpy and
  cuts its own view (``Mesh.local_block``). The parent holds rank 0's
  results against the reference's single-device ``repro.core.ata.ata``,
  ``strassen_tn`` and ``repro.optim.powersgd.compress`` on the same numpy
  input, within ``8·√k·eps·max|ref|`` (k the contraction length), and
  checks that every rank got bitwise the same result. The bitwise
  contracts inside the port (packed ``to_dense()`` equals dense, every
  interleaving equals ``ata_tile_parallel`` at the same grid, ``alpha``
  equals ``scale``) are checked on the ranks.
* **Imports.** This module imports ``jax`` and ``repro`` only inside the
  functions the parent runs, so the ranks (which import it to find their
  body) never load JAX; each rank reports whether it did.
* **Planner.** ``bfs_dfs_assignment``, ``choose_tiling``,
  ``tile_parallel_device_flops`` and the cost model's distributed branch
  equal the reference's field for field on the cpu machine.

Each reference call runs under a scoped ``jax.enable_x64(False)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh

SEED = 19
EPS32 = 1.19e-7
M, N, N_BASE = 128, 200, 32       # the ata operand and the leaf cutoff
NB_PIN = 6                         # the pinned stripe grid of the bitwise checks
GM, GN = 144, 96                   # gram_rowshard's operand, rows over the pool
CM, CN, CK = 128, 80, 48           # gemm_tn_colshard's A (CM, CN), B (CM, CK)
PM, PN, PR = 144, 40, 4            # PowerSGD's gradient and rank
# (2, 2) with the row axis first: the merged pool's group order is then not
# task-major, and the tri-direct exchange permutes its chunks
MESHES = {4: (((4,), ("model",)), ((2, 2), ("model", "data")), ((2, 2), ("data", "model"))),
          6: (((6,), ("model",)), ((3, 2), ("model", "data")))}
INTERLEAVINGS = ("D", "BD", "B", "BDB")
SPAWN_TIMEOUT_S = 120.0
REL_POWERSGD = 1e-4                # tests/test_torch_optim.py's REL_P4


def _inputs():
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((M, N)).astype(np.float32)
    ga = rng.standard_normal((GM, GN)).astype(np.float32)
    ca = rng.standard_normal((CM, CN)).astype(np.float32)
    cb = rng.standard_normal((CM, CK)).astype(np.float32)
    u = rng.standard_normal((PM, PR)).astype(np.float32)
    v = rng.standard_normal((PN, PR)).astype(np.float32)
    g = (u @ v.T + 0.1 * rng.standard_normal((PM, PN))).astype(np.float32)
    q = rng.standard_normal((PN, PR)).astype(np.float32)
    return dict(a=a, ga=ga, ca=ca, cb=cb, g=g, q=q)


def _mesh_id(shape, axes) -> str:
    return "x".join(map(str, shape)) + ("" if axes[0] == "model" else "_data_first")


def _dims(mesh_id):
    """(task ranks, row ranks) of a mesh of the grid."""
    shape, axes = MESH_OF[mesh_id]
    sizes = dict(zip(axes, shape))
    return sizes["model"], sizes.get("data", 1)


def _dummy_nb(p: int) -> int:
    """The least stripe count ≥ 3 whose triangle does not split evenly over
    ``p`` task ranks (so the last ranks hold dummy slots)."""
    nb = 3
    while (nb * (nb + 1) // 2) % p == 0:
        nb += 1
    return nb


# ---------------------------------------------------------------------------
# the rank bodies (run in the spawned processes)
# ---------------------------------------------------------------------------


def _np(x):
    from repro_torch.core import SymmetricMatrix

    if isinstance(x, SymmetricMatrix):
        x = x.to_dense()
    return x.detach().cpu().numpy()


def _mesh_cases(mesh) -> dict:
    """Every schedule case on one mesh: ``{name: {key: array | number}}``."""
    from repro_torch import obs
    from repro_torch.core.distributed import (ata_bfs_dfs, ata_tile_parallel,
                                              gemm_tn_colshard, gram_rowshard)
    from repro_torch.optim import powersgd
    from repro_torch.tune import plan as plan_fn
    from repro_torch.tune.apply import ata_distributed_with_plan

    x = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    two_d = len(mesh.axis_names) == 2
    row = "data" if two_d else None
    pool = ("model", "data") if two_d else "model"
    p_task = mesh.axis_size("model")
    a = mesh.local_block(x["a"], (row, None))
    kw = dict(mesh=mesh, task_axis="model", row_axis=row)
    tp = dict(n_base=N_BASE)
    res = {}

    def ran(fn, *args, **kwargs):
        """``fn``'s result and the tile products it computed here."""
        before = obs.metrics.counters("dispatch.gemm_tn.")
        out = fn(*args, **kwargs)
        after = obs.metrics.counters("dispatch.gemm_tn.")
        return out, sum(after.values()) - sum(before.values())

    def packed_dense(fn, **extra):
        packed = fn(a, **kw, out="packed", **extra)
        dense = fn(a, **kw, out="dense", **extra)
        return packed, dense

    for ld in ("unrolled", "batched", "fused"):
        packed, dense = packed_dense(ata_tile_parallel, leaf_dispatch=ld, **tp)
        res[f"tile_{ld}"] = dict(c=_np(dense), packed_is_dense=bool(
            torch.equal(packed.to_dense(), dense)))
    base_p, base_d = packed_dense(ata_tile_parallel, nb=NB_PIN, **tp)
    for il in INTERLEAVINGS:
        packed, dense = packed_dense(ata_bfs_dfs, interleaving=il, nb=NB_PIN, **tp)
        res[f"bfs_{il}"] = dict(
            c=_np(dense), packed_is_dense=bool(torch.equal(packed.to_dense(), dense)),
            packed_is_tile=bool(torch.equal(packed.blocks, base_p.blocks)),
            dense_is_tile=bool(torch.equal(dense, base_d)))
    grid = ata_bfs_dfs(a, **kw, interleaving="B", out="packed", **tp)
    res["bfs_grid"] = dict(c=_np(grid), bn=grid.bn)
    half = ata_tile_parallel(a, **kw, nb=NB_PIN, alpha=0.5, out="packed", **tp)
    half_b = ata_bfs_dfs(a, **kw, nb=NB_PIN, interleaving="BD", alpha=0.5, out="packed", **tp)
    res["alpha"] = dict(c=_np(half), is_scale=bool(
        torch.equal(half.blocks, base_p.scale(0.5).blocks)
        and torch.equal(half_b.blocks, half.blocks)))
    acc = ata_tile_parallel(a, **kw, nb=_dummy_nb(p_task), acc_dtype=torch.float64,
                            out="packed", **tp)
    res["acc_dtype"] = dict(c=_np(acc), dtype=str(acc.dtype))
    for name, fn in (("dummy_tile", ata_tile_parallel), ("dummy_bfs", ata_bfs_dfs)):
        extra = dict(interleaving="BD") if fn is ata_bfs_dfs else {}
        c, tiles = ran(fn, a, **kw, nb=_dummy_nb(p_task), out="packed", **extra, **tp)
        res[name] = dict(c=_np(c), tiles=tiles)
    res["tile_planned"] = dict(c=_np(ata_tile_parallel(a, **kw, out="packed")))
    res["bfs_planned"] = dict(c=_np(ata_bfs_dfs(a, **kw, out="packed")))
    pl = plan_fn(op="ata", m=M, n=N, devices=p_task,
                 row_devices=mesh.axis_size(row) if row else 1, out="packed", backend="cpu")
    res["apply"] = dict(c=_np(ata_distributed_with_plan(a, mesh, pl, task_axis="model",
                                                        row_axis=row)),
                        comm_schedule=str(pl.comm_schedule))

    ga = mesh.local_block(x["ga"], (pool, None))
    for name, gkw in (("gram_ata_packed", dict(out="packed")),
                      ("gram_ata_dense", dict(out="dense")),
                      ("gram_dot_packed", dict(out="packed", use_ata=False)),
                      ("gram_dot_dense", dict(out="dense", use_ata=False))):
        res[name] = dict(c=_np(gram_rowshard(ga, pool, mesh=mesh, n_base=16, **gkw)))
    res["gram_group"] = dict(c=_np(gram_rowshard(ga, mesh.group(pool), n_base=16,
                                                 out="packed")))

    rows = (row,) if two_d else (None,)
    for r in rows + ((None,) if two_d else ()):
        ca = mesh.local_block(x["ca"], (r, None))
        cb = mesh.local_block(x["cb"], (r, "model"))
        c = gemm_tn_colshard(ca, cb, mesh, task_axis="model", row_axis=r, n_base=16)
        res["colshard_row" if r else "colshard"] = dict(c=_np(c))

    g = mesh.local_block(x["g"], (pool, None))
    state = powersgd.PowerSGDState(q=x["q"], error=torch.zeros_like(g))
    p_loc, q, state = powersgd.compress_sharded(g, state, pool, mesh=mesh, n_base=16)
    res["compress_sharded"] = dict(p=_np(p_loc), q=_np(q), error=_np(state.error),
                                   index=mesh.axis_index(pool))

    obs.metrics.reset()
    obs.trace.reset()
    obs.enable()
    try:
        ata_bfs_dfs(a, **kw, nb=NB_PIN, interleaving="BD", out="packed", **tp)
    finally:
        obs.disable()
    res["obs"] = dict(counters=obs.metrics.counters(), spans=obs.trace.span_counts(),
                      seconds=sorted(obs.metrics.histograms("collective_seconds.")))
    return res


def _run_world(rank: int, world: int, cache_file: str) -> dict:
    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = cache_file
    from repro_torch.launch.mesh import make_mesh

    out = {"_jax_loaded": "jax" in sys.modules}
    for shape, axes in MESHES[world]:
        mesh = make_mesh(shape, axes, backend="gloo", device="cpu")
        res = _mesh_cases(mesh)
        for case in res.values():
            for k, v in list(case.items()):
                if isinstance(v, np.ndarray):
                    case[k + "_sha"] = hashlib.sha256(np.ascontiguousarray(v)).hexdigest()
                    if rank and case is not res["compress_sharded"]:
                        del case[k]
        out[_mesh_id(shape, axes)] = res
    return out


def _run_failing(rank: int, world: int, hang: bool):
    import torch.distributed as dist

    if rank == 1:
        if hang:
            time.sleep(600)
        raise RuntimeError("rank 1 gives up")
    dist.barrier()   # waits for rank 1 forever
    return rank


# ---------------------------------------------------------------------------
# the parent: spawn once per world size, then one test per case
# ---------------------------------------------------------------------------


def _world(tmp_path_factory, world: int) -> dict:
    cache = str(tmp_path_factory.mktemp(f"world{world}") / "plans.json")
    t0 = time.perf_counter()
    ranks = tmesh.spawn(_run_world, world, backend="gloo", timeout_s=SPAWN_TIMEOUT_S,
                        args=(cache,))
    return dict(ranks=ranks, seconds=time.perf_counter() - t0)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def world6(tmp_path_factory):
    return _world(tmp_path_factory, 6)


@pytest.fixture(scope="module")
def refs():
    """The reference's single-device results on the same numpy inputs."""
    import jax
    import jax.numpy as jnp

    from repro.core.ata import ata as jata
    from repro.core.strassen import strassen_tn as jstrassen
    from repro.optim import powersgd as jpsgd

    x = _inputs()
    with jax.enable_x64(False):
        out = dict(
            a=np.asarray(jata(jnp.asarray(x["a"]), n_base=N_BASE)),
            ga=np.asarray(jata(jnp.asarray(x["ga"]), n_base=16)),
            c=np.asarray(jstrassen(jnp.asarray(x["ca"]), jnp.asarray(x["cb"]), n_base=16)),
        )
        st = jpsgd.PowerSGDState(q=jnp.asarray(x["q"]), error=jnp.zeros((PM, PN), jnp.float32))
        p, q, st = jpsgd.compress(jnp.asarray(x["g"]), st, n_base=16)
        out.update(p=np.asarray(p), q=np.asarray(q), error=np.asarray(st.error))
    return out


def _close(got, want, k):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = 8 * math.sqrt(k) * EPS32 * float(np.abs(want).max())
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _case(request, world, mesh_id, name) -> list:
    """The case's result on every rank; every rank's arrays bitwise equal
    to rank 0's."""
    ranks = request.getfixturevalue(f"world{world}")["ranks"]
    cases = [r[mesh_id][name] for r in ranks]
    for key in (k for k in cases[0] if k.endswith("_sha") and name != "compress_sharded"):
        assert len({c[key] for c in cases}) == 1, f"{key}: ranks disagree"
    return cases


MESH_OF = {_mesh_id(shape, axes): (shape, axes) for meshes in MESHES.values()
           for shape, axes in meshes}
GRID = [(w, _mesh_id(shape, axes)) for w, meshes in MESHES.items() for shape, axes in meshes]
ATA_CASES = (["tile_unrolled", "tile_batched", "tile_fused", "bfs_grid", "alpha",
              "acc_dtype", "dummy_tile", "dummy_bfs", "tile_planned", "bfs_planned", "apply"]
             + [f"bfs_{il}" for il in INTERLEAVINGS])


@pytest.mark.parametrize("name", ATA_CASES)
@pytest.mark.parametrize("world,mesh_id", GRID)
def test_ata_schedules_match_reference(request, refs, world, mesh_id, name):
    """Every ata schedule case against the reference's single-device ``ata``
    (alpha = 0.5 against half of it); the packed and dense results agree
    bitwise where both were made."""
    case = _case(request, world, mesh_id, name)[0]
    want = refs["a"] * (0.5 if name == "alpha" else 1.0)
    _close(case["c"], want, M)
    if "packed_is_dense" in case:
        assert case["packed_is_dense"]


@pytest.mark.parametrize("il", INTERLEAVINGS)
@pytest.mark.parametrize("world,mesh_id", GRID)
def test_interleavings_equal_tile_parallel_bitwise(request, world, mesh_id, il):
    """At the same stripe grid every interleaving gives ``ata_tile_parallel``'s
    packed blocks and dense square bitwise (row axes of ≤ 2 ranks)."""
    case = _case(request, world, mesh_id, f"bfs_{il}")[0]
    assert case["packed_is_tile"] and case["dense_is_tile"]


@pytest.mark.parametrize("world,mesh_id", GRID)
def test_alpha_is_scale_and_acc_dtype_and_grid(request, world, mesh_id):
    """``alpha`` scales the packed blocks (``SymmetricMatrix.scale``,
    bitwise, both schedules); ``acc_dtype`` reaches the tiles and the dummy
    tiles; a BFS string without ``nb`` runs on ``bfs_tiling``'s grid with
    the stripe as packed block."""
    from repro_torch.tune.cost import bfs_tiling

    p_task, d_row = _dims(mesh_id)
    pool = p_task * d_row
    assert _case(request, world, mesh_id, "alpha")[0]["is_scale"]
    assert _case(request, world, mesh_id, "acc_dtype")[0]["dtype"] == "torch.float64"
    nb, w = bfs_tiling(N, pool, devices=p_task, out="packed")
    assert _case(request, world, mesh_id, "bfs_grid")[0]["bn"] == w


@pytest.mark.parametrize("world,mesh_id", GRID)
def test_dummy_slots_are_never_computed(request, world, mesh_id):
    """With ``T % p ≠ 0`` the task ranks compute exactly the ``T`` real
    tiles between them (each row rank its own partials): dummy slots are
    zero tiles, not recomputed clamps."""
    p_task, d_row = _dims(mesh_id)
    nb = _dummy_nb(p_task)
    t_total = nb * (nb + 1) // 2
    assert t_total % p_task
    for name in ("dummy_tile", "dummy_bfs"):
        cases = _case(request, world, mesh_id, name)
        assert sum(c["tiles"] for c in cases) == t_total * d_row, name


GRAM_CASES = ["gram_ata_packed", "gram_ata_dense", "gram_dot_packed", "gram_dot_dense",
              "gram_group"]


@pytest.mark.parametrize("name", GRAM_CASES)
@pytest.mark.parametrize("world,mesh_id", GRID)
def test_gram_rowshard_matches_reference(request, refs, world, mesh_id, name):
    """Row blocks over the whole pool, one all-reduce: the full gram on
    every rank, with ``use_ata`` on and off, packed and dense, the group
    given by mesh axes or as a ``ProcessGroup``."""
    _close(_case(request, world, mesh_id, name)[0]["c"], refs["ga"], GM)


@pytest.mark.parametrize("world,mesh_id", GRID)
def test_gemm_tn_colshard_matches_reference(request, refs, world, mesh_id):
    """B column-sharded over the task axis, gathered on every rank; on the
    2-D meshes also with A and B row-sharded over the row axis."""
    names = ["colshard"] + (["colshard_row"] if _dims(mesh_id)[1] > 1 else [])
    for name in names:
        _close(_case(request, world, mesh_id, name)[0]["c"], refs["c"], CM)


@pytest.mark.parametrize("world,mesh_id", GRID)
def test_compress_sharded_matches_reference(request, refs, world, mesh_id):
    """One PowerSGD round on row shards against the reference's
    ``compress`` of the whole gradient from the same ``q``: P's and the
    error's row blocks stacked in pool order, and Q on every rank."""
    cases = sorted(_case(request, world, mesh_id, "compress_sharded"), key=lambda c: c["index"])
    assert [c["index"] for c in cases] == list(range(world))
    assert len({c["q_sha"] for c in cases}) == 1
    # normwise, as tests/test_torch_optim.py holds compress: the Cholesky
    # whitening amplifies rounding by the condition of PᵀP
    assert _rel(cases[0]["q"], refs["q"]) <= REL_POWERSGD
    assert _rel(np.concatenate([c["p"] for c in cases]), refs["p"]) <= REL_POWERSGD
    assert _rel(np.concatenate([c["error"] for c in cases]), refs["error"]) <= REL_POWERSGD


@pytest.mark.parametrize("world,mesh_id", GRID)
def test_collective_bytes_spans_and_counters(request, world, mesh_id):
    """A traced ``ata_bfs_dfs("BD")``: the reference's counters and spans,
    and ``collective_bytes.<kind>`` equal to each collective's result bytes
    (the tri-direct reduce-scatter's chunk, the gathered ``T_pad`` stack)."""
    obs = _case(request, world, mesh_id, "obs")[0]
    pool = math.prod(_dims(mesh_id))
    w = -(-(-(-N // NB_PIN)) // 8) * 8
    t_total = NB_PIN * (NB_PIN + 1) // 2
    t_pad = -(-t_total // pool) * pool
    c = obs["counters"]
    assert c["collective_bytes.reduce-scatter"] == t_pad // pool * w * w * 4
    assert c["collective_bytes.all-gather"] == t_pad * w * w * 4
    assert "collective_bytes.all-reduce" not in c
    assert c["dispatch.ata_bfs_dfs"] == 1 and c["ata_bfs_dfs.tiles"] == t_total
    assert c["ata_bfs_dfs.bfs_levels"] == 1 and c["ata_bfs_dfs.dfs_levels"] == 1
    s = obs["spans"]
    for name in ("distributed.bfs", "distributed.dfs", "distributed.tile_body",
                 "distributed.psum_scatter", "distributed.gather"):
        assert s.get(name) == 1, (name, s)
    assert obs["seconds"] == ["collective_seconds.all-gather",
                              "collective_seconds.reduce-scatter"]


def test_record_collective_bytes_folds_kinds_into_counters():
    """The port's ``record_collective_bytes`` takes per-kind bytes (from the
    collective wrappers) and, like the reference's, adds each nonzero kind
    to ``collective_bytes.<kind>`` and returns those kinds."""
    from repro_torch.obs import metrics

    metrics.reset()
    got = metrics.record_collective_bytes({"all-reduce": 64, "all-gather": 0,
                                           "reduce-scatter": 16})
    assert got == {"all-reduce": 64, "reduce-scatter": 16}
    metrics.record_collective_bytes({"all-reduce": 8}, prefix="x")
    assert metrics.counters("collective_bytes.") == {"collective_bytes.all-reduce": 64,
                                                     "collective_bytes.reduce-scatter": 16}
    assert metrics.get("x.all-reduce") == 8
    metrics.reset()


@pytest.mark.parametrize("world", sorted(MESHES))
def test_ranks_spawn_fresh_and_never_load_jax(request, world):
    """The ranks are started by ``spawn`` (a ``fork`` would inherit the
    parent's JAX) and load nothing of JAX; the whole world, every case on
    both meshes, stays well inside its time limit."""
    w = request.getfixturevalue(f"world{world}")
    assert not any(r["_jax_loaded"] for r in w["ranks"])
    assert w["seconds"] < SPAWN_TIMEOUT_S / 2, w["seconds"]


@pytest.mark.parametrize("hang", [False, True], ids=["fails", "hangs"])
def test_spawn_reports_a_failed_or_hung_rank(hang):
    """A rank that raises makes ``spawn`` kill the rank waiting for it and
    raise with its traceback; a rank that hangs is killed at ``timeout_s``."""
    t0 = time.perf_counter()
    timeout = 8.0 if hang else SPAWN_TIMEOUT_S
    with pytest.raises(RuntimeError) as err:
        tmesh.spawn(_run_failing, 2, backend="gloo", timeout_s=timeout, args=(hang,))
    took = time.perf_counter() - t0
    if hang:
        assert "timed out" in str(err.value) and took < timeout + 20
    else:
        assert "rank 1 gives up" in str(err.value) and took < 60


# ---------------------------------------------------------------------------
# the mesh (one process: a mesh of one rank needs no process group)
# ---------------------------------------------------------------------------


def test_mesh_geometry_and_errors():
    one = tmesh.Mesh((1, 1), ("model", "data"), backend="gloo", device="cpu", rank=0)
    assert one.coords == {"model": 0, "data": 0} and one.group("model") is None
    assert one.axis_size(("model", "data")) == 1 and one.pool_order(("data", "model")) is None
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(one.local_block(x, ("model", None)), x)
    assert tmesh.merged_axis("model", "data") == ("model", "data")
    assert tmesh.merged_axis("model") == "model"
    with pytest.raises(ValueError, match="axis 'x' not in mesh"):
        tmesh.split_axis(one, "x", (1,), ("a",))
    with pytest.raises(ValueError, match="sizes and names must pair up"):
        tmesh.split_axis(one, "model", (1,), ("a", "b"))
    with pytest.raises(ValueError, match=r"prod\(sizes\)=2 != mesh.shape\['model'\]=1"):
        tmesh.split_axis(one, "model", (2, 1), ("a", "b"))
    split = tmesh.split_axis(one, "model", (1, 1), ("grp", "sub"))
    assert split.axis_names == ("grp", "sub", "data")
    # a mesh's rank geometry without groups: rank 5 of (3, 2) sits at (2, 1)
    geo = object.__new__(tmesh.Mesh)
    geo.axis_names, geo.shape = ("model", "data"), {"model": 3, "data": 2}
    geo.coords = dict(zip(geo.axis_names, geo._coords_of(5)))
    assert geo.coords == {"model": 2, "data": 1} and geo.axis_index(("model", "data")) == 5
    assert geo.axis_index(("data", "model")) == 1 * 3 + 2
    # group positions follow the flat rank; merged data-major order permutes
    assert geo.pool_order(("model", "data")) is None
    assert geo.pool_order(("data", "model")) == [0, 3, 1, 4, 2, 5]
    with pytest.raises(ValueError, match="size 3 must divide dim 0 of size 4"):
        geo.local_block(torch.zeros(4, 2), ("model", None))
    assert torch.equal(geo.local_block(torch.arange(12.0).reshape(6, 2), (("model", "data"), None)),
                       torch.tensor([[10.0, 11.0]]))
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.make_mesh((1,), ("model",), backend="mpi", device="cpu")


@pytest.mark.parametrize("module,names,extra", [
    ("core/distributed.py", None, {"gram_rowshard": {"mesh"},
                                   "tile_parallel_device_flops": {"backend"}}),
    ("launch/mesh.py", None, {"make_mesh": {"backend", "device"},
                              "make_production_mesh": {"rank", "device"}}),
    ("tune/apply.py", ("ata_distributed_with_plan",), {}),
    ("optim/powersgd.py", ("compress_sharded",), {"compress_sharded": {"mesh"}}),
])
def test_public_names_and_signatures_follow_the_reference(module, names, extra):
    """The functions of this slice (``names``; None: every public function
    of the reference's module) exist in the port with the reference's
    parameters, in order, plus the mesh adaptations named: a keyword
    ``mesh=`` where the reference runs inside ``shard_map``, an explicit
    backend and device for the mesh, the rank and device of the production
    mesh (one rank's view over a fake group), the operand's backend for the
    flop model."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"

    def params(package):
        tree = ast.parse((root / package / module).read_text())
        out = {}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                a = node.args
                out[node.name] = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        return out

    ref, port = params("repro"), params("repro_torch")
    for name in names or sorted(ref):
        assert name in port, name
        got = [p for p in port[name] if p not in extra.get(name, set())]
        assert got == ref[name], (name, port[name], ref[name])


# ---------------------------------------------------------------------------
# field-for-field parity with the reference (pure Python, cpu machine)
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_plans(tmp_path, monkeypatch):
    from repro.tune import cache as jcache
    from repro_torch import tune

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref_plans.json"))
    tune.cache.clear_memo()
    jcache.clear_memo()
    yield
    tune.cache.clear_memo()
    jcache.clear_memo()


@pytest.mark.parametrize("il", ["D", "B", "BD", "DB", "BDB", "BB", "DDB", "BBB"])
def test_bfs_dfs_assignment_equals_reference(il):
    from repro.core.distributed import bfs_dfs_assignment as jassign
    from repro_torch.core.distributed import bfs_dfs_assignment

    for nb in range(1, 18):
        for pool in range(1, 10):
            assert bfs_dfs_assignment(nb, pool, il) == jassign(nb, pool, il), (nb, pool)
    with pytest.raises(ValueError, match="non-empty string"):
        bfs_dfs_assignment(4, 2, "BX")


@pytest.mark.parametrize("out", ["dense", "packed"])
def test_choose_tiling_and_device_flops_equal_reference(out, fresh_plans):
    import jax

    from repro.core import distributed as jd
    from repro_torch.core import distributed as td

    for n in (128, 200, 777, 1000, 4096, 8192):
        for p in (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 64):
            assert td.choose_tiling(n, p, out=out) == jd.choose_tiling(n, p, out=out), (n, p)
            assert td.choose_tiling(n, p, out=out, packed_block=64) == \
                jd.choose_tiling(n, p, out=out, packed_block=64)
    with jax.enable_x64(False):
        for m, n, p, nb, n_base, st in ((256, 192, 8, 4, 32, True), (256, 192, 3, 4, None, None),
                                        (512, 300, 4, None, 64, False), (1024, 777, 6, None,
                                                                          None, None)):
            kw = dict(nb=nb, n_base=n_base, use_strassen=st, out=out)
            assert td.tile_parallel_device_flops(m, n, p, backend="cpu", **kw) == \
                jd.tile_parallel_device_flops(m, n, p, **kw), (m, n, p)


def _fields_equal(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    pa, pb = da.pop("predicted_s"), db.pop("predicted_s")
    assert da == db
    assert (pa is None and pb is None) or abs(pa - pb) <= 1e-12 * abs(pa)


@pytest.mark.parametrize("devices,row_devices", [(2, 4), (4, 2), (8, 1), (2, 1), (4, 1),
                                                 (1, 4), (3, 2), (6, 1)])
def test_distributed_planner_equals_reference(devices, row_devices, fresh_plans):
    """``candidates``/``analytic_plan``/``default_plan`` over a mesh, and
    ``tune.plan(devices=, row_devices=)``, at the reference tests' shapes."""
    from repro import tune as jtune
    from repro.tune import cost as jc
    from repro_torch import tune
    from repro_torch.tune import cost as tc

    for m, n in ((1024, 1024), (512, 777), (4096, 2048)):
        for out in ("dense", "packed"):
            kw = dict(out=out, devices=devices, row_devices=row_devices)
            got, want = tc.candidates("ata", m, n, **kw), jc.candidates("ata", m, n, **kw)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _fields_equal(g, w)
            _fields_equal(tc.default_plan("ata", m, n, **kw), jc.default_plan("ata", m, n, **kw))
            _fields_equal(tune.plan(op="ata", m=m, n=n, backend="cpu", **kw),
                          jtune.plan(op="ata", m=m, n=n, backend="cpu", **kw))


def test_comm_model_equals_reference():
    """The α-β model's functions, argument for argument."""
    from repro.tune import cost as jc
    from repro_torch.tune import cost as tc

    jm, tm = jc.machine_for("cpu"), tc.machine_for("cpu")
    assert (tm.alpha_s, tm.beta_s_per_byte, tm.device_memory_bytes) == \
        (jm.alpha_s, jm.beta_s_per_byte, jm.device_memory_bytes)
    for nb in (1, 2, 3, 5, 8, 15, 16, 33):
        assert tc.comm_schedule_candidates(nb) == jc.comm_schedule_candidates(nb)
        assert tc.comm_schedule_candidates(nb, 2) == jc.comm_schedule_candidates(nb, 2)
        for out in ("dense", "packed"):
            assert tc.retrieval_bytes(out, nb, 64) == jc.retrieval_bytes(out, nb, 64)
            for devices, row in ((1, 4), (2, 1), (2, 4), (4, 2), (8, 1), (3, 2)):
                for cs in (None, "D", "B", "BD", "DB", "BDB"):
                    args = (cs, nb, 64, devices, row)
                    assert tc.comm_levels(*args, out=out) == jc.comm_levels(*args, out=out)
                    assert tc.comm_seconds(tm, *args, out=out) == \
                        jc.comm_seconds(jm, *args, out=out)
                    assert tc.comm_memory_bytes(*args, m=4096, out=out) == \
                        jc.comm_memory_bytes(*args, m=4096, out=out)
                    assert tc._bfs_makespan(nb, devices, cs) == jc._bfs_makespan(nb, devices, cs)
                assert tc.choose_comm_schedule(nb, 64, devices, row, m=4096, out=out, n=1000) \
                    == jc.choose_comm_schedule(nb, 64, devices, row, m=4096, out=out, n=1000)
    tight = dataclasses.replace(tm, device_memory_bytes=1.0)
    jtight = jc.Machine(**{f.name: getattr(tight, f.name) for f in dataclasses.fields(jc.Machine)})
    assert tc.choose_comm_schedule(8, 64, 4, 2, m=4096, machine=tight, n=500) == \
        jc.choose_comm_schedule(8, 64, 4, 2, m=4096, machine=jtight, n=500)


def test_tilings_and_distributed_predictions_equal_reference():
    """``distributed_tiling``/``bfs_tiling`` over a grid (the reference's
    ``test_bfs_tiling_*`` invariants hold on the port's) and
    ``predict_seconds``'s distributed arm."""
    from repro.tune import cost as jc
    from repro_torch.tune import cost as tc

    for n in (160, 512, 777, 1024, 4096, 8192):
        for pool in (1, 2, 3, 4, 6, 8, 16):
            for devices in (None, 2, 4):
                nb, w = tc.bfs_tiling(n, pool, devices=devices)
                assert (nb, w) == jc.bfs_tiling(n, pool, devices=devices)
                if pool > 1:
                    assert (nb * (nb + 1) // 2) % pool == 0
                assert nb * w >= n and w % 8 == 0
            for out in ("dense", "packed"):
                assert tc.distributed_tiling(n, pool, out=out) == \
                    jc.distributed_tiling(n, pool, out=out)
                assert tc.distributed_tiling(n, pool, out=out, n_base=128) == \
                    jc.distributed_tiling(n, pool, out=out, n_base=128)
    for devices, row in ((2, 4), (4, 2), (8, 1), (1, 4)):
        for cs in (None, "B", "BD", "D"):
            for ld in ("unrolled", "batched", "fused"):
                kw = dict(out="packed", devices=devices, row_devices=row, comm_schedule=cs,
                          leaf_dispatch=ld)
                got = tc.predict_seconds("ata", "strassen", 1024, 1024, 1024, 256, **kw)
                want = jc.predict_seconds("ata", "strassen", 1024, 1024, 1024, 256, **kw)
                assert abs(got - want) <= 1e-12 * want, (devices, row, cs, ld)
    # the reference's acceptance: BFS under the all-reduce schedule at the
    # bench meshes, and the planner picking a BFS string there
    mach = tc.machine_for("cpu")
    for devices, row in ((2, 4), (4, 2), (8, 1)):
        nb_b, w_b = tc.bfs_tiling(1024, devices * row, devices=devices)
        nb_d, w_d = tc.distributed_tiling(1024, devices, out="packed")
        assert tc.comm_seconds(mach, "B", nb_b, w_b, devices, row) < \
            tc.comm_seconds(mach, None, nb_d, w_d, devices, row)
        top = tc.candidates("ata", 1024, 1024, out="packed", devices=devices, row_devices=row)[0]
        assert top.comm_schedule and "B" in top.comm_schedule


def test_distributed_plan_stays_analytic_under_autotune(tmp_path, fresh_plans):
    """As in the reference: the autotuner times the single-device op, so a
    distributed request with ``autotune=True`` stays analytic and persists
    nothing."""
    from repro_torch import tune

    path = str(tmp_path / "c.json")
    p = tune.plan(op="ata", m=512, n=512, devices=8, autotune=True, cache_file=path,
                  backend="cpu")
    assert p.source == "analytic" and p.nb is not None and p.tile_w is not None
    assert tune.cache.load_cache(path) == {}


def test_cuda_machine_prices_the_interleavings():
    """The cuda machine's nominal α-β terms: NVLink 4's 450 GB/s a
    direction and a 10 µs step; over a mesh its argmin carries a grid and
    an interleaving that fits the 80 GB budget."""
    from repro_torch.tune import cost as tc

    m = tc.machine_for("cuda")
    assert (m.alpha_s, m.beta_s_per_byte, m.device_memory_bytes) == (1e-5, 1 / 450e9, 80e9)
    assert m.budget_single_device and not tc.machine_for("cpu").budget_single_device
    top = tc.candidates("ata", 8192, 8192, out="packed", backend="cuda", devices=4,
                        row_devices=1)[0]
    assert top.devices == 4 and top.nb and top.tile_w
    assert tc.comm_memory_bytes(top.comm_schedule, top.nb, top.tile_w, 4, 1, m=8192,
                                out="packed") <= m.device_memory_bytes
