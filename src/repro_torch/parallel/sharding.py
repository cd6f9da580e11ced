"""Sharding rules: logical axes → mesh axes, with divisibility fallbacks
(port of ``repro.parallel.sharding``).

The production meshes are ``(data=16, model=16)`` and
``(pod=2, data=16, model=16)``. Assigned-pool dimensions are *not* all
divisible by 16 (hymba has 25 heads / 5 kv heads, qwen2-moe has 60 experts,
mamba2's vocab is 50280), so rules degrade gracefully:

* ``pick(dim, candidates)`` returns the first mesh-axis tuple whose size
  divides ``dim`` (None = replicate);
* vocab/embedding tables are padded up to a multiple of
  ``model_axis · 128`` (``pad_vocab``);
* experts are padded up to the model-axis size for EP (qwen2-moe 60 → 64,
  router-masked dummies).

The rules read only ``mesh.shape`` (axis name → size), so they take a
rank's :class:`~repro_torch.launch.mesh.Mesh` or a shape-only
:class:`~repro_torch.launch.mesh.AbstractMesh` alike, and they give the
reference's ``PartitionSpec`` trees entry for entry, as :class:`P` trees.

How the port holds a spec. The reference hands its trees to GSPMD; the
port runs one process per rank, and a rank holds a leaf as its block of
the global array under a spec (:func:`local_block`; :func:`gather` puts
the blocks back together). What a rank holds is the spec itself
(:func:`held`), with one fallback: a ``model`` entry on a dim the
``model`` axis does not divide is dropped, and the rank holds that dim
whole (GSPMD pads such a dim; the port's layers compute with it whole).
So the dense weights are the rank's tensor-parallel blocks (q/k/v/o by
heads or, where the heads do not divide the axis, by ``d_model``; the
MLPs by ``d_ff``; the SSM's ``d_inner``; the embedding and ``lm_head``
by vocab), the expert weights its experts, and the ``data`` entries
(ZeRO-1 moments, Shampoo's owned stat blocks, the batch) and the cache's
``model`` entries (its sequence chunk, SSD heads and conv channels) its
blocks. ``models`` computes with those blocks and the explicit
collectives of ``launch.collectives``.

A global batch the data axes do not divide has its sequence sharded over
them instead (:func:`batch_spec`, :func:`batch_input_specs`), as in the
reference (the long-context single-sequence cells).

Departure: ``MeshAxes`` is named in the reference's ``__all__`` but never
defined there, so the port has nothing to export under that name.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = [
    "P",
    "pad_vocab",
    "pad_experts",
    "pick",
    "param_specs",
    "batch_spec",
    "activation_spec",
    "cache_specs",
    "batch_input_specs",
    "data_axes",
    "named",
    "NamedSharding",
    "held",
    "local_block",
    "gather",
    "gather_tree",
    "map_specs",
    "map_named",
    "leaf_shape",
    "spec_leaves",
    "global_shape",
]

AxisT = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per leading dim, an axis name, a tuple
    of names (merged, the first slowest) or None (replicated). A tuple, so
    it compares equal entry for entry with ``tuple(jax PartitionSpec)``;
    entries are canonicalized as ``PartitionSpec`` does it (a tuple of one
    name is the name, an empty tuple is None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canon(a) for a in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _canon(axes):
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


class NamedSharding(NamedTuple):
    """A spec placed on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure-DP axes: ('pod', 'data') when multi-pod, else ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _axes_size(mesh, axes: AxisT) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def pick(mesh, dim: int, candidates: Sequence[AxisT]) -> AxisT:
    """First candidate axis (tuple) whose total size divides ``dim``."""
    for cand in candidates:
        if dim % _axes_size(mesh, cand) == 0:
            return cand
    return None


def pad_vocab(vocab: int, mesh) -> int:
    """Pad vocab to a multiple of model_axis·128."""
    mult = mesh.shape.get("model", 1) * 128
    return -(-vocab // mult) * mult


def pad_experts(num_experts: int, mesh) -> int:
    """Pad routed-expert count up to a multiple of the model axis for EP."""
    m = mesh.shape.get("model", 1)
    return -(-num_experts // m) * m


def batch_spec(mesh, shape: ShapeConfig) -> P:
    """Token batch (B, S) sharding: B over DP axes; for global_batch too
    small to shard (long_500k B=1), shard the sequence instead."""
    dp = data_axes(mesh)
    if shape.global_batch % _axes_size(mesh, dp) == 0:
        return P(dp, None)
    if shape.seq_len % _axes_size(mesh, dp) == 0:
        return P(None, dp)
    return P(None, None)


def activation_spec(mesh, shape: ShapeConfig) -> P:
    """(B, S, D) activations."""
    bs = batch_spec(mesh, shape)
    return P(bs[0], bs[1], None)


def _div(mesh, dim: int, axes: AxisT) -> bool:
    return (axes is not None and dim % _axes_size(mesh, axes) == 0
            and dim >= _axes_size(mesh, axes))


def leaf_shape(x) -> tuple:
    """A leaf's shape: a tensor's, a packed matrix's block array's, () for
    a number."""
    x = getattr(x, "blocks", x)         # SymmetricMatrix, CholeskyFactor
    return tuple(getattr(x, "shape", ()))


def map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over a tree of dicts/lists/tuples, ``name`` the
    nearest enclosing dict key (``jax.tree_util.DictKey``)."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def map_specs(fn, *trees):
    """``fn`` over the leaves of spec trees (P or NamedSharding leaves) and
    the trees beside them, which must have the spec trees' structure down
    to the specs."""
    first = trees[0]
    if isinstance(first, (P, NamedSharding)):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: map_specs(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_specs(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree in the leaf order of ``optim._tree``'s
    flatten (dicts in sorted key order)."""
    if isinstance(spec_tree, (P, NamedSharding)):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree) for s in spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, (list, tuple)):
        return [s for v in spec_tree for s in spec_leaves(v)]
    return [spec_tree]


def global_shape(x, mesh, spec) -> tuple:
    """The global shape of a block ``x`` held under ``spec``."""
    shape = list(leaf_shape(x))
    for d, axes in enumerate(spec):
        if axes is not None:
            shape[d] *= mesh.axis_size(axes)
    return tuple(shape)


def cache_specs(mesh, cfg: ModelConfig, cache_abs) -> dict:
    """Spec tree for a decode cache (``init_cache`` structure).

    * ``k``/``v`` leaves (…, S_cache, KV, HD): batch → DP axes, cache
      sequence → ``model`` (sequence-parallel decode);
    * ``h`` SSD states (…, B, H, P, N): batch → DP, then H (or P) → model;
    * ``conv`` states (…, B, K-1, C): batch → DP, channels → model.
    """
    dp = data_axes(mesh)
    m = "model" if "model" in mesh.shape else None

    def leaf_spec(name, ab):
        shape = leaf_shape(ab)
        nd = len(shape)
        parts = [None] * nd
        if name in ("k", "v"):
            b_i, s_i = nd - 4, nd - 3
            if _div(mesh, shape[b_i], dp):
                parts[b_i] = dp
            if m and _div(mesh, shape[s_i], m):
                parts[s_i] = m
        elif name == "h":
            b_i = nd - 4
            if _div(mesh, shape[b_i], dp):
                parts[b_i] = dp
            for i in (nd - 3, nd - 2):
                if m and _div(mesh, shape[i], m):
                    parts[i] = m
                    break
        elif name == "conv":
            b_i = nd - 3
            if _div(mesh, shape[b_i], dp):
                parts[b_i] = dp
            if m and _div(mesh, shape[nd - 1], m):
                parts[nd - 1] = m
        return P(*parts)

    return map_named(leaf_spec, cache_abs)


def batch_input_specs(mesh, batch_abs) -> dict:
    """Spec tree for model inputs (tokens/labels/image_embeds/pos): batch
    dim → DP axes when divisible, else the sequence dim (long-context
    single-sequence cells)."""
    dp = data_axes(mesh)

    def leaf_spec(name, ab):
        shape = leaf_shape(ab)
        parts = [None] * len(shape)
        if len(shape) >= 1 and _div(mesh, shape[0], dp):
            parts[0] = dp
        elif len(shape) >= 2 and _div(mesh, shape[1], dp):
            parts[1] = dp
        return P(*parts)

    return map_named(leaf_spec, batch_abs)


def param_specs(mesh, cfg: ModelConfig) -> dict:
    """Spec tree matching the param tree of ``models.transformer.init``."""
    m = "model" if "model" in mesh.shape else None
    h, kv = cfg.num_heads, cfg.num_kv_heads

    # attention projections: prefer head-sharding (column-parallel), fall
    # back to contract-dim (row-parallel) sharding on d_model
    q_spec = P(None, m, None) if m and h % mesh.shape["model"] == 0 else P(m, None, None)
    kv_spec = P(None, m, None) if m and kv % mesh.shape["model"] == 0 else P(m, None, None)
    o_spec = P(m, None, None) if m and h % mesh.shape["model"] == 0 else P(None, None, m)

    specs: dict = {"embed": P(m, None), "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, m)

    layer: dict = {}
    if cfg.family != "ssm":
        attn = {"wq": q_spec, "wk": kv_spec, "wv": kv_spec, "wo": o_spec, "norm": P(None)}
        if cfg.qkv_bias:
            attn["bq"] = P(m, None) if q_spec == P(None, m, None) else P(None, None)
            attn["bk"] = P(m, None) if kv_spec == P(None, m, None) else P(None, None)
            attn["bv"] = attn["bk"]
        layer["attn"] = attn

    if cfg.ssm is not None:
        layer["ssm"] = {
            "x_proj": P(None, m), "z_proj": P(None, m),
            "bc_proj": P(None, None), "dt_proj": P(None, None),
            "conv": P(m, None), "a_log": P(None), "d_skip": P(None),
            "gnorm": P(m), "out_proj": P(m, None), "norm": P(None),
        }

    if cfg.moe is not None:
        ep_ok = cfg.moe.sharding == "ep"
        e_axis = m if ep_ok else None
        f_axis = None if ep_ok else m
        layer["moe"] = {
            "router": P(None, None),
            "wg": P(e_axis, None, f_axis),
            "wu": P(e_axis, None, f_axis),
            "wd": P(e_axis, f_axis, None),
            "norm": P(None),
        }
        if cfg.moe.num_shared:
            layer["shared_mlp"] = {"wg": P(None, m), "wu": P(None, m), "wd": P(m, None)}
    elif cfg.d_ff:
        layer["mlp"] = {"wg": P(None, m), "wu": P(None, m), "wd": P(m, None), "norm": P(None)}

    if cfg.scan_layers:
        specs["layers"] = map_specs(lambda s: P(None, *s), layer)
    else:
        specs["layers"] = [layer for _ in range(cfg.num_layers)]
    return specs


def named(mesh, spec_tree):
    """The spec tree as :class:`NamedSharding` leaves on ``mesh``."""
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# holding a spec: this rank's block, and the blocks gathered back
# ---------------------------------------------------------------------------


def held(spec_tree, cfg: ModelConfig, mesh=None):
    """The part of a param-shaped spec tree (``param_specs``, or a state
    tree whose ``params``/``m``/``v`` mirror it) a rank holds as blocks:
    every entry of the spec, except that with a ``mesh`` a ``model`` entry
    on a dim the ``model`` axis does not divide is dropped (the rank holds
    that dim whole). Without a mesh the specs come back as they are."""
    if mesh is None or "model" not in mesh.shape:
        return spec_tree
    shapes = _global_shapes(cfg, tuple(mesh.shape.items()))
    return _held(spec_tree, shapes, mesh)


def _held(spec_tree, shapes, mesh):
    if isinstance(spec_tree, dict):
        if set(spec_tree) == set(shapes) and "embed" in spec_tree:
            # a tree that mirrors the parameters: its specs meet their shapes
            return _fit(spec_tree, shapes, mesh)
        return {k: _held(v, shapes, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)) and not isinstance(spec_tree, P):
        return type(spec_tree)(_held(v, shapes, mesh) for v in spec_tree)
    return spec_tree


def _fit(spec, shape, mesh):
    """``spec`` without its ``model`` entries on dims of ``shape`` that the
    ``model`` axis does not divide, over a spec tree and the tree of its
    leaves' shapes (a subtree that is not a spec, such as Shampoo's
    per-leaf state, passes as it is)."""
    if isinstance(spec, dict) and isinstance(shape, dict):
        return {k: _fit(v, shape[k], mesh) if k in shape else v for k, v in spec.items()}
    if isinstance(spec, list) and isinstance(shape, list):
        return [_fit(v, sh, mesh) for v, sh in zip(spec, shape)]
    if not isinstance(spec, P) or not isinstance(shape, tuple):
        return spec
    return P(*(_drop_model(a) if a is not None and "model" in _names(a)
               and not _div(mesh, shape[d], "model") else a for d, a in enumerate(spec)))


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@functools.lru_cache(maxsize=64)
def _global_shapes(cfg: ModelConfig, mesh_shape: tuple):
    """The global shape of every parameter leaf of ``cfg`` on a mesh of
    ``mesh_shape`` (``transformer.init`` on the ``meta`` device)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.transformer import init

    mesh = AbstractMesh([n for _, n in mesh_shape], [a for a, _ in mesh_shape])
    return map_specs(lambda x: tuple(x.shape), init(None, cfg, mesh, device="meta"))


def _drop_model(axes: AxisT) -> AxisT:
    if axes == "model":
        return None
    if isinstance(axes, tuple):
        kept = tuple(a for a in axes if a != "model")
        return kept or None
    return axes


def _entries(spec, nd: int) -> list:
    return list(spec) + [None] * (nd - len(spec))


def local_block(x: torch.Tensor, mesh, spec: P, have: Optional[P] = None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (``Mesh.local_block``).
    ``x`` is the global array, or a block already held under ``have`` (a
    spec whose entries are each None or equal to ``spec``'s: those dims are
    not cut again)."""
    if hasattr(x, "blocks"):
        return type(x)(local_block(x.blocks, mesh, spec, have), x.n, x.bn)
    want = _entries(spec, x.dim())
    got = _entries(have or P(), x.dim())
    for d, (axes, had) in enumerate(zip(want, got)):
        if had is not None and had != axes:
            raise ValueError(f"dim {d} is held under {had!r}, not {axes!r}")
    return mesh.local_block(x, [None if a == h else a for a, h in zip(want, got)])


def gather(x: torch.Tensor, mesh, spec: P, keep: Optional[P] = None) -> torch.Tensor:
    """The blocks of ``x`` (held under ``spec``) gathered back along every
    dim whose spec entry is not also ``keep``'s: the global array when
    ``keep`` is None. Collective over the axes gathered (every rank of
    them must call it); not differentiable."""
    from repro_torch.launch import collectives

    if hasattr(x, "blocks"):
        return type(x)(gather(x.blocks, mesh, spec, keep), x.n, x.bn)
    want = _entries(spec, x.dim())
    kept = _entries(keep or P(), x.dim())
    for d, (axes, k) in enumerate(zip(want, kept)):
        if axes is None or axes == k or mesh.axis_size(axes) == 1:
            continue
        x = collectives.all_gather_dim(x, mesh, axes, d)
    return x


def gather_tree(tree, mesh, spec_tree):
    """:func:`gather` over a tree and its spec tree."""
    return map_specs(lambda s, x: gather(x, mesh, s), spec_tree, tree)
