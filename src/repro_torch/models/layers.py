"""Shared transformer layers: norms, RoPE, GQA attention (flash-style
chunked for training and prefill, one token against a cache for decode),
gated MLPs (port of ``repro.models.layers``).

Plain functions over parameter dicts of tensors, as in the reference. The
reference has no Pallas kernel here (its attention is chunked ``jnp``), and
neither has the port: the einsums and products are ``torch`` ops.

Where the reference writes a projection as an ``einsum`` with no batch
dimension, the port writes ``torch.matmul`` against the weight flattened to
two dimensions: that runs one ``aten.mm`` (``torch.einsum`` always runs
``aten.bmm``), which the ``"dots"`` remat policy of
``models.transformer`` saves, as ``dots_with_no_batch_dims_saveable``
saves those dots in the reference.

Departures:

* the reference computes scores, softmax statistics and norms in float32
  whatever the compute dtype; the port computes them in the promotion of
  the compute dtype and float32 (:func:`acc_dtype`), which is float32 for
  bfloat16 and float32 compute and float64 for float64 compute, so a
  float64 step is a float64 reference all through;
* query and key/value blocks are slices of the sequence, the last one
  short, where the reference pads both to whole blocks (its padded keys
  are masked and its padded queries dropped, so the real rows agree);
* :func:`attention_decode` writes the new key and value into the cache
  tensors it is given, in place, and returns them; the reference returns
  fresh arrays. A cache is therefore used once: after a step, only the
  returned one is current;
* :func:`attention_decode_sp` masks the slots of its chunk by the three
  validity rules of :func:`attention_decode` (absolute cache, ring buffer,
  absolute cache with a window), where the reference's sequence-parallel
  decode applies the last rule to every windowed cache; they differ on a
  ring buffer after it wraps, where the port's agrees with
  ``attention_decode``.

The mesh paths run on one process per rank (``launch.mesh``), every rank
with its own block of the batch and its blocks of the weights
(``parallel.sharding.held(param_specs)``):

* tensor parallelism (:func:`attn_modes`): q/k/v are column-parallel
  over the heads where the heads divide the ``model`` axis, else
  row-parallel over ``d_model`` (the rank's slice of ``x`` by its rows,
  summed: the reference's fallback spec); the rank attends with its query
  heads and the kv heads they group to; ``wo`` is row-parallel over the
  heads (summed) or, under the fallback, column-parallel over ``d_model``
  (gathered); :func:`mlp_gated` is column- then row-parallel. A
  replicated input each rank uses for its part is marked with
  ``launch.collectives.sum_grads``; a row-parallel sum is
  ``reduce_replicas``;
* :func:`attention_train_cp` (context-parallel attention, for head counts
  that do not divide the ``model`` axis): the weights are gathered whole
  (``gather_params``, whose backward pass sums the ranks' partial
  gradients and keeps the block), each ``model`` rank attends with its
  slice of the queries against the keys and values of the whole sequence
  and the slices are gathered (``gather_replicas``);
* :func:`attention_decode_sp` (sequence-parallel decode): each rank holds
  its chunk of the cache sequence, gathers every head's q/k/v, writes the
  new key and value only if the slot is in its chunk, and the ranks
  combine their softmax statistics with all-reduces of the maximum, the
  denominator and the accumulator (the flash-decode combine), then apply
  their block of ``wo``; :func:`attention_decode` with a mesh decodes a
  whole cache on the rank's heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import collectives as C

__all__ = [
    "rms_norm",
    "rope",
    "attention_train",
    "attention_decode",
    "attention_decode_sp",
    "attention_train_cp",
    "mlp_gated",
    "init_attn",
    "init_mlp",
]

# flash-attention block sizes (chunked attention in torch ops)
Q_BLOCK = 2048
KV_BLOCK = 1024


def model_ranks(mesh) -> int:
    """Ranks on the mesh's ``model`` axis (1 without a mesh or axis)."""
    if mesh is None:
        return 1
    return mesh.shape.get("model", 1)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the reference's float32 statistics under compute
    ``dtype``: float32, or float64 for float64 compute."""
    return torch.promote_types(dtype, torch.float32)


def remat(fn, *args):
    """``fn(*args)``, checkpointed while autograd records (the backward
    pass recomputes it, as ``jax.checkpoint`` does); a plain call under
    ``torch.no_grad()`` (prefill and decode), where there is no backward
    pass to save for."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def normal(generator, shape, scale: float, device) -> torch.Tensor:
    """``N(0, 1)·scale`` float32 draws on ``device`` from ``generator`` (a
    ``torch.Generator`` on that device, or None for the default); on the
    ``meta`` device, a tensor with no storage."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device) * scale


def padded(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``size``."""
    if x.shape[dim] == size:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, size - x.shape[dim]]
    return F.pad(x, pad)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    acc = acc_dtype(dtype)
    x = x.to(acc)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.to(acc))).to(dtype)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embeddings. x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attn(generator, cfg, device="cuda", lead=()) -> dict:
    """One attention block's parameters, each with the leading dims
    ``lead`` (``(num_layers,)`` for the stacked layers of
    ``transformer.init``)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = d ** -0.5
    p = {
        "wq": normal(generator, (*lead, d, h, hd), scale, device),
        "wk": normal(generator, (*lead, d, kv, hd), scale, device),
        "wv": normal(generator, (*lead, d, kv, hd), scale, device),
        "wo": normal(generator, (*lead, h, hd, d), (h * hd) ** -0.5, device),
        "norm": torch.zeros((*lead, d), dtype=torch.float32, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h, hd), dtype=torch.float32, device=device)
        p["bk"] = torch.zeros((*lead, kv, hd), dtype=torch.float32, device=device)
        p["bv"] = torch.zeros((*lead, kv, hd), dtype=torch.float32, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one ``aten.mm``."""
    d = w.shape[0]
    out = torch.matmul(x, w.to(x.dtype).reshape(d, -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# tensor parallelism over the ``model`` axis
# ---------------------------------------------------------------------------


def splits(n: int, m: int) -> bool:
    """Whether ``m > 1`` ranks split a dim of ``n`` (``parallel.sharding``'s
    divisibility rule: a dim they do not divide is held whole)."""
    return m > 1 and n % m == 0 and n >= m


def attn_modes(cfg, mesh) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """How a rank holds wq, wk/wv and wo (``held(param_specs)``): ``"heads"``
    (a block of the heads; wo's rows), ``"dmodel"`` (a block of ``d_model``:
    the contract dim of q/k/v, the output dim of wo) or None (whole)."""
    m = model_ranks(mesh)
    if m == 1:
        return None, None, None
    fall = "dmodel" if splits(cfg.d_model, m) else None
    q = "heads" if splits(cfg.num_heads, m) else fall
    kv = "heads" if splits(cfg.num_kv_heads, m) else fall
    return q, kv, q


def model_block(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This ``model`` rank's block of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // mesh.shape["model"]
    return x.narrow(dim, mesh.axis_index("model") * n, n)


def _project(x, x_sg, w, b, mode, mesh, partial_use: bool):
    """One of q/k/v, (B, S, heads, hd): the rank's heads (``"heads"``, a
    column-parallel product of ``x_sg``) or all heads (``"dmodel"``: the
    rank's ``d_model`` slice of ``x_sg`` by its row block, summed over
    ``model``; None: the whole product of ``x``). ``partial_use``: the
    rank uses the whole result for its own heads only, so its cotangent is
    summed over ``model``."""
    if mode == "heads":
        out = _proj(x_sg, w)
        return out if b is None else out + b.to(x.dtype)
    if mode == "dmodel":
        out = C.reduce_replicas(_proj(model_block(x_sg, mesh, -1), w), mesh, "model")
    else:
        out = _proj(x, w)
    if b is not None:
        out = out + b.to(x.dtype)
    return C.sum_grads(out, mesh, "model") if partial_use and mesh is not None else out


def _group_kv(k, v, hq: int, cfg, mesh, q_mode, kv_mode):
    """The kv heads the rank's ``hq`` query heads group to, and their group
    size: the rank's own kv heads when both are split by heads, every kv
    head when the queries are all heads, else the slice of the whole k/v."""
    groups = cfg.num_heads // cfg.num_kv_heads
    if q_mode != "heads" or kv_mode == "heads":
        return k, v, hq // k.shape[2]
    j = mesh.axis_index("model")
    lo = j * hq // groups
    if hq % groups == 0:
        n = hq // groups
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n], groups
    if groups % hq == 0:
        return k[:, :, lo:lo + 1], v[:, :, lo:lo + 1], hq
    idx = (j * hq + torch.arange(hq, device=k.device)) // groups
    return k[:, :, idx], v[:, :, idx], 1


def _project_qkv(p, x, cfg, positions, mesh=None):
    """The rank's roped q and k and its v: (q, k, v) with q the rank's heads
    or all heads, k/v its kv heads or all (:func:`attn_modes`)."""
    qm, kvm, _ = attn_modes(cfg, mesh)
    # a replicated input each rank uses for its part of the heads (or of
    # d_model): its cotangent is summed over ``model``
    x_sg = C.sum_grads(x, mesh, "model") if (qm or kvm) else x
    partial_kv = qm == "heads" and kvm != "heads"
    q = _project(x, x_sg, p["wq"], p.get("bq"), qm, mesh, False)
    k = _project(x, x_sg, p["wk"], p.get("bk"), kvm, mesh, partial_kv)
    v = _project(x, x_sg, p["wv"], p.get("bv"), kvm, mesh, partial_kv)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o, wo, mesh, mode) -> torch.Tensor:
    """``o`` (B, S, heads·hd) by wo: row-parallel over the rank's heads
    then summed (``"heads"``), column-parallel over ``d_model`` then
    gathered (``"dmodel"``), or whole."""
    w = wo.to(o.dtype).reshape(-1, wo.shape[-1])
    if mode == "heads":
        return C.reduce_replicas(torch.matmul(o, w), mesh, "model")
    if mode == "dmodel":
        y = torch.matmul(C.sum_grads(o, mesh, "model"), w)
        return C.gather_replicas(y, mesh, "model", y.dim() - 1)
    return torch.matmul(o, w)


def _all_kv(k, v, mesh, kv_mode):
    """Every kv head of k/v (the cache's layout): the rank's heads gathered
    over ``model`` under ``"heads"``."""
    if kv_mode != "heads":
        return k, v
    return (C.gather_replicas(k, mesh, "model", 2), C.gather_replicas(v, mesh, "model", 2))


def _kv_step(m_i, l_i, acc, q_blk, k_c, v_c, q_pos, pos_c, window, scale, groups):
    """One KV block of the flash recurrence: the running (max, denominator,
    accumulator) after attending ``q_blk`` to ``k_c``/``v_c``."""
    if groups > 1:   # GQA: expand kv heads
        k_c = torch.repeat_interleave(k_c, groups, dim=2)
        v_c = torch.repeat_interleave(v_c, groups, dim=2)
    scores = torch.einsum("bqhd,bchd->bhqc", q_blk, k_c).to(m_i.dtype)
    scores = scores * scale
    causal = q_pos[:, None] >= pos_c[None, :]          # (Qb, C)
    if window is not None:
        causal = causal & ((q_pos[:, None] - pos_c[None, :]) < window)
    scores = torch.where(causal[None, None], scores, -1e30)
    m_new = torch.maximum(m_i, scores.amax(dim=-1))    # (B,H,Qb)
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m_i - m_new)
    l_new = l_i * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhqc,bchd->bhqd", p.to(v_c.dtype), v_c).to(acc.dtype)
    return m_new, l_new, acc


def _flash_body(q_blk, k, v, q_pos, kv_pos, window, scale, groups):
    """Attend one query block against all KV blocks with running softmax.

    q_blk: (B, Qb, H, D); k/v: (B, S, KV, D). Returns (B, Qb, H, D).
    Chunked over KV with running (max, denom, acc) in :func:`acc_dtype` —
    the flash recurrence — so the (S × S) score matrix is never
    materialized. Each KV step is checkpointed (the reference's
    ``jax.checkpoint``, :func:`remat`): the backward pass recomputes the
    (B, H, Qb, C) score and probability blocks instead of keeping S² of
    them.
    """
    b, qb, h, hd = q_blk.shape
    s = k.shape[1]
    acc_t = acc_dtype(q_blk.dtype)
    m = torch.full((b, h, qb), -1e30, dtype=acc_t, device=q_blk.device)
    l = torch.zeros((b, h, qb), dtype=acc_t, device=q_blk.device)
    acc = torch.zeros((b, h, qb, hd), dtype=acc_t, device=q_blk.device)
    for c0 in range(0, s, KV_BLOCK):
        c1 = min(c0 + KV_BLOCK, s)
        m, l, acc = remat(_kv_step, m, l, acc, q_blk, k[:, c0:c1], v[:, c0:c1], q_pos,
                          kv_pos[c0:c1], window, scale, groups)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q_blk.dtype)  # (B, Qb, H, D)


def attention_train(
    p: dict,
    x: torch.Tensor,
    cfg,
    *,
    window: Optional[int] = None,
    return_kv: bool = False,
    mesh=None,
):
    """Causal (optionally sliding-window) self-attention, flash-chunked.

    x: (B, S, D) → (B, S, D). Never materializes S×S scores; used for both
    train and prefill. With ``return_kv`` also returns the roped (k, v)
    (B, S, KV, D) for prefill cache construction. ``window`` is an int, a
    0-d tensor (a scanned hybrid stack's window as data) or None. With a
    mesh of several ``model`` ranks, ``p`` holds the rank's blocks
    (:func:`attn_modes`): the rank attends with its query heads and the kv
    heads they group to, ``x`` and the result are whole on every rank, and
    ``return_kv`` gives every kv head.
    """
    b, s, d = x.shape
    qm, kvm, om = attn_modes(cfg, mesh)
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions[None, :], mesh)
    k_att, v_att, groups = _group_kv(k, v, q.shape[2], cfg, mesh, qm, kvm)
    scale = cfg.head_dim ** -0.5

    out = _flash_blocks(q, k_att, v_att, positions, positions, window, scale, groups)
    out = _out_proj(out.reshape(b, s, -1), p["wo"], mesh, om)
    if return_kv:
        return out, _all_kv(k, v, mesh, kvm)
    return out


def _flash_blocks(q, k, v, q_pos, kv_pos, window, scale, groups):
    """:func:`_flash_body` over the query blocks of ``q`` (B, Sq, H, D)."""
    sq = q.shape[1]
    outs = [_flash_body(q[:, q0:q0 + Q_BLOCK], k, v, q_pos[q0:q0 + Q_BLOCK], kv_pos,
                        window, scale, groups)
            for q0 in range(0, sq, Q_BLOCK)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _whole_attn(p, cfg, mesh) -> dict:
    """The attention weights whole on every ``model`` rank, for a region
    that reads them whole and computes its own part of the work: each held
    block gathered (``gather_params``: the backward pass sums the ranks'
    partial gradients and keeps the block), each whole leaf marked
    (``sum_grads``)."""
    qm, kvm, om = attn_modes(cfg, mesh)
    dims = {"wq": {"heads": 1, "dmodel": 0}.get(qm), "bq": {"heads": 0}.get(qm),
            "wo": {"heads": 0, "dmodel": 2}.get(om)}
    for k in ("wk", "wv"):
        dims[k] = {"heads": 1, "dmodel": 0}.get(kvm)
    for k in ("bk", "bv"):
        dims[k] = {"heads": 0}.get(kvm)
    return {k: (C.sum_grads(p[k], mesh, "model") if dims[k] is None
                else C.gather_params(p[k], mesh, "model", dims[k]))
            for k in dims if k in p}


def attention_train_cp(p: dict, x: torch.Tensor, cfg, mesh, *, window=None,
                       return_kv: bool = False, seq_axis: str = "model"):
    """Context-parallel :func:`attention_train`: the queries' sequence is
    split over ``seq_axis`` (``"model"``). x: (B, S, D), the same on every
    rank of the axis → (B, S, D), gathered. As the reference's
    ``shard_map`` takes the weights whole, the rank's blocks are gathered
    (:func:`_whole_attn`); each rank projects the queries of its slice and
    the keys and values of the whole sequence (absolute positions), runs
    the flash body on its slice, then ``wo``; ``return_kv`` gives the whole
    (k, v). Falls back to :func:`attention_train` when the axis does not
    divide S, as the reference does."""
    b, s, d = x.shape
    n_seq = mesh.shape[seq_axis]
    if s % n_seq:
        return attention_train(p, x, cfg, window=window, return_kv=return_kv, mesh=mesh)
    s_loc = s // n_seq
    j = mesh.axis_index(seq_axis)
    groups = cfg.num_heads // cfg.num_kv_heads
    scale = cfg.head_dim ** -0.5
    # a replicated input each rank uses for its own queries only
    x = C.sum_grads(x, mesh, seq_axis)
    w = _whole_attn(p, cfg, mesh)
    q = _proj(x[:, j * s_loc:(j + 1) * s_loc], w["wq"])
    k = _proj(x, w["wk"])
    v = _proj(x, w["wv"])
    if cfg.qkv_bias:
        q = q + w["bq"].to(x.dtype)
        k = k + w["bk"].to(x.dtype)
        v = v + w["bv"].to(x.dtype)
    kv_pos = torch.arange(s, device=x.device)
    q_pos = kv_pos[j * s_loc:(j + 1) * s_loc]
    q = rope(q, q_pos[None, :], cfg.rope_theta)
    k = rope(k, kv_pos[None, :], cfg.rope_theta)
    out = _flash_blocks(q, k, v, q_pos, kv_pos, window, scale, groups)
    out = torch.matmul(out.reshape(b, s_loc, -1), w["wo"].to(x.dtype).reshape(-1, d))
    out = C.gather_replicas(out, mesh, seq_axis, 1)
    if return_kv:
        return out, (k, v)
    return out


def _valid_slots(slots, pos, s_cache: int, window):
    """(B, len(slots)) mask of the cache slots (absolute indices ``slots``
    of a cache of ``s_cache``) a query at ``pos`` attends to. A slot holds
    an absolute position; with a ring buffer the absolute position of slot c
    is recoverable from (pos, window)."""
    slots = slots[None, :]
    pos_c = pos.to(torch.int64)[:, None]
    if window is None:
        return slots <= pos_c                   # slot index == position
    if isinstance(window, int) and window == s_cache:
        # ring buffer: before it wraps, slots <= pos; after, every slot
        return (slots <= pos_c) | (pos_c >= s_cache)
    # absolute cache, a (possibly tensor) window: causal and distance
    return (slots <= pos_c) & ((pos_c - slots) < window)


def _full_heads(x, w, b, mode, mesh):
    """All heads of one of q/k/v on every rank (decode: the rank's block
    gathered, or its partial product summed)."""
    if mode == "heads":
        out = _proj(x, w)
        if b is not None:
            out = out + b.to(x.dtype)
        return C.all_gather_dim(out, mesh, "model", 2)
    if mode == "dmodel":
        out = C.all_reduce(_proj(model_block(x, mesh, -1), w), mesh.group("model"))
    else:
        out = _proj(x, w)
    return out if b is None else out + b.to(x.dtype)


def _decode_qkv(p, x, cfg, pos, mesh=None):
    """Every head's roped q and k and v, (B, 1, heads, hd), on every rank."""
    qm, kvm, _ = attn_modes(cfg, mesh)
    q = _full_heads(x, p["wq"], p.get("bq"), qm, mesh)
    k = _full_heads(x, p["wk"], p.get("bk"), kvm, mesh)
    v = _full_heads(x, p["wv"], p.get("bv"), kvm, mesh)
    return rope(q, pos[:, None], cfg.rope_theta), rope(k, pos[:, None], cfg.rope_theta), v


def _decode_out(out, p, cfg, mesh, mode) -> torch.Tensor:
    """Every head's attention output (B, 1, H·hd) by wo: the rank's heads by
    its rows of wo, summed over ``model`` (``"heads"``), its output columns
    gathered (``"dmodel"``), or whole."""
    w = p["wo"].to(out.dtype).reshape(-1, p["wo"].shape[-1])
    if mode == "heads":
        b, s_, _ = out.shape
        mine = model_block(out.reshape(b, s_, cfg.num_heads, -1), mesh, 2).reshape(b, s_, -1)
        return C.all_reduce(torch.matmul(mine, w), mesh.group("model"))
    y = torch.matmul(out, w)
    if mode == "dmodel":
        return C.all_gather_dim(y, mesh, "model", y.dim() - 1)
    return y


def attention_decode(
    p: dict,
    x: torch.Tensor,
    cfg,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    *,
    window=None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step with a (ring-buffered when windowed) KV cache.

    x: (B, 1, D); cache_k/v: (B, S_cache, KV, D) — stores *roped* keys at
    absolute slot ``pos % S_cache``; pos: (B,) absolute positions.
    Returns (out (B,1,D), cache_k, cache_v). The new key and value are
    written into ``cache_k`` and ``cache_v`` in place (the reference
    returns updated copies): the returned caches are the ones passed in.

    ``window``: None (an absolute cache), an int equal to ``S_cache`` (a
    ring buffer, every slot valid once ``pos >= S_cache``), or any other
    int or a 0-d tensor (an absolute cache masked by distance < window).

    With a mesh of several ``model`` ranks, ``p`` holds the rank's blocks
    and the cache is whole on every rank (a cache length the axis does not
    divide): every rank writes every kv head, attends with its query heads
    (every head where the heads do not divide the axis) and applies its
    block of ``wo``.
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    qm, kvm, om = attn_modes(cfg, mesh)
    q, k, v = _decode_qkv(p, x, cfg, pos, mesh)

    rows = torch.arange(b, device=x.device)
    slot = pos.to(torch.int64) % s_cache
    cache_k.index_put_((rows, slot), k[:, 0].to(cache_k.dtype))
    cache_v.index_put_((rows, slot), v[:, 0].to(cache_v.dtype))

    ck, cv = cache_k, cache_v
    if qm == "heads":
        q = model_block(q, mesh, 2)
        ck, cv, _ = _group_kv(ck, cv, q.shape[2], cfg, mesh, qm, None)
    b, s_, hq, hd_ = q.shape
    kvh = ck.shape[2]
    groups = hq // kvh
    acc = acc_dtype(x.dtype)
    # grouped-query einsum — no materialized repeat of the KV cache
    qk_t = torch.promote_types(q.dtype, ck.dtype)
    qg = q.reshape(b, s_, kvh, groups, hd_).to(qk_t)
    scores = torch.einsum("bskgd,bckd->bkgsc", qg, ck.to(qk_t)).to(acc)
    scores = scores.reshape(b, hq, s_, -1)
    scores = scores * (cfg.head_dim ** -0.5)

    slots = torch.arange(s_cache, device=x.device)
    valid = _valid_slots(slots, pos, s_cache, window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    wg = w.reshape(b, kvh, groups, s_, -1)
    out = torch.einsum("bkgsc,bckd->bskgd", wg, cv)
    out = out.reshape(b, s_, hq * hd_).to(x.dtype)
    if om == "heads":
        wo = p["wo"].to(x.dtype).reshape(-1, x.shape[-1])
        out = C.all_reduce(torch.matmul(out, wo), mesh.group("model"))
    else:
        out = _decode_out(out, p, cfg, mesh, om)
    return out, cache_k, cache_v


def attention_decode_sp(
    p: dict,
    x: torch.Tensor,
    cfg,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    mesh,
    *,
    window=None,
    seq_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention with the KV cache **sequence-chunked over**
    ``seq_axis``: this rank's cache_k/v are (B, S_cache / n, KV, D), chunk
    ``j`` of the axis' ``n`` holding slots ``[j·S/n, (j+1)·S/n)``.

    * ``p`` holds the rank's tensor-parallel blocks: the rank's q/k/v heads
      are gathered over ``model`` (every head, (B, 1, H, hd), is small);
    * the new (roped) key and value are written, in place, only by the rank
      whose chunk holds slot ``pos % S_cache`` (a predicated write: the
      others write back the slot's old value);
    * each rank attends over its chunk with grouped-query heads (no repeat
      of the cache), and the ranks combine their partial softmax with an
      all-reduce of the maximum, then of the denominator and the
      accumulator (the flash-decode combine);
    * ``wo`` is applied by the rank's block (:func:`_decode_out`).

    Returns (out (B,1,D), cache_k, cache_v) like :func:`attention_decode`.
    """
    b = x.shape[0]
    n_seq = mesh.shape[seq_axis]
    chunk = cache_k.shape[1]
    s_cache = chunk * n_seq
    j = mesh.axis_index(seq_axis)
    q, k, v = _decode_qkv(p, x, cfg, pos, mesh)

    rows = torch.arange(b, device=x.device)
    slot_loc = pos.to(torch.int64) % s_cache - j * chunk
    mine = ((slot_loc >= 0) & (slot_loc < chunk))[:, None, None]
    idx = slot_loc.clamp(0, chunk - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        old = cache[rows, idx]
        cache.index_put_((rows, idx), torch.where(mine, new[:, 0].to(cache.dtype), old))

    groups = cfg.num_heads // cfg.num_kv_heads
    acc = acc_dtype(x.dtype)
    _, s_, _, hd_ = q.shape
    qk_t = torch.promote_types(q.dtype, cache_k.dtype)
    qg = q.reshape(b, s_, cfg.num_kv_heads, groups, hd_).to(qk_t)
    scores = torch.einsum("bskgd,bckd->bkgsc", qg, cache_k.to(qk_t)).to(acc)
    scores = scores.reshape(b, cfg.num_heads, s_, -1) * (cfg.head_dim ** -0.5)
    slots = j * chunk + torch.arange(chunk, device=x.device)
    valid = _valid_slots(slots, pos, s_cache, window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)

    m = C.reduce_replicas(scores.amax(dim=-1), mesh, seq_axis, "max")     # (B,H,1)
    pr = torch.exp(scores - m[..., None])
    l = C.reduce_replicas(pr.sum(dim=-1), mesh, seq_axis)                   # (B,H,1)
    pg = pr.to(cache_v.dtype).reshape(b, cfg.num_kv_heads, groups, s_, -1)
    out = torch.einsum("bkgsc,bckd->bskgd", pg, cache_v).reshape(b, s_, cfg.num_heads, hd_)
    out = C.reduce_replicas(out.to(acc), mesh, seq_axis)
    out = out / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    out = out.reshape(b, s_, cfg.num_heads * hd_).to(x.dtype)
    return _decode_out(out, p, cfg, mesh, attn_modes(cfg, mesh)[2]), cache_k, cache_v


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, device="cuda", lead=()) -> dict:
    """One gated MLP's parameters, each with the leading dims ``lead``."""
    return {
        "wg": normal(generator, (*lead, d_model, d_ff), d_model ** -0.5, device),
        "wu": normal(generator, (*lead, d_model, d_ff), d_model ** -0.5, device),
        "wd": normal(generator, (*lead, d_ff, d_model), d_ff ** -0.5, device),
        "norm": torch.zeros((*lead, d_model), dtype=torch.float32, device=device),
    }


def mlp_gated(p: dict, x: torch.Tensor, activation: str = "swiglu", mesh=None,
              width: Optional[int] = None) -> torch.Tensor:
    """The gated MLP. With a mesh whose ``model`` ranks split its hidden
    ``width`` (the rank holds wg/wu's columns and wd's rows of its block),
    wg/wu are column-parallel on ``x`` (whole on every rank, its cotangent
    summed) and wd row-parallel, its partial outputs summed."""
    split = width is not None and splits(width, model_ranks(mesh))
    if split:
        x = C.sum_grads(x, mesh, "model")
    g = torch.matmul(x, p["wg"].to(x.dtype))
    u = torch.matmul(x, p["wu"].to(x.dtype))
    h = F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")
    y = torch.matmul(h * u, p["wd"].to(x.dtype))
    return C.reduce_replicas(y, mesh, "model") if split else y
