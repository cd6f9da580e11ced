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
* the sequence-parallel attention (``attention_decode_sp``,
  ``attention_train_cp``) needs a mesh and waits for the sharding slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "rms_norm",
    "rope",
    "attention_train",
    "attention_decode",
    "mlp_gated",
    "init_attn",
    "init_mlp",
]

# flash-attention block sizes (chunked attention in torch ops)
Q_BLOCK = 2048
KV_BLOCK = 1024


def check_mesh(mesh) -> None:
    """Raise for any mesh: vocab and expert padding, sharded layers and the
    pinned head grids wait for the sharding slice."""
    if mesh is not None:
        raise NotImplementedError("a mesh (vocab and expert padding, sharded layers) waits "
                                  "for the sharding slice (parallel/sharding.py)")


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


def _project_qkv(p, x, cfg, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


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
):
    """Causal (optionally sliding-window) self-attention, flash-chunked.

    x: (B, S, D) → (B, S, D). Never materializes S×S scores; used for both
    train and prefill. With ``return_kv`` also returns the roped (k, v)
    (B, S, KV, D) for prefill cache construction. ``window`` is an int, a
    0-d tensor (a scanned hybrid stack's window as data) or None.
    """
    b, s, d = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions[None, :])
    groups = cfg.num_heads // cfg.num_kv_heads
    scale = cfg.head_dim ** -0.5

    outs = [_flash_body(q[:, q0:q0 + Q_BLOCK], k, v, positions[q0:q0 + Q_BLOCK], positions,
                        window, scale, groups)
            for q0 in range(0, s, Q_BLOCK)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    out = torch.matmul(out.reshape(b, s, -1), p["wo"].to(x.dtype).reshape(-1, d))
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(
    p: dict,
    x: torch.Tensor,
    cfg,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    *,
    window=None,
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
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    rows = torch.arange(b, device=x.device)
    slot = pos.to(torch.int64) % s_cache
    cache_k.index_put_((rows, slot), k[:, 0].to(cache_k.dtype))
    cache_v.index_put_((rows, slot), v[:, 0].to(cache_v.dtype))

    groups = cfg.num_heads // cfg.num_kv_heads
    acc = acc_dtype(x.dtype)
    # grouped-query einsum — no materialized repeat of the KV cache
    _, s_, _, hd_ = q.shape
    qk_t = torch.promote_types(q.dtype, cache_k.dtype)
    qg = q.reshape(b, s_, cfg.num_kv_heads, groups, hd_).to(qk_t)
    scores = torch.einsum("bskgd,bckd->bkgsc", qg, cache_k.to(qk_t)).to(acc)
    scores = scores.reshape(b, cfg.num_heads, s_, -1)
    scores = scores * (cfg.head_dim ** -0.5)

    # validity: slot c holds an absolute position; with a ring buffer the
    # absolute position of slot c is recoverable from (pos, window)
    slots = torch.arange(s_cache, device=x.device)[None, :]    # (1, S_cache)
    pos_c = pos.to(torch.int64)[:, None]
    if window is None:
        valid = slots <= pos_c                  # slot index == position
    elif isinstance(window, int) and window == s_cache:
        # ring buffer: before it wraps, slots <= pos; after, every slot
        valid = (slots <= pos_c) | (pos_c >= s_cache)
    else:
        # absolute cache, a (possibly tensor) window: causal and distance
        valid = (slots <= pos_c) & ((pos_c - slots) < window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    wg = w.reshape(b, cfg.num_kv_heads, groups, s_, -1)
    out = torch.einsum("bkgsc,bckd->bskgd", wg, cache_v)
    out = out.reshape(b, s_, cfg.num_heads * hd_).to(x.dtype)
    out = torch.matmul(out, p["wo"].to(x.dtype).reshape(-1, x.shape[-1]))
    return out, cache_k, cache_v


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


def mlp_gated(p: dict, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    g = torch.matmul(x, p["wg"].to(x.dtype))
    u = torch.matmul(x, p["wu"].to(x.dtype))
    h = F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")
    return torch.matmul(h * u, p["wd"].to(x.dtype))
