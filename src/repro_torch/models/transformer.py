"""Model assembly for all assigned architectures (port of
``repro.models.transformer``).

One decoder-LM skeleton covers the pool:

* ``dense``  — GQA attention + gated MLP (qwen1.5-*, gemma, command-r-plus,
  musicgen backbone, llava backbone).
* ``moe``    — GQA attention + routed experts (+ fused shared experts).
* ``ssm``    — pure Mamba-2 SSD stack (no attention, no MLP).
* ``hybrid`` — hymba: parallel attention+SSM heads per layer + MLP, with
  per-layer sliding-window/global attention (as data in a scanned stack,
  per-layer windows and cache shapes in an unscanned one).

Modalities: ``audio`` (musicgen) feeds summed codebook embeddings (or
precomputed frame embeddings from the stub front end) and predicts all
codebooks with a factored head; ``vision_text`` (llava) prepends stub patch
embeddings to the token sequence.

Entry points:
  * :func:`init` — parameter init from a ``torch.Generator`` (on the
    ``meta`` device it allocates nothing, as ``jax.eval_shape`` of the
    reference's ``init``);
  * :func:`forward_train` — logits for training/prefill (optionally
    returning a decode cache);
  * :func:`forward_decode` — single-token step with KV/SSM caches;
  * :func:`init_cache` — the decode cache for a given shape;
  * :func:`padded_vocab` — the vocab width of the embedding and head.

The tree is the reference's: ``embed``, ``final_norm``, ``layers`` (each
leaf stacked on a leading ``num_layers`` dimension under ``scan_layers``,
else a list of per-layer dicts) and ``lm_head`` unless the embeddings are
tied. The stacked leaves are split into per-layer views once
(``torch.unbind``), so the backward pass stacks the layers' gradients in
one copy instead of writing a whole stack a layer. The layers always run
as a Python loop, so the reference's ``unroll_scans`` and
``unroll_layers`` (which only unroll its ``lax.scan``) have no
counterpart; ``forward_decode`` accepts ``unroll_layers`` and ignores it.

Remat, the reference's ``jax.checkpoint`` policies around each layer of a
scanned stack: ``"full"`` (``nothing_saveable``) is
``torch.utils.checkpoint`` of the layer; ``"dots"``
(``dots_with_no_batch_dims_saveable``) is selective checkpointing that
saves the outputs of ``aten.mm`` and ``aten.addmm`` (the layers'
projections, ``models.layers``) and recomputes the rest. An unscanned
stack is not rematerialized, except the unscanned hybrid's layers, which
are checkpointed whole for any remat but ``"none"`` (the reference's
plain ``jax.checkpoint``) and not at all while building a cache. Casts to
the compute dtype are explicit, where the reference calls ``.astype``;
nothing runs under ``torch.autocast``.

The decode cache is updated in place: :func:`forward_decode` writes each
layer's new key, value and SSM state into the cache it is given and
returns that cache (the reference returns a new one). A cache is used
once: after a step only the returned one is current.

A mesh raises ``NotImplementedError`` (the sharding slice), as does
``sp_decode=True``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.backend import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

__all__ = ["init", "forward_train", "forward_decode", "init_cache", "padded_vocab"]

# the "dots" policy: the ops whose outputs a layer's checkpoint keeps
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def padded_vocab(cfg: ModelConfig, mesh=None) -> int:
    L.check_mesh(mesh)
    return cfg.vocab_size


def _head_width(cfg: ModelConfig) -> int:
    return max(cfg.num_codebooks, 1)  # lm head emits mult × vocab logits


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: ModelConfig, device, lead=()) -> dict:
    """One layer's parameters, each with the leading dims ``lead`` (the
    stacked layers under ``scan_layers``)."""
    p: dict = {}
    if cfg.family != "ssm":
        p["attn"] = L.init_attn(generator, cfg, device, lead)
    if cfg.ssm is not None:
        p["ssm"] = SSM.init_ssm(generator, cfg, device, lead)
    if cfg.moe is not None:
        p["moe"] = MOE.init_moe(generator, cfg, None, device, lead)
        if cfg.moe.num_shared:
            shared = L.init_mlp(generator, cfg.d_model, cfg.moe.num_shared * cfg.moe.d_ff_expert,
                                device, lead)
            del shared["norm"]
            p["shared_mlp"] = shared
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, device, lead)
    return p


def init(generator, cfg: ModelConfig, mesh=None, *, device=None) -> dict:
    """The parameter tree of ``cfg``: float32 normal draws scaled as the
    reference scales them, constants (norms, biases, the SSD's ``a_log``
    and ``d_skip``) as the reference sets them. ``generator`` is a
    ``torch.Generator`` on ``device`` (or None); ``device="meta"`` gives
    the shapes with no storage. The draws are the port's own: a test that
    needs the reference's weights carries them across with
    ``convert.params_from_reference``."""
    device = resolve_device(device)
    v = padded_vocab(cfg, mesh)
    params: dict = {
        "embed": L.normal(generator, (v, cfg.d_model), cfg.d_model ** -0.5, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(generator, (cfg.d_model, _head_width(cfg) * v),
                                     cfg.d_model ** -0.5, device)
    if cfg.scan_layers:
        params["layers"] = _init_layer(generator, cfg, device, lead=(cfg.num_layers,))
    else:
        params["layers"] = [_init_layer(generator, cfg, device) for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(params, tokens, cfg, dtype):
    emb = F.embedding(tokens, params["embed"].to(dtype))
    if cfg.num_codebooks > 1:
        # musicgen: (B, S, K) codebook ids → summed embeddings
        return emb.sum(dim=2)
    return emb


def _lm_logits(params, x, cfg, v):
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T  # (d, V)
    else:
        w = params["lm_head"].to(x.dtype)
    logits = torch.matmul(x, w)
    if cfg.num_codebooks > 1:
        b, s, _ = logits.shape
        logits = logits.reshape(b, s, cfg.num_codebooks, v)
    return logits


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def _window_for(cfg: ModelConfig, layer_idx: int) -> Optional[int]:
    if cfg.sliding_window is None:
        return None
    if layer_idx in cfg.global_attn_layers:
        return None
    return cfg.sliding_window


@functools.lru_cache(maxsize=64)
def _layer_windows(cfg: ModelConfig, max_seq: int, device: torch.device):
    """Per-layer attention windows as data (scanned hybrid stacks; the
    reference's ``_window_array``), one 0-d tensor a layer: global layers
    get window = max_seq+1 (≥ any distance ⇒ full causal attention), SWA
    layers get the sliding window. Made once per ``(cfg, max_seq,
    device)``: a decode step reuses its cache length's windows instead of
    copying them to the card every step."""
    w = []
    for i in range(cfg.num_layers):
        wi = _window_for(cfg, i)
        w.append(max_seq + 1 if wi is None else wi)
    return torch.tensor(w, dtype=torch.int32, device=device).unbind(0)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _pad_kv_to(k, cache_len):
    """(B, S, KV, D) → (B, cache_len, KV, D) absolute-slot layout."""
    s = k.shape[1]
    if s < cache_len:
        return F.pad(k, (0, 0, 0, 0, 0, cache_len - s))
    return k[:, :cache_len]


def _ring_kv(k, window):
    """(B, S, KV, D) → (B, window, KV, D) ring layout: slot = pos % window."""
    s = k.shape[1]
    if s <= window:
        return F.pad(k, (0, 0, 0, 0, 0, window - s))
    return torch.roll(k[:, -window:], s % window, dims=1)


def _zero(device):
    return torch.zeros((), dtype=torch.float32, device=device)


def _feed_forward(x, p_layer, cfg):
    """A layer's feed-forward half, residual added: the routed experts
    (plus the shared ones) or the gated MLP. Returns ``(x, aux)``, aux the
    MoE load-balance loss or None without experts."""
    if cfg.moe is not None:
        xn = L.rms_norm(x, p_layer["moe"]["norm"], cfg.norm_eps)
        y, aux = MOE.moe_layer(p_layer["moe"], xn, cfg)
        if cfg.moe.num_shared:
            y = y + L.mlp_gated(p_layer["shared_mlp"], xn, cfg.mlp_activation)
        return x + y, aux
    if cfg.d_ff:
        xn = L.rms_norm(x, p_layer["mlp"]["norm"], cfg.norm_eps)
        x = x + L.mlp_gated(p_layer["mlp"], xn, cfg.mlp_activation)
    return x, None


def _dense_body(x, p_layer, *, cfg, return_cache, cache_len, seq):
    """A dense or MoE layer: (x, aux, cache or None)."""
    h = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
    c = None
    if return_cache:
        y, (kk, vv) = L.attention_train(p_layer["attn"], h, cfg, window=cfg.sliding_window,
                                        return_kv=True)
        c_len = min(cfg.sliding_window or cache_len, cache_len)
        if cfg.sliding_window is not None and seq > c_len:
            c = {"k": _ring_kv(kk, c_len), "v": _ring_kv(vv, c_len)}
        else:
            c = {"k": _pad_kv_to(kk, c_len), "v": _pad_kv_to(vv, c_len)}
    else:
        y = L.attention_train(p_layer["attn"], h, cfg, window=cfg.sliding_window)
    x, aux = _feed_forward(x + y, p_layer, cfg)
    return x, _zero(x.device) if aux is None else aux, c


def _ssm_body(x, p_layer, *, cfg, return_cache, cache_len, seq):
    xn = L.rms_norm(x, p_layer["ssm"]["norm"], cfg.norm_eps)
    if return_cache:
        y, (h_f, conv) = SSM.ssm_train(p_layer["ssm"], xn, cfg, return_state=True)
        c = {"h": h_f, "conv": conv}
    else:
        y = SSM.ssm_train(p_layer["ssm"], xn, cfg)
        c = None
    return x + y, _zero(x.device), c


def _hybrid_body(x, p_layer, window, *, cfg, return_cache, cache_len, seq, ring=False):
    """A hybrid layer: ``x + ½(attention + SSM)``, then the MLP. ``window``
    is an int, a 0-d tensor or None; ``ring`` (unscanned stacks) keeps a
    sliding-window layer's cache as a ring of ``min(window, cache_len)``
    slots when the sequence outgrows it."""
    xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
    if return_cache:
        attn_y, (kk, vv) = L.attention_train(p_layer["attn"], xn, cfg, window=window,
                                             return_kv=True)
        c_len = min(window, cache_len) if ring and window is not None else cache_len
        if ring and window is not None and c_len < seq:
            c = {"k": _ring_kv(kk, c_len), "v": _ring_kv(vv, c_len)}
        else:
            c = {"k": _pad_kv_to(kk, c_len), "v": _pad_kv_to(vv, c_len)}
        ssm_y, (h_f, conv) = SSM.ssm_train(p_layer["ssm"], xn, cfg, return_state=True)
        c.update({"h": h_f, "conv": conv})
    else:
        attn_y = L.attention_train(p_layer["attn"], xn, cfg, window=window)
        ssm_y = SSM.ssm_train(p_layer["ssm"], xn, cfg)
        c = None
    x, _ = _feed_forward(x + 0.5 * (attn_y + ssm_y), p_layer, cfg)
    return x, _zero(x.device), c


def _unstack(tree, n: int):
    """A stacked layer tree as ``n`` per-layer trees of views (one
    ``unbind`` a leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return torch.unbind(tree, 0)


def _stack(trees):
    """Per-layer trees (dicts of tensors) as one stacked tree."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _remat(body, remat: str):
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _DOTS))
    return body


def forward_train(
    params: dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    mesh=None,
    *,
    remat: str = "none",
    compute_dtype=torch.bfloat16,
    return_cache: bool = False,
    cache_len: Optional[int] = None,
):
    """Training/prefill forward. batch: {'tokens': (B,S[,K])} or
    {'embeds': ..., 'image_embeds': ...}. Returns (logits, aux_loss) or
    (logits, aux_loss, cache) when ``return_cache`` (prefill): the
    auxiliary loss is the MoE load-balance loss summed over the layers, a
    float32 zero for the other families."""
    L.check_mesh(mesh)
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be 'none', 'dots' or 'full', got {remat!r}")
    v = params["embed"].shape[0]
    if "embeds" in batch:  # audio stub front end: precomputed frame embeddings
        x = batch["embeds"].to(compute_dtype)
    else:
        x = _embed_tokens(params, batch["tokens"], cfg, compute_dtype)
    if cfg.modality == "vision_text" and "image_embeds" in batch:
        img = batch["image_embeds"].to(compute_dtype)
        x = torch.cat([img, x], dim=1)
    seq = x.shape[1]
    cache_len = cache_len or seq
    kw = dict(cfg=cfg, return_cache=return_cache, cache_len=cache_len, seq=seq)

    aux_total = _zero(x.device)
    caches = []
    if cfg.scan_layers:
        layers = _unstack(params["layers"], cfg.num_layers)
        if cfg.family == "hybrid":
            windows = _layer_windows(cfg, seq, x.device)
            body = _remat(functools.partial(_hybrid_body, **kw), remat)
            for p_layer, window in zip(layers, windows):
                x, a, c = body(x, p_layer, window)
                aux_total = aux_total + a
                caches.append(c)
        else:
            base = _ssm_body if cfg.family == "ssm" else _dense_body
            body = _remat(functools.partial(base, **kw), remat)
            for p_layer in layers:
                x, a, c = body(x, p_layer)
                aux_total = aux_total + a
                caches.append(c)
        caches = _stack(caches) if return_cache else None
    elif cfg.family != "hybrid":  # unscanned uniform stack (analysis variants)
        body = _ssm_body if cfg.family == "ssm" else _dense_body
        for p_layer in params["layers"]:
            x, a, c = body(x, p_layer, **kw)
            aux_total = aux_total + a
            caches.append(c)
    else:  # hybrid (unscanned): per-layer windows and cache shapes
        body = functools.partial(_hybrid_body, **kw, ring=True)
        if remat != "none" and not return_cache:
            body = functools.partial(checkpoint, body, use_reentrant=False)
        for i, p_layer in enumerate(params["layers"]):
            x, _, c = body(x, p_layer, _window_for(cfg, i))
            caches.append(c)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.modality == "vision_text" and "image_embeds" in batch:
        x = x[:, batch["image_embeds"].shape[1]:]  # logits over text positions
    logits = _lm_logits(params, x, cfg, v)
    if return_cache:
        return logits, aux_total, {"layers": caches}
    return logits, aux_total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    mesh=None,
    dtype=torch.bfloat16,
    *,
    device=None,
) -> dict:
    """Decode cache, zeros on ``device``.

    Attention layers: (L, B, S_c, KV, HD) ×2 with S_c = min(max_seq, window).
    SSM layers: SSD state (L, B, H, P, N) float32 + conv state.
    Hybrid: a scanned stack carries full-length absolute-slot caches
    (sliding-window layers mask by distance, the window as data); an
    unscanned one carries per-layer dicts, ring buffers of window size on
    the sliding-window layers and full-length caches on the global ones.
    """
    L.check_mesh(mesh)
    device = resolve_device(device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim

    def attn_cache(window):
        s_c = max_seq if window is None else min(window, max_seq)
        return {
            "k": torch.zeros((batch, s_c, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, s_c, kv, hd), dtype=dtype, device=device),
        }

    def ssm_cache():
        h, conv = SSM.init_ssm_state(cfg, batch, device=device)
        return {"h": h, "conv": conv}

    if cfg.family == "ssm":
        return {"layers": _stack([ssm_cache() for _ in range(cfg.num_layers)])}
    if cfg.family == "hybrid":
        per = []
        for i in range(cfg.num_layers):
            c = attn_cache(None if cfg.scan_layers else _window_for(cfg, i))
            c.update(ssm_cache())
            per.append(c)
        return {"layers": _stack(per) if cfg.scan_layers else per}
    return {"layers": _stack([attn_cache(cfg.sliding_window) for _ in range(cfg.num_layers)])}


def forward_decode(
    params: dict,
    tokens: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    cfg: ModelConfig,
    mesh=None,
    *,
    compute_dtype=torch.bfloat16,
    unroll_layers: bool = False,
    sp_decode: bool = False,
) -> Tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1[, K]); pos: (B,) absolute positions.
    Returns (logits (B, 1, [K,] V), cache): ``cache`` itself, its tensors
    updated in place. ``unroll_layers`` is accepted and ignored (the
    layers are a Python loop); ``sp_decode`` (the sequence-parallel
    flash-decode) needs a mesh and raises, as a mesh does."""
    L.check_mesh(mesh)
    if sp_decode:
        raise NotImplementedError("sp_decode (attention_decode_sp) needs a mesh; it waits "
                                  "for the sharding slice (parallel/sharding.py)")
    v = params["embed"].shape[0]
    x = _embed_tokens(params, tokens, cfg, compute_dtype)

    if cfg.scan_layers:
        layers = _unstack(params["layers"], cfg.num_layers)
        c_layers = _unstack(cache["layers"], cfg.num_layers)
        if cfg.family == "hybrid":
            windows = _layer_windows(cfg, cache["layers"]["k"].shape[2], x.device)
        else:
            windows = [cfg.sliding_window] * cfg.num_layers
    else:
        layers, c_layers = params["layers"], cache["layers"]
        windows = [_window_for(cfg, i) if cfg.family == "hybrid" else cfg.sliding_window
                   for i in range(cfg.num_layers)]

    for p_layer, c_layer, window in zip(layers, c_layers, windows):
        if cfg.family == "ssm":
            xn = L.rms_norm(x, p_layer["ssm"]["norm"], cfg.norm_eps)
            y, h, conv = SSM.ssm_decode(p_layer["ssm"], xn, cfg, c_layer["h"], c_layer["conv"])
            c_layer["h"].copy_(h)
            c_layer["conv"].copy_(conv)
            x = x + y
        elif cfg.family == "hybrid":
            xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
            attn_y, _, _ = L.attention_decode(p_layer["attn"], xn, cfg, c_layer["k"],
                                              c_layer["v"], pos, window=window)
            ssm_y, h, conv = SSM.ssm_decode(p_layer["ssm"], xn, cfg, c_layer["h"],
                                            c_layer["conv"])
            c_layer["h"].copy_(h)
            c_layer["conv"].copy_(conv)
            x, _ = _feed_forward(x + 0.5 * (attn_y + ssm_y), p_layer, cfg)
        else:
            xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
            y, _, _ = L.attention_decode(p_layer["attn"], xn, cfg, c_layer["k"], c_layer["v"],
                                         pos, window=window)
            x, _ = _feed_forward(x + y, p_layer, cfg)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg, v), cache
