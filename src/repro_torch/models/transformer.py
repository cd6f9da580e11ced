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

With a mesh (``launch.mesh.Mesh``, one process a rank), every rank runs
these functions on its block of the batch and returns its block of the
output:

* :func:`init` pads the vocab (``parallel.sharding.pad_vocab``) and the
  experts (``pad_experts``); on a rank's mesh the expert-parallel expert
  weights are the rank's experts. Every other weight is whole on every
  rank: the reference shards the dense weights by ``param_specs`` and
  leaves their tensor-parallel compute to GSPMD, which the port does not
  have (see ROADMAP);
* :func:`forward_train` runs context-parallel attention
  (``layers.attention_train_cp``) under ``cfg.cp_attention`` with more
  than one ``model`` rank, splits the hybrid's SSD over ``model``
  (``ssm.ssm_train``) and the MoE over it (``moe.moe_layer``); a prefill
  cache comes back as this rank's blocks, as ``cache_specs`` lays it out;
* :func:`init_cache` gives this rank's blocks of the cache: its batch
  rows, its chunk of every attention layer's sequence, its SSD heads (or P
  channels) and conv channels;
* :func:`forward_decode` attends over the rank's sequence chunk with
  ``layers.attention_decode_sp`` whenever the ``model`` axis has more than
  one rank (whatever ``sp_decode`` says: the rank holds only its chunk),
  and steps its blocks of the SSM state.

Departure: under a mesh with more than one ``model`` rank a cache length
the axis does not divide raises ``ValueError`` in :func:`init_cache` and
the prefill (the reference keeps such a cache whole on every rank and
decodes it through GSPMD).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.backend import device_cached, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

__all__ = ["init", "forward_train", "forward_decode", "init_cache", "padded_vocab"]

# the "dots" policy: the ops whose outputs a layer's checkpoint keeps
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def padded_vocab(cfg: ModelConfig, mesh=None) -> int:
    from repro_torch.parallel.sharding import pad_vocab

    return pad_vocab(cfg.vocab_size, mesh) if mesh is not None else cfg.vocab_size


def _head_width(cfg: ModelConfig) -> int:
    return max(cfg.num_codebooks, 1)  # lm head emits mult × vocab logits


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: ModelConfig, mesh, device, lead=()) -> dict:
    """One layer's parameters, each with the leading dims ``lead`` (the
    stacked layers under ``scan_layers``)."""
    p: dict = {}
    if cfg.family != "ssm":
        p["attn"] = L.init_attn(generator, cfg, device, lead)
    if cfg.ssm is not None:
        p["ssm"] = SSM.init_ssm(generator, cfg, device, lead)
    if cfg.moe is not None:
        p["moe"] = MOE.init_moe(generator, cfg, mesh, device, lead)
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
    the shapes with no storage. With a mesh the vocab and the experts are
    padded with zeros (the rows no token reaches, the dummy experts the
    router masks), so the draws, and the weights of the real vocab and
    experts, do not depend on the mesh; on a rank's mesh the
    expert-parallel expert weights are this rank's block
    (``moe.init_moe``). The draws are the port's own: a test that
    needs the reference's weights carries them across with
    ``convert.params_from_reference``."""
    device = resolve_device(device)
    v = padded_vocab(cfg, mesh)
    params: dict = {
        "embed": L.padded(L.normal(generator, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
                                   device), 0, v),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        k = _head_width(cfg)
        head = L.normal(generator, (cfg.d_model, k, cfg.vocab_size), cfg.d_model ** -0.5, device)
        params["lm_head"] = L.padded(head, 2, v).reshape(cfg.d_model, k * v)
    if cfg.scan_layers:
        params["layers"] = _init_layer(generator, cfg, mesh, device, lead=(cfg.num_layers,))
    else:
        params["layers"] = [_init_layer(generator, cfg, mesh, device)
                            for _ in range(cfg.num_layers)]
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


def _layer_windows(cfg: ModelConfig, max_seq: int, device: torch.device):
    """Per-layer attention windows as data (scanned hybrid stacks; the
    reference's ``_window_array``), one 0-d tensor a layer: global layers
    get window = max_seq+1 (≥ any distance ⇒ full causal attention), SWA
    layers get the sliding window. Kept per ``(cfg, max_seq, device)``
    (``backend.device_cached``, which keeps nothing made in a fake-tensor
    trace): a decode step reuses its cache length's windows instead of
    copying them to the card every step."""
    def make():
        w = []
        for i in range(cfg.num_layers):
            wi = _window_for(cfg, i)
            w.append(max_seq + 1 if wi is None else wi)
        return torch.tensor(w, dtype=torch.int32, device=device).unbind(0)

    return device_cached(("layer_windows", cfg, max_seq, torch.device(device)), make)


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


def _feed_forward(x, p_layer, cfg, mesh=None):
    """A layer's feed-forward half, residual added: the routed experts
    (plus the shared ones) or the gated MLP. Returns ``(x, aux)``, aux the
    MoE load-balance loss or None without experts."""
    if cfg.moe is not None:
        xn = L.rms_norm(x, p_layer["moe"]["norm"], cfg.norm_eps)
        y, aux = MOE.moe_layer(p_layer["moe"], xn, cfg, mesh)
        if cfg.moe.num_shared:
            y = y + L.mlp_gated(p_layer["shared_mlp"], xn, cfg.mlp_activation)
        return x + y, aux
    if cfg.d_ff:
        xn = L.rms_norm(x, p_layer["mlp"]["norm"], cfg.norm_eps)
        x = x + L.mlp_gated(p_layer["mlp"], xn, cfg.mlp_activation)
    return x, None


def _attn(p_attn, x, window, return_kv, cfg, mesh):
    """Self-attention of a layer: context-parallel under ``cp_attention``
    with more than one ``model`` rank, else whole on every rank."""
    if cfg.cp_attention and L.model_ranks(mesh) > 1:
        return L.attention_train_cp(p_attn, x, cfg, mesh, window=window, return_kv=return_kv)
    return L.attention_train(p_attn, x, cfg, window=window, return_kv=return_kv)


def _kv_block(c, mesh):
    """A layer's prefill cache as this rank's sequence chunk of k and v."""
    if L.model_ranks(mesh) == 1:
        return c
    from repro_torch.parallel.sharding import P, local_block

    spec = P(None, "model")
    return {**c, "k": local_block(c["k"], mesh, spec).contiguous(),
            "v": local_block(c["v"], mesh, spec).contiguous()}


def _dense_body(x, p_layer, *, cfg, return_cache, cache_len, seq, mesh=None):
    """A dense or MoE layer: (x, aux, cache or None)."""
    h = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
    c = None
    if return_cache:
        y, (kk, vv) = _attn(p_layer["attn"], h, cfg.sliding_window, True, cfg, mesh)
        c_len = min(cfg.sliding_window or cache_len, cache_len)
        if cfg.sliding_window is not None and seq > c_len:
            c = {"k": _ring_kv(kk, c_len), "v": _ring_kv(vv, c_len)}
        else:
            c = {"k": _pad_kv_to(kk, c_len), "v": _pad_kv_to(vv, c_len)}
        c = _kv_block(c, mesh)
    else:
        y = _attn(p_layer["attn"], h, cfg.sliding_window, False, cfg, mesh)
    x, aux = _feed_forward(x + y, p_layer, cfg, mesh)
    return x, _zero(x.device) if aux is None else aux, c


def _ssm_body(x, p_layer, *, cfg, return_cache, cache_len, seq, mesh=None):
    xn = L.rms_norm(x, p_layer["ssm"]["norm"], cfg.norm_eps)
    if return_cache:
        y, (h_f, conv) = SSM.ssm_train(p_layer["ssm"], xn, cfg, return_state=True, mesh=mesh)
        c = {"h": h_f, "conv": conv}
    else:
        y = SSM.ssm_train(p_layer["ssm"], xn, cfg, mesh=mesh)
        c = None
    return x + y, _zero(x.device), c


def _hybrid_body(x, p_layer, window, *, cfg, return_cache, cache_len, seq, ring=False,
                 mesh=None):
    """A hybrid layer: ``x + ½(attention + SSM)``, then the MLP. ``window``
    is an int, a 0-d tensor or None; ``ring`` (unscanned stacks) keeps a
    sliding-window layer's cache as a ring of ``min(window, cache_len)``
    slots when the sequence outgrows it."""
    xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
    if return_cache:
        attn_y, (kk, vv) = _attn(p_layer["attn"], xn, window, True, cfg, mesh)
        c_len = min(window, cache_len) if ring and window is not None else cache_len
        if ring and window is not None and c_len < seq:
            c = {"k": _ring_kv(kk, c_len), "v": _ring_kv(vv, c_len)}
        else:
            c = {"k": _pad_kv_to(kk, c_len), "v": _pad_kv_to(vv, c_len)}
        c = _kv_block(c, mesh)
        ssm_y, (h_f, conv) = SSM.ssm_train(p_layer["ssm"], xn, cfg, return_state=True,
                                           mesh=mesh)
        c.update({"h": h_f, "conv": conv})
    else:
        attn_y = _attn(p_layer["attn"], xn, window, False, cfg, mesh)
        ssm_y = SSM.ssm_train(p_layer["ssm"], xn, cfg, mesh=mesh)
        c = None
    x, _ = _feed_forward(x + 0.5 * (attn_y + ssm_y), p_layer, cfg, mesh)
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
    kw = dict(cfg=cfg, return_cache=return_cache, cache_len=cache_len, seq=seq, mesh=mesh)

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

    With a rank's mesh the cache is this rank's blocks of it, as
    ``parallel.sharding.cache_specs`` lays it out (``batch`` is the global
    batch); a batch the data axes do not divide, or a cache length the
    ``model`` axis does not divide, raises ``ValueError``.
    """
    device = resolve_device(device)
    if mesh is not None and hasattr(mesh, "axis_index"):
        return _cache_blocks(cfg, batch, max_seq, mesh, dtype, device)
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


def _cache_blocks(cfg, batch, max_seq, mesh, dtype, device):
    """This rank's zero blocks of the cache (:func:`init_cache` on a mesh)."""
    from repro_torch.parallel.sharding import cache_specs, data_axes, map_named, map_specs

    dp = data_axes(mesh)
    if dp and batch % mesh.axis_size(dp):
        raise ValueError(f"the data axes ({mesh.axis_size(dp)} ranks) do not divide the "
                         f"batch {batch}")
    full = init_cache(cfg, batch, max_seq, None, dtype, device="meta")
    m = L.model_ranks(mesh)

    def block(spec, leaf):
        name, x = leaf
        if name in ("k", "v") and m > 1 and spec[x.dim() - 3] is None:
            raise ValueError(f"the model axis ({m} ranks) does not divide a cache length "
                             f"of {x.shape[-3]}")
        shape = list(x.shape)
        for d, axes in enumerate(spec):
            if axes is not None:
                shape[d] //= mesh.axis_size(axes)
        return torch.zeros(shape, dtype=x.dtype, device=device)

    return map_specs(block, cache_specs(mesh, cfg, full), map_named(lambda n, x: (n, x), full))


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
    layers are a Python loop). ``sp_decode`` selects the sequence-parallel
    flash-decode (``layers.attention_decode_sp``) when the mesh has more
    than one ``model`` rank; there it is the only decode, since each rank
    holds its chunk of the cache (module docstring). Without such a mesh
    it changes nothing, as in the reference."""
    v = params["embed"].shape[0]
    sp = L.model_ranks(mesh) > 1

    def attend(p_attn, xn, c_layer, window):
        if sp:
            return L.attention_decode_sp(p_attn, xn, cfg, c_layer["k"], c_layer["v"], pos,
                                         mesh, window=window)
        return L.attention_decode(p_attn, xn, cfg, c_layer["k"], c_layer["v"], pos,
                                  window=window)

    x = _embed_tokens(params, tokens, cfg, compute_dtype)

    if cfg.scan_layers:
        layers = _unstack(params["layers"], cfg.num_layers)
        c_layers = _unstack(cache["layers"], cfg.num_layers)
        if cfg.family == "hybrid":
            s_cache = cache["layers"]["k"].shape[2] * (L.model_ranks(mesh) if sp else 1)
            windows = _layer_windows(cfg, s_cache, x.device)
        else:
            windows = [cfg.sliding_window] * cfg.num_layers
    else:
        layers, c_layers = params["layers"], cache["layers"]
        windows = [_window_for(cfg, i) if cfg.family == "hybrid" else cfg.sliding_window
                   for i in range(cfg.num_layers)]

    for p_layer, c_layer, window in zip(layers, c_layers, windows):
        if cfg.family == "ssm":
            xn = L.rms_norm(x, p_layer["ssm"]["norm"], cfg.norm_eps)
            y, h, conv = SSM.ssm_decode(p_layer["ssm"], xn, cfg, c_layer["h"], c_layer["conv"],
                                        mesh)
            c_layer["h"].copy_(h)
            c_layer["conv"].copy_(conv)
            x = x + y
        elif cfg.family == "hybrid":
            xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
            attn_y, _, _ = attend(p_layer["attn"], xn, c_layer, window)
            ssm_y, h, conv = SSM.ssm_decode(p_layer["ssm"], xn, cfg, c_layer["h"],
                                            c_layer["conv"], mesh)
            c_layer["h"].copy_(h)
            c_layer["conv"].copy_(conv)
            x, _ = _feed_forward(x + 0.5 * (attn_y + ssm_y), p_layer, cfg, mesh)
        else:
            xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
            y, _, _ = attend(p_layer["attn"], xn, c_layer, window)
            x, _ = _feed_forward(x + y, p_layer, cfg, mesh)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg, v), cache
