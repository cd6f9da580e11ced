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
these functions on its block of the batch and its blocks of the weights
(``parallel.sharding.held(param_specs)``, the reference's layout) and
returns its block of the output:

* :func:`init` pads the vocab (``parallel.sharding.pad_vocab``) and the
  experts (``pad_experts``) and, on a rank's mesh, draws each leaf as one
  rank draws it and keeps the rank's block, so a rank's values are one
  rank's;
* the layers are tensor-parallel over ``model``: q/k/v column-parallel
  over the heads (row-parallel over ``d_model`` where the heads do not
  divide the axis), attention on the rank's heads, ``wo`` and the MLPs'
  ``wd`` row-parallel with their partial outputs summed
  (``layers.attention_train``, ``layers.mlp_gated``), the SSM's
  ``d_inner`` split (``ssm.ssm_train``), the MoE's experts over ``model``
  (``moe.moe_layer``); context-parallel attention under ``cfg.cp_attention``
  with more than one ``model`` rank (``layers.attention_train_cp``,
  which gathers the weights whole, as the reference's ``shard_map``
  takes them);
* the embedding is vocab-parallel (:func:`_embed_tokens`) and the head
  gives the rank's block of the vocab's logits (:func:`_lm_logits`;
  :func:`gather_vocab` gathers them; the train step's loss is
  vocab-parallel);
* :func:`forward_train` with ``seq_axes`` takes a batch whose sequence
  is sharded over the data axes (a global batch they do not divide, as
  long-context single sequences are): attention and the SSM's conv and
  scan gather the sequence, the rest runs on the rank's slice;
* :func:`init_cache` gives this rank's blocks of the cache
  (``cache_specs``): its batch rows (the whole batch where the data axes
  do not divide it), its chunk of every attention layer's sequence (the
  whole sequence where the ``model`` axis does not divide its length),
  its SSD heads (or P channels) and conv channels;
* :func:`forward_decode` attends over the rank's sequence chunk with
  ``layers.attention_decode_sp`` (the rank's q/k/v heads gathered), or
  over a whole cache with ``layers.attention_decode`` on the rank's heads,
  and steps its blocks of the SSM state.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.backend import device_cached, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives as C
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
    cut = _cutter(cfg, mesh)
    params: dict = {
        "embed": cut("embed", L.padded(L.normal(generator, (cfg.vocab_size, cfg.d_model),
                                                cfg.d_model ** -0.5, device), 0, v)),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        k = _head_width(cfg)
        head = L.normal(generator, (cfg.d_model, k, cfg.vocab_size), cfg.d_model ** -0.5, device)
        params["lm_head"] = cut("lm_head", L.padded(head, 2, v).reshape(cfg.d_model, k * v))
    if cfg.scan_layers:
        params["layers"] = cut("layers", _init_layer(generator, cfg, mesh, device,
                                                     lead=(cfg.num_layers,)))
    else:
        params["layers"] = [cut("layers", _init_layer(generator, cfg, mesh, device), i)
                            for i in range(cfg.num_layers)]
    return params


def _cutter(cfg: ModelConfig, mesh):
    """``cut(key, tree[, i])``: the rank's blocks of a part of the
    parameter tree (``params[key]``, or layer ``i`` of an unscanned stack)
    under ``held(param_specs)`` on a rank's mesh; the part itself on no
    mesh or a shape-only one. Each block is copied out, so the whole draw is
    freed before the next part is drawn."""
    if mesh is None or not hasattr(mesh, "axis_index"):
        return lambda key, tree, i=None: tree
    from repro_torch.parallel.sharding import held, local_block, map_specs, param_specs

    specs = held(param_specs(mesh, cfg), cfg, mesh)

    def cut(key, tree, i=None):
        spec = specs[key] if i is None else specs[key][i]
        return map_specs(lambda s, x: local_block(x, mesh, s).clone(), spec, tree)

    return cut


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _vocab_split(params, cfg, mesh) -> bool:
    """Whether the embedding (and head) hold the rank's vocab block."""
    return L.model_ranks(mesh) > 1 and params["embed"].shape[0] < padded_vocab(cfg, mesh)


def _vocab(params, cfg, mesh) -> int:
    """The (padded) vocab width of the whole embedding."""
    n = params["embed"].shape[0]
    return n * L.model_ranks(mesh) if _vocab_split(params, cfg, mesh) else n


def _embed_tokens(params, tokens, cfg, dtype, mesh=None):
    """The token embeddings; vocab-parallel where the rank holds its block
    of the rows: the ids outside it are looked up at row 0 and zeroed, and
    the ranks' embeddings are summed (exact: one rank adds each id's row)."""
    w = params["embed"].to(dtype)
    if _vocab_split(params, cfg, mesh):
        n = w.shape[0]
        local = tokens.to(torch.int64) - mesh.axis_index("model") * n
        mine = (local >= 0) & (local < n)
        emb = F.embedding(torch.where(mine, local, 0), w) * mine[..., None].to(dtype)
        if cfg.num_codebooks > 1:
            emb = emb.sum(dim=2)
        return C.reduce_replicas(emb, mesh, "model")
    emb = F.embedding(tokens, w)
    if cfg.num_codebooks > 1:
        # musicgen: (B, S, K) codebook ids → summed embeddings
        return emb.sum(dim=2)
    return emb


def _lm_logits(params, x, cfg, v, mesh=None):
    """The logits: (B, S, V), or (B, S, K, V) for K codebooks; where the
    rank holds its vocab block of the head (or of the tied embedding), its
    block of the columns, (B, S, V/M) or (B, S, K·V/M) of the flattened
    codebook-major columns, from ``x`` marked for its partial cotangent."""
    split = _vocab_split(params, cfg, mesh)
    if split:
        x = C.sum_grads(x, mesh, "model")
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T  # (d, V)
    else:
        w = params["lm_head"].to(x.dtype)
    logits = torch.matmul(x, w)
    if cfg.num_codebooks > 1 and not split:
        b, s, _ = logits.shape
        logits = logits.reshape(b, s, cfg.num_codebooks, v)
    return logits


def gather_vocab(logits, cfg, mesh, v: int):
    """The rank's vocab block of logits (:func:`forward_train` /
    :func:`forward_decode` on a mesh) gathered whole: (…, V) or
    (…, K, V). Not differentiable; the identity without a split vocab."""
    m = L.model_ranks(mesh)
    flat = cfg.num_codebooks <= 1 or logits.dim() == 3
    if m == 1 or not flat or logits.shape[-1] * m != v * max(cfg.num_codebooks, 1):
        return logits
    full = C.all_gather_dim(logits, mesh, "model", logits.dim() - 1)
    if cfg.num_codebooks > 1:
        full = full.reshape(*full.shape[:-1], cfg.num_codebooks, v)
    return full


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


def _feed_forward(x, p_layer, cfg, mesh=None, seq_axes=None):
    """A layer's feed-forward half, residual added: the routed experts
    (plus the shared ones) or the gated MLP. Returns ``(x, aux)``, aux the
    MoE load-balance loss or None without experts."""
    if cfg.moe is not None:
        xn = L.rms_norm(x, p_layer["moe"]["norm"], cfg.norm_eps)
        y, aux = MOE.moe_layer(p_layer["moe"], xn, cfg, mesh, seq_sharded=bool(seq_axes))
        if cfg.moe.num_shared:
            y = y + L.mlp_gated(p_layer["shared_mlp"], xn, cfg.mlp_activation, mesh,
                                cfg.moe.num_shared * cfg.moe.d_ff_expert)
        return x + y, aux
    if cfg.d_ff:
        xn = L.rms_norm(x, p_layer["mlp"]["norm"], cfg.norm_eps)
        x = x + L.mlp_gated(p_layer["mlp"], xn, cfg.mlp_activation, mesh, cfg.d_ff)
    return x, None


def _attn(p_attn, x, window, return_kv, cfg, mesh, seq_axes=None):
    """Self-attention of a layer: context-parallel under ``cp_attention``
    with more than one ``model`` rank, else tensor-parallel over the
    rank's heads. ``seq_axes``: ``x`` is the rank's slice of the sequence
    over those (data) axes; it is gathered whole first (the backward pass
    sums the ranks' cotangents) and the rank keeps its slice of the
    output."""
    if seq_axes:
        x = C.gather_params(x, mesh, seq_axes, 1)
    if cfg.cp_attention and L.model_ranks(mesh) > 1:
        y = L.attention_train_cp(p_attn, x, cfg, mesh, window=window, return_kv=return_kv)
    else:
        y = L.attention_train(p_attn, x, cfg, window=window, return_kv=return_kv, mesh=mesh)
    if seq_axes:
        n = x.shape[1] // mesh.axis_size(seq_axes)
        y = y.narrow(1, mesh.axis_index(seq_axes) * n, n)
    return y


def _kv_block(c, mesh):
    """A layer's prefill cache as this rank's sequence chunk of k and v
    (whole where the ``model`` axis does not divide its length)."""
    if not L.splits(c["k"].shape[1], L.model_ranks(mesh)):
        return c
    from repro_torch.parallel.sharding import P, local_block

    spec = P(None, "model")
    return {**c, "k": local_block(c["k"], mesh, spec).contiguous(),
            "v": local_block(c["v"], mesh, spec).contiguous()}


def _dense_body(x, p_layer, *, cfg, return_cache, cache_len, seq, mesh=None, seq_axes=None):
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
        y = _attn(p_layer["attn"], h, cfg.sliding_window, False, cfg, mesh, seq_axes)
    x, aux = _feed_forward(x + y, p_layer, cfg, mesh, seq_axes)
    return x, _zero(x.device) if aux is None else aux, c


def _ssm_body(x, p_layer, *, cfg, return_cache, cache_len, seq, mesh=None, seq_axes=None):
    xn = L.rms_norm(x, p_layer["ssm"]["norm"], cfg.norm_eps)
    if return_cache:
        y, (h_f, conv) = SSM.ssm_train(p_layer["ssm"], xn, cfg, return_state=True, mesh=mesh)
        c = {"h": h_f, "conv": conv}
    else:
        y = SSM.ssm_train(p_layer["ssm"], xn, cfg, mesh=mesh, seq_axes=seq_axes)
        c = None
    return x + y, _zero(x.device), c


def _hybrid_body(x, p_layer, window, *, cfg, return_cache, cache_len, seq, ring=False,
                 mesh=None, seq_axes=None):
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
        attn_y = _attn(p_layer["attn"], xn, window, False, cfg, mesh, seq_axes)
        ssm_y = SSM.ssm_train(p_layer["ssm"], xn, cfg, mesh=mesh, seq_axes=seq_axes)
        c = None
    x, _ = _feed_forward(x + 0.5 * (attn_y + ssm_y), p_layer, cfg, mesh, seq_axes)
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
    seq_axes=None,
):
    """Training/prefill forward. batch: {'tokens': (B,S[,K])} or
    {'embeds': ..., 'image_embeds': ...}. Returns (logits, aux_loss) or
    (logits, aux_loss, cache) when ``return_cache`` (prefill): the
    auxiliary loss is the MoE load-balance loss summed over the layers, a
    float32 zero for the other families. With a mesh of several ``model``
    ranks the logits are the rank's vocab block (:func:`_lm_logits`;
    :func:`gather_vocab` gathers them). ``seq_axes``: the batch is this
    rank's slice of the sequence over those (data) axes (a global batch
    they do not divide; train only)."""
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be 'none', 'dots' or 'full', got {remat!r}")
    if seq_axes and (return_cache or "image_embeds" in batch):
        raise ValueError("a sequence sharded over the data axes is a train step's text or "
                         "audio input; prefill and image inputs take whole sequences")
    v = _vocab(params, cfg, mesh)
    if "embeds" in batch:  # audio stub front end: precomputed frame embeddings
        x = batch["embeds"].to(compute_dtype)
    else:
        x = _embed_tokens(params, batch["tokens"], cfg, compute_dtype, mesh)
    if cfg.modality == "vision_text" and "image_embeds" in batch:
        img = batch["image_embeds"].to(compute_dtype)
        x = torch.cat([img, x], dim=1)
    seq = x.shape[1]
    cache_len = cache_len or seq
    kw = dict(cfg=cfg, return_cache=return_cache, cache_len=cache_len, seq=seq, mesh=mesh,
              seq_axes=seq_axes or None)

    aux_total = _zero(x.device)
    caches = []
    if cfg.scan_layers:
        layers = _unstack(params["layers"], cfg.num_layers)
        if cfg.family == "hybrid":
            n_seq = mesh.axis_size(seq_axes) if seq_axes else 1
            windows = _layer_windows(cfg, seq * n_seq, x.device)
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
    logits = _lm_logits(params, x, cfg, v, mesh)
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
    """This rank's zero blocks of the cache (:func:`init_cache` on a mesh):
    a batch the data axes do not divide is whole on every rank, and so is
    the sequence of an attention layer's cache whose length the ``model``
    axis does not divide (``cache_specs``)."""
    from repro_torch.parallel.sharding import cache_specs, map_specs

    full = init_cache(cfg, batch, max_seq, None, dtype, device="meta")

    def block(spec, x):
        shape = list(x.shape)
        for d, axes in enumerate(spec):
            if axes is not None:
                shape[d] //= mesh.axis_size(axes)
        return torch.zeros(shape, dtype=x.dtype, device=device)

    return map_specs(block, cache_specs(mesh, cfg, full), full)


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
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1[, K]); pos: (B,) absolute positions.
    Returns (logits (B, 1, [K,] V), cache): ``cache`` itself, its tensors
    updated in place. ``unroll_layers`` is accepted and ignored (the
    layers are a Python loop). With a mesh of several ``model`` ranks the
    logits are the rank's vocab block (as :func:`forward_train`'s), and an
    attention layer whose cache holds the rank's chunk of the sequence
    (``cache_specs``) decodes by the sequence-parallel flash-decode
    (``layers.attention_decode_sp``), whatever ``sp_decode`` says; a layer
    whose cache is whole (a length the axis does not divide) decodes with
    ``layers.attention_decode`` on the rank's heads. ``cache_len`` is the
    cache's global length (``init_cache``'s ``max_seq``, the prefill's
    ``cache_len``), which tells the two apart; None: every attention cache
    is a chunk. Without such a mesh ``sp_decode`` changes nothing, as in
    the reference."""
    v = _vocab(params, cfg, mesh)
    m = L.model_ranks(mesh)

    def chunked(window) -> bool:
        if m == 1:
            return False
        if cache_len is None:
            return True
        length = cache_len if not isinstance(window, int) else min(window, cache_len)
        return L.splits(length, m)

    def attend(p_attn, xn, c_layer, window, sp):
        if sp:
            return L.attention_decode_sp(p_attn, xn, cfg, c_layer["k"], c_layer["v"], pos,
                                         mesh, window=window)
        return L.attention_decode(p_attn, xn, cfg, c_layer["k"], c_layer["v"], pos,
                                  window=window, mesh=mesh)

    x = _embed_tokens(params, tokens, cfg, compute_dtype, mesh)

    if cfg.scan_layers:
        layers = _unstack(params["layers"], cfg.num_layers)
        c_layers = _unstack(cache["layers"], cfg.num_layers)
        if cfg.family == "hybrid":
            sp = chunked(None)
            s_cache = cache_len or cache["layers"]["k"].shape[2] * (m if sp else 1)
            windows = _layer_windows(cfg, s_cache, x.device)
            sps = [sp] * cfg.num_layers
        else:
            windows = [cfg.sliding_window] * cfg.num_layers
            sps = [chunked(cfg.sliding_window)] * cfg.num_layers
    else:
        layers, c_layers = params["layers"], cache["layers"]
        windows = [_window_for(cfg, i) if cfg.family == "hybrid" else cfg.sliding_window
                   for i in range(cfg.num_layers)]
        sps = [chunked(w) for w in windows]

    for p_layer, c_layer, window, sp in zip(layers, c_layers, windows, sps):
        if cfg.family == "ssm":
            xn = L.rms_norm(x, p_layer["ssm"]["norm"], cfg.norm_eps)
            y, h, conv = SSM.ssm_decode(p_layer["ssm"], xn, cfg, c_layer["h"], c_layer["conv"],
                                        mesh)
            c_layer["h"].copy_(h)
            c_layer["conv"].copy_(conv)
            x = x + y
        elif cfg.family == "hybrid":
            xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
            attn_y, _, _ = attend(p_layer["attn"], xn, c_layer, window, sp)
            ssm_y, h, conv = SSM.ssm_decode(p_layer["ssm"], xn, cfg, c_layer["h"],
                                            c_layer["conv"], mesh)
            c_layer["h"].copy_(h)
            c_layer["conv"].copy_(conv)
            x, _ = _feed_forward(x + 0.5 * (attn_y + ssm_y), p_layer, cfg, mesh)
        else:
            xn = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
            y, _, _ = attend(p_layer["attn"], xn, c_layer, window, sp)
            x, _ = _feed_forward(x + y, p_layer, cfg, mesh)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg, v, mesh), cache
