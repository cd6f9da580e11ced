"""Model assembly, dense family (port of ``repro.models.transformer``).

The dense decoder LM: GQA attention with a gated MLP (qwen1.5-*, gemma,
command-r-plus, and the backbones of musicgen and llava), text modality.

Entry points:
  * :func:`init` — parameter init from a ``torch.Generator`` (on the
    ``meta`` device it allocates nothing, as ``jax.eval_shape`` of the
    reference's ``init``);
  * :func:`forward_train` — logits for training/prefill;
  * :func:`padded_vocab` — the vocab width of the embedding and head.

The tree is the reference's: ``embed``, ``final_norm``, ``layers`` (each
leaf stacked on a leading ``num_layers`` dimension under ``scan_layers``,
else a list of per-layer dicts) and ``lm_head`` unless the embeddings are
tied. The stacked leaves are split into per-layer views once
(``torch.unbind``), so the backward pass stacks the layers' gradients in
one copy instead of writing a whole stack a layer.

Remat, the reference's ``jax.checkpoint`` policies around each layer:
``"full"`` (``nothing_saveable``) is ``torch.utils.checkpoint`` of the
layer; ``"dots"`` (``dots_with_no_batch_dims_saveable``) is selective
checkpointing that saves the outputs of ``aten.mm`` and ``aten.addmm``
(the layers' projections, ``models.layers``) and recomputes the rest.
Casts to the compute dtype are explicit, where the reference calls
``.astype``; nothing runs under ``torch.autocast``.

Not in this slice (they raise ``NotImplementedError``): the MoE, SSM and
hybrid families (the MoE/SSM slice), ``num_codebooks > 1`` and the
``vision_text`` modality (the same slice, with their front ends), a mesh
(the sharding slice), and ``forward_decode``/``init_cache`` (the decode
slice).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.backend import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["init", "forward_train", "padded_vocab"]

# the "dots" policy: the ops whose outputs a layer's checkpoint keeps
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def padded_vocab(cfg: ModelConfig, mesh=None) -> int:
    if mesh is not None:
        raise NotImplementedError("a mesh pads the vocab in parallel/sharding.py, "
                                  "which waits for the sharding slice")
    return cfg.vocab_size


def _check_supported(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}): the port has the dense family; MoE, "
            "SSM and hybrid models wait for the slice of models/moe.py and models/ssm.py")
    if cfg.num_codebooks > 1 or cfg.modality != "text":
        raise NotImplementedError(
            f"modality {cfg.modality!r} ({cfg.name}): the audio and vision front ends wait "
            "for the slice of models/moe.py and models/ssm.py")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: ModelConfig, device, lead=()) -> dict:
    """One layer's parameters, each with the leading dims ``lead`` (the
    stacked layers under ``scan_layers``)."""
    p = {"attn": L.init_attn(generator, cfg, device, lead)}
    if cfg.d_ff:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, device, lead)
    return p


def init(generator, cfg: ModelConfig, mesh=None, *, device=None) -> dict:
    """The parameter tree of ``cfg``: float32 normal draws scaled as the
    reference scales them (``d_model^-½``, ``(heads·head_dim)^-½`` for
    ``wo``, ``d_ff^-½`` for ``wd``), zero norms and biases. ``generator``
    is a ``torch.Generator`` on ``device`` (or None); ``device="meta"``
    gives the shapes with no storage. The draws are the port's own: a test
    that needs the reference's weights carries them across with
    ``convert.params_from_reference``."""
    _check_supported(cfg)
    device = resolve_device(device)
    v = padded_vocab(cfg, mesh)
    params: dict = {
        "embed": L.normal(generator, (v, cfg.d_model), cfg.d_model ** -0.5, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(generator, (cfg.d_model, v), cfg.d_model ** -0.5, device)
    if cfg.scan_layers:
        params["layers"] = _init_layer(generator, cfg, device, lead=(cfg.num_layers,))
    else:
        params["layers"] = [_init_layer(generator, cfg, device) for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(params, tokens, cfg, dtype):
    return F.embedding(tokens, params["embed"].to(dtype))


def _lm_logits(params, x, cfg):
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T  # (d, V)
    else:
        w = params["lm_head"].to(x.dtype)
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _dense_body(x, p_layer, cfg):
    h = L.rms_norm(x, p_layer["attn"]["norm"], cfg.norm_eps)
    x = x + L.attention_train(p_layer["attn"], h, cfg, window=cfg.sliding_window)
    if cfg.d_ff:
        xn = L.rms_norm(x, p_layer["mlp"]["norm"], cfg.norm_eps)
        x = x + L.mlp_gated(p_layer["mlp"], xn, cfg.mlp_activation)
    return x


def _unstack(tree, n: int):
    """A stacked layer tree as ``n`` per-layer trees of views (one
    ``unbind`` a leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return torch.unbind(tree, 0)


def forward_train(
    params: dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    mesh=None,
    *,
    remat: str = "none",
    compute_dtype=torch.bfloat16,
):
    """Training/prefill forward. batch: {'tokens': (B, S)}. Returns
    (logits (B, S, V), aux_loss): the dense family has no auxiliary loss,
    so ``aux_loss`` is a float32 zero, as in the reference."""
    _check_supported(cfg)
    if mesh is not None:
        raise NotImplementedError("a mesh waits for the sharding slice")
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be 'none', 'dots' or 'full', got {remat!r}")
    x = _embed_tokens(params, batch["tokens"], cfg, compute_dtype)
    layers = (_unstack(params["layers"], cfg.num_layers) if cfg.scan_layers
              else params["layers"])

    body = functools.partial(_dense_body, cfg=cfg)
    if remat == "full":
        body = functools.partial(checkpoint, body, use_reentrant=False)
    elif remat == "dots":
        body = functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _DOTS))
    for p_layer in layers:
        x = body(x, p_layer)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(params, x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
