"""The train step: loss, grads, clipping, optimizer, microbatching (port of
``repro.train.train_step``).

The step runs eagerly: there is no ``jax.jit`` and no buffer donation.
Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (``optim._tree``); microbatches are a Python loop that accumulates
float32 gradients divided by ``n_micro`` in the reference's order; then
come ``clip_by_global_norm``, ``opt.update``, ``apply_updates`` and the
step counter. The optimizer is ``repro_torch.optim.build``.

``state_specs`` and ZeRO-1 (``_zero1``) wait for the port of
``parallel/sharding.py``; a mesh other than None raises.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.transformer import forward_train
from repro_torch.optim import apply_updates, build as build_optimizer
from repro_torch.optim._tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.optim.adamw import clip_by_global_norm

__all__ = [
    "cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "loss_and_grads",
    "TrainState",
]

TrainState = Dict[str, Any]  # {"params": ..., "opt": ..., "step": 0-d int32 on the CPU}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """Mean token NLL; logits may carry padded vocab columns (masked out).

    The label logit is picked with an iota-compare masked reduction, as the
    reference picks it (no gather over the vocab axis, so a vocab-sharded
    layout partitions cleanly), and the normalizer is a plain reduction.
    The logits are cast to float32 here, or stay float64.
    """
    v_pad = logits.shape[-1]
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    iota = torch.arange(v_pad, device=logits.device)
    if v_pad > vocab_real:
        logits = torch.where(iota >= vocab_real, -1e30, logits)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    label_hit = iota == labels[..., None].to(torch.int64)
    label_logit = torch.sum(torch.where(label_hit, shifted, 0.0), dim=-1)
    return (lse - label_logit).mean()


def make_loss_fn(cfg: ModelConfig, mesh, run: RunConfig):
    compute_dtype = getattr(torch, run.compute_dtype)

    def loss_fn(params, batch):
        logits, aux = forward_train(params, batch, cfg, mesh, remat=run.remat,
                                    compute_dtype=compute_dtype)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_coef * aux
        return loss, {"loss": loss, "aux": aux}

    return loss_fn


def _unused_by_design(params, batch) -> set:
    """Key paths of the leaves no loss reads: a hybrid layer's ``ssm.norm``
    (the layer normalizes its input once, with ``attn.norm``, for both
    branches), and ``embed`` under precomputed ``embeds`` with an untied
    head."""
    out = set()
    layers = params.get("layers")
    per = layers if isinstance(layers, list) else [layers]
    for i, p in enumerate(per):
        if isinstance(p, dict) and "attn" in p and "ssm" in p:
            out.add("['layers']" + (f"[{i}]" if isinstance(layers, list) else "")
                    + "['ssm']['norm']")
    if "embeds" in batch and "lm_head" in params:
        out.add("['embed']")
    return out


def loss_and_grads(loss_fn, params, batch):
    """``(metrics, grads)`` of ``loss_fn(params, batch) -> (loss, metrics)``:
    the reference's ``jax.value_and_grad(loss_fn, has_aux=True)``. The
    metrics are detached; the gradients have the tree of ``params``. A
    leaf the loss does not use by design (:func:`_unused_by_design`) gets a
    zero gradient, as in JAX; any other leaf cut off from the loss raises
    ``RuntimeError``."""
    paths = [k for k, _ in tree_flatten_with_path(params)[0]]
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(treedef.unflatten(leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    cut = {k for k, g in zip(paths, grads) if g is None} - _unused_by_design(params, batch)
    if cut:
        raise RuntimeError(f"the loss does not reach the leaves {sorted(cut)}")
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, treedef.unflatten(grads)


def make_train_step(
    cfg: ModelConfig,
    mesh=None,
    run: RunConfig = None,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
):
    """Returns (train_step, optimizer). train_step(state, batch) -> (state,
    metrics); microbatches split the batch's leading dim and accumulate
    float32 grads."""
    if mesh is not None:
        raise NotImplementedError("a mesh waits for the port of parallel/sharding.py")
    opt = build_optimizer(run.optimizer, total_steps)
    loss_fn = make_loss_fn(cfg, mesh, run)
    n_micro = max(run.microbatch, 1)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state["params"]

        if n_micro == 1:
            metrics, grads = loss_and_grads(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            ms = []
            for i in range(n_micro):
                mb = {k: x[i * (x.shape[0] // n_micro):(i + 1) * (x.shape[0] // n_micro)]
                      for k, x in batch.items()}
                m, g = loss_and_grads(loss_fn, params, mb)
                grads = tree_map(lambda a, gg: a + gg.to(torch.float32) / n_micro, grads, g)
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        updates, opt_state = opt.update(grads, state["opt"], params)
        params = apply_updates(params, updates)
        metrics = dict(metrics, grad_norm=gnorm)
        return {"params": params, "opt": opt_state, "step": state["step"] + 1}, metrics

    return train_step, opt
