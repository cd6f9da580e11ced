"""The train step: loss, grads, clipping, optimizer, microbatching (port of
``repro.train.train_step``).

The step runs eagerly: there is no ``jax.jit`` and no buffer donation.
Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (``optim._tree``); microbatches are a Python loop that accumulates
float32 gradients divided by ``n_micro`` in the reference's order; then
come ``clip_by_global_norm``, ``opt.update``, ``apply_updates`` and the
step counter. The optimizer is ``repro_torch.optim.build``.

With a mesh (``launch.mesh.Mesh``, one process a rank) the step is the
reference's under ``state_specs``, run by every rank on its blocks:

1. each rank takes its block of the global batch (``batch_input_specs``:
   its rows, or where the data axes do not divide the batch its slice of
   the sequence, as the reference shards it) and computes its gradients
   with its tensor-parallel blocks of the weights (``models``); the loss
   is vocab-parallel (:func:`cross_entropy`), and a region's partial
   gradients are summed over ``model`` inside the layers
   (``launch.collectives.sum_grads``, ``gather_params``);
2. the gradients are averaged with an all-reduce over the data axes (the
   token mean over all data ranks: their blocks are equal);
3. ``clip_by_global_norm`` runs on the whole gradients (each leaf's
   squares summed over the ranks that hold its blocks: ``model`` for the
   tensor-parallel blocks and the experts);
4. the optimizer updates only this rank's ZeRO-1 block of each moment and
   parameter (Shampoo: whole gradients in, its own stat blocks,
   ``optim.shampoo``);
5. the updated blocks are all-gathered over ``data``.

The state a rank holds is ``held(state_specs(...))``
(``parallel.sharding.held``): the weights as the rank's tensor-parallel
blocks (the experts as its experts), the moments and Shampoo's stats as
their blocks. :func:`init_state` makes it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.transformer import forward_train
from repro_torch.optim import apply_updates, build as build_optimizer
from repro_torch.optim._tree import tree_flatten, tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.optim.adamw import clip_by_global_norm

__all__ = [
    "cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "loss_and_grads",
    "state_specs",
    "init_state",
    "held_state_specs",
    "TrainState",
]

TrainState = Dict[str, Any]  # {"params": ..., "opt": ..., "step": 0-d int32 on the CPU}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int, mesh=None,
                  vocab: int = None) -> torch.Tensor:
    """Mean token NLL; logits may carry padded vocab columns (masked out).

    The label logit is picked with an iota-compare masked reduction, as the
    reference picks it (no gather over the vocab axis, so a vocab-sharded
    layout partitions cleanly), and the normalizer is a plain reduction.
    The logits are cast to float32 here, or stay float64.

    With a mesh of several ``model`` ranks and logits that are the rank's
    vocab block (``transformer.forward_train``), the loss is vocab-parallel
    (:func:`_vocab_parallel_nll`); ``vocab`` is the padded width of the
    whole vocab. Nothing vocab-wide is gathered.
    """
    if (vocab is not None and mesh is not None and _model_ranks(mesh) > 1
            and (logits.dim() == labels.dim() or logits.shape[-1] < vocab)):
        return _vocab_parallel_nll(logits, labels, vocab_real, mesh, vocab).mean()
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


def _model_ranks(mesh) -> int:
    return mesh.shape.get("model", 1)


def _vocab_parallel_nll(logits, labels, vocab_real: int, mesh, vocab: int) -> torch.Tensor:
    """Each token's NLL from the rank's vocab block of its logits, (B, S)
    or (B, S, K) for K codebooks (the block a slice of the flattened
    codebook-major K·V columns). Per codebook, the ranks combine with
    all-reduces over ``model``: the maximum (detached), the sum of
    ``exp``, and the label logit picked by global vocab index; padded
    columns are masked by global index."""
    from repro_torch.launch import collectives as C

    n = logits.shape[-1]
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    col = mesh.axis_index("model") * n + torch.arange(n, device=logits.device)
    book, word = col // vocab, col % vocab
    logits = torch.where(word >= vocab_real, -1e30, logits)
    multi = labels.dim() == logits.dim()        # (B, S, K) labels: codebooks
    books = range(labels.shape[-1]) if multi else (0,)
    out = []
    for k in books:
        lab = (labels[..., k] if multi else labels).to(torch.int64)
        mine = book == k
        lk = torch.where(mine, logits, -1e30)
        with torch.no_grad():
            m = C.reduce_replicas(lk.amax(dim=-1, keepdim=True), mesh, "model", "max")
        shifted = lk - m
        sumexp = torch.sum(torch.where(mine, torch.exp(shifted), 0.0), dim=-1)
        hit = mine & (word == lab[..., None])
        picked = torch.sum(torch.where(hit, shifted, 0.0), dim=-1)
        sumexp = C.reduce_replicas(sumexp, mesh, "model")
        picked = C.reduce_replicas(picked, mesh, "model")
        out.append(torch.log(sumexp) - picked)
    return torch.stack(out, -1) if multi else out[0]


def make_loss_fn(cfg: ModelConfig, mesh, run: RunConfig, seq_axes=None):
    """``loss_fn(params, batch) -> (loss, metrics)``; on a mesh the logits
    are the rank's vocab block and the loss is vocab-parallel.
    ``seq_axes``: the batch is the rank's slice of the sequence over those
    (data) axes."""
    compute_dtype = getattr(torch, run.compute_dtype)
    vocab = None
    if mesh is not None:
        from repro_torch.models.transformer import padded_vocab

        vocab = padded_vocab(cfg, mesh)

    def loss_fn(params, batch):
        logits, aux = forward_train(params, batch, cfg, mesh, remat=run.remat,
                                    compute_dtype=compute_dtype, seq_axes=seq_axes)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size, mesh, vocab)
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
    optimizer=None,
):
    """Returns (train_step, optimizer). train_step(state, batch) -> (state,
    metrics); microbatches split the batch's leading dim and accumulate
    float32 grads. ``optimizer`` (an ``optim.Optimizer``) replaces the one
    ``run.optimizer`` builds: the way to train with an optimizer that
    ``OptimizerConfig`` cannot express (Shampoo with ``precond_p=2`` and a
    ridge, as ``chip_smoke.py``'s phase mesh does). With a mesh, ``state`` is this rank's
    (:func:`init_state`) and ``batch`` the global batch; the metrics are
    the global ones."""
    opt = optimizer or build_optimizer(run.optimizer, total_steps)
    loss_fn = make_loss_fn(cfg, mesh, run)
    n_micro = max(run.microbatch, 1)
    if mesh is not None:
        return _meshed_step(cfg, mesh, run, opt, loss_fn, n_micro, max_grad_norm), opt

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state["params"]

        metrics, grads = _grads(loss_fn, params, batch, n_micro)

        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        updates, opt_state = opt.update(grads, state["opt"], params)
        params = apply_updates(params, updates)
        metrics = dict(metrics, grad_norm=gnorm)
        return {"params": params, "opt": opt_state, "step": state["step"] + 1}, metrics

    return train_step, opt


def _grads(loss_fn, params, batch, n_micro: int):
    """``(metrics, grads)`` over ``n_micro`` microbatches of ``batch``."""
    if n_micro == 1:
        return loss_and_grads(loss_fn, params, batch)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    ms = []
    for i in range(n_micro):
        mb = {k: x[i * (x.shape[0] // n_micro):(i + 1) * (x.shape[0] // n_micro)]
              for k, x in batch.items()}
        m, g = loss_and_grads(loss_fn, params, mb)
        grads = tree_map(lambda a, gg: a + gg.to(torch.float32) / n_micro, grads, g)
        ms.append(m)
    return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}, grads


# ---------------------------------------------------------------------------
# sharding specs for the full train state
# ---------------------------------------------------------------------------


def _zero1(spec, shape, mesh):
    """Add 'data' sharding to the first unsharded, divisible dim (ZeRO-1)."""
    from repro_torch.parallel.sharding import P

    if "data" not in mesh.shape:
        return spec
    d = mesh.shape["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % d == 0 and dim >= d:
            parts[i] = "data"
            return P(*parts)
    return spec


def state_specs(cfg: ModelConfig, mesh, run: RunConfig, params_abs, opt_state_abs) -> TrainState:
    """Spec tree (``parallel.sharding.P`` leaves) for {"params", "opt",
    "step"}, the reference's: optimizer moments mirror the param specs and
    with ZeRO-1 additionally shard over 'data'; Shampoo's stat stacks
    ((nb, b, b) dense, (nb, T, bn, bn) packed) shard their block dim over
    'data' (block ownership). ``params_abs``/``opt_state_abs`` may be
    tensors on the ``meta`` device."""
    from repro_torch.parallel.sharding import P, leaf_shape, map_specs, param_specs

    p_specs = param_specs(mesh, cfg)
    zero1 = run.optimizer.zero1

    def like_param(spec_tree, abs_tree):
        return map_specs(lambda spec, ab: _zero1(spec, leaf_shape(ab), mesh) if zero1 else spec,
                         spec_tree, abs_tree)

    opt_specs = {"m": like_param(p_specs, params_abs), "v": like_param(p_specs, params_abs),
                 "step": P()}
    if run.optimizer.name != "adamw":
        def shampoo_leaf_spec(ab):
            shape = leaf_shape(ab)
            if len(shape) in (3, 4):
                shard = zero1 and "data" in mesh.shape and shape[0] % mesh.shape["data"] == 0
                return P(*(["data" if shard else None] + [None] * (len(shape) - 1)))
            return P(*([None] * len(shape)))

        opt_specs["shampoo"] = tree_map(shampoo_leaf_spec, opt_state_abs["shampoo"])
    return {"params": p_specs, "opt": opt_specs, "step": P()}


def _reshard(x, mesh, src, dst):
    """A block held under spec ``src`` as the block under ``dst``."""
    from repro_torch.parallel.sharding import P, gather, local_block

    nd = x.dim()
    a = list(src) + [None] * (nd - len(src))
    b = list(dst) + [None] * (nd - len(dst))
    common = P(*(s if s == t else None for s, t in zip(a, b)))
    return local_block(gather(x, mesh, P(*a), keep=common), mesh, P(*b), have=common)


def held_state_specs(cfg, mesh, run: RunConfig, opt, params) -> TrainState:
    """The spec tree of the train state a rank holds,
    ``held(state_specs(...))``, for this rank's ``params`` (the experts as
    its block): the specs come from the parameters and optimizer state of
    the global shapes, made on the ``meta`` device."""
    from repro_torch.parallel.sharding import global_shape, held, map_specs, param_specs

    p_held = held(param_specs(mesh, cfg), cfg, mesh)
    meta = map_specs(lambda s, x: torch.empty(global_shape(x, mesh, s), dtype=x.dtype,
                                              device="meta"), p_held, params)
    return held(state_specs(cfg, mesh, run, meta, opt.init(meta)), cfg, mesh)


def init_state(cfg: ModelConfig, mesh, run: RunConfig, opt, params) -> TrainState:
    """This rank's train state: ``params`` as ``transformer.init`` gives
    them on ``mesh`` (the expert-parallel experts as this rank's block),
    the optimizer state cut to its held blocks (``held(state_specs)``).
    The state is made one parameter at a time (``opt.init`` of a tree
    whose other leaves are on the ``meta`` device) and cut at once, so no
    rank ever holds the whole optimizer state. ``opt``'s state must be a
    dict of trees shaped like the parameters and of scalars."""
    from repro_torch.parallel.sharding import held, map_specs, param_specs
    from repro_torch.runtime.elastic import reshard_tree

    p_held = held(param_specs(mesh, cfg), cfg, mesh)
    specs = held_state_specs(cfg, mesh, run, opt, params)["opt"]
    leaves, treedef = tree_flatten(
        map_specs(lambda s, x: _reshard(x, mesh, s, ()), p_held, params))
    meta = [torch.empty_like(x, device="meta") for x in leaves]
    parts, scalars = {}, {}
    for i, x in enumerate(leaves):
        one = opt.init(treedef.unflatten(meta[:i] + [x] + meta[i + 1:]))
        for key, sub in one.items():
            if key in specs and isinstance(specs[key], dict | list):
                mine = treedef.flatten_up_to(sub)[i]
                spec = treedef.flatten_up_to(specs[key])[i]
                parts.setdefault(key, []).append(reshard_tree(mine, mesh, spec))
            elif i == 0:
                scalars[key] = sub
        del one
    state = {k: treedef.unflatten(v) for k, v in parts.items()}
    return {"params": params, "opt": {**state, **scalars},
            "step": torch.zeros((), dtype=torch.int32)}


def _meshed_step(cfg, mesh, run, opt, loss_fn, n_micro, max_grad_norm):
    """The train step of one rank of ``mesh`` (module docstring)."""
    from repro_torch.launch import collectives as C
    from repro_torch.parallel.sharding import (batch_input_specs, data_axes, held,
                                               local_block, map_specs, param_specs,
                                               spec_leaves)

    dp = data_axes(mesh)
    n_data = mesh.axis_size(dp) if dp else 1
    dgroup = mesh.group(dp) if dp else None
    p_held = held(param_specs(mesh, cfg), cfg, mesh)
    specs = {}
    seq_loss_fn = make_loss_fn(cfg, mesh, run, seq_axes=dp)

    def local_batch(batch):
        """The rank's block of the global batch (``batch_input_specs``):
        its rows, or where the data axes do not divide the batch its slice
        of the sequence (the loss is then the token mean over the data
        ranks' equal slices). Returns (block, the axes its sequence is
        sharded over or None)."""
        specs = batch_input_specs(mesh, batch)
        seq = None
        if dp and n_data > 1 and any(x.dim() >= 2 and specs[k][0] is None and
                                     specs[k][1] is not None for k, x in batch.items()):
            seq = dp
        return {k: local_block(batch[k], mesh, spec) for k, spec in specs.items()}, seq

    def average(x):
        return C.all_reduce(x, dgroup) / n_data if n_data > 1 else x

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state["params"]
        block, seq = local_batch(batch)
        fn = loss_fn if seq is None else seq_loss_fn
        metrics, grads = _grads(fn, params, block, n_micro)
        grads = tree_map(average, grads)
        metrics = {k: (v if k == "aux" else average(v)) for k, v in metrics.items()}

        # the global norm: each leaf's squares, summed over the ranks that
        # hold its blocks (the expert-parallel experts)
        def sq(spec, g):
            s = torch.sum(torch.square(g.to(torch.float32)))
            axes = tuple(a for a in spec if a is not None)
            return C.all_reduce(s, mesh.group(axes)) if axes else s

        gnorm = torch.sqrt(torch.sum(torch.stack(tree_leaves(map_specs(sq, p_held, grads)))))
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

        if "opt" not in specs:
            specs["opt"] = held_state_specs(cfg, mesh, run, opt, params)["opt"]
        o_specs = specs["opt"]
        m_specs = spec_leaves(o_specs["m"])
        if "shampoo" in state["opt"]:
            # whole gradients and parameters in; each update comes back as
            # the block of its leaf's momentum spec (Adam: m's)
            g_full = map_specs(lambda s, x: _reshard(x, mesh, s, ()), p_held, grads)
            p_full = map_specs(lambda s, x: _reshard(x, mesh, s, ()), p_held, params)
            updates, opt_state = opt.update(g_full, state["opt"], p_full, mesh=mesh,
                                            specs=o_specs)
            del grads, g_full     # before the parameters' all-gathers
            s_leaves = tree_flatten(params)[1].flatten_up_to(o_specs["shampoo"])
            u_specs = [s["mom"] if isinstance(s, dict) else m for s, m in zip(s_leaves, m_specs)]
            p_blocks = [local_block(p, mesh, s) for p, s in zip(tree_leaves(p_full), u_specs)]
        else:
            g_blk = map_specs(lambda s, h, x: _reshard(x, mesh, h, s), o_specs["m"], p_held,
                              grads)
            p_blk = map_specs(lambda s, h, x: _reshard(x, mesh, h, s), o_specs["m"], p_held,
                              params)
            updates, opt_state = opt.update(g_blk, state["opt"], p_blk)
            del grads, g_blk      # before the parameters' all-gathers
            u_specs, p_blocks = m_specs, tree_leaves(p_blk)
        u_leaves, treedef = tree_flatten(updates)
        new = [_reshard((p + u).to(p.dtype), mesh, s, h)
               for p, u, s, h in zip(p_blocks, u_leaves, u_specs, spec_leaves(p_held))]
        metrics = dict(metrics, grad_norm=gnorm)
        return {"params": treedef.unflatten(new), "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step
