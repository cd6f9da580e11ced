"""AdamW — the baseline optimizer (port of ``repro.optim.adamw``).

``Optimizer`` is the reference's functional (init, update) pair over
parameter trees (nested dicts/lists/tuples of tensors, ``optim._tree``):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The step counter lives in the state as a 0-d int32 tensor **on the CPU**,
whatever device the parameters are on: the learning rate (a schedule of
the step), the bias corrections and Shampoo's refresh test are computed
and read on the host, so none of them waits for the card. The moments live
beside their parameters.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.optim._tree import tree_flatten, tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "apply_updates", "global_norm", "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def zeros_like_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def bias_corrections(step, beta1: float, beta2: float):
    """``(1 − β₁ᵗ, 1 − β₂ᵗ)`` as 0-d float32 tensors of the CPU step."""
    t = step.to(torch.float32)
    return 1.0 - beta1 ** t, 1.0 - beta2 ** t


def adamw(
    lr_schedule: Callable,
    beta1: float = 0.9,
    beta2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        return {
            "m": tree_map(zeros_like_f32, params),
            "v": tree_map(zeros_like_f32, params),
            "step": torch.zeros((), dtype=torch.int32),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_schedule(step)
        bc1, bc2 = bias_corrections(step, beta1, beta2)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = beta1 * m + (1 - beta1) * g
            v = beta2 * v + (1 - beta2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32))
            return u, m, v

        g_leaves, treedef = tree_flatten(grads)
        out = [upd(*xs) for xs in zip(g_leaves, treedef.flatten_up_to(state["m"]),
                                      treedef.flatten_up_to(state["v"]),
                                      treedef.flatten_up_to(params))]
        updates, m, v = (treedef.unflatten(o[i] for o in out) for i in range(3))
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)
