"""Mixture-of-Experts layer (port of ``repro.models.moe``, one device).

Token-choice top-k routing with capacity: the router's probabilities for
every token, then for each expert the top-C tokens by routing weight
(tokens beyond capacity are dropped, as in GShard/Switch), the expert FFNs
as one batched product over (E, C, d), and the weighted expert outputs
summed back into each token. Dummy padded experts are masked in the
router so they attract no tokens. Shared experts are a dense gated MLP
handled outside this module (``models.transformer``). The reference has
no Pallas kernel here, and neither has the port.

What the port does that the reference leaves to its libraries:

* **Ties.** ``jax.lax.top_k`` returns equal values lowest index first;
  ``torch.topk`` promises no order. Both selections (the router's top-k
  and each expert's top-C) take the first entries of a stable descending
  ``torch.sort``, so ties go to the lowest index, as in the reference.
  They are common in the capacity step, where most routing weights are 0.
* **The combine.** The reference scatter-adds the expert outputs into the
  tokens in expert-major order. ``index_add_`` on CUDA adds with atomics,
  in an order that changes from run to run. Here each token's
  contributions go into its own slots, one a chosen expert in expert
  order, and are summed slot by slot: the reference's order, and bitwise
  repeatable on the card.

Without a mesh the layer runs locally, as the reference's no-mesh path;
any mesh raises, since the expert-parallel ``shard_map`` path and
``pad_experts`` wait for the sharding slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import acc_dtype, check_mesh, normal

__all__ = ["init_moe", "moe_layer", "moe_capacity"]


def init_moe(generator, cfg, mesh=None, device="cuda", lead=()) -> dict:
    """One MoE block's parameters, each with the leading dims ``lead``.
    Without a mesh the experts are not padded."""
    check_mesh(mesh)
    d = cfg.d_model
    f = cfg.moe.d_ff_expert
    e = cfg.moe.num_experts
    scale = d ** -0.5
    return {
        "router": normal(generator, (*lead, d, e), scale, device),
        "wg": normal(generator, (*lead, e, d, f), scale, device),
        "wu": normal(generator, (*lead, e, d, f), scale, device),
        "wd": normal(generator, (*lead, e, f, d), f ** -0.5, device),
        "norm": torch.zeros((*lead, d), dtype=torch.float32, device=device),
    }


def moe_capacity(tokens: int, num_experts: int, top_k: int, cf: float) -> int:
    """Per-expert capacity C, padded to a multiple of 8 (sublane)."""
    c = int(tokens * top_k / num_experts * cf) + 1
    return -(-c // 8) * 8


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: the k largest, ties to the
    lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_local(x, router, wg, wu, wd, *, cfg, e_pad: int):
    """The MoE compute of one device. x: (B, S, d)."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    acc = acc_dtype(x.dtype)

    # --- routing ---
    logits = torch.matmul(xf.to(acc), router.to(acc))                 # (T, E_pad)
    if e_pad > moe.num_experts:     # mask padded dummy experts
        pad_mask = torch.arange(e_pad, device=x.device) >= moe.num_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top(probs, moe.top_k)                             # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)  # renorm

    # dense routing-weight matrix restricted to top-k: (T, E_pad)
    w_full = torch.zeros((t, e_pad), dtype=acc, device=x.device).scatter(1, top_i, top_p)

    # aux load-balance loss (computed on true experts only)
    chosen = w_full > 0
    frac_tokens = chosen[:, :moe.num_experts].to(acc).mean(0)
    frac_probs = probs[:, :moe.num_experts].mean(0)
    aux = moe.num_experts * torch.sum(frac_tokens * frac_probs)

    cap = min(moe_capacity(t, e_pad, moe.top_k, moe.capacity_factor), t)
    # capacity-select: per expert, top-C tokens by routing weight
    sel_w, sel_t = _top(w_full.T, cap)                                # (E_pad, C)
    xg = xf[sel_t]                                                    # (E_pad, C, d)
    active = sel_w > 0.0

    g = torch.bmm(xg, wg.to(xf.dtype))
    u = torch.bmm(xg, wu.to(xf.dtype))
    h = F.silu(g) * u
    out_e = torch.bmm(h, wd.to(xf.dtype))
    out_e = out_e * active.to(xf.dtype)[..., None] * sel_w[..., None].to(xf.dtype)

    # combine: an active (expert, slot) entry goes to its token's slot
    # ``rank`` (the expert's place among the token's chosen experts, in
    # expert order); inactive entries go to a spare slot that is dropped.
    # Each token's slots are then summed in expert order.
    rank = torch.cumsum(chosen.to(torch.int64), dim=1) - 1           # (T, E_pad)
    experts = torch.arange(e_pad, device=x.device)[:, None].expand_as(sel_t)
    slot = torch.where(active, rank[sel_t, experts], moe.top_k)
    buf = torch.zeros((t, moe.top_k + 1, d), dtype=xf.dtype, device=x.device)
    buf = buf.index_put((sel_t.reshape(-1), slot.reshape(-1)), out_e.reshape(-1, d))
    yf = buf[:, 0]
    for j in range(1, moe.top_k):
        yf = yf + buf[:, j]
    return yf.reshape(b, s, d), aux


def moe_layer(p: dict, x: torch.Tensor, cfg, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) → (y, aux_loss), by the local path. A mesh
    raises until the sharding slice."""
    check_mesh(mesh)
    return _moe_local(x, p["router"], p["wg"], p["wu"], p["wd"], cfg=cfg,
                      e_pad=p["router"].shape[-1])
