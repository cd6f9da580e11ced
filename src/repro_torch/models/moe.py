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

With a mesh (one process a rank, ``launch.mesh``), each rank holds its
block of the batch:

* with one ``model`` rank and several data ranks the tokens are routed as
  the reference's no-mesh path routes the global batch: each rank
  computes its tokens' routing weights, the ``(T, E_pad)`` weights are
  all-gathered over the data axes, each expert takes its top-C of all
  tokens with one capacity (stable sort, lowest index first), and the rank
  keeps the selections of its own tokens. ``aux`` is the global batch's;
* with ``M > 1`` ``model`` ranks each rank routes its block of the batch
  (capacity from its own tokens, as the reference's ``_moe_local`` sees
  its data shard), with the routing repeated on every ``model`` rank:

  - **expert parallelism** (``cfg.moe.sharding == "ep"`` and ``M``
    dividing the padded expert count): the rank holds its ``E_pad / M``
    experts (the expert dim of wg/wu/wd is its block), computes their
    outputs and the ranks sum them (``launch.collectives.reduce_replicas``);
  - **the TP fallback** (otherwise): the rank holds its block of every
    expert's ff dim (``param_specs``' ``P(None, None, "model")``), so its
    outputs are partial and are summed.

  Each rank's gradients of the tokens and the routing weights cover its
  own part, so the region marks them with ``collectives.sum_grads``.
  ``aux`` is the same on every ``model`` rank (the routing is repeated
  there) and is averaged over the data axes; the reference averages it
  over every axis, which gives the same value.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.models.layers import acc_dtype, model_ranks, normal, padded, splits

__all__ = ["init_moe", "moe_layer", "moe_capacity"]


def init_moe(generator, cfg, mesh=None, device="cuda", lead=()) -> dict:
    """One MoE block's parameters, each with the leading dims ``lead``.
    With a mesh the experts are padded to a multiple of its ``model`` axis
    (``parallel.sharding.pad_experts``) with zero dummies (the router masks
    them), so the real experts' draws do not depend on the mesh
    (``transformer.init`` cuts a rank's blocks out of them)."""
    from repro_torch.parallel.sharding import pad_experts

    d = cfg.d_model
    f = cfg.moe.d_ff_expert
    e0 = cfg.moe.num_experts
    e = pad_experts(e0, mesh) if mesh is not None else e0
    scale = d ** -0.5
    dim = len(lead)

    def experts(shape, s):
        return padded(normal(generator, (*lead, e0, *shape), s, device), dim, e)

    return {
        "router": padded(normal(generator, (*lead, d, e0), scale, device), dim + 1, e),
        "wg": experts((d, f), scale),
        "wu": experts((d, f), scale),
        "wd": experts((f, d), f ** -0.5),
        "norm": torch.zeros((*lead, d), dtype=torch.float32, device=device),
    }


def _ep(cfg, mesh, e_pad: int) -> bool:
    """Whether the experts are split over ``model`` (expert parallelism)."""
    m = model_ranks(mesh)
    return m > 1 and cfg.moe.sharding == "ep" and e_pad % m == 0


def moe_capacity(tokens: int, num_experts: int, top_k: int, cf: float) -> int:
    """Per-expert capacity C, padded to a multiple of 8 (sublane)."""
    c = int(tokens * top_k / num_experts * cf) + 1
    return -(-c // 8) * 8


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: the k largest, ties to the
    lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_local(x, router, wg, wu, wd, *, cfg, e_pad: int, mesh=None, mode=None,
               seq_sharded: bool = False):
    """The MoE compute of one rank. x: (B, S, d). ``mode`` is None (all
    experts, whole), ``"ep"`` (wg/wu/wd hold this ``model`` rank's experts),
    ``"tp"`` (its block of every expert's ff dim) or ``"global"`` (one
    ``model`` rank, several data ranks: routed over the global batch); for
    ``"ep"``/``"tp"`` the result is this rank's part of the output, to be
    summed. ``seq_sharded``: the rank's block is a slice of the sequence
    (a global batch the data axes do not divide)."""
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
    if mode == "global":
        from repro_torch.parallel.sharding import data_axes

        dp = data_axes(mesh)
        n = mesh.axis_size(dp)
        frac_tokens = C.all_reduce(frac_tokens, mesh.group(dp)) / n
        # each rank's loss carries the global aux; the train step averages
        # the ranks' gradients, so each rank's share is summed back
        frac_probs = C.reduce_replicas(C.sum_grads(frac_probs, mesh, dp), mesh, dp) / n
    aux = moe.num_experts * torch.sum(frac_tokens * frac_probs)

    e0 = 0
    if mode in ("ep", "tp"):
        # each rank's gradients of the tokens and routing weights (in the
        # TP fallback: of its own ff blocks) cover its part of the output
        xf = C.sum_grads(xf, mesh, "model")
        w_full = C.sum_grads(w_full, mesh, "model")
        if mode == "ep":
            m, j = mesh.shape["model"], mesh.axis_index("model")
            e0 = j * (e_pad // m)
            w_sel = w_full[:, e0:e0 + e_pad // m]
        else:
            w_sel = w_full
    else:
        w_sel = w_full

    if mode == "global":
        sel_w, sel_t, active = _global_select(w_sel, mesh, moe, e_pad, b, s, seq_sharded)
    else:
        cap = min(moe_capacity(t, e_pad, moe.top_k, moe.capacity_factor), t)
        # capacity-select: per expert, top-C tokens by routing weight
        sel_w, sel_t = _top(w_sel.T, cap)                             # (E, C)
        active = sel_w > 0.0
    xg = xf[sel_t]                                                    # (E, C, d)

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
    experts = torch.arange(e0, e0 + sel_t.shape[0], device=x.device)[:, None].expand_as(sel_t)
    slot = torch.where(active, rank[sel_t, experts], moe.top_k)
    buf = torch.zeros((t, moe.top_k + 1, d), dtype=xf.dtype, device=x.device)
    buf = buf.index_put((sel_t.reshape(-1), slot.reshape(-1)), out_e.reshape(-1, d))
    yf = buf[:, 0]
    for j in range(1, moe.top_k):
        yf = yf + buf[:, j]
    return yf.reshape(b, s, d), aux


def _global_select(w_loc, mesh, moe, e_pad: int, b: int, s: int, seq_sharded: bool):
    """Each expert's top-C of the global batch's tokens by routing weight
    (one capacity), restricted to this data rank's tokens: (sel_w, sel_t,
    active), (E, C') with C' the most any expert keeps here, ``sel_t`` the
    rank's local token indices and ``sel_w`` the rank's own (differentiable)
    weights."""
    from repro_torch.parallel.sharding import data_axes

    dp = data_axes(mesh)
    n, r = mesh.axis_size(dp), mesh.axis_index(dp)
    t = b * s
    w_all = C.all_gather_dim(w_loc.detach(), mesh, dp, 0)             # (n·T, E), rank-major
    if seq_sharded:
        # the ranks hold slices of the sequence: global token order is
        # batch-major over the whole sequence
        w_all = w_all.reshape(n, b, s, e_pad).transpose(0, 1).reshape(n * t, e_pad)
        ids = (torch.arange(b, device=w_loc.device)[:, None] * (n * s) + r * s
               + torch.arange(s, device=w_loc.device)[None, :]).reshape(-1)
    else:
        ids = r * t + torch.arange(t, device=w_loc.device)
    t_all = n * t
    cap = min(moe_capacity(t_all, e_pad, moe.top_k, moe.capacity_factor), t_all)
    sel_w, sel_g = _top(w_all.T, cap)                                 # (E, C) global ids
    local = torch.full((t_all,), -1, dtype=torch.int64, device=w_loc.device)
    local[ids] = torch.arange(t, device=w_loc.device)
    sel_l = local[sel_g]                                              # -1: another rank's
    mine = sel_l >= 0
    keep = max(int(mine.sum(1).max()), 1)
    # the rank's entries first, in their order (descending weight)
    order = torch.sort((~mine).to(torch.int8), dim=1, stable=True).indices[:, :keep]
    sel_l = torch.gather(sel_l, 1, order).clamp(min=0)
    active = torch.gather(mine & (sel_w > 0.0), 1, order)
    experts = torch.arange(w_loc.shape[1], device=w_loc.device)[:, None].expand_as(sel_l)
    return w_loc[sel_l, experts], sel_l, active


def moe_layer(p: dict, x: torch.Tensor, cfg, mesh=None,
              seq_sharded: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) → (y, aux_loss). Without a mesh (or with one
    rank) the local path; with one ``model`` rank and several data ranks,
    the global routing; with several ``model`` ranks, this rank's block of
    the batch, expert-parallel or by the TP fallback (see the module
    docstring). ``seq_sharded``: the rank's block is a slice of the
    sequence."""
    from repro_torch.parallel.sharding import data_axes

    e_pad = p["router"].shape[-1]
    m = model_ranks(mesh)
    dp = data_axes(mesh) if mesh is not None else ()
    n_data = mesh.axis_size(dp) if dp else 1
    mode = None
    if m > 1:
        if _ep(cfg, mesh, e_pad):
            mode = "ep"
        elif splits(cfg.moe.d_ff_expert, m):
            mode = "tp"
    elif n_data > 1:
        mode = "global"
    y, aux = _moe_local(x, p["router"], p["wg"], p["wu"], p["wd"], cfg=cfg, e_pad=e_pad,
                        mesh=mesh, mode=mode, seq_sharded=seq_sharded)
    if mode in ("ep", "tp"):
        y = C.reduce_replicas(y, mesh, "model")
    if mode != "global" and n_data > 1:
        # the mean over the data ranks, each rank's loss a term of the
        # objective: the cotangent is summed back over them
        aux = C.reduce_replicas(C.sum_grads(aux, mesh, dp), mesh, dp) / n_data
    return y, aux
