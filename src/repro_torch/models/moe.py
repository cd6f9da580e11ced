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

With a mesh whose ``model`` axis has ``M > 1`` ranks (one process a
rank, ``launch.mesh``), each rank holds its block of the batch and routes
it (capacity from its own tokens, as the reference's ``_moe_local`` sees
its data shard), with the routing repeated on every ``model`` rank:

* **expert parallelism** (``cfg.moe.sharding == "ep"`` and ``M`` dividing
  the padded expert count): the rank holds its ``E_pad / M`` experts (the
  expert dim of wg/wu/wd is its block), computes their outputs and the
  ranks sum them (``launch.collectives.reduce_replicas``);
* **the TP fallback** (otherwise): every rank holds all experts and
  computes its slice of the ff dim; the partial outputs are summed.

Each rank's gradients of the tokens, of the routing weights (and in the TP
fallback of the whole expert weights) cover its own part, so the region
marks them with ``collectives.sum_grads``. ``aux`` is the same on every
``model`` rank (the routing is repeated there) and is averaged over the
data axes; the reference averages it over every axis, which gives the
same value.

Departure: at a mesh with ``M == 1`` and several data ranks the reference
runs its no-mesh path over the global batch (one capacity for all
tokens); the port routes each data rank's tokens with their own capacity
and averages ``aux``, as the reference does whenever ``M > 1``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.models.layers import acc_dtype, model_ranks, normal, padded

__all__ = ["init_moe", "moe_layer", "moe_capacity"]


def init_moe(generator, cfg, mesh=None, device="cuda", lead=()) -> dict:
    """One MoE block's parameters, each with the leading dims ``lead``.
    With a mesh the experts are padded to a multiple of its ``model`` axis
    (``parallel.sharding.pad_experts``) with zero dummies (the router masks
    them), so the real experts' draws do not depend on the mesh; on a
    rank's mesh (``launch.mesh.Mesh``) under expert parallelism the expert
    weights are this rank's block of the experts, drawn whole and cut."""
    from repro_torch.parallel.sharding import pad_experts

    d = cfg.d_model
    f = cfg.moe.d_ff_expert
    e0 = cfg.moe.num_experts
    e = pad_experts(e0, mesh) if mesh is not None else e0
    scale = d ** -0.5
    cut = _ep(cfg, mesh, e) and hasattr(mesh, "axis_index")
    dim = len(lead)

    def experts(shape, s):
        w = padded(normal(generator, (*lead, e0, *shape), s, device), dim, e)
        if not cut:
            return w
        n = e // mesh.shape["model"]
        return w.narrow(dim, mesh.axis_index("model") * n, n).clone()

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


def _moe_local(x, router, wg, wu, wd, *, cfg, e_pad: int, mesh=None, mode=None):
    """The MoE compute of one rank. x: (B, S, d). ``mode`` is None (all
    experts, whole), ``"ep"`` (wg/wu/wd hold this ``model`` rank's experts)
    or ``"tp"`` (this rank's slice of every expert's ff dim); for the last
    two the result is this rank's part of the output, to be summed."""
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

    e0 = 0
    if mode is not None:
        # each rank's gradients of the tokens and routing weights (and in
        # the TP fallback of the whole expert weights) cover its part
        xf = C.sum_grads(xf, mesh, "model")
        w_full = C.sum_grads(w_full, mesh, "model")
        m, j = mesh.shape["model"], mesh.axis_index("model")
        if mode == "ep":
            e0 = j * (e_pad // m)
            w_sel = w_full[:, e0:e0 + e_pad // m]
        else:
            f = wg.shape[-1]
            if f % m:
                raise ValueError(f"the model axis ({m}) does not divide d_ff_expert ({f})")
            fs = slice(j * (f // m), (j + 1) * (f // m))
            wg, wu, wd = (C.sum_grads(w, mesh, "model") for w in (wg, wu, wd))
            wg, wu, wd = wg[:, :, fs], wu[:, :, fs], wd[:, fs, :]
            w_sel = w_full
    else:
        w_sel = w_full

    cap = min(moe_capacity(t, e_pad, moe.top_k, moe.capacity_factor), t)
    # capacity-select: per expert, top-C tokens by routing weight
    sel_w, sel_t = _top(w_sel.T, cap)                                 # (E, C)
    xg = xf[sel_t]                                                    # (E, C, d)
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
    experts = torch.arange(e0, e0 + sel_t.shape[0], device=x.device)[:, None].expand_as(sel_t)
    slot = torch.where(active, rank[sel_t, experts], moe.top_k)
    buf = torch.zeros((t, moe.top_k + 1, d), dtype=xf.dtype, device=x.device)
    buf = buf.index_put((sel_t.reshape(-1), slot.reshape(-1)), out_e.reshape(-1, d))
    yf = buf[:, 0]
    for j in range(1, moe.top_k):
        yf = yf + buf[:, j]
    return yf.reshape(b, s, d), aux


def moe_layer(p: dict, x: torch.Tensor, cfg, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) → (y, aux_loss). Without a mesh (or with one
    ``model`` rank and one data rank) the local path; with a mesh, this
    rank's block of the batch, expert-parallel or by the TP fallback (see
    the module docstring)."""
    from repro_torch.parallel.sharding import data_axes

    e_pad = p["router"].shape[-1]
    mode = None
    if model_ranks(mesh) > 1:
        mode = "ep" if _ep(cfg, mesh, e_pad) else "tp"
    y, aux = _moe_local(x, p["router"], p["wg"], p["wu"], p["wd"], cfg=cfg, e_pad=e_pad,
                        mesh=mesh, mode=mode)
    if mode is not None:
        y = C.reduce_replicas(y, mesh, "model")
    dp = data_axes(mesh) if mesh is not None else ()
    if dp and mesh.axis_size(dp) > 1:
        # the mean over the data ranks, each rank's loss a term of the
        # objective: the cotangent is summed back over them
        aux = C.reduce_replicas(C.sum_grads(aux, mesh, dp), mesh, dp) / mesh.axis_size(dp)
    return y, aux
