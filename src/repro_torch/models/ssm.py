"""Mamba-2 (SSD — state-space duality) blocks (port of ``repro.models.ssm``).

Training/prefill uses the chunked SSD algorithm (intra-chunk quadratic +
inter-chunk recurrent state pass, a Python loop over chunks); decode uses
the O(1) recurrent update. The layer is attention-free: its state is
``(B, H, head_dim, d_state)``.

Shapes follow the Mamba-2 paper: ``d_inner = expand·d_model``,
``H = d_inner / head_dim`` SSD heads, scalar-per-head ``A``; B and C are
shared across heads (single group), conv over the ``[x, B, C]`` channels.
The reference has no Pallas kernel here (its scan is ``jnp``), and neither
has the port.

Departures:

* the reference's float32 statistics and SSD state are :func:`acc_dtype`
  of the compute dtype here (float32, or float64 for float64 compute), as
  in ``models.layers``;
* a chunk's decay exponents (the sums of ``dt·A`` over a segment) are
  summed directly, where the reference subtracts two running sums. The
  subtraction loses ``|Σ dt·A|·eps`` of each exponent: at mamba2-1.3b's
  full width with random weights a 256-chunk's sum reaches ~1e3, and the
  reference's form puts the float32 prefill ~3e-5 a layer off float64
  where the recurrent decode is ~2e-6 off, which over 48 layers breaks
  the teacher-forced decode bound (2e-3). The two forms are equal in
  exact arithmetic;
* ``F.softplus`` returns ``x`` itself above 20, where ``jax.nn.softplus``
  computes ``log1p(exp(x))``: the two differ by less than 2e-9.

With a mesh (one process a rank):

* with ``M > 1`` ``model`` ranks, where the reference pins the head
  grid's sharding and leaves the SSD to GSPMD, the port computes the
  block tensor-parallel, on the rank's blocks of ``param_specs``:
  ``x_proj``/``z_proj`` are column-parallel over ``d_inner``, so each rank
  computes the ``x`` and ``z`` of its SSD heads (or, in hymba's
  ``p_major`` layout, of its P channels: the rank's ``d_inner`` block is
  a block of P there); ``bc_proj``/``dt_proj`` stay whole; the conv acts
  on the rank's channels and ``[B, C]`` (its weight block is gathered:
  ``param_specs`` cuts the conv's ``[x, B, C]`` channels in one block
  each); the gated norm takes its variance over ``model`` and multiplies
  by the rank's ``gnorm`` block; ``out_proj`` is row-parallel and its
  partial outputs are summed. The scan is independent per head and per P
  channel. ``return_state`` returns this rank's block of the final state
  ``h`` and of the conv tail, as ``parallel.sharding.cache_specs`` lays the
  decode cache out (which cuts ``h`` by heads wherever ``M`` divides them,
  so a ``p_major`` block is moved to the heads there), and
  :func:`ssm_decode` takes and returns those blocks;
* a batch-1 input whose sequence is sharded over the data axes
  (``seq_axes``): the reference pins the head grid with the sequence whole,
  so the port gathers the conv's and the SSD's inputs over those axes
  (``collectives.gather_params``: the backward pass sums the ranks'
  cotangents), runs both on the whole sequence and keeps its slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from repro_torch.launch import collectives as C
from repro_torch.models.layers import (acc_dtype, model_block, model_ranks, normal, remat,
                                       splits)

__all__ = ["init_ssm", "ssm_train", "ssm_decode", "init_ssm_state"]


def init_ssm(generator, cfg, device="cuda", lead=()) -> dict:
    """One SSD block's parameters, each with the leading dims ``lead``."""
    d = cfg.d_model
    s = cfg.ssm
    di = s.d_inner(d)
    nh = s.num_heads(d)
    ns = s.d_state
    scale = d ** -0.5
    device = torch.device(device)

    def const(values):
        if device.type == "meta":
            return torch.empty((*lead, nh), dtype=torch.float32, device=device)
        return values.to(device).expand(*lead, nh).clone()

    return {
        "x_proj": normal(generator, (*lead, d, di), scale, device),
        "z_proj": normal(generator, (*lead, d, di), scale, device),
        "bc_proj": normal(generator, (*lead, d, 2 * ns), scale, device),
        "dt_proj": normal(generator, (*lead, d, nh), scale, device),
        "conv": normal(generator, (*lead, di + 2 * ns, s.d_conv), s.d_conv ** -0.5, device),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))),
        "d_skip": const(torch.ones((nh,), dtype=torch.float32)),
        "gnorm": torch.zeros((*lead, di), dtype=torch.float32, device=device),
        "out_proj": normal(generator, (*lead, di, d), di ** -0.5, device),
        "norm": torch.zeros((*lead, d), dtype=torch.float32, device=device),
    }


def init_ssm_state(cfg, batch: int, dtype=torch.float32, *,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ssd_state, conv_state) for decode, zeros on ``device``."""
    from repro_torch.backend import resolve_device

    device = resolve_device(device)
    d = cfg.d_model
    s = cfg.ssm
    di = s.d_inner(d)
    nh = s.num_heads(d)
    h = torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype, device=device)
    conv = torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state), dtype=dtype, device=device)
    return h, conv


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, K) causal depthwise conv. Both libraries
    correlate, so tap ``K-1`` multiplies the current token, as in
    :func:`ssm_decode`."""
    k = w.shape[-1]
    x_pad = F.pad(x.transpose(1, 2), (k - 1, 0))                 # (B, C, S + K - 1)
    return F.conv1d(x_pad, w[:, None, :], groups=x.shape[-1]).transpose(1, 2)


def _ssd_chunk(h_carry, x_c, dt_c, b_c, c_c, a):
    """One chunk of the SSD scan: the outputs of its positions and the
    state after it. x_c: (B,Q,H,P), dt_c: (B,Q,H), b_c/c_c: (B,Q,N)."""
    q = x_c.shape[1]
    da = dt_c * a[None, None, :]            # (B,Q,H) negative decay
    cum = torch.cumsum(da, dim=1)
    total = cum[:, -1]                      # (B,H)

    # intra-chunk: L[q,k] = exp(da[k+1] + … + da[q]) for q >= k, the segment
    # sums taken directly (a cumsum of da masked to j > k) rather than as
    # cum[q] - cum[k], whose cancellation costs |cum|·eps of every exponent.
    # Mask *before* exp: the (discarded) upper triangle gets -1e9, so the
    # gradient never meets 0·inf.
    ones = torch.ones((q, q), dtype=torch.bool, device=x_c.device)
    seg = torch.where(ones.tril(-1)[None, :, :, None], da[:, :, None, :], 0.0).cumsum(dim=1)
    rel = torch.where(ones.tril()[None, :, :, None], seg, -1e9)   # (B,Q,K,H)
    l_mat = torch.exp(rel)
    scores = torch.einsum("bqn,bkn->bqk", c_c, b_c)             # head-shared
    xdt = x_c * dt_c[..., None]                                 # (B,K,H,P)
    # the reference's three-operand einsum, as one product and one
    # two-operand einsum, so its order does not depend on opt_einsum
    y_intra = torch.einsum("bqkh,bkhp->bqhp", scores[..., None] * l_mat, xdt)

    # carried-state contribution + state update
    decay_in = torch.exp(cum)                                   # (B,Q,H)
    y_prev = torch.einsum("bqn,bhpn->bqhp", c_c, h_carry) * decay_in[..., None]
    # exp(da[k+1] + … + da[Q-1]): the suffix sums, shifted by one
    suffix = torch.flip(torch.cumsum(torch.flip(da, [1]), 1), [1])
    decay_rest = torch.exp(torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], 1))
    s_chunk = torch.einsum("bkn,bkhp->bhpn", b_c, (dt_c * decay_rest)[..., None] * x_c)
    h_new = h_carry * torch.exp(total)[..., None, None] + s_chunk
    return h_new, y_intra + y_prev


def _ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (softplus'd); a: (H,) (negative);
    b, c: (B, S, N). Returns (y: (B, S, H, P), the final state
    (B, H, P, N)). Each chunk body is checkpointed (the reference's
    ``jax.checkpoint``, :func:`layers.remat`): the backward pass
    recomputes its (B, Q, K, H) decay and score blocks instead of keeping
    one set a chunk.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = -s % chunk
    if pad:
        # whole chunks, as the reference pads: the padded steps have dt = 0
        # (decay 1, increment 0) and their outputs are dropped. Every chunk
        # then has one shape, so a head's or P channel's products do not
        # depend on how many others ride along (the split SSD, bitwise)
        x, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    h_carry = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        h_carry, y = remat(_ssd_chunk, h_carry, x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk],
                           b[:, c0:c0 + chunk], c[:, c0:c0 + chunk], a)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y[:, :s], h_carry


def _split(cfg, mesh):
    """How the cache cuts the SSD state over the ``model`` axis
    (``cache_specs``): ``(dim, ranks)``, dim 1 of the (B, H, P, N) state
    for heads, 2 for P channels, or None (one rank, or neither divides)."""
    m = model_ranks(mesh)
    if m == 1:
        return None
    s_cfg = cfg.ssm
    if splits(s_cfg.num_heads(cfg.d_model), m):
        return 1, m
    if splits(s_cfg.head_dim, m):
        return 2, m
    return None


def _tp(cfg, mesh):
    """The state dim the rank's ``d_inner`` block covers under tensor
    parallelism: 2 (its P channels, ``p_major``), 1 (its heads), or None
    (one ``model`` rank). Raises where the block is not whole heads or P
    channels."""
    m = model_ranks(mesh)
    if m == 1:
        return None
    s_cfg = cfg.ssm
    nh = s_cfg.num_heads(cfg.d_model)
    if s_cfg.p_major and splits(s_cfg.head_dim, m):
        return 2
    if not s_cfg.p_major and splits(nh, m):
        return 1
    raise ValueError(f"the model axis ({m} ranks) splits neither the SSD heads ({nh}) nor, "
                     f"in the p_major layout, the head dim ({s_cfg.head_dim})")


def _conv_split(cfg, mesh) -> bool:
    """Whether the conv state's channels are split over ``model``."""
    m = model_ranks(mesh)
    ch = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
    return splits(ch, m)


def _move_state(h, mesh, src, dst):
    """A block of the (B, H, P, N) state cut along ``src`` as the block cut
    along ``dst`` (both over ``model``; no-grad paths)."""
    if src == dst:
        return h
    return model_block(C.all_gather_dim(h, mesh, "model", src), mesh, dst).contiguous()


def _conv_weights(p, cfg, mesh, dtype):
    """The conv taps of the rank's ``[x, B, C]`` channels, (di/M + 2N, K):
    the held block of the conv weight (or the whole one) gathered, then
    the rank's x channels and the B/C channels taken."""
    w = p["conv"]
    if _conv_split(cfg, mesh):
        w = C.gather_params(w, mesh, "model", 0)
    di = cfg.ssm.d_inner(cfg.d_model)
    return torch.cat([model_block(w[:di], mesh, 0), w[di:]], 0).to(dtype)


def _heads(x, s_cfg, nh):
    """(..., d_inner) → (..., H, P) in the config's head layout."""
    if s_cfg.p_major:
        # (…, P, H) → (…, H, P): the model-sharded d_inner axis lands on P
        return x.reshape(*x.shape[:-1], s_cfg.head_dim, nh).transpose(-1, -2)
    return x.reshape(*x.shape[:-1], nh, s_cfg.head_dim)


def _gated_out(p, y, z, dtype, mesh=None):
    """Mamba-2's gated RMSNorm (norm-before-out with the z gate), then the
    out projection. With ``mesh``, y and z are the rank's ``d_inner`` block:
    the variance is summed over ``model`` and ``out_proj`` is row-parallel,
    its partial outputs summed."""
    acc = acc_dtype(dtype)
    y = y * F.silu(z)
    yf = y.to(acc)
    if mesh is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        # every rank normalizes its block by the whole variance: its
        # cotangent is summed back
        ss = C.reduce_replicas(torch.sum(yf * yf, dim=-1, keepdim=True), mesh, "model")
        var = C.sum_grads(ss, mesh, "model") / (yf.shape[-1] * mesh.shape["model"])
    y = (yf * torch.rsqrt(var + 1e-6) * (1.0 + p["gnorm"].to(acc))).to(dtype)
    out = torch.matmul(y, p["out_proj"].to(dtype))
    return out if mesh is None else C.reduce_replicas(out, mesh, "model")


def ssm_train(p: dict, x_in: torch.Tensor, cfg, return_state: bool = False, mesh=None,
              seq_axes=None):
    """Full-sequence SSD block. x_in: (B, S, D) → (B, S, D).

    With ``return_state`` also returns (h_final, conv_state) so prefill can
    hand off to the recurrent decode path: the SSD state in float32 (or
    float64) and the last ``K-1`` *pre-conv* channels, left-padded with
    zeros when the sequence is shorter. With a mesh of several ``model``
    ranks, ``p`` holds the rank's blocks (module docstring); ``seq_axes``:
    ``x_in`` is this rank's slice of the sequence over those (data) axes."""
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    ns = s_cfg.d_state
    dtype = x_in.dtype
    acc = acc_dtype(dtype)
    tp = _tp(cfg, mesh)
    m = model_ranks(mesh)
    d_loc = di // m if tp else di
    pw = {k: p[k] for k in ("bc_proj", "dt_proj", "a_log", "d_skip")}
    if tp:
        # a replicated input and whole weights each rank uses for its own
        # heads (or P channels): their cotangents are summed
        x_in = C.sum_grads(x_in, mesh, "model")
        pw = {k: C.sum_grads(w, mesh, "model") for k, w in pw.items()}

    x = torch.matmul(x_in, p["x_proj"].to(dtype))
    z = torch.matmul(x_in, p["z_proj"].to(dtype))
    bc = torch.matmul(x_in, pw["bc_proj"].to(dtype))
    dt = torch.matmul(x_in, pw["dt_proj"].to(dtype))

    xbc_raw = torch.cat([x, bc], dim=-1)
    if seq_axes:
        # the conv and the scan run over the whole sequence
        xbc_raw = C.gather_params(xbc_raw, mesh, seq_axes, 1)
        dt = C.gather_params(dt, mesh, seq_axes, 1)
    w_conv = _conv_weights(p, cfg, mesh, dtype) if tp else p["conv"].to(dtype)
    xbc = F.silu(_depthwise_causal_conv(xbc_raw, w_conv))
    x, b, c = torch.split(xbc, [d_loc, ns, ns], dim=-1)

    dt = F.softplus(dt.to(acc))
    a = -torch.exp(pw["a_log"].to(acc))
    d_skip = pw["d_skip"].to(acc)
    if tp == 1:
        dt = model_block(dt, mesh, 2)
        a, d_skip = model_block(a, mesh, 0), model_block(d_skip, mesh, 0)
    h_loc = nh // m if tp == 1 else nh
    p_loc = s_cfg.head_dim // m if tp == 2 else s_cfg.head_dim
    if s_cfg.p_major:
        # (…, P, H) → (…, H, P): the model-sharded d_inner axis lands on P
        xh = x.reshape(*x.shape[:-1], p_loc, h_loc).transpose(-1, -2)
    else:
        xh = x.reshape(*x.shape[:-1], h_loc, p_loc)
    y, h_final = _ssd_chunked(xh.to(acc), dt, a, b.to(acc), c.to(acc), s_cfg.chunk)
    y = y + xh.to(acc) * d_skip[None, None, :, None]
    if s_cfg.p_major:
        y = y.transpose(-1, -2)
    y = y.reshape(*y.shape[:2], d_loc).to(dtype)
    if seq_axes:
        y = _seq_slice(y, mesh, seq_axes)
    out = _gated_out(p, y, z, dtype, mesh if tp else None)
    if return_state:
        k = s_cfg.d_conv - 1
        tail = xbc_raw[:, -k:].to(acc)
        if tail.shape[1] < k:  # sequences shorter than the conv receptive field
            tail = F.pad(tail, (0, 0, k - tail.shape[1], 0))
        if tp:
            # the cache's blocks: the whole [x, B, C] tail cut by channels,
            # the state cut as ``cache_specs`` cuts it
            tail = torch.cat([C.all_gather_dim(tail[..., :d_loc], mesh, "model", 2),
                              tail[..., d_loc:]], 2)
            if _conv_split(cfg, mesh):
                tail = model_block(tail, mesh, 2)
            h_final = _move_state(h_final, mesh, tp, _split(cfg, mesh)[0])
        return out, (h_final.to(acc), tail)
    return out


def _seq_slice(x, mesh, seq_axes):
    """This rank's slice (dim 1) of a sequence gathered over ``seq_axes``."""
    n = x.shape[1] // mesh.axis_size(seq_axes)
    return x.narrow(1, mesh.axis_index(seq_axes) * n, n)


def ssm_decode(
    p: dict,
    x_in: torch.Tensor,
    cfg,
    h: torch.Tensor,
    conv_state: torch.Tensor,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step.

    x_in: (B, 1, D); h: (B, H, P, N); conv_state: (B, K-1, C).
    Returns (y (B,1,D), new_h, new_conv_state), new tensors (the caller
    stores them; ``transformer.forward_decode`` copies them into its
    cache). With a mesh of several ``model`` ranks, ``p`` holds the rank's
    blocks and ``h`` and ``conv_state`` are the cache's blocks
    (``parallel.sharding.cache_specs``): each rank steps its channels and
    its heads or P channels (module docstring), and the conv state's new
    column is gathered over ``model``.
    """
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    ns = s_cfg.d_state
    dtype = x_in.dtype
    acc = acc_dtype(dtype)
    tp = _tp(cfg, mesh)
    m = model_ranks(mesh)
    d_loc = di // m if tp else di

    x = torch.matmul(x_in, p["x_proj"].to(dtype))
    z = torch.matmul(x_in, p["z_proj"].to(dtype))
    bc = torch.matmul(x_in, p["bc_proj"].to(dtype))
    dt = torch.matmul(x_in, p["dt_proj"].to(dtype))

    # the window is in the promotion of the state's and the compute dtype,
    # as jnp.concatenate promotes
    win_t = torch.promote_types(conv_state.dtype, dtype)
    xbc = torch.cat([x, bc], dim=-1)[:, 0]                             # (B, C)
    if tp:
        full = conv_state
        if _conv_split(cfg, mesh):
            full = C.all_gather_dim(conv_state, mesh, "model", 2)
        state = torch.cat([model_block(full[..., :di], mesh, 2), full[..., di:]], 2)
        window = torch.cat([state.to(win_t), xbc[:, None].to(win_t)], dim=1)
        new_col = torch.cat([C.all_gather_dim(x[:, 0], mesh, "model", 1), bc[:, 0]], 1)
        new_conv_state = torch.cat([full[:, 1:].to(win_t), new_col[:, None].to(win_t)], 1)
        if _conv_split(cfg, mesh):
            new_conv_state = model_block(new_conv_state, mesh, 2)
        w = _conv_weights(p, cfg, mesh, dtype).to(win_t)
    else:
        window = torch.cat([conv_state.to(win_t), xbc[:, None].to(win_t)], dim=1)  # (B, K, C)
        new_conv_state = window[:, 1:]
        w = p["conv"].to(dtype).to(win_t)                               # (C, K)
    xbc = F.silu(torch.einsum("bkc,ck->bc", window, w))
    x, b, c = torch.split(xbc, [d_loc, ns, ns], dim=-1)

    dt = F.softplus(dt[:, 0].to(acc))                                   # (B, H)
    a = -torch.exp(p["a_log"].to(acc))
    d_skip = p["d_skip"].to(acc)
    if tp == 1:
        dt = model_block(dt, mesh, 1)
        a, d_skip = model_block(a, mesh, 0), model_block(d_skip, mesh, 0)
    da = torch.exp(dt * a[None])                                        # (B, H)
    h_loc = nh // m if tp == 1 else nh
    p_loc = s_cfg.head_dim // m if tp == 2 else s_cfg.head_dim
    if s_cfg.p_major:
        xh = x.reshape(-1, p_loc, h_loc).transpose(-1, -2).to(acc)
    else:
        xh = x.reshape(-1, h_loc, p_loc).to(acc)
    if tp:
        h = _move_state(h, mesh, _split(cfg, mesh)[0], tp)

    # h ← h·exp(dt·A) + dt · B ⊗ x
    inc = (dt[:, :, None] * xh)[..., None] * b.to(acc)[:, None, None, :]
    h = h * da[..., None, None] + inc
    y = torch.einsum("bn,bhpn->bhp", c.to(acc), h)
    y = y + xh * d_skip[None, :, None]
    if tp:
        h = _move_state(h, mesh, tp, _split(cfg, mesh)[0])
    if s_cfg.p_major:
        y = y.transpose(-1, -2)
    y = y.reshape(-1, 1, d_loc).to(dtype)
    return _gated_out(p, y, z, dtype, mesh if tp else None), h, new_conv_state
