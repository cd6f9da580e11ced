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
* the chunk loop takes a short last chunk where the reference pads the
  sequence to whole chunks (padded steps have ``dt = 0``, so they add
  nothing to the state, and their outputs are dropped);
* a chunk's decay exponents (the sums of ``dt·A`` over a segment) are
  summed directly, where the reference subtracts two running sums. The
  subtraction loses ``|Σ dt·A|·eps`` of each exponent: at mamba2-1.3b's
  full width with random weights a 256-chunk's sum reaches ~1e3, and the
  reference's form puts the float32 prefill ~3e-5 a layer off float64
  where the recurrent decode is ~2e-6 off, which over 48 layers breaks
  the teacher-forced decode bound (2e-3). The two forms are equal in
  exact arithmetic;
* ``F.softplus`` returns ``x`` itself above 20, where ``jax.nn.softplus``
  computes ``log1p(exp(x))``: the two differ by less than 2e-9;
* a mesh (the reference pins the head grid's sharding) raises until the
  sharding slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from repro_torch.models.layers import acc_dtype, check_mesh, normal, remat

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
    h_carry = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        h_carry, y = remat(_ssd_chunk, h_carry, x[:, c0:c1], dt[:, c0:c1], b[:, c0:c1],
                           c[:, c0:c1], a)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h_carry


def _heads(x, s_cfg, nh):
    """(..., d_inner) → (..., H, P) in the config's head layout."""
    if s_cfg.p_major:
        # (…, P, H) → (…, H, P): the model-sharded d_inner axis lands on P
        return x.reshape(*x.shape[:-1], s_cfg.head_dim, nh).transpose(-1, -2)
    return x.reshape(*x.shape[:-1], nh, s_cfg.head_dim)


def _gated_out(p, y, z, dtype):
    """Mamba-2's gated RMSNorm (norm-before-out with the z gate), then the
    out projection."""
    acc = acc_dtype(dtype)
    y = y * F.silu(z)
    yf = y.to(acc)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * (1.0 + p["gnorm"].to(acc))).to(dtype)
    return torch.matmul(y, p["out_proj"].to(dtype))


def ssm_train(p: dict, x_in: torch.Tensor, cfg, return_state: bool = False, mesh=None):
    """Full-sequence SSD block. x_in: (B, S, D) → (B, S, D).

    With ``return_state`` also returns (h_final, conv_state) so prefill can
    hand off to the recurrent decode path: the SSD state in float32 (or
    float64) and the last ``K-1`` *pre-conv* channels, left-padded with
    zeros when the sequence is shorter."""
    check_mesh(mesh)
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    ns = s_cfg.d_state
    dtype = x_in.dtype
    acc = acc_dtype(dtype)

    x = torch.matmul(x_in, p["x_proj"].to(dtype))
    z = torch.matmul(x_in, p["z_proj"].to(dtype))
    bc = torch.matmul(x_in, p["bc_proj"].to(dtype))
    dt = torch.matmul(x_in, p["dt_proj"].to(dtype))

    xbc_raw = torch.cat([x, bc], dim=-1)
    xbc = F.silu(_depthwise_causal_conv(xbc_raw, p["conv"].to(dtype)))
    x, b, c = torch.split(xbc, [di, ns, ns], dim=-1)

    dt = F.softplus(dt.to(acc))
    a = -torch.exp(p["a_log"].to(acc))
    xh = _heads(x, s_cfg, nh)
    y, h_final = _ssd_chunked(xh.to(acc), dt, a, b.to(acc), c.to(acc), s_cfg.chunk)
    y = y + xh.to(acc) * p["d_skip"].to(acc)[None, None, :, None]
    if s_cfg.p_major:
        y = y.transpose(-1, -2)
    y = y.reshape(*x.shape[:2], di).to(dtype)
    out = _gated_out(p, y, z, dtype)
    if return_state:
        k = s_cfg.d_conv - 1
        tail = xbc_raw[:, -k:].to(acc)
        if tail.shape[1] < k:  # sequences shorter than the conv receptive field
            tail = F.pad(tail, (0, 0, k - tail.shape[1], 0))
        return out, (h_final.to(acc), tail)
    return out


def ssm_decode(
    p: dict,
    x_in: torch.Tensor,
    cfg,
    h: torch.Tensor,
    conv_state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step.

    x_in: (B, 1, D); h: (B, H, P, N); conv_state: (B, K-1, C).
    Returns (y (B,1,D), new_h, new_conv_state), new tensors (the caller
    stores them; ``transformer.forward_decode`` copies them into its
    cache).
    """
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    ns = s_cfg.d_state
    dtype = x_in.dtype
    acc = acc_dtype(dtype)

    x = torch.matmul(x_in, p["x_proj"].to(dtype))
    z = torch.matmul(x_in, p["z_proj"].to(dtype))
    bc = torch.matmul(x_in, p["bc_proj"].to(dtype))
    dt = torch.matmul(x_in, p["dt_proj"].to(dtype))

    # the window is in the promotion of the state's and the compute dtype,
    # as jnp.concatenate promotes
    win_t = torch.promote_types(conv_state.dtype, dtype)
    xbc = torch.cat([x, bc], dim=-1)[:, 0]                             # (B, C)
    window = torch.cat([conv_state.to(win_t), xbc[:, None].to(win_t)], dim=1)  # (B, K, C)
    new_conv_state = window[:, 1:]
    w = p["conv"].to(dtype).to(win_t)                                   # (C, K)
    xbc = F.silu(torch.einsum("bkc,ck->bc", window, w))
    x, b, c = torch.split(xbc, [di, ns, ns], dim=-1)

    dt = F.softplus(dt[:, 0].to(acc))                                   # (B, H)
    a = -torch.exp(p["a_log"].to(acc))
    da = torch.exp(dt * a[None])                                        # (B, H)
    xh = _heads(x, s_cfg, nh).to(acc)

    # h ← h·exp(dt·A) + dt · B ⊗ x
    inc = (dt[:, :, None] * xh)[..., None] * b.to(acc)[:, None, None, :]
    h = h * da[..., None, None] + inc
    y = torch.einsum("bn,bhpn->bhp", c.to(acc), h)
    y = y + xh * p["d_skip"].to(acc)[None, :, None]
    if s_cfg.p_major:
        y = y.transpose(-1, -2)
    y = y.reshape(-1, 1, di).to(dtype)
    return _gated_out(p, y, z, dtype), h, new_conv_state
