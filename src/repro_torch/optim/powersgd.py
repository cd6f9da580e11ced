"""PowerSGD-style low-rank gradient compression on the paper's ops (port
of ``repro.optim.powersgd``).

Rank-r compression replaces the dense all-reduce of a (m, n) gradient with
all-reduces of (m, r) and (n, r) factors (r ≪ min(m, n)). The hot linear
algebra is the paper's:

  * ``Q ← GᵀP``  — a TN product → :func:`repro_torch.core.strassen_tn`;
  * orthonormalization gram ``PᵀP`` — :func:`repro_torch.core.ata` (+
    Cholesky whitening).

Error feedback keeps the compression unbiased over time: the residual
``G − P·Qᵀ`` is added back into the next step's gradient.

:func:`compress_sharded` runs one round on a row-sharded gradient, one
rank a row block, over ``torch.distributed`` (the reference runs it
inside ``shard_map``): the gram is reduced in packed form by
``repro_torch.core.distributed.gram_rowshard``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.backend import resolve_device
from repro_torch.core.ata import ata
from repro_torch.core.strassen import strassen_tn
from repro_torch.core.symmetric import SymmetricMatrix

__all__ = [
    "PowerSGDState",
    "init_state",
    "compress",
    "compress_sharded",
    "decompress",
    "error_feedback",
]


class PowerSGDState(NamedTuple):
    q: torch.Tensor      # (n, r) — persistent right factor (warm start)
    error: torch.Tensor  # (m, n) — error-feedback residual


def init_state(generator: torch.Generator, shape, rank: int, *, device=None) -> PowerSGDState:
    """Standard-normal ``q`` drawn from ``generator`` (in place of the
    reference's JAX key, whose stream cannot be reproduced here) on the
    generator's device, then moved to ``device``; zero error."""
    m, n = shape
    dev = resolve_device(device)
    q = torch.randn((n, rank), generator=generator, dtype=torch.float32,
                    device=generator.device).to(dev)
    return PowerSGDState(q=q, error=torch.zeros((m, n), dtype=torch.float32, device=dev))


def _whiten(p: torch.Tensor, g, eps: float = 1e-6) -> torch.Tensor:
    """Whiten columns of p given its gram ``g = PᵀP`` (p ← p·L⁻ᵀ).

    The ridge scales with trace(g)/r so rank-deficient P stays finite.
    ``g`` may be a packed :class:`SymmetricMatrix`: the Cholesky and the
    solve then run packed (``repro_torch.solve``: the potrf and trsm
    kernels), never densified. A dense ``g`` takes
    ``torch.linalg.cholesky_ex`` and ``solve_triangular``, as the
    reference takes ``jnp.linalg.cholesky`` and ``triangular_solve``.
    Returns a row-major ``(m, r)`` tensor: the TN kernel that takes it next
    reads unit-stride rows.
    """
    r = p.shape[1]
    if isinstance(g, SymmetricMatrix):
        from repro_torch.solve import cholesky, solve_triangular

        ridge = eps * (g.trace() / r + 1e-30) + 1e-30
        f = cholesky(g.add_scaled_identity(ridge))
        # p·L⁻ᵀ: solve X·Lᵀ = P  ⇔  L·Xᵀ = Pᵀ (forward, packed factor)
        return solve_triangular(f, p.T, transpose=False).T.contiguous()
    ridge = eps * (torch.trace(g) / r + 1e-30) + 1e-30
    g = g + ridge * torch.eye(r, dtype=g.dtype, device=g.device)
    l = torch.linalg.cholesky_ex(g).L
    # solve p_new Lᵀ = p  →  p_new = p · L⁻ᵀ (column-major from the solver
    # on the card)
    return torch.linalg.solve_triangular(l.T, p, upper=True, left=False).contiguous()


def _orthonormalize(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # (r, r) = pᵀp — the paper's op, planner-dispatched
    return _whiten(p, ata(p), eps)


def compress(
    g: torch.Tensor, state: PowerSGDState, *, n_base: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, PowerSGDState]:
    """One PowerSGD round for a (m, n) gradient.

    Returns (p, q, new_state): all-reduce p and q across data-parallel
    ranks, then call :func:`decompress`. Error feedback is accumulated
    locally. The TN product is planner-dispatched unless ``n_base`` is
    pinned.
    """
    g = g.to(torch.float32) + state.error
    p = g @ state.q                                        # (m, r)
    p = _orthonormalize(p)
    q = strassen_tn(g, p, n_base=n_base)                   # GᵀP — TN product
    g_hat = p @ q.T
    return p, q, PowerSGDState(q=q, error=g - g_hat)


def compress_sharded(
    g_local: torch.Tensor,
    state: PowerSGDState,
    axis,
    *,
    mesh=None,
    n_base: Optional[int] = None,
    packed_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, PowerSGDState]:
    """One PowerSGD round for a **row-sharded** gradient: every rank of the
    group calls it with ``g_local``/``state.error`` holding its row block
    of the global ``(m, n)`` gradient and the same ``state.q``.

    ``axis``: the ``ProcessGroup`` of the row ranks, or a mesh axis name
    together with ``mesh=`` (a ``repro_torch.launch.mesh.Mesh``). The row
    shard of :func:`compress` up to the reduction's order: ``P``'s rows
    stay sharded like ``G``'s, and the two collectives are

    * the orthonormalization gram ``PᵀP`` — ``gram_rowshard(out='packed')``,
      so the all-reduce moves the packed lower-triangular block stack;
    * the ``(n, r)`` factor ``Q = GᵀP`` — an all-reduce of each rank's
      ``strassen_tn(G_local, P_local)``.

    Returns ``(p_local, q, state)``: ``p_local`` and ``state.error`` this
    rank's rows, ``q`` the same on every rank.
    """
    from repro_torch.core.distributed import _group, gram_rowshard
    from repro_torch.launch import collectives

    group = _group(axis, mesh)
    g_local = g_local.to(torch.float32) + state.error
    p_local = g_local @ state.q                            # rows of P = G·Q
    gram = gram_rowshard(p_local, group, n_base=n_base, out="packed",
                         packed_block=packed_block)
    p_local = _whiten(p_local, gram)       # packed Cholesky, never densified
    q = collectives.all_reduce(strassen_tn(g_local, p_local, n_base=n_base), group)
    g_hat_local = p_local @ q.T
    return p_local, q, PowerSGDState(q=q, error=g_local - g_hat_local)


def decompress(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return p @ q.T


def error_feedback(state: PowerSGDState, g: torch.Tensor, g_hat: torch.Tensor) -> PowerSGDState:
    return PowerSGDState(q=state.q, error=g.to(torch.float32) - g_hat)
