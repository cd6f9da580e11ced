"""Distributed Shampoo with ATA-powered gram statistics (port of
``repro.optim.shampoo``) — the production consumer of the paper's product.

Shampoo's preconditioner statistics for a gradient block G are exactly the
paper's product:

    L += G·Gᵀ  =  ata(Gᵀ)        (b1 × b1)
    R += GᵀG   =  ata(G)         (b2 × b2)

computed every step for every 2-D parameter block with
:func:`repro_torch.core.ata_batched` over the blocks of the standard
blocked-Shampoo partitioning (pad → tile into ``block×block`` tiles): the
block batch rides through the recursion as a leading dim, so every base
case is one batched launch (``csrc/syrk.cu``, ``csrc/gemm_tn.cu``) over all
blocks of a parameter.

With ``packed_grams=True`` (default) the L/R statistics stay in packed
lower-triangular block form (:class:`SymmetricMatrix`): the grams come out
of ``ata_batched(..., out="packed")`` mirror-free, the decayed accumulation
runs on packed blocks, and with ``precond_p=4`` the dense square is formed
only inside the (every ``update_every`` steps) inverse-root refresh.
``precond_p=2`` is the whitening preconditioner: the refresh factors the
decayed stats with the **packed Cholesky** (``solve.cholesky``: the
``potrf`` and ``trsm`` kernels; no densify) and the update applies the
factors as two packed triangular solves ``C_L⁻¹·G·C_R⁻ᵀ``. With
``packed_grams=False`` the same math runs densely
(``torch.linalg.cholesky_ex`` and ``solve_triangular``), as the reference
runs ``jnp.linalg.cholesky`` and ``triangular_solve`` outside any kernel.
The coupled-Newton inverse p-th roots are batched float32 matmuls over the
block stack (the reference's ``vmap``); TF32 is off (``repro_torch``).

Differences of form, not of result, from the reference:

* ``jax.lax.cond(refresh, …)`` is a Python ``if`` on the step, which lives
  on the CPU (``optim.adamw``), so no step waits for the card; a step that
  does not refresh copies nothing between host and card;
* the L-side gram operand ``Gᵀ`` is made contiguous first: the syrk
  kernel reads unit-stride rows.

Adam grafting transplants the step size per block; 1-D, scalar and
embedding parameters take Adam.

**Block ownership on a mesh** (``update(..., mesh=, specs=)``, the train
step's ZeRO-1 path under ``train_step.state_specs``): the gradients and
parameters come in whole, the state as this rank's blocks. The moments are
updated on their ZeRO-1 blocks. Each data rank keeps, accumulates and
refreshes the stats of its own parameter blocks only (the stat stacks'
block dim is split over ``data`` where it divides, else every rank holds
all of them), so its grams, Cholesky factors and whitening solves run on
its own blocks; the preconditioned blocks are then all-gathered over
``data`` and grafted. The grams of a block do not depend on the other blocks of the
batch, so the owned stats equal the unsharded run's bitwise. Each update
comes back as the block of its leaf's momentum (``mom``) spec, or of the
``m`` spec for the Adam leaves.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.ata import ata_batched
from repro_torch.core.symmetric import SymmetricMatrix
from repro_torch.optim._tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.optim.adamw import Optimizer, bias_corrections, zeros_like_f32
from repro_torch.solve.cholesky import CholeskyFactor, cholesky as packed_cholesky
from repro_torch.solve.triangular import solve_triangular

__all__ = ["shampoo", "inverse_pth_root"]

_SKIP_SUBSTRINGS = ("embed", "lm_head")  # Adam fallback for huge vocab tables


# ---------------------------------------------------------------------------
# inverse p-th root (coupled Newton, float32), batched over leading dims
# ---------------------------------------------------------------------------


def _eye(n: int, device):
    return torch.eye(n, dtype=torch.float32, device=device)


def _max_ev(a: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Power-iteration estimate of the largest eigenvalue of each PSD
    matrix in ``(..., n, n)``; returns ``(...)``."""
    n = a.shape[-1]
    v = torch.full(a.shape[:-1], n ** -0.5, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        w = torch.matmul(a, v[..., None])[..., 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-30)
    av = torch.matmul(a, v[..., None])[..., 0]
    return torch.clamp(torch.sum(v * av, dim=-1), min=1e-30)


def inverse_pth_root(
    a: torch.Tensor, p: int = 4, iters: int = 25, ridge: float = 1e-6
) -> torch.Tensor:
    """``(A + εI)^{-1/p}`` for PSD A via the coupled Newton iteration, for
    ``(n, n)`` or a stack ``(..., n, n)`` (one batched matmul per product).

    M₀ = A·z (eigs in (0,1]), X₀ = I;
    M₁ = ((p+1)I − M)/p;  X ← X·M₁;  M ← M₁ᵖ·M — X → (A·z)^{-1/p}.
    """
    n = a.shape[-1]
    eye = _eye(n, a.device)
    a = a.to(torch.float32)
    tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
    a = a + (ridge * (tr / n + 1e-30))[..., None, None] * eye
    z = (1.0 / _max_ev(a))[..., None, None]
    m = a * z
    alpha = -1.0 / p
    x = eye.expand(a.shape)
    for _ in range(iters):
        m1 = (1.0 - alpha) * eye + alpha * m      # = ((p+1)I − M)/p
        x = torch.matmul(x, m1)
        m1p = m1
        for _ in range(p.bit_length() - 1):        # p = 4 → square twice
            m1p = torch.matmul(m1p, m1p)
        if (1 << (p.bit_length() - 1)) != p:       # non-power-of-two p
            m1p = torch.linalg.matrix_power(m1, p)
        m = torch.matmul(m1p, m)
    return x * z ** (-alpha)                        # (A z)^{-1/p} · z^{1/p}


# ---------------------------------------------------------------------------
# blocked partitioning
# ---------------------------------------------------------------------------


class _Part(NamedTuple):
    d1: int
    d2: int
    b1: int
    b2: int
    n1: int
    n2: int


def _plan(shape, block: int) -> _Part:
    d1 = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    d2 = shape[-1] if len(shape) > 1 else 1
    b1 = min(block, -(-d1 // 8) * 8)
    b2 = min(block, -(-d2 // 8) * 8)
    n1 = -(-d1 // b1)
    n2 = -(-d2 // b2)
    return _Part(d1, d2, b1, b2, n1, n2)


def _to_blocks(g: torch.Tensor, pt: _Part) -> torch.Tensor:
    g = g.reshape(pt.d1, pt.d2).to(torch.float32)
    pad1 = pt.n1 * pt.b1 - pt.d1
    pad2 = pt.n2 * pt.b2 - pt.d2
    if pad1 or pad2:
        g = F.pad(g, (0, pad2, 0, pad1))
    g = g.reshape(pt.n1, pt.b1, pt.n2, pt.b2).permute(0, 2, 1, 3)
    return g.reshape(pt.n1 * pt.n2, pt.b1, pt.b2)


def _from_blocks(blocks: torch.Tensor, pt: _Part, shape) -> torch.Tensor:
    g = blocks.reshape(pt.n1, pt.n2, pt.b1, pt.b2).permute(0, 2, 1, 3)
    g = g.reshape(pt.n1 * pt.b1, pt.n2 * pt.b2)[: pt.d1, : pt.d2]
    return g.reshape(shape)


def _use_shampoo(path: str, shape) -> bool:
    if any(s in path for s in _SKIP_SUBSTRINGS):
        return False
    return len(shape) >= 2 and min(shape[-1], math.prod(shape[:-1])) >= 8


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def shampoo(
    lr_schedule: Callable,
    block: int = 1024,
    beta1: float = 0.9,
    beta2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    update_every: int = 10,
    stat_decay: float = 0.95,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    newton_iters: int = 25,
    packed_grams: bool = True,
    gram_block: Optional[int] = None,
    precond_p: int = 4,
    precond_ridge: float = 1e-6,
) -> Optimizer:
    """ATA-powered blocked Shampoo with Adam grafting.

    ``packed_grams`` keeps the L/R gram statistics in packed symmetric form
    (about half the memory; with ``precond_p=4`` they are densified only
    inside the preconditioner refresh). ``gram_block`` is the packed
    storage block size (default ``tune.defaults.DEFAULT_PACKED_BLOCK``).

    ``precond_p`` selects the preconditioner exponent: 4 (inverse 4th roots
    by coupled Newton) or 2 — the whitening path, where the refresh is a
    packed Cholesky of each stat and the update applies the factor by two
    triangular solves. ``precond_ridge`` is the p=2 refresh's relative
    ridge (scaled by ``trace/n``, like ``inverse_pth_root``'s).

    ``n_base``/``variant`` default to None: the gram dispatches are then
    planned per block shape through ``repro_torch.tune.plan`` inside
    ``ata_batched`` for the gradients' device (a pinned value bypasses the
    planner). A measured plan in the tune cache changes the gram recursion
    and hence its rounding; pin ``n_base`` for bitwise-reproducible runs.
    """
    if precond_p not in (2, 4):
        raise ValueError(f"precond_p must be 2 or 4, got {precond_p}")
    if gram_block is None:
        from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

        gram_block = DEFAULT_PACKED_BLOCK

    gram_b = functools.partial(ata_batched, n_base=n_base, variant=variant)

    def _gram_stats(gb):
        """L/R gram products for all blocks of one parameter — one batched
        launch per base tile over the whole block batch."""
        out = "packed" if packed_grams else "dense"
        l_new = gram_b(gb.transpose(-1, -2).contiguous(), out=out, packed_block=gram_block)
        r_new = gram_b(gb, out=out, packed_block=gram_block)
        return l_new, r_new

    def _zeros_stat(n, nb, device):
        if packed_grams:
            return SymmetricMatrix.zeros(n, gram_block, batch=(nb,), device=device)
        return torch.zeros((nb, n, n), dtype=torch.float32, device=device)

    def _dense(stat):
        return stat.to_dense() if isinstance(stat, SymmetricMatrix) else stat

    def _eye_stack(d, nb, device):
        return _eye(d, device).expand(nb, d, d).clone()

    # --- p=2 whitening path: packed Cholesky factors, never densified ---

    def _chol_refresh(stat, d):
        """Cholesky factor of the (relative-)ridged stat — packed in,
        packed out (the dense branch runs the identical math densely)."""
        if isinstance(stat, SymmetricMatrix):
            tr = stat.trace()                                   # (nb,)
            ridge = precond_ridge * (tr / d + 1e-30) + 1e-30
            return packed_cholesky(
                stat.add_scaled_identity(ridge[:, None, None, None])
            )
        tr = torch.diagonal(stat, dim1=-2, dim2=-1).sum(-1)
        ridge = precond_ridge * (tr / d + 1e-30) + 1e-30
        # cholesky_ex: no error check, so no wait for the card (the
        # reference's jnp.linalg.cholesky does not raise either)
        return torch.linalg.cholesky_ex(stat + ridge[:, None, None] * _eye(d, stat.device)).L

    def _id_factor(d, nb, device):
        """Well-posed init/keep value for a p=2 preconditioner slot."""
        if packed_grams:
            return CholeskyFactor.identity(d, gram_block, batch=(nb,), device=device)
        return _eye_stack(d, nb, device)

    def _whiten_apply(cl, gb, cr):
        """``C_L⁻¹ · G · C_R⁻ᵀ`` — packed triangular solves (or their dense
        ``torch.linalg.solve_triangular`` twin) on the block batch."""
        if isinstance(cl, CholeskyFactor):
            y = solve_triangular(cl, gb, transpose=False)
            zt = solve_triangular(cr, y.transpose(-1, -2), transpose=False)
            return zt.transpose(-1, -2)
        y = torch.linalg.solve_triangular(cl, gb, upper=False, left=True)
        return torch.linalg.solve_triangular(cr.transpose(-1, -2), y, upper=True, left=False)

    def _paths(tree):
        flat, treedef = tree_flatten_with_path(tree)
        return [k for k, _ in flat], [v for _, v in flat], treedef

    def init(params):
        paths, leaves, treedef = _paths(params)
        stats = []
        for path, p in zip(paths, leaves):
            if _use_shampoo(path, p.shape):
                pt = _plan(p.shape, block)
                nb = pt.n1 * pt.n2
                dev = p.device
                if precond_p == 2:
                    pl0, pr0 = _id_factor(pt.b1, nb, dev), _id_factor(pt.b2, nb, dev)
                else:
                    pl0, pr0 = _eye_stack(pt.b1, nb, dev), _eye_stack(pt.b2, nb, dev)
                stats.append(
                    {
                        "l": _zeros_stat(pt.b1, nb, dev),
                        "r": _zeros_stat(pt.b2, nb, dev),
                        "pl": pl0,
                        "pr": pr0,
                        "mom": zeros_like_f32(p),
                    }
                )
            else:
                stats.append(0)
        return {
            "m": tree_map(zeros_like_f32, params),
            "v": tree_map(zeros_like_f32, params),
            "shampoo": treedef.unflatten(stats),
            "step": torch.zeros((), dtype=torch.int32),
        }

    def update(grads, state, params, *, mesh=None, specs=None):
        from repro_torch.parallel.sharding import P, gather, local_block

        if mesh is None:
            def cut(x, spec):
                return x

            def whole(x, spec):
                return x
        else:
            def cut(x, spec):
                return local_block(x, mesh, spec)

            def whole(x, spec):
                # contiguous, as the unsharded tensors are: a reduction's
                # order follows the layout
                return gather(x, mesh, spec).contiguous()

        step = state["step"] + 1
        lr = lr_schedule(step)
        bc1, bc2 = bias_corrections(step, beta1, beta2)
        refresh = bool(step % update_every == 0)   # the step is on the CPU

        g_paths, g_leaves, treedef = _paths(grads)
        p_leaves = tree_leaves(params)
        m_leaves = tree_leaves(state["m"])
        v_leaves = tree_leaves(state["v"])
        s_leaves = treedef.flatten_up_to(state["shampoo"])
        if mesh is None:
            m_specs = s_specs = [None] * len(g_leaves)
        else:
            m_specs = treedef.flatten_up_to(specs["m"])
            s_specs = treedef.flatten_up_to(specs["shampoo"])

        new_updates, new_m, new_v, new_s = [], [], [], []
        for path, g, p, m, v, s, ms, ss in zip(
            g_paths, g_leaves, p_leaves, m_leaves, v_leaves, s_leaves, m_specs, s_specs
        ):
            g = g.to(torch.float32)
            gm = cut(g, ms)
            m = beta1 * m + (1 - beta1) * gm
            v = beta2 * v + (1 - beta2) * gm * gm
            adam_dir = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            new_m.append(m)
            new_v.append(v)

            if not isinstance(s, dict):
                u = -lr * (adam_dir + weight_decay * cut(p, ms).to(torch.float32))
                new_updates.append(u)
                new_s.append(s)
                continue

            pt = _plan(p.shape, block)
            # this rank's blocks: dim 0 of every stat stack (all of them
            # where the stacks are not split)
            own = None if ss is None else P(ss["l"][0])
            gb = cut(_to_blocks(g, pt), own)                    # (nb, b1, b2)

            # --- the paper's product: gram statistics via batched ATA ---
            l_new, r_new = _gram_stats(gb)
            l = stat_decay * s["l"] + (1 - stat_decay) * l_new
            r = stat_decay * s["r"] + (1 - stat_decay) * r_new

            if not refresh:
                pl, pr = s["pl"], s["pr"]
            elif precond_p == 2:
                # whitening: packed Cholesky of the stats — no densify
                pl, pr = _chol_refresh(l, pt.b1), _chol_refresh(r, pt.b2)
            else:
                # densify only here — once per `update_every` steps
                pl = inverse_pth_root(_dense(l), 4, newton_iters)
                pr = inverse_pth_root(_dense(r), 4, newton_iters)

            if precond_p == 2:
                pg = _whiten_apply(pl, gb, pr)
            else:
                pg = torch.matmul(torch.matmul(pl, gb), pr)
            # Adam grafting: per-block norm transplant, over every block
            # (the owned blocks gathered) in one memory layout, so the
            # norms' sums run in the same order sharded or not
            pg = whole(pg, own).contiguous()   # (the packed whitening's is a transpose)
            ab = _to_blocks(whole(adam_dir, ms), pt)
            a_norm = torch.sqrt(torch.sum(ab * ab, dim=(1, 2)) + 1e-30)
            s_norm = torch.sqrt(torch.sum(pg * pg, dim=(1, 2)) + 1e-30)
            pg = pg * (a_norm / s_norm)[:, None, None]
            pg = _from_blocks(pg, pt, p.shape)

            mom_spec = None if ss is None else ss["mom"]
            mom = beta1 * s["mom"] + cut(pg, mom_spec)
            u = -lr * (mom + weight_decay * cut(p, mom_spec).to(torch.float32))
            new_updates.append(u)
            new_s.append({"l": l, "r": r, "pl": pl, "pr": pr, "mom": mom})

        return treedef.unflatten(new_updates), {
            "m": treedef.unflatten(new_m),
            "v": treedef.unflatten(new_v),
            "shampoo": treedef.unflatten(new_s),
            "step": step,
        }

    return Optimizer(init, update)
