"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

Each wrapper takes the reference's signature and routes by device:

* a CUDA tensor launches the hand-written kernel (``csrc/*.cu``) once, on
  the current stream, or raises — there is no fallback;
* a CPU tensor runs the kernel's plain PyTorch version.

A leading batch dim is one launch for the whole stack. ``plan=`` (a
``repro_torch.tune.Plan``) is accepted where the reference's wrappers take
it and, like ``blocks``, is read for output geometry only (the packed
block size of ``syrk``): each CUDA kernel chooses its own CTA tile. Each
wrapper counts its kernel launches in :data:`launches` (plain ints,
incremented right after a CUDA launch and nowhere else), so a run can
show that its path went through the kernels. That differs from the reference's counter, which this
module keeps too: ``obs.metrics`` counter ``kernels.launch.<name>`` counts
every wrapper call, on the card or on the CPU, as ``repro.kernels.ops``
counts every call whether Pallas runs compiled or in interpret mode. Each
call also opens one ``kernels.<name>`` span (``repro_torch.obs``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.backend import on_cuda
from repro_torch.core.symmetric import SymmetricMatrix, default_block_size
from repro_torch.kernels import gemm_tn as _gemm_tn
from repro_torch.kernels import potrf as _potrf
from repro_torch.kernels import syrk as _syrk
from repro_torch.kernels import trsm as _trsm
from repro_torch.tune.defaults import SYRK_BLOCKS

__all__ = ["syrk", "gemm_tn", "gemm_tn_fused", "syrk_gather", "potrf", "trsm", "launches",
           "reset_launches", "Bases", "bases", "PLAIN"]

# kernel name -> CUDA launches since the last reset_launches()
launches = {"syrk": 0, "gemm_tn": 0, "gemm_tn_fused": 0, "syrk_gather": 0, "potrf": 0,
            "trsm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# kernel name -> (counter, span) names of the reference's ops wrappers
_OBS_NAMES = {name: (f"kernels.launch.{name}", f"kernels.{name}") for name in launches}


def _run(name: str, cuda: bool, kernel, plain, *args, **kw):
    """One wrapper call: the reference's ``kernels.launch.<name>`` counter
    and ``kernels.<name>`` span around the CUDA ``kernel(*args, **kw)``
    (counted in :data:`launches`) or the ``plain`` version. With spans off
    (the default) the call skips even the shared no-op span: the unrolled
    dispatches make one call per leaf, and their time is the host's."""
    counter, span = _OBS_NAMES[name]
    obs.metrics.inc(counter)
    fn = kernel if cuda else plain
    if obs.enabled():
        with obs.span(span, cuda=cuda):
            out = fn(*args, **kw)
    else:
        out = fn(*args, **kw)
    if cuda:
        launches[name] += 1
    return out


def syrk(a, *, alpha: float = 1.0, blocks=None, plan=None, out_dtype=torch.float32,
         out: str = "dense"):
    """``alpha·AᵀA`` for ``(m, n)`` or ``(B, m, n)``.

    ``out='dense'`` → bitwise-symmetric ``(..., n, n)``; ``out='packed'`` →
    :class:`SymmetricMatrix` on the ``default_block_size(n, blocks[1])``
    grid, ``blocks`` from the argument, else ``plan.syrk_blocks``, else the
    defaults. They set only that packed block size; the kernel chooses its
    own CTA tile.
    """
    if blocks is None and plan is not None:
        blocks = plan.syrk_blocks
    bn = default_block_size(a.shape[-1], tuple(blocks or SYRK_BLOCKS)[1])
    raw = _run("syrk", on_cuda(a), _syrk.syrk_cuda, _syrk.syrk_plain, a, alpha=alpha,
               out_dtype=out_dtype, out=out, bn=bn)
    if out == "packed":
        return SymmetricMatrix(raw, n=a.shape[-1], bn=bn)
    return raw


def gemm_tn(a, b, *, alpha: float = 1.0, blocks=None, plan=None, out_dtype=torch.float32):
    """``alpha·AᵀB`` for ``(m, n) × (m, k)`` or ``(B, m, n) × (B, m, k)``,
    ``Aᵀ`` never formed. ``blocks`` and ``plan`` (the reference's Pallas
    block shape and its source) are accepted for signature parity only:
    the kernel picks its CTA tile."""
    del blocks, plan
    return _run("gemm_tn", on_cuda(a, b), _gemm_tn.gemm_tn_cuda, _gemm_tn.gemm_tn_plain, a, b,
                alpha=alpha, out_dtype=out_dtype)


def gemm_tn_fused(a_blocks, b_blocks, tables, *, alpha: float = 1.0, blocks=None, plan=None,
                  out_dtype=torch.float32):
    """All ``G·T`` fused-operand Strassen leaf products in ONE launch.

    ``a_blocks``/``b_blocks``: block-major leaf grids ``(G, R, C, [B,] mb,
    n)`` and ``(G, R, C, [B,] mb, k)`` (``core.strassen._to_blocks``
    layout, any strides); ``tables``: ``((a_rows, a_cols, a_sgn), (b_rows,
    b_cols, b_sgn))``, six ``(T, W)`` int arrays (``_slot_tables``). Leaf
    ``g·T + t`` multiplies the balanced ± sums of its slot blocks; returns
    ``(G·T, [B,] n, k)``. ``blocks`` and ``plan`` are accepted for
    signature parity.
    """
    del blocks, plan
    return _run("gemm_tn_fused", on_cuda(a_blocks, b_blocks), _gemm_tn.gemm_tn_fused_cuda,
                _gemm_tn.gemm_tn_fused_plain, a_blocks, b_blocks, tables, alpha=alpha,
                out_dtype=out_dtype)


def syrk_gather(a_blocks, rows, cols, *, alpha: float = 1.0, blocks=None, plan=None,
                out_dtype=torch.float32):
    """Dense ``alpha·ÂᵀÂ`` of every gathered leaf ``Â = a_blocks[rows[s],
    cols[s]]`` in ONE launch: ``(R, C, [B,] mL, nL)`` → ``(S, [B,] nL,
    nL)``, each tile bitwise symmetric. ``blocks`` and ``plan`` are
    accepted for signature parity."""
    del blocks, plan
    return _run("syrk_gather", on_cuda(a_blocks), _syrk.syrk_gather_cuda, _syrk.syrk_gather_plain,
                a_blocks, rows, cols, alpha=alpha, out_dtype=out_dtype)


def potrf(a, *, out_dtype=torch.float32):
    """Lower Cholesky factor of SPD tile(s) ``(n, n)`` or ``(B, n, n)``."""
    return _run("potrf", on_cuda(a), _potrf.potrf_cuda, _potrf.potrf_plain, a,
                out_dtype=out_dtype)


def trsm(l, b, *, transpose: bool = True, out_dtype=torch.float32):
    """Solve ``X·Lᵀ = B`` (``transpose=True``) or ``X·L = B`` for
    ``(n, n) × (m, n)`` or stacked ``(B, n, n) × (B, m, n)``."""
    return _run("trsm", on_cuda(l, b), _trsm.trsm_cuda, _trsm.trsm_plain, l, b,
                transpose=transpose, out_dtype=out_dtype)


class Bases(NamedTuple):
    """The engines the default bases of ``core/`` and ``solve/`` call. The
    two fused launches are None where the fused dispatch gathers instead."""

    syrk: Callable
    gemm_tn: Callable
    potrf: Callable
    trsm: Callable
    gemm_tn_fused: Optional[Callable]
    syrk_gather: Optional[Callable]


# the plain versions: the bases of float64 and of plans without kernels
PLAIN = Bases(_syrk.syrk_plain, _gemm_tn.gemm_tn_plain, _potrf.potrf_plain, _trsm.trsm_plain,
               None, None)


def bases(*dtypes) -> Bases:
    """The engines for operands and accumulation of ``dtypes``: this
    module's wrappers (the kernel on a CUDA tensor, the plain version on a
    CPU one), or, when any dtype is float64, which no kernel takes, the
    plain versions on every device and no fused launch. Chosen by dtype
    alone, before any launch, as the reference's kernel-free defaults
    compute float64 through ``dot_general``; the wrappers themselves go on
    refusing float64 on the card."""
    if torch.float64 in dtypes:
        return PLAIN
    # looked up at each call, so a wrapper replaced on this module is the one used
    return Bases(syrk, gemm_tn, potrf, trsm, gemm_tn_fused, syrk_gather)
