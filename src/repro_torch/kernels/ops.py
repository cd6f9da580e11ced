"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

Each wrapper takes the reference's signature and routes by device:

* a CUDA tensor launches the hand-written kernel (``csrc/*.cu``) once, on
  the current stream, or raises — there is no fallback;
* a CPU tensor runs the kernel's plain PyTorch version.

A leading batch dim is one launch for the whole stack. Each wrapper counts
its kernel launches in :data:`launches` (plain ints, incremented right
after a launch and nowhere else), so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.backend import on_cuda
from repro_torch.core.symmetric import SymmetricMatrix, default_block_size
from repro_torch.kernels import gemm_tn as _gemm_tn
from repro_torch.kernels import potrf as _potrf
from repro_torch.kernels import syrk as _syrk
from repro_torch.kernels import trsm as _trsm
from repro_torch.tune.defaults import SYRK_BLOCKS

__all__ = ["syrk", "gemm_tn", "gemm_tn_fused", "syrk_gather", "potrf", "trsm", "launches",
           "reset_launches"]

# kernel name -> CUDA launches since the last reset_launches()
launches = {"syrk": 0, "gemm_tn": 0, "gemm_tn_fused": 0, "syrk_gather": 0, "potrf": 0,
            "trsm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def syrk(a, *, alpha: float = 1.0, blocks=None, out_dtype=torch.float32, out: str = "dense"):
    """``alpha·AᵀA`` for ``(m, n)`` or ``(B, m, n)``.

    ``out='dense'`` → bitwise-symmetric ``(..., n, n)``; ``out='packed'`` →
    :class:`SymmetricMatrix` on the ``default_block_size(n, blocks[1])``
    grid. ``blocks`` sets only that packed block size; the kernel chooses
    its own CTA tile.
    """
    bn = default_block_size(a.shape[-1], tuple(blocks or SYRK_BLOCKS)[1])
    if on_cuda(a):
        raw = _syrk.syrk_cuda(a, alpha=alpha, out_dtype=out_dtype, out=out, bn=bn)
        launches["syrk"] += 1
    else:
        raw = _syrk.syrk_plain(a, alpha=alpha, out_dtype=out_dtype, out=out, bn=bn)
    if out == "packed":
        return SymmetricMatrix(raw, n=a.shape[-1], bn=bn)
    return raw


def gemm_tn(a, b, *, alpha: float = 1.0, blocks=None, out_dtype=torch.float32):
    """``alpha·AᵀB`` for ``(m, n) × (m, k)`` or ``(B, m, n) × (B, m, k)``,
    ``Aᵀ`` never formed. ``blocks`` (the reference's Pallas block shape)
    is accepted for signature parity only: the kernel picks its CTA tile."""
    del blocks
    if on_cuda(a, b):
        c = _gemm_tn.gemm_tn_cuda(a, b, alpha=alpha, out_dtype=out_dtype)
        launches["gemm_tn"] += 1
        return c
    return _gemm_tn.gemm_tn_plain(a, b, alpha=alpha, out_dtype=out_dtype)


def gemm_tn_fused(a_blocks, b_blocks, tables, *, alpha: float = 1.0, blocks=None,
                  out_dtype=torch.float32):
    """All ``G·T`` fused-operand Strassen leaf products in ONE launch.

    ``a_blocks``/``b_blocks``: block-major leaf grids ``(G, R, C, [B,] mb,
    n)`` and ``(G, R, C, [B,] mb, k)`` (``core.strassen._to_blocks``
    layout, any strides); ``tables``: ``((a_rows, a_cols, a_sgn), (b_rows,
    b_cols, b_sgn))``, six ``(T, W)`` int arrays (``_slot_tables``). Leaf
    ``g·T + t`` multiplies the balanced ± sums of its slot blocks; returns
    ``(G·T, [B,] n, k)``. ``blocks`` is accepted for signature parity.
    """
    del blocks
    if on_cuda(a_blocks, b_blocks):
        c = _gemm_tn.gemm_tn_fused_cuda(a_blocks, b_blocks, tables, alpha=alpha,
                                        out_dtype=out_dtype)
        launches["gemm_tn_fused"] += 1
        return c
    return _gemm_tn.gemm_tn_fused_plain(a_blocks, b_blocks, tables, alpha=alpha,
                                        out_dtype=out_dtype)


def syrk_gather(a_blocks, rows, cols, *, alpha: float = 1.0, blocks=None,
                out_dtype=torch.float32):
    """Dense ``alpha·ÂᵀÂ`` of every gathered leaf ``Â = a_blocks[rows[s],
    cols[s]]`` in ONE launch: ``(R, C, [B,] mL, nL)`` → ``(S, [B,] nL,
    nL)``, each tile bitwise symmetric. ``blocks`` is accepted for
    signature parity."""
    del blocks
    if on_cuda(a_blocks):
        c = _syrk.syrk_gather_cuda(a_blocks, rows, cols, alpha=alpha, out_dtype=out_dtype)
        launches["syrk_gather"] += 1
        return c
    return _syrk.syrk_gather_plain(a_blocks, rows, cols, alpha=alpha, out_dtype=out_dtype)


def potrf(a, *, out_dtype=torch.float32):
    """Lower Cholesky factor of SPD tile(s) ``(n, n)`` or ``(B, n, n)``."""
    if on_cuda(a):
        out = _potrf.potrf_cuda(a, out_dtype=out_dtype)
        launches["potrf"] += 1
        return out
    return _potrf.potrf_plain(a, out_dtype=out_dtype)


def trsm(l, b, *, transpose: bool = True, out_dtype=torch.float32):
    """Solve ``X·Lᵀ = B`` (``transpose=True``) or ``X·L = B`` for
    ``(n, n) × (m, n)`` or stacked ``(B, n, n) × (B, m, n)``."""
    if on_cuda(l, b):
        x = _trsm.trsm_cuda(l, b, transpose=transpose, out_dtype=out_dtype)
        launches["trsm"] += 1
        return x
    return _trsm.trsm_plain(l, b, transpose=transpose, out_dtype=out_dtype)

