"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

Each wrapper takes the reference's signature and calls its kernel's
dispatcher operator (``torch.ops.repro_torch.<name>``,
``kernels/_library.py``), which routes by device:

* a CUDA tensor launches the hand-written kernel (``csrc/*.cu``) once, on
  the current stream, or raises — there is no fallback;
* a CPU tensor runs the kernel's plain PyTorch version;
* a fake tensor (``make_fx``, ``torch.export``) records one node of the
  graph, with the output's shape and dtype.

A leading batch dim is one launch for the whole stack. On a CUDA operand
the wrapper does what the kernels do not:

* an operand whose column stride is not 1 (``potrf``/``trsm``: that is not
  contiguous; trsm's factor may keep any batch stride) is copied once to a
  contiguous tensor, counted in the ``obs.metrics`` counter
  ``kernels.copy.<name>``; the kernels never copy;
* ``potrf`` and ``trsm`` of ``n`` over :data:`TILE` = 256 (the kernels'
  shared-memory bound) run a fixed-order blocked split into tiles of
  ``TILE``, each step a call of these wrappers (:func:`split_launches`
  counts them), so every launch of the split is counted and traced as any
  other, and a tile's factor does not depend on who asked for it.

The CPU path takes any tensor and does neither. ``plan=`` (a
``repro_torch.tune.Plan``) is accepted where the reference's wrappers take
it and, like ``blocks``, is read for output geometry only (the packed
block size of ``syrk``): each CUDA kernel chooses its own CTA tile. The
operators count their CUDA launches in :data:`launches` (plain ints,
incremented right after a launch and nowhere else), so a run can show that
its path went through the kernels. That differs from the reference's
counter, which this module keeps too: ``obs.metrics`` counter
``kernels.launch.<name>`` counts every wrapper call, on the card, on the
CPU or in a trace, as ``repro.kernels.ops`` counts every call whether
Pallas runs compiled or in interpret mode. Each call also opens one
``kernels.<name>`` span (``repro_torch.obs``).
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
from repro_torch.kernels._library import OPS, dtype_code, launches
from repro_torch.tune.defaults import SYRK_BLOCKS

__all__ = ["syrk", "gemm_tn", "gemm_tn_fused", "syrk_gather", "potrf", "trsm", "launches",
           "reset_launches", "split_launches", "TILE", "Bases", "bases", "PLAIN"]

# the widest potrf/trsm tile one launch takes (csrc/potrf.cu, csrc/trsm.cu)
TILE = _potrf.MAX_N


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# kernel name -> (counter, span, copy counter)
_OBS_NAMES = {name: (f"kernels.launch.{name}", f"kernels.{name}", f"kernels.copy.{name}")
              for name in launches}


def _run(name: str, cuda: bool, *args):
    """One wrapper call: the reference's ``kernels.launch.<name>`` counter
    and ``kernels.<name>`` span around the operator ``name`` on ``args``
    (its schema's order). With spans off (the default) the call skips even
    the shared no-op span: the unrolled dispatches make one call per leaf,
    and their time is the host's."""
    counter, span, _ = _OBS_NAMES[name]
    obs.metrics.inc(counter)
    if obs.enabled():
        with obs.span(span, cuda=cuda):
            return OPS[name](*args)
    return OPS[name](*args)


def _copied(name: str, x):
    obs.metrics.inc(_OBS_NAMES[name][2])
    return x.contiguous()


def _unit_columns(name: str, x):
    """``x``, or its one counted copy if its column stride is not 1."""
    return x if x.stride(-1) == 1 or x.shape[-1] <= 1 else _copied(name, x)


def _dense(name: str, x):
    """``x``, or its one counted copy if it is not contiguous."""
    return x if x.is_contiguous() else _copied(name, x)


def _table_tensors(*arrays):
    """Gather or slot tables as the host tensors the operators take: a
    numpy table is viewed in place, not copied (the CUDA path keeps its
    launch tables per table memory, ``gemm_tn._device_launch_tables``)."""
    return tuple(torch.as_tensor(x) for x in arrays)


def syrk(a, *, alpha: float = 1.0, blocks=None, plan=None, out_dtype=torch.float32,
         out: str = "dense"):
    """``alpha·AᵀA`` for ``(m, n)`` or ``(B, m, n)``.

    ``out='dense'`` → bitwise-symmetric ``(..., n, n)``; ``out='packed'`` →
    :class:`SymmetricMatrix` on the ``default_block_size(n, blocks[1])``
    grid, ``blocks`` from the argument, else ``plan.syrk_blocks``, else the
    defaults. They set only that packed block size; the kernel chooses its
    own CTA tile.
    """
    if out not in ("dense", "packed"):
        raise ValueError(f"unknown output mode {out!r}; use 'dense' or 'packed'")
    if blocks is None and plan is not None:
        blocks = plan.syrk_blocks
    bn = default_block_size(a.shape[-1], tuple(blocks or SYRK_BLOCKS)[1])
    cuda = on_cuda(a)
    if cuda:
        a = _unit_columns("syrk", a)
    raw = _run("syrk", cuda, a, float(alpha), dtype_code(out_dtype), out == "packed", bn)
    if out == "packed":
        return SymmetricMatrix(raw, n=a.shape[-1], bn=bn)
    return raw


def gemm_tn(a, b, *, alpha: float = 1.0, blocks=None, plan=None, out_dtype=torch.float32):
    """``alpha·AᵀB`` for ``(m, n) × (m, k)`` or ``(B, m, n) × (B, m, k)``,
    ``Aᵀ`` never formed. ``blocks`` and ``plan`` (the reference's Pallas
    block shape and its source) are accepted for signature parity only:
    the kernel picks its CTA tile."""
    del blocks, plan
    cuda = on_cuda(a, b)
    if cuda:
        a, b = _unit_columns("gemm_tn", a), _unit_columns("gemm_tn", b)
    return _run("gemm_tn", cuda, a, b, float(alpha), dtype_code(out_dtype))


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
    cuda = on_cuda(a_blocks, b_blocks)
    if cuda:
        a_blocks = _unit_columns("gemm_tn_fused", a_blocks)
        b_blocks = _unit_columns("gemm_tn_fused", b_blocks)
    (ar, ac, asg), (br, bc, bsg) = tables
    return _run("gemm_tn_fused", cuda, a_blocks, b_blocks,
                *_table_tensors(ar, ac, asg, br, bc, bsg), float(alpha), dtype_code(out_dtype))


def syrk_gather(a_blocks, rows, cols, *, alpha: float = 1.0, blocks=None, plan=None,
                out_dtype=torch.float32):
    """Dense ``alpha·ÂᵀÂ`` of every gathered leaf ``Â = a_blocks[rows[s],
    cols[s]]`` in ONE launch: ``(R, C, [B,] mL, nL)`` → ``(S, [B,] nL,
    nL)``, each tile bitwise symmetric. ``blocks`` and ``plan`` are
    accepted for signature parity."""
    del blocks, plan
    cuda = on_cuda(a_blocks)
    if cuda:
        a_blocks = _unit_columns("syrk_gather", a_blocks)
    return _run("syrk_gather", cuda, a_blocks, *_table_tensors(rows, cols), float(alpha),
                dtype_code(out_dtype))


def _tiles(n: int):
    return [(s, min(s + TILE, n)) for s in range(0, n, TILE)]


def split_launches(name: str, n: int) -> dict:
    """Kernel launches of one ``potrf`` (``name='potrf'``) or ``trsm`` call
    of width ``n`` on the card: one for ``n ≤ TILE``; over it, the split's
    ``t = ceil(n/TILE)`` tiles take ``t`` potrf, ``t − 1`` trsm and
    ``t − 1`` syrk, or ``t`` trsm and ``t − 1`` gemm_tn."""
    t = len(_tiles(n))
    if name == "potrf":
        return {"potrf": t, "trsm": t - 1, "syrk": t - 1}
    if name == "trsm":
        return {"trsm": t, "gemm_tn": t - 1}
    raise ValueError(f"only potrf and trsm split, not {name!r}")


def _potrf_split(a, out_dtype):
    """Right-looking blocked Cholesky of ``n > TILE``: factor the leading
    tile, solve the panel below it, subtract ``L21·L21ᵀ`` (the dense syrk of
    the once-copied ``L21ᵀ``, ``TILE`` rows: one unsplit, fixed-order
    contraction) from the trailing matrix, and go on with it. Every step
    sums in float32; the factor is stored in ``out_dtype`` at the end."""
    f32 = torch.float32
    w = TILE
    l11 = potrf(a[..., :w, :w], out_dtype=f32)
    l21 = trsm(l11, a[..., w:, :w], transpose=True, out_dtype=f32)
    schur = syrk(_copied("potrf", l21.transpose(-1, -2)), out_dtype=f32)
    l22 = potrf(a[..., w:, w:] - schur, out_dtype=f32)
    top = torch.cat([l11, l11.new_zeros((*l11.shape[:-1], l22.shape[-1]))], -1)
    return torch.cat([top, torch.cat([l21, l22], -1)], -2).to(out_dtype)


def _trsm_split(l, b, transpose, out_dtype):
    """Blocked substitution of ``n > TILE`` over :func:`_tiles`: forward
    for ``X·Lᵀ = B``, backward for ``X·L = B``; tile ``j`` solves its
    diagonal block against ``B_j`` minus one ``gemm_tn`` over every tile
    solved before it (``X_doneᵀ`` kept transposed as the tiles come, so the
    contraction runs over rows). Every step sums in float32."""
    f32 = torch.float32
    tiles = _tiles(l.shape[-1])
    order = tiles if transpose else tiles[::-1]
    xs, xts = {}, []            # tile -> X_j; the X_jᵀ solved so far, in order
    for s, e in order:
        rhs = b[..., :, s:e]
        if xts:
            done = torch.cat(xts, -2)                       # (…, Σw, m)
            if transpose:       # X_done·L[j, done]ᵀ: L's row panel, transposed once
                panel = _copied("trsm", l[..., s:e, :s].transpose(-1, -2))
            else:               # X_done·L[done, j]: L's column panel, a view
                panel = l[..., e:, s:e]
            rhs = rhs - gemm_tn(done, panel, out_dtype=f32)
        x = trsm(l[..., s:e, s:e], rhs, transpose=transpose, out_dtype=f32)
        xs[s] = x
        # X_doneᵀ keeps its rows in ascending order, as L's panels do
        xts.insert(len(xts) if transpose else 0, _copied("trsm", x.transpose(-1, -2)))
    return torch.cat([xs[s] for s, _ in tiles], -1).to(out_dtype)


def potrf(a, *, out_dtype=torch.float32):
    """Lower Cholesky factor of SPD tile(s) ``(n, n)`` or ``(B, n, n)``."""
    cuda = on_cuda(a)
    if cuda:
        _potrf.check_shape(a)
        if a.shape[-1] > TILE:
            return _potrf_split(a, out_dtype)
        a = _dense("potrf", a)
    return _run("potrf", cuda, a, dtype_code(out_dtype))


def trsm(l, b, *, transpose: bool = True, out_dtype=torch.float32):
    """Solve ``X·Lᵀ = B`` (``transpose=True``) or ``X·L = B`` for
    ``(n, n) × (m, n)`` or stacked ``(B, n, n) × (B, m, n)``."""
    cuda = on_cuda(l, b)
    if cuda:
        _trsm.check_shapes(l, b)
        n = l.shape[-1]
        if n > TILE:
            return _trsm_split(l, b, transpose, out_dtype)
        if l.stride(-1) != 1 or l.stride(-2) != n:      # each tile contiguous
            l = _copied("trsm", l)
        b = _dense("trsm", b)
    return _run("trsm", cuda, l, b, bool(transpose), dtype_code(out_dtype))


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
