"""Packed lower-triangular block storage (port of ``repro.core.symmetric``).

A symmetric ``n × n`` matrix is stored as its ``nb(nb+1)/2`` lower blocks:

    blocks : (..., T, bn, bn)   with T = nb·(nb+1)/2, nb = ⌈n/bn⌉

block ``t`` being tile ``(i, j)`` of the block grid under the row-major
lower enumeration ``t = i(i+1)/2 + j`` (``j ≤ i``) — the enumeration of the
``syrk`` kernel's grid, so its packed output is this storage as it stands.
Off-diagonal blocks hold full tiles; diagonal blocks hold bitwise-symmetric
tiles (:func:`sym_tile`).

Everything here is data movement or elementwise IEEE arithmetic, so it
agrees with the reference bitwise. Unlike the reference's immutable arrays,
:func:`write_packed_region` writes into its buffer in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.backend import device_table, resolve_device

__all__ = [
    "SymmetricMatrix",
    "tri_block_indices",
    "diag_block_indices",
    "col_panel_indices",
    "default_block_size",
    "sym_tile",
    "write_packed_region",
]


def sym_tile(x):
    """Bitwise-symmetrize the trailing two dims: keep ``low(x)``, mirror up."""
    return torch.tril(x) + torch.tril(x, -1).transpose(-1, -2)


def default_block_size(n: int, bn: int) -> int:
    """Clamp a requested packed block size to the logical matrix size: never
    above the next multiple of 8 ≥ n, and balanced over the implied block
    count (n=200 with a 128 request stores two 104-blocks). Every producer
    of packed storage uses this one clamp."""
    bn = min(bn, max(8, -(-n // 8) * 8))
    nb = -(-n // bn)
    return max(8, -(-(-(-n // nb)) // 8) * 8)


def write_packed_region(buf, arr, r0, c0, bn):
    """Write a dense region at global offset ``(r0, c0)`` into packed
    ``(..., T, bn, bn)`` storage, split along the bn grid, in place.

    Pieces that fall in strictly-upper blocks (bi < bj) are skipped: they
    come only from the intra-tile upper halves of symmetric regions, which
    the mirror in ``to_dense`` reconstructs. Returns ``buf``.
    """
    h, w = arr.shape[-2:]
    r = r0
    while r < r0 + h:
        bi = r // bn
        r_end = min((bi + 1) * bn, r0 + h)
        c = c0
        while c < c0 + w:
            bj = c // bn
            c_end = min((bj + 1) * bn, c0 + w)
            if bi >= bj:
                t = bi * (bi + 1) // 2 + bj
                buf[..., t, r - bi * bn : r_end - bi * bn,
                    c - bj * bn : c_end - bj * bn] = arr[
                    ..., r - r0 : r_end - r0, c - c0 : c_end - c0]
            c = c_end
        r = r_end
    return buf


def _retile(tiles, nb: int, bn: int, nb_pack: int):
    """The packed ``(..., T, bn, bn)`` storage over an ``nb_pack``-block grid
    of a tri-ordered stripe tile stack ``(..., S, w, w)`` on an ``nb``-stripe
    grid, each diagonal stripe tile symmetrized (:func:`sym_tile`) first,
    blocks strictly above the diagonal left out and everything past the
    packed grid's ``nb_pack·bn`` rows and columns cut: what writing each
    tile with :func:`write_packed_region` gives, bitwise (the same values
    copied), one stripe row at a time. A stripe row is one row panel of
    its tiles, cut to block height and copied into each block row it
    covers at once, so the copies scale with the stripe and block rows,
    not with the tiles times the blocks each spans."""
    w = tiles.shape[-1]
    batch = tiles.shape[:-3]
    n_pad = nb_pack * bn
    buf = torch.zeros((*batch, nb_pack * (nb_pack + 1) // 2, bn, bn), dtype=tiles.dtype,
                      device=tiles.device)
    for i in range(nb):
        r0 = i * w
        if r0 >= n_pad:
            break
        h, cols = min(w, n_pad - r0), min((i + 1) * w, n_pad)
        t0 = i * (i + 1) // 2
        # stripe row i: tiles (i, 0..i) side by side, the diagonal one symmetrized
        left = tiles[..., t0:t0 + i, :h, :].movedim(-3, -2).reshape(*batch, h, i * w)
        panel = torch.cat([left, sym_tile(tiles[..., t0 + i, :, :])[..., :h, :]], dim=-1)
        top = r0 % bn
        kr, kc = -(-(top + h) // bn), -(-cols // bn)
        panel = torch.nn.functional.pad(panel[..., :cols], (0, kc * bn - cols, top,
                                                            kr * bn - top - h))
        blocks = panel.reshape(*batch, kr, bn, kc, bn)
        for r in range(kr):
            bi = r0 // bn + r
            lo, hi = max(top - r * bn, 0), min(top + h - r * bn, bn)
            nk = min(bi + 1, kc)   # blocks (bi, bj ≤ bi) the panel reaches
            ta = bi * (bi + 1) // 2
            buf[..., ta:ta + nk, lo:hi, :] = blocks[..., r, lo:hi, :nk, :].movedim(-2, -3)
    return buf


def diag_block_indices(nb: int):
    """Packed indices of the ``nb`` diagonal blocks: ``t = i(i+1)/2 + i``."""
    return np.array([i * (i + 1) // 2 + i for i in range(nb)], np.int64)


def col_panel_indices(nb: int, j: int):
    """Packed indices of block column ``j`` below the diagonal
    (``t = i(i+1)/2 + j`` for ``i = j+1 … nb−1``)."""
    return np.array([i * (i + 1) // 2 + j for i in range(j + 1, nb)], np.int64)


def tri_block_indices(nb: int):
    """``(i, j)`` arrays of length ``T = nb(nb+1)/2`` with
    ``t = i(i+1)/2 + j``, ``j ≤ i`` — row-major over the lower triangle."""
    i, j = np.tril_indices(nb)
    return i.astype(np.int64), j.astype(np.int64)


def tri_index(nb: int, device):
    """:func:`tri_block_indices` as two int64 tensors kept on ``device``."""
    return (device_table(("tri_i", nb), device, lambda: tri_block_indices(nb)[0]),
            device_table(("tri_j", nb), device, lambda: tri_block_indices(nb)[1]))


def _diag_index(nb: int, device):
    return device_table(("diag", nb), device, lambda: diag_block_indices(nb))


def _col_index(nb: int, j: int, device):
    return device_table(("col", nb, j), device, lambda: col_panel_indices(nb, j))


def _eye_mask(n: int, bn: int, dtype, device):
    """``(nb, bn, bn)`` ones on the logical diagonal of each diagonal tile."""
    def make():
        nb = -(-n // bn)
        mask = np.zeros((nb, bn, bn), np.float32)
        for i in range(nb):
            d = min(bn, n - i * bn)
            mask[i, range(d), range(d)] = 1.0
        return torch.as_tensor(mask, dtype=dtype)

    return device_table(("eye_mask", n, bn, str(dtype)), device, make)


class SymmetricMatrix:
    """Symmetric ``n × n`` matrix stored as packed lower-triangular blocks."""

    __slots__ = ("blocks", "n", "bn")

    def __init__(self, blocks, n: int, bn: int):
        self.blocks = blocks
        self.n = int(n)
        self.bn = int(bn)

    # -- static geometry ----------------------------------------------------

    @property
    def nb(self) -> int:
        return -(-self.n // self.bn)

    @property
    def t_total(self) -> int:
        return self.nb * (self.nb + 1) // 2

    @property
    def shape(self):
        """Logical dense shape (leading batch dims + (n, n))."""
        return tuple(self.blocks.shape[:-3]) + (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def nbytes(self) -> int:
        """Resident bytes of the packed storage."""
        return self.blocks.numel() * self.blocks.element_size()

    @staticmethod
    def dense_nbytes(n: int, batch=(), itemsize: int = 4) -> int:
        """Bytes the equivalent dense storage would occupy."""
        return int(math.prod(batch)) * n * n * itemsize

    # -- constructors -------------------------------------------------------

    @classmethod
    def zeros(cls, n: int, bn: int, batch=(), dtype=torch.float32, device=None):
        bn = default_block_size(n, bn)
        nb = -(-n // bn)
        t = nb * (nb + 1) // 2
        return cls(torch.zeros((*batch, t, bn, bn), dtype=dtype,
                               device=resolve_device(device)), n, bn)

    @classmethod
    def from_dense_lower(cls, lower, bn: int):
        """Pack a dense ``(..., n, n)`` array whose meaningful content is the
        lower triangle (strictly-upper block positions ignored) — a gather."""
        *batch, n, n2 = lower.shape
        if n != n2:
            raise ValueError(f"expected square input, got {tuple(lower.shape)}")
        bn = default_block_size(n, bn)
        nb = -(-n // bn)
        pad = nb * bn - n
        if pad:
            lower = torch.nn.functional.pad(lower, (0, pad, 0, pad))
        i_idx, j_idx = tri_index(nb, lower.device)
        x = lower.reshape(*batch, nb, bn, nb, bn).transpose(-3, -2)
        blocks = x[..., i_idx, j_idx, :, :]
        return cls(blocks, n, bn)

    @classmethod
    def from_tile_stack(cls, tiles, n: int, *, nb: int, packed_block=None,
                        presymmetrized: bool = False):
        """Assemble from a tri-enumerated ``(..., S, w, w)`` lower-triangle
        tile stack over an ``nb``-stripe grid of width ``w``.

        Aligned (``w`` equals the packed block size): the first ``T`` stack
        entries are the packed storage. Misaligned: the stripe tiles are
        re-tiled onto the packed grid (:func:`_retile`, bitwise what
        :func:`write_packed_region` of each tile gives).
        Diagonal blocks are symmetrized either way, unless the aligned
        producer says they already are (``presymmetrized``).
        """
        w = tiles.shape[-1]
        t_src = nb * (nb + 1) // 2
        if tiles.shape[-2] != w:
            raise ValueError(f"expected square tiles, got {tuple(tiles.shape[-2:])}")
        if tiles.shape[-3] < t_src:
            raise ValueError(
                f"stack holds {tiles.shape[-3]} tiles < T={t_src} for nb={nb}"
            )
        if nb * w < n:
            raise ValueError(f"nb={nb} stripes of width {w} do not cover n={n}")
        if packed_block is None:
            from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

            packed_block = DEFAULT_PACKED_BLOCK
        bn = default_block_size(n, packed_block)
        nb_pack = -(-n // bn)
        t_pack = nb_pack * (nb_pack + 1) // 2
        if w == bn:
            packed = cls(tiles[..., :t_pack, :, :], n, bn)
            return packed if presymmetrized else packed._symmetrize_diag()
        return cls(_retile(tiles, nb, bn, nb_pack), n, bn)._symmetrize_diag()

    @classmethod
    def from_dense(cls, dense, bn: int):
        """Pack a full symmetric dense matrix (upper triangle discarded)."""
        return cls.from_dense_lower(torch.tril(dense), bn)._symmetrize_diag()

    def _symmetrize_diag(self):
        """Restore the full-symmetric-diagonal-tile contract after a tril."""
        diag_t = _diag_index(self.nb, self.blocks.device)
        blocks = self.blocks.clone()
        blocks[..., diag_t, :, :] = sym_tile(self.blocks[..., diag_t, :, :])
        return SymmetricMatrix(blocks, self.n, self.bn)

    # -- conversions --------------------------------------------------------

    def to_dense(self):
        """Dense ``(..., n, n)`` reconstruction, bitwise symmetric: the one
        mirror of the lower triangle happens here."""
        nb, bn, n = self.nb, self.bn, self.n
        i_idx, j_idx = tri_index(nb, self.blocks.device)
        batch = self.blocks.shape[:-3]
        z = self.blocks.new_zeros((*batch, nb, nb, bn, bn))
        z[..., i_idx, j_idx, :, :] = self.blocks
        z = z.transpose(-3, -2).reshape(*batch, nb * bn, nb * bn)
        return sym_tile(z[..., :n, :n])

    # -- block views --------------------------------------------------------

    @staticmethod
    def block_index(i: int, j: int) -> int:
        """Packed index of block ``(i, j)`` — row-major lower enumeration."""
        if j > i:
            raise ValueError(f"block ({i}, {j}) lies in the upper triangle")
        return i * (i + 1) // 2 + j

    def block(self, i: int, j: int):
        """The ``(..., bn, bn)`` tile of block-grid position ``(i, j)``."""
        return self.blocks[..., self.block_index(i, j), :, :]

    def diag_blocks(self):
        """All diagonal tiles as one ``(..., nb, bn, bn)`` stack."""
        return self.blocks[..., _diag_index(self.nb, self.blocks.device), :, :]

    def col_panel(self, j: int):
        """Block column ``j`` below the diagonal: ``(..., nb−1−j, bn, bn)``."""
        return self.blocks[..., _col_index(self.nb, j, self.blocks.device), :, :]

    def add_scaled_identity(self, s) -> "SymmetricMatrix":
        """``self + s·I`` on the logical diagonal (pad entries beyond ``n``
        untouched); only the ``nb`` diagonal tiles change."""
        mask = _eye_mask(self.n, self.bn, self.blocks.dtype, self.blocks.device)
        tiles = self.diag_blocks() + s * mask
        diag_t = _diag_index(self.nb, self.blocks.device)
        blocks = self.blocks.clone()
        blocks[..., diag_t, :, :] = tiles
        return SymmetricMatrix(blocks, self.n, self.bn)

    def diagonal(self):
        """The main diagonal of the logical matrix, ``(..., n)``."""
        nb, bn, n = self.nb, self.bn, self.n
        d = torch.diagonal(self.diag_blocks(), dim1=-2, dim2=-1)
        return d.reshape(*self.blocks.shape[:-3], nb * bn)[..., :n]

    def trace(self):
        return torch.sum(self.diagonal(), dim=-1)

    # -- arithmetic ---------------------------------------------------------

    def _check_compatible(self, other: "SymmetricMatrix"):
        if (self.n, self.bn) != (other.n, other.bn):
            raise ValueError(
                f"incompatible packed layouts: (n={self.n}, bn={self.bn}) vs "
                f"(n={other.n}, bn={other.bn})"
            )

    def add(self, other: "SymmetricMatrix") -> "SymmetricMatrix":
        self._check_compatible(other)
        return SymmetricMatrix(self.blocks + other.blocks, self.n, self.bn)

    def scale(self, s) -> "SymmetricMatrix":
        return SymmetricMatrix(self.blocks * s, self.n, self.bn)

    def astype(self, dtype) -> "SymmetricMatrix":
        return SymmetricMatrix(self.blocks.to(dtype), self.n, self.bn)

    def __add__(self, other):
        if isinstance(other, SymmetricMatrix):
            return self.add(other)
        return NotImplemented

    def __mul__(self, s):
        if isinstance(s, SymmetricMatrix):
            return NotImplemented
        return self.scale(s)

    __rmul__ = __mul__

    def __repr__(self):
        return (
            f"SymmetricMatrix(n={self.n}, bn={self.bn}, "
            f"blocks={tuple(self.blocks.shape)}, dtype={self.blocks.dtype})"
        )
