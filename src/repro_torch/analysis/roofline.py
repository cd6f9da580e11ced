"""Write-traffic models of the symmetric product and the normal-equations
tail (port of the models in ``repro.analysis.roofline``).

The reference module also holds a TPU v5e's peak rates (``PEAK_FLOPS``,
``HBM_BW``, ``LINK_BW``) and the dry-run roofline of its models; neither
is copied. The ``*_seconds`` helpers take the memory rate as an argument
instead, so a caller prices the traffic at its own device's rate.
"""

from __future__ import annotations

__all__ = [
    "syrk_write_traffic",
    "syrk_write_seconds",
    "potrf_write_traffic",
    "trsm_write_traffic",
    "normal_eq_write_traffic",
    "normal_eq_write_seconds",
]


def syrk_write_traffic(n: int, bn: int, mode: str, itemsize: int = 4) -> int:
    """Bytes *written* to produce an ``n × n`` symmetric product, with
    ``nb = ⌈n/bn⌉`` output tiles a side and ``T = nb(nb+1)/2`` lower tiles:

    * ``'packed'`` — only the T packed tiles:              ``T·bn²``;
    * ``'dual'``   — dense output, every block stored once: ``nb²·bn²``;
    * ``'mirror'`` — T tiles into an nb²-tile buffer, then a mirror pass
      rewrites the square:                                ``T·bn² + n²``.
    """
    nb = -(-n // bn)
    t = nb * (nb + 1) // 2
    tile = bn * bn * itemsize
    if mode == "packed":
        return t * tile
    if mode == "dual":
        return nb * nb * tile
    if mode == "mirror":
        return t * tile + n * n * itemsize
    raise ValueError(f"unknown syrk output mode {mode!r}")


def syrk_write_seconds(n: int, bn: int, mode: str, hbm_bw: float, itemsize: int = 4) -> float:
    """:func:`syrk_write_traffic` over the memory rate ``hbm_bw`` (bytes/s)."""
    return syrk_write_traffic(n, bn, mode, itemsize) / hbm_bw


def potrf_write_traffic(n: int, bn: int, mode: str = "packed", itemsize: int = 4) -> int:
    """Bytes written by the blocked Cholesky of an ``n × n`` gram: the
    packed factor's ``T·bn²`` (``'packed'``) or a dense factor's
    ``(nb·bn)²`` (``'dense'``)."""
    nb = -(-n // bn)
    tile = bn * bn * itemsize
    if mode == "packed":
        return nb * (nb + 1) // 2 * tile
    if mode == "dense":
        return nb * nb * tile
    raise ValueError(f"unknown potrf output mode {mode!r}")


def trsm_write_traffic(n: int, r: int, itemsize: int = 4) -> int:
    """Bytes written by one substitution pass: the ``n·r`` solution panel."""
    return n * r * itemsize


def normal_eq_write_traffic(n: int, bn: int, r: int, *, mode: str = "packed",
                            itemsize: int = 4) -> int:
    """Write bytes of the tail after the gram: the factor
    (:func:`potrf_write_traffic`) and two substitution passes."""
    return potrf_write_traffic(n, bn, mode, itemsize) + 2 * trsm_write_traffic(n, r, itemsize)


def normal_eq_write_seconds(n: int, bn: int, r: int, hbm_bw: float, *, mode: str = "packed",
                            itemsize: int = 4) -> float:
    """Write seconds of the whole pipeline at ``hbm_bw`` (bytes/s): the gram
    in the matching mode plus :func:`normal_eq_write_traffic`."""
    gram_mode = "packed" if mode == "packed" else "dual"
    total = (syrk_write_traffic(n, bn, gram_mode, itemsize)
             + normal_eq_write_traffic(n, bn, r, mode=mode, itemsize=itemsize))
    return total / hbm_bw
