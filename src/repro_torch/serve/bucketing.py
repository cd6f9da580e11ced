"""The bucket lattice: plan-keyed request routing with pad/crop rules
(port of ``repro.serve.bucketing``).

A bucket is one *pre-built program identity*: every request routed to the
same :class:`BucketSpec` shares one solve plan, one batched bucket program
(a captured CUDA graph on the card, :mod:`repro_torch.serve.engine`), and
one static operand shape — so a flush is ONE replay and a request in steady
state never builds or captures anything. The lattice is the map from a
heterogeneous request ``(op, m, n, r, dtype)`` to that identity.

Which axes band and which stay exact is not a free design choice — it is
dictated by the **bitwise-parity contract**: a bucketed result must equal
the per-request ``solve.lstsq`` answer bit for bit, or micro-batching
changes numerics under load (the one failure mode a serving layer must
never have). The reference's rules, which the port keeps on every device:

* ``n`` (features) is an **exact key, never padded**. ``n`` determines the
  packed block grid and the blocked Cholesky walk; padding it across a
  block boundary reorders the factorization's reductions.
  A request whose ``n`` is not in the lattice is rejected, not resized.
* ``m`` (rows) **bands up with zero-row padding** — appended zero rows
  extend the gram's reduction without re-associating it. This holds for
  buckets whose gram is a single leaf (``n ≤ n_base``); a *recursing* gram
  splits ``m`` into slabs, padding moves the split, so recursing buckets
  carry ``exact_m=True`` and admit only ``m == spec.m``.
* ``r`` (right-hand sides) **bands up with zero-column padding** — each
  RHS column flows through the substitutions independently, so appended
  zero columns solve to zero columns and the crop is exact.
* ``dtype`` is an exact key (it is part of the plan key).

**The card's rule — the one place where the port's lattice departs from
the reference's.** On a CUDA device (:func:`card_exact_axes`) two more
things decide the reduction order, and padding can move it:

* the ``syrk`` kernel splits the gram's contraction over
  ``K = syrk_splits(m, n)`` CTAs once ``m > UNSPLIT_MAX_ROWS`` (512), with
  row ranges cut from ``m``: a request padded from 1500 to 2048 rows is
  summed as 8 partials, its twin as 4. A bucket with ``K > 1`` at its
  capacity (``K`` does not fall as ``m`` grows, so ``K = 1`` there means
  ``K = 1`` across the band) is ``exact_m``. At ``K = 1`` the kernel sums
  each output as one ``fmaf`` chain over ascending rows, which zero rows
  extend exactly;
* the plain float32 products outside the kernels go to cuBLAS, which picks
  its kernel and split of the contraction from the shape and the batch.
  ``tools/serve_invariance.py`` (on an NVIDIA H100 80GB HBM3 at 700 W,
  torch 2.11, CUDA 12.8) padded ragged requests into ``chip_smoke.py``
  phase ``serve``'s buckets and compared each stage with the request's
  own: ``Aᵀb`` on cuBLAS changed its bits under zero-row padding in 3 of 7
  requests at ``(m, n, r) = (512, 256, 64)`` and in all 14 at
  ``m = 8192``, and under zero-column padding in 6 of 7 at ``(512, 256,
  64)``; the substitutions' Schur products (``solve/triangular.py``, one
  product of ``r`` columns a block step) changed theirs under zero-column
  padding in 1 of 8 at ``(512, 256, 8)``, 6 of 7 at ``(8192, 512, 64)``
  and 3 of 3 at whiten ``(4096, 1024, 64)``.

So ``Aᵀb`` (``core.strassen._dot_tn``) runs on the ``gemm_tn`` kernel
wherever ``m ≤ UNSPLIT_MAX_ROWS``: one ``fmaf`` chain over ascending rows
per output, each column of ``b`` its own, so zero rows and zero columns
leave the other outputs' bits as they were (the same tool: 8 of 8
requests at ``(512, 256)`` kept their bits under row padding, column
padding and batching alike). A bucket is then ``exact_m``
where ``syrk`` splits, and ``exact_r`` where ``n`` spans more than one
packed block (with one block the substitution is one ``trsm`` launch,
whose right-hand sides are independent); an ``lstsq`` bucket above
``UNSPLIT_MAX_ROWS`` rows, whose ``Aᵀb`` is cuBLAS's, is exact in both.

The same runs showed the batched Schur products of the Cholesky walk
(``n ≥ 512``) and the batched ``Aᵀb`` to differ from the unbatched ones in
their last bits; the engine therefore runs the factor, ``Aᵀb`` and the
solves one batch entry at a time inside the bucket's program
(:mod:`repro_torch.serve.engine`). On the CPU the lattice is the
reference's, field for field; its bitwise contract there rests on MKL's
products keeping their bits under the padding, which the CPU tests show at
the smoke lattice's shapes (it does not hold at ``(8192, 256)``:
``tools/serve_invariance.py --device cpu``).

The parity reference for a request ``(m, n, r)`` served by bucket ``spec``
is ``solve.lstsq(a, b, plan=request_twin(spec_plan, m, r))`` — the bucket's
solve plan re-shaped to the request (same ``n_base``/``packed_block``/
method, request ``m``/``k``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "OPS",
    "BucketSpec",
    "BucketLattice",
    "make_buckets",
    "card_exact_axes",
    "for_device",
    "pad_operands",
    "crop_result",
]

# request operations the server understands:
#   lstsq  — min ‖A·x − b‖² + ridge‖x‖²: a (m, n), b (m, r) → x (n, r)
#   whiten — L⁻¹·v with AᵀA = L·Lᵀ:      a (m, n), v (n, r) → z (n, r)
OPS = ("lstsq", "whiten")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One bucket: a pre-built program identity in the lattice.

    ``m``/``r`` are *capacities* (requests pad up to them); ``n`` is exact.
    ``batch`` is the static flush width B of the bucket's program.
    ``exact_m`` marks buckets where zero-row m-padding would move a
    reduction (a recursing gram, ``n > n_base``; on the card also the rule
    of :func:`card_exact_axes`) — those admit only ``m == spec.m``. ``exact_r``
    (the card's rule only) admits only ``r == spec.r``.
    """

    op: str
    m: int
    n: int
    r: int
    batch: int
    dtype: str = "float32"
    exact_m: bool = False
    exact_r: bool = False

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown serve op {self.op!r}; use one of {OPS}")
        if self.m < self.n:
            raise ValueError(
                f"bucket m={self.m} < n={self.n}: the normal equations "
                "need a tall (or square) design matrix")
        if min(self.m, self.n, self.r, self.batch) < 1:
            raise ValueError(f"bucket dims must be positive, got {self}")

    @property
    def key(self) -> Tuple:
        """The routing identity (one pre-built program per key)."""
        return (self.op, self.m, self.n, self.r, self.dtype)

    def label(self) -> str:
        """Stable metric/artifact label: ``lstsq:m96:n64:r8:float32:b4``."""
        tag = f"{self.op}:m{self.m}:n{self.n}:r{self.r}:{self.dtype}:b{self.batch}"
        return tag + (":exact_m" if self.exact_m else "") + (":exact_r" if self.exact_r else "")

    def admits(self, op: str, m: int, n: int, r: int, dtype: str) -> bool:
        """Can a ``(op, m, n, r, dtype)`` request be served by this bucket?"""
        if op != self.op or n != self.n or dtype != self.dtype:
            return False
        if m != self.m if self.exact_m else m > self.m:
            return False
        return r == self.r if self.exact_r else r <= self.r

    def to_json(self) -> dict:
        """The reference's fields; ``exact_r`` only where it is set."""
        d = dataclasses.asdict(self)
        if not self.exact_r:
            del d["exact_r"]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "BucketSpec":
        return cls(**d)


def card_exact_axes(op: str, m: int, n: int, *,
                    packed_block: Optional[int] = None) -> Tuple[bool, bool]:
    """``(exact_m, exact_r)`` that the card's rule (module docstring) asks
    of a bucket of capacity ``m``: ``m`` where ``syrk_splits(m, n) > 1``,
    ``r`` where ``n`` spans more than one block of ``packed_block``
    (default: the planner's ``DEFAULT_PACKED_BLOCK``), so that the
    substitutions run Schur products of ``r`` columns; both for an
    ``lstsq`` bucket above ``UNSPLIT_MAX_ROWS`` rows, whose ``Aᵀb`` is a
    cuBLAS product at the bucket's ``(m, r)``."""
    from repro_torch.core.symmetric import default_block_size
    from repro_torch.kernels.syrk import UNSPLIT_MAX_ROWS, syrk_splits
    from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

    bn = default_block_size(n, packed_block or DEFAULT_PACKED_BLOCK)
    blas = op == "lstsq" and m > UNSPLIT_MAX_ROWS
    return syrk_splits(m, n) > 1 or blas, n > bn or blas


def for_device(spec: BucketSpec, device, *, packed_block: Optional[int] = None) -> BucketSpec:
    """``spec`` as a server on ``device`` serves it: on a CUDA device with
    the card's rule (:func:`card_exact_axes`) added to its flags, elsewhere
    unchanged. Flags are only ever added, so a lattice read from JSON keeps
    its own. :class:`~repro_torch.serve.engine.Server` applies it to every
    bucket of its config; nothing else does."""
    if torch.device(device).type != "cuda":
        return spec
    exact_m, exact_r = card_exact_axes(spec.op, spec.m, spec.n, packed_block=packed_block)
    return dataclasses.replace(spec, exact_m=spec.exact_m or exact_m,
                               exact_r=spec.exact_r or exact_r)


def make_buckets(
    *,
    ops: Sequence[str] = ("lstsq",),
    n_values: Sequence[int] = (64,),
    m_bands: Sequence[int] = (128,),
    r_bands: Sequence[int] = (8,),
    batch: int = 4,
    dtype: str = "float32",
    n_base: Optional[int] = None,
) -> Tuple[BucketSpec, ...]:
    """The cross-product lattice: one bucket per (op × n × m-band × r-band).

    ``n_base`` (default: the planner's ``DEFAULT_N_BASE``) decides which
    buckets recurse and therefore carry ``exact_m`` (see module docstring).
    This is the reference's lattice on every device; a
    :class:`~repro_torch.serve.engine.Server` adds its device's rule
    (:func:`for_device`).
    """
    if n_base is None:
        from repro_torch.tune.defaults import DEFAULT_N_BASE

        n_base = DEFAULT_N_BASE
    specs = []
    for op in ops:
        for n in n_values:
            for m in sorted(m_bands):
                if m < n:
                    continue
                for r in sorted(r_bands):
                    specs.append(BucketSpec(op=op, m=m, n=n, r=r, batch=batch, dtype=dtype,
                                            exact_m=n > n_base))
    if not specs:
        raise ValueError("empty bucket lattice (every m band below n?)")
    return tuple(specs)


class BucketLattice:
    """Routes requests to the smallest admitting bucket.

    "Smallest" means least padding: among admitting buckets the one with
    minimal ``(m, r)`` lexicographically — bands are nested by
    construction, so this is the tightest capacity fit.
    """

    def __init__(self, specs: Sequence[BucketSpec]):
        seen = set()
        for s in specs:
            if s.key in seen:
                raise ValueError(f"duplicate bucket key {s.key}")
            seen.add(s.key)
        self.specs: Tuple[BucketSpec, ...] = tuple(
            sorted(specs, key=lambda s: (s.op, s.n, s.dtype, s.m, s.r)))

    def __len__(self) -> int:
        return len(self.specs)

    def bucket_for(self, op: str, m: int, n: int, r: int,
                   dtype: str = "float32") -> Optional[BucketSpec]:
        """The tightest admitting bucket, or None (→ admission reject)."""
        for s in self.specs:          # sorted ascending (m, r) per group
            if s.admits(op, m, n, r, dtype):
                return s
        return None


def pad_operands(spec: BucketSpec, a, b, *, out=None):
    """Pad one request's operands to the bucket's static shape.

    ``a``: (m, n) → (spec.m, n) with zero rows (bitwise-transparent to the
    gram — the parity contract's m rule). ``b``: lstsq (m, r) →
    (spec.m, spec.r) with zero rows (they meet A's zero rows in Aᵀb) and
    zero columns; whiten (n, r) → (n, spec.r) with zero columns only (v
    lives in feature space — it has no row padding to do).

    ``out``: optional ``(a_out, b_out)`` numpy arrays of those shapes to
    write into (the engine's staging slots); values are cast to their
    dtype, as the pipeline's own float32 cast would. Returns the padded
    pair.

    Assembly is **numpy on purpose**: a flush touches the device once, to
    copy the assembled batch in, and runs nothing there but the bucket's
    program.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    m, n = a.shape
    r = b.shape[-1]
    if n != spec.n or m > spec.m or r > spec.r:
        raise ValueError(
            f"request ({m}, {n}, r={r}) does not fit bucket {spec.label()}")
    want_rows = spec.m if spec.op == "lstsq" else spec.n
    if out is None:
        a_pad = np.zeros((spec.m, spec.n), a.dtype)
        b_pad = np.zeros((want_rows, spec.r), b.dtype)
    else:
        a_pad, b_pad = out
        a_pad[m:] = 0
        b_pad[...] = 0
    a_pad[:m] = a
    b_pad[:b.shape[0], :r] = b
    return a_pad, b_pad


def crop_result(spec: BucketSpec, x, r: int):
    """Crop one bucketed result slice back to the request's RHS count.

    ``x``: (n, spec.r) → (n, r). The crop is exact by the parity
    contract: padded RHS columns are zero end-to-end, and ``n`` was never
    padded in the first place.
    """
    del spec
    return x[:, :r]
