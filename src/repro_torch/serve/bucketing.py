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

The rules hold on the card as they stand: every stage of the bucket
program sums an entry in an order that zero rows, zero right-hand-side
columns and the batch leave alone (:mod:`repro_torch.serve.engine`;
``tools/serve_invariance.py`` holds each stage of the lattice's bucket
shapes against the request's own). On the CPU the contract rests on MKL's
products keeping their bits under the padding, which the CPU tests show at
the smoke lattice's shapes (it does not hold from ``(512, 256)`` up:
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

__all__ = [
    "OPS",
    "BucketSpec",
    "BucketLattice",
    "make_buckets",
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
    ``exact_m`` marks buckets whose gram recurses (``n > n_base``), where
    zero-row m-padding would move the recursion's row split and break the
    bitwise contract — those admit only ``m == spec.m``.
    """

    op: str
    m: int
    n: int
    r: int
    batch: int
    dtype: str = "float32"
    exact_m: bool = False

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
        return tag + (":exact_m" if self.exact_m else "")

    def admits(self, op: str, m: int, n: int, r: int, dtype: str) -> bool:
        """Can a ``(op, m, n, r, dtype)`` request be served by this bucket?"""
        if op != self.op or n != self.n or dtype != self.dtype:
            return False
        if m != self.m if self.exact_m else m > self.m:
            return False
        return r <= self.r

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "BucketSpec":
        return cls(**d)


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
