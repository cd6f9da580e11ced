"""Roofline of the dry-run records, priced on an NVIDIA H100, and the
write-traffic models of the symmetric product and the normal-equations
tail (port of ``repro.analysis.roofline``).

Terms per (arch × shape × mesh) cell, all **per rank** (the dry-run traces
one rank's program; a balanced program makes per rank ≡ global/cards):

    compute_s    = flops / PEAK_FLOPS              (989 TFLOP/s bf16)
    memory_s     = bytes_accessed / HBM_BW         (3.35 TB/s)
    collective_s = Σ_kind factor·bytes / LINK_BW   (50 GB/s a card;
                   all-reduce counts 2× — ring reduce-scatter+all-gather)

The rates are data-sheet rates of one NVIDIA H100 SXM 80 GB at its 700 W
limit, not measurements: bfloat16 dense tensor-core flops, HBM3 (read from
``tune.cost``'s ``cuda`` machine, so it has one home), and one NDR 400 Gb/s
InfiniBand port a card, since both axes of the production meshes cross
hosts of 8 cards. The reference prices a TPU v5e (197 TFLOP/s, 819 GB/s,
50 GB/s a link).

Train and prefill cells may be composed from the dry-run's reduced-depth
*analysis variants* by the affine model ``C(L) = C_fix + L·C_layer``:

    uniform stacks:  C_layer = C(2) − C(1);  C_fix = C(1) − C_layer
    hybrid (hymba):  three variants solve (C_fix, C_global, C_swa)

The port's trace already counts every layer (its layers are a Python
loop), so its ``main`` artifact is exact and a record without variants
(``--no-analysis``) is composed from it; the reference needs the variants
because XLA's cost model counts a loop body once.

MODEL_FLOPS uses the 6·N·T convention (2·N·T for forward-only prefill and
2·N·B for decode), with N = active params (MoE); the ratio
MODEL_FLOPS/flops exposes remat, attention, routing and replicated work.
``COLLECTIVE_KINDS`` and :func:`collective_seconds` are the reference's
``analysis.hlo`` names, which has no port (there is no HLO text).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

from repro_torch.tune.cost import MACHINES

PEAK_FLOPS = 989e12                  # bf16 dense tensor cores / card (data sheet)
HBM_BW = MACHINES["cuda"]().hbm_bw   # bytes/s / card (data sheet, HBM3)
LINK_BW = 50e9                       # bytes/s / card: one NDR 400 Gb/s port (data sheet)
CHIPS = {"single": 256, "multi": 512}

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

__all__ = [
    "compose_cell",
    "load_cells",
    "render_markdown",
    "model_flops_per_device",
    "collective_seconds",
    "syrk_write_traffic",
    "syrk_write_seconds",
    "potrf_write_traffic",
    "trsm_write_traffic",
    "normal_eq_write_traffic",
    "normal_eq_write_seconds",
    "PEAK_FLOPS",
    "HBM_BW",
    "LINK_BW",
    "CHIPS",
    "COLLECTIVE_KINDS",
]


def collective_seconds(
    bytes_by_kind: Dict[str, int],
    link_bw: float = 50e9,
    scale: float = 1.0,
) -> float:
    """Time model: all-reduce moves ≈2× its buffer over the bottleneck link
    (ring reduce-scatter + all-gather); the others ≈1×. ``scale`` multiplies
    byte counts (used by the layer-differencing composition)."""
    factors = {
        "all-reduce": 2.0,
        "all-gather": 1.0,
        "reduce-scatter": 1.0,
        "all-to-all": 1.0,
        "collective-permute": 1.0,
    }
    t = 0.0
    for kind, b in bytes_by_kind.items():
        t += factors.get(kind, 1.0) * b * scale / link_bw
    return t


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


# ---------------------------------------------------------------------------
# the dry-run roofline
# ---------------------------------------------------------------------------


def _cost_vec(artifact: dict) -> dict:
    v = {
        "flops": artifact["cost"].get("flops", 0.0),
        "bytes": artifact["cost"].get("bytes_accessed", 0.0),
    }
    for k in COLLECTIVE_KINDS:
        v[f"coll_{k}"] = float(artifact["collectives"].get(k, 0))
    return v


def _affine(v1: dict, v2: dict, n_layers: int) -> dict:
    out = {}
    for k in v1:
        layer = max(v2[k] - v1[k], 0.0)
        fix = max(v1[k] - layer, 0.0)
        out[k] = fix + n_layers * layer
    return out


def _hybrid(vg1: dict, vgs2: dict, vss2: dict, n_g: int, n_s: int) -> dict:
    out = {}
    for k in vg1:
        f_s = max(vgs2[k] - vg1[k], 0.0)
        f_fix = max(vss2[k] - 2 * f_s, 0.0)
        f_g = max(vg1[k] - f_fix, 0.0)
        out[k] = f_fix + n_g * f_g + n_s * f_s
    return out


def model_flops_per_device(rec: dict) -> float:
    from repro_torch.configs.base import SHAPES

    n = rec["active_params"]
    chips = CHIPS[rec["mesh"]]
    shape = SHAPES[rec["shape"]]
    b, s = shape.global_batch, shape.seq_len
    if rec["mode"] == "train":
        total = 6.0 * n * b * s
    elif rec["mode"] == "prefill":
        total = 2.0 * n * b * s
    else:  # decode: one token per sequence
        total = 2.0 * n * b
    return total / chips


def compose_cell(rec: dict) -> Optional[dict]:
    """Roofline terms for one dry-run record (None if skipped/errored)."""
    if rec.get("status") != "ok":
        return None
    if rec.get("mode") == "gram":
        return None  # gram cells are reported separately
    arts = rec["artifacts"]
    if rec["mode"] == "decode":
        vec = _cost_vec(arts.get("analysis_unrolled", arts["main"]))
    elif "analysis_g1" in arts:  # hybrid
        n_g = len(rec.get("global_attn_layers", []))
        n_s = rec["num_layers"] - n_g
        vec = _hybrid(
            _cost_vec(arts["analysis_g1"]),
            _cost_vec(arts["analysis_gs2"]),
            _cost_vec(arts["analysis_ss2"]),
            n_g, n_s,
        )
    elif "analysis_l1" in arts:
        vec = _affine(
            _cost_vec(arts["analysis_l1"]),
            _cost_vec(arts["analysis_l2"]),
            rec["num_layers"],
        )
    else:  # no analysis variants: the main artifact (exact in the port)
        vec = _cost_vec(arts["main"])

    coll_bytes = {k: vec[f"coll_{k}"] for k in COLLECTIVE_KINDS}
    compute_s = vec["flops"] / PEAK_FLOPS
    memory_s = vec["bytes"] / HBM_BW
    coll_s = collective_seconds(coll_bytes, LINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    bound = max(terms.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "mode": rec["mode"],
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "hlo_flops_per_dev": vec["flops"],
        "hlo_bytes_per_dev": vec["bytes"],
        "collective_bytes_per_dev": coll_bytes,
        "model_flops_per_dev": mf,
        "useful_flop_ratio": round(mf / vec["flops"], 4) if vec["flops"] else 0.0,
        # roofline fraction: how close the dominant term is to the ideal
        # compute-only time (1.0 = perfectly compute-bound at model flops)
        "roofline_fraction": round((mf / PEAK_FLOPS) / bound, 4) if bound else 0.0,
        "peak_bytes_per_dev": rec["artifacts"]["main"]["memory"].get("peak_bytes_est"),
    }


def load_cells(dryrun_dir: str):
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


_SUGGEST = {
    "compute": "cut replicated work: shard the dense layers over 'model' "
               "(tensor parallelism), fewer remat recomputes where memory allows",
    "memory": "cut HBM traffic: fuse elementwise chains, keep intermediates "
              "in bfloat16, fewer remat round-trips",
    "collective": "cut collective volume: reduce-scatter instead of "
                  "all-reduce for grads (ZeRO), bfloat16 reductions, overlap "
                  "collectives with compute",
}


def render_markdown(rows) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | model/HLO flops | roofline frac | peak GiB/dev | next lever |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r is None:
            continue
        peak = r.get("peak_bytes_per_dev")
        peak_s = f"{peak/2**30:.2f}" if peak else "-"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['useful_flop_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} | {peak_s} | "
            f"{_SUGGEST[r['dominant']]} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun", default="results/dryrun")
    ap.add_argument("--out", default="results/roofline")
    args = ap.parse_args(argv)
    recs = load_cells(args.dryrun)
    rows = [compose_cell(r) for r in recs]
    rows = [r for r in rows if r]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "roofline.json"), "w") as f:
        json.dump(rows, f, indent=1)
    md = render_markdown(rows)
    with open(os.path.join(args.out, "roofline.md"), "w") as f:
        f.write(md)
    print(md)


if __name__ == "__main__":
    main()
