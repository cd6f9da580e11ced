#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (the run fails, exits non-zero and prints no final line if any
phase fails):

1. build   — compile every CUDA kernel of ``repro_torch`` from the sources
             in this checkout (``build/kernels/``), with its time;
2. kernels — each kernel's wrapper on card tensors at the main path's
             shapes, held against its plain PyTorch version on the same
             inputs (tolerance ``8·√k·eps·max|ref|``), timed beside the
             plain version and one PyTorch library call;
             The fused kernels are also held bitwise against ``gemm_tn`` /
             ``syrk`` on the materialized combined / stacked operands,
             gemm_tn_fused at each level of ata 8192² with its rate; potrf
             on stacks of n ∈ {1, 33, 104, 128, 256}; syrk on lstsq's
             single (2048, 512) leaf, split over a cluster of
             ``syrk_splits`` CTAs a tile, a batch entry bitwise against its
             single launch there; device times (CUDA graphs; syrk_gather
             20 launches back to back) of syrk, syrk_gather, potrf and
             trsm, each beside its library call's;
             and lines of registers, shared memory and occupancy of the
             redesigned kernels (gemm_tn_fused, potrf, gemm_tn, trsm, syrk);
3. ata     — ``ata(a, out="packed")`` at ``a: 8192×8192`` float32 under the
             unrolled, batched and fused leaf dispatch: bitwise equal to
             each other, each with its exact kernel launch counts and peak
             device memory (the fused one at least one 1430-leaf operand
             stack below the batched one), and within 1e-4 (relative
             Frobenius, lower triangle) of the float64 product;
4. strassen — ``strassen_tn`` at 4096³, fused (one launch) bitwise equal
             to unrolled;
5. lstsq   — ``lstsq(a, b, ridge=1e-3)`` at ``a: 16384×4096``,
             ``b: 16384×8``, within 1e-3 of the float64 solution of the
             ridge normal equations, with each of its four kernels launched;
6. dtypes  — (after kernels) each of the six kernels on bfloat16 operands
             at the shapes of phase 2, storing float32 and bfloat16,
             against its plain version (the bound above, plus one
             bfloat16 ulp for a bfloat16 store), with device times; ata
             4096² in bfloat16 under the three dispatches within 2e-2
             (the reference's bfloat16 rtol, normwise) of the float64
             product, unrolled == batched bitwise; ata 4096² in float64 on
             the card (plain bases, no launch) within ``8·√k·eps64`` of the
             same call on the CPU;
7. cg      — ``lstsq(a, b, ridge=1e-3, method="cg")`` on the lstsq
             phase's data under ``torch.cuda.set_sync_debug_mode("error")``
             (no host sync in the loop), within 1e-3 of the float64
             solution, exactly ``iters + 1`` gemm_tn launches; the device
             time of one (16384, 4096, 8) gemm_tn beside
             ``torch.matmul(a.T, ap)`` and its bound;
8. obs     — fused ata 8192² with spans off and on: times, span counts,
             outputs bitwise equal, the metrics snapshot validated;
9. tune    — the planner (``repro_torch.tune``, cuda machine): the analytic
             plans of ata 8192² packed, strassen_tn 4096³, lstsq
             16384×4096×8 and CG's (16384, 4096, 8) product; each planned
             default (an unpinned call) against the pinned call on the same
             data (``scaled_tol``; bitwise where both run one tree), timed
             beside the pinned dispatches and the library call, with its
             launches, calibration rows and peak device memory beside the
             model's ``peak_bytes``; ``autotune=True`` for ata 8192² into
             a temporary cache file, read back in a fresh memo;
             ``python -m repro_torch.obs`` on the card; and ata 32768²,
             where the memory budget leaves no batched or fused tree,
             planned and run within 1e-4 of the float64 product;
10. optim  — the optimizers (``repro_torch.optim``) on qwen1.5-0.5b's full
             parameter tree (``param_shapes``: 24 layers, d_model 1024,
             619.57 M float32 parameters; seeded parameters and gradients):
             each gram block shape's plan and peak memory beside
             ``tune.cost.peak_bytes``; wq's L (384, 64, 1024) and wg's
             (72, 1024, 1024) gram stacks against ``torch.einsum`` and, on
             sampled blocks, within ``scaled_tol`` of float64; Shampoo p = 2
             packed for 3 steps (``update_every=2``, ``block=1024``, gram
             cutoff pinned): step ms, the grams' ms alone, launches, peak
             memory, resident stats and preconditioners, the refresh
             step's host syncs, the third step under
             ``set_sync_debug_mode("error")``, syrk, gemm_tn, potrf and
             trsm each launched by the refresh step, the refreshed
             factors' residual ≤ 1e-4, every factor finite, and one
             planned refresh step; p = 2 dense within 2e-3 of packed, every
             update finite; p = 4 packed bitwise equal to dense in its
             updates, stats and preconditioners, the stats finite and the
             updates of at least 6 leaves finite; PowerSGD rank 4 on wg and wd (two rounds), its
             rank-sufficient reconstruction within 1e-3, and its narrow
             ``strassen_tn(G, P)`` beside ``torch.matmul``; one AdamW step
             over the whole tree.

11. distributed — (``repro_torch.core.distributed`` on
             ``torch.distributed``) 4 ranks started by ``launch.mesh.spawn``:
             NCCL with one card per rank where the machine has 4 cards,
             else gloo with the 4 ranks on card 0 (time-sliced: no
             scaling is claimed from those times). On meshes ``(task=4)``
             and ``(task=2, row=2)``, ``a`` 8192×8192: ``ata_tile_parallel``
             packed and dense, ``ata_bfs_dfs`` with interleavings "D",
             "BD", "B" (and "BD" dense), a fused tile body and
             ``alpha=0.5`` at the pinned grid (``nb=8``, ``n_base=512``),
             each within ``scaled_tol(8192)`` of the single-device ``ata``
             on card 0, packed ``to_dense()`` bitwise equal to dense, every
             interleaving and the fused body bitwise equal to
             ``ata_tile_parallel``, ``alpha`` bitwise ``scale(0.5)``; one
             planned call (no pins) with its plan, prediction and drift.
             On ``(task=4)``: ``gram_rowshard`` of a (32768, 4096) row-sharded
             operand (packed, fused local ata) within ``scaled_tol(32768)``,
             ``gemm_tn_colshard`` (16384, 4096)ᵀ×(16384, 4096) within
             ``scaled_tol(16384)`` of ``strassen_tn``, and PowerSGD's
             ``compress_sharded`` at rank 4 on a (24576, 2816) gradient (wg's
             shape) in 4 row shards of 6144 within 1e-3 (normwise Ĝ and Q) of
             ``compress`` on one rank, P orthonormal within 1e-3, and rank 8
             on a rank-4 gradient reconstructed within 1e-3. Per case and
             rank: ms (median of CUDA events over 3 runs after a checked
             run), the collectives' ms (one run with tracing on) and bytes
             by kind, kernel launches and peak memory. Each of the six
             kernels must be launched by the ranks' checked runs.

Phases 3–8, Shampoo's checked runs in phase 10 and the pinned cases of
phase 11 pin ``n_base`` (or ``method``) to the static defaults: unpinned
calls are planned, and those phases measure the dispatches they name.
``python3 chip_smoke.py distributed`` runs the build and phase 11 alone
(what a call on four cards needs) and prints no final line.

Inputs are made with numpy from fixed seeds. Times are medians of CUDA
events over a few runs after one warm-up. Output: the card's name and
power limit first, a JSON line ``{"kernels": [...]}`` before the last, and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth. Used only for the bound column.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
EPS32 = 1.19e-7
EPS64 = 2.2e-16
BF16_ULP = 2.0 ** -7
# the reference's bfloat16 band (tests/test_kernels.py): rtol, here normwise
BF16_RTOL = 2e-2
SEED = 0
# the static cutoff: the phases before `tune` pin it, so they keep measuring
# the dispatches they name now that unpinned calls are planned
DEFAULT_N_BASE = 512


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``runs`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 50) -> float:
    """Device time of one ``fn()``: ``launches`` calls captured in a CUDA
    graph, replayed, median over five replays, divided by ``launches`` — no
    host time between launches."""
    import torch

    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    return time_ms(graph.replay) / launches


def burst_ms(fn, launches: int = 20) -> float:
    """Device time of one ``fn()`` that cannot be captured in a CUDA graph
    (it copies a table from the host): ``launches`` calls queued back to back
    between two CUDA events, median over five bursts, divided by
    ``launches``. Valid for calls whose host time is well below their device
    time, so the device never waits between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(least time in ms, what bounds it) for the work on an H100."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def scaled_tol(k: int, ref) -> float:
    return 8.0 * math.sqrt(k) * EPS32 * float(ref.abs().max())


def cuda_tensor(rng, shape):
    import torch

    return torch.as_tensor(rng.standard_normal(shape, dtype="float32"), device="cuda")


def spd_tiles(rng, batch: int, n: int):
    """Well-conditioned SPD tiles: XᵀX/n + I."""
    import torch

    x = torch.as_tensor(rng.standard_normal((batch, 2 * n, n), dtype="float32"),
                        device="cuda", dtype=torch.float64)
    s = x.transpose(1, 2) @ x / (2 * n) + torch.eye(n, device="cuda", dtype=torch.float64)
    return s.float().contiguous()


def param_shapes(cfg) -> dict:
    """Shapes of the reference's ``models.transformer.init`` tree for a
    dense ``ModelConfig`` (no mesh), as nested dicts with sorted keys:
    ``embed``, ``final_norm``, ``layers`` (stacked on a leading
    ``num_layers`` dim under ``scan_layers``, else a list of per-layer
    dicts) and, unless the embeddings are tied, ``lm_head``."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
        raise ValueError(f"param_shapes covers dense configs, got family {cfg.family!r}")
    d, h, kv, hd, ff = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d),
            "norm": (d,)}
    if cfg.qkv_bias:
        attn.update(bq=(h, hd), bk=(kv, hd), bv=(kv, hd))
    layer = {"attn": attn}
    if ff:
        layer["mlp"] = {"wg": (d, ff), "wu": (d, ff), "wd": (ff, d), "norm": (d,)}

    def lead(tree, dims):
        if isinstance(tree, dict):
            return {k: lead(v, dims) for k, v in sorted(tree.items())}
        return (*dims, *tree)

    out = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
           "layers": lead(layer, (cfg.num_layers,)) if cfg.scan_layers
           else [lead(layer, ()) for _ in range(cfg.num_layers)]}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, max(cfg.num_codebooks, 1) * cfg.vocab_size)
    return dict(sorted(out.items()))


class Checks:
    """Collects per-kernel results for the final JSON line."""

    def __init__(self, launches):
        self.rows = {}
        self.launches = launches  # ops.launches: the wrappers' counters

    def compare(self, label, got, ref, k):
        """Kernel against plain on the same operands. A bfloat16 output may
        round the two float32 sums to neighbouring values: one bfloat16
        ulp (2^-7 of the largest magnitude) more. bfloat16 operands need
        nothing more: their products are exact in float32."""
        if got.dtype != ref.dtype:
            raise AssertionError(f"{label}: dtype {got.dtype} != plain {ref.dtype}")
        bf16_out = str(got.dtype) == "torch.bfloat16"
        got, ref = got.float(), ref.float()
        err = float((got - ref).abs().max())
        tol = scaled_tol(k, ref) + (BF16_ULP * float(ref.abs().max()) if bf16_out else 0.0)
        ok = err <= tol
        log(f"  {label}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'} "
            f"launches={self.launches}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        return err


def phase_kernels(checks, ops, plain):
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.core.reference import classical_gemm_flops, potrf_flops, trsm_flops
    from repro_torch.core.symmetric import default_block_size
    from repro_torch.kernels.syrk import syrk_splits

    rng = np.random.default_rng(SEED)
    log("phase kernels")

    # gemm_tn: the ata 8192² batched leaf stack, and a ragged batched case
    a = cuda_tensor(rng, (1430, 512, 512))
    b = cuda_tensor(rng, (1430, 512, 512))
    got, ref = ops.gemm_tn(a, b), plain["gemm_tn"](a, b)
    err = checks.compare("gemm_tn (1430,512,512)x(1430,512,512)", got, ref, 512)
    del got, ref
    ms = time_ms(lambda: ops.gemm_tn(a, b))
    plain_ms = time_ms(lambda: plain["gemm_tn"](a, b))
    lib_ms = time_ms(lambda: torch.bmm(a.transpose(1, 2), b))
    device_ms = graph_ms(lambda: ops.gemm_tn(a, b), launches=10)
    lib_device_ms = graph_ms(lambda: torch.bmm(a.transpose(1, 2), b), launches=10)
    bms, by = bound(1430 * classical_gemm_flops(512, 512, 512), 4 * 1430 * 3 * 512 * 512)
    checks.rows["gemm_tn"] = dict(
        shape="(1430,512,512)x(1430,512,512)", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by, device_ms=device_ms,
        library_device_ms=lib_device_ms,
        resources={f"vec16={v}": _build.resources("gemm_tn_info", v) for v in (1, 0)})
    rate = 1430 * classical_gemm_flops(512, 512, 512) / ms / 1e9
    log(f"  gemm_tn ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"bound_ms={bms:.3f} ({by}) rate={rate:.2f} TFLOP/s; device_ms={device_ms:.4f} "
        f"library_device_ms={lib_device_ms:.4f} (CUDA graphs of 10)")
    log("  resources gemm_tn " + json.dumps(checks.rows["gemm_tn"]["resources"]))
    del a, b
    a = cuda_tensor(rng, (7, 1000, 520))
    b = cuda_tensor(rng, (7, 1000, 390))
    got = ops.gemm_tn(a, b)
    checks.compare("gemm_tn ragged (7,1000,520)x(7,1000,390)", got, plain["gemm_tn"](a, b), 1000)
    one = ops.gemm_tn(a[3].contiguous(), b[3].contiguous())
    if not torch.equal(got[3], one):
        raise AssertionError("gemm_tn: batch entry differs from its single launch")
    log("  gemm_tn batched entry == single launch: bitwise")

    # syrk: dense (256,512,512) — the ata 8192² diagonal leaves — lstsq's
    # single (2048,512) leaf, split over a cluster of syrk_splits CTAs a
    # tile, and packed (2048,1000)
    a = cuda_tensor(rng, (256, 512, 512))
    got, ref = ops.syrk(a), plain["syrk"](a)
    err = checks.compare("syrk dense (256,512,512)", got, ref, 512)
    if not torch.equal(got, got.transpose(-1, -2)):
        raise AssertionError("syrk dense output is not bitwise symmetric")
    log("  syrk dense output bitwise symmetric")
    del got, ref
    ms = time_ms(lambda: ops.syrk(a))
    plain_ms = time_ms(lambda: plain["syrk"](a))
    lib_ms = time_ms(lambda: torch.matmul(a.transpose(1, 2), a))
    device_ms = graph_ms(lambda: ops.syrk(a), launches=20)
    lib_device_ms = graph_ms(lambda: torch.matmul(a.transpose(1, 2), a), launches=20)
    bms, by = bound(256 * 512 * 512 * 513, 4 * 256 * 2 * 512 * 512)
    del a
    single = syrk_single_leaf(checks, ops, plain, rng)
    checks.rows["syrk"] = dict(
        shape="(256,512,512) dense", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by, device_ms=device_ms,
        library_device_ms=lib_device_ms, splits=syrk_splits(512, 512),
        single_2048x512=single,
        resources={f"vec16={v},K={k}": _build.resources("syrk_info", v, k)
                   for v in (1, 0) for k in (1, 2, 4, 8)})
    log(f"  syrk ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"bound_ms={bms:.3f} ({by}); device_ms={device_ms:.4f} "
        f"library_device_ms={lib_device_ms:.4f} (CUDA graphs of 20 launches), "
        f"K={syrk_splits(512, 512)}")
    log("  resources syrk (by copy width and cluster size K) "
        + json.dumps(checks.rows["syrk"]["resources"]))
    a = cuda_tensor(rng, (2048, 1000))
    packed = ops.syrk(a, out="packed")
    bn = default_block_size(1000, 256)
    ref = plain["syrk"](a, out="packed", bn=bn)
    checks.compare(f"syrk packed (2048,1000) bn={packed.bn}", packed.blocks, ref, 2048)
    if not torch.equal(packed.to_dense(), ops.syrk(a)):
        raise AssertionError("syrk packed != dense")
    log("  syrk packed.to_dense() == dense: bitwise")
    pms = time_ms(lambda: ops.syrk(a, out="packed"))
    log(f"  syrk packed (2048,1000) ms={pms:.3f}")
    del a, packed, ref

    phase_fused_kernels(checks, ops, plain, rng)
    phase_fused_levels(checks, ops, rng)

    # potrf: the walk's single 128 tile, and stacks of 128 and 104 tiles
    s1 = spd_tiles(rng, 1, 128)[0]
    got, ref = ops.potrf(s1), plain["potrf"](s1)
    err = checks.compare("potrf (128,128)", got, ref, 128)
    if torch.triu(got, 1).any():
        raise AssertionError("potrf: strict upper half not zero")
    for nb_, n_ in ((32, 128), (32, 104), (16, 1), (16, 33), (8, 256)):
        s = spd_tiles(rng, nb_, n_)
        got_s = ops.potrf(s)
        checks.compare(f"potrf ({nb_},{n_},{n_})", got_s, plain["potrf"](s), n_)
        if torch.triu(got_s, 1).any():
            raise AssertionError(f"potrf ({nb_},{n_},{n_}): strict upper half not zero")
    ms = time_ms(lambda: ops.potrf(s1), runs=20)
    plain_ms = time_ms(lambda: plain["potrf"](s1))
    lib_ms = time_ms(lambda: torch.linalg.cholesky(s1), runs=20)
    device_ms = graph_ms(lambda: ops.potrf(s1))
    # cholesky_ex: the library factor without the host sync of its info check,
    # so it can be captured in a CUDA graph
    lib_device_ms = graph_ms(lambda: torch.linalg.cholesky_ex(s1))
    bms, by = bound(potrf_flops(128), 4 * 2 * 128 * 128)
    checks.rows["potrf"] = dict(
        shape="(128,128)", max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bms, bound_by=by, device_ms=device_ms, library_device_ms=lib_device_ms,
        resources={n_: _build.resources("potrf_info", n_) for n_ in (128, 256)})
    log(f"  potrf ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
        f"bound_ms={bms:.6f} ({by}) device_ms={device_ms:.4f} "
        f"library_device_ms={lib_device_ms:.4f} (torch.linalg.cholesky_ex; CUDA graphs of 50 "
        f"launches)")
    log("  resources potrf " + json.dumps(checks.rows["potrf"]["resources"]))

    # trsm: the panel (31 panels against one expanded factor), both
    # transposes, and the substitutions' r = 8 row panel
    l1 = plain["potrf"](spd_tiles(rng, 1, 128)[0])
    lx = l1.expand(31, 128, 128)
    p = cuda_tensor(rng, (31, 128, 128))
    errs = []
    for tr in (True, False):
        errs.append(checks.compare(f"trsm transpose={tr} (31,128,128)",
                                   ops.trsm(lx, p, transpose=tr),
                                   plain["trsm"](lx, p, transpose=tr), 128))
    ls = plain["potrf"](spd_tiles(rng, 31, 128))  # one factor per panel entry
    checks.compare("trsm transpose=True (31,128,128) own factors", ops.trsm(ls, p),
                   plain["trsm"](ls, p), 128)
    r8 = cuda_tensor(rng, (8, 128))
    for tr in (True, False):
        checks.compare(f"trsm transpose={tr} r=8 (8,128)", ops.trsm(l1, r8, transpose=tr),
                       plain["trsm"](l1, r8, transpose=tr), 128)
    ms = time_ms(lambda: ops.trsm(lx, p), runs=20)
    plain_ms = time_ms(lambda: plain["trsm"](lx, p))
    lu = l1.transpose(0, 1)
    lib_ms = time_ms(lambda: torch.linalg.solve_triangular(lu, p, upper=True, left=False),
                     runs=20)
    r8_ms = time_ms(lambda: ops.trsm(l1, r8, transpose=False), runs=20)
    # device times: CUDA graphs of 50 launches, the kernel and the library
    # call on the panel and on the substitutions' r = 8 rows (X·L = R)
    device_ms = graph_ms(lambda: ops.trsm(lx, p))
    lib_device_ms = graph_ms(lambda: torch.linalg.solve_triangular(lu, p, upper=True, left=False))
    r8_device_ms = graph_ms(lambda: ops.trsm(l1, r8, transpose=False))
    r8_lib_device_ms = graph_ms(
        lambda: torch.linalg.solve_triangular(l1, r8, upper=False, left=False))
    bms, by = bound(31 * trsm_flops(128, 128), 4 * (128 * 128 + 2 * 31 * 128 * 128))
    checks.rows["trsm"] = dict(
        shape="(128,128) expanded x (31,128,128), transpose=True", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
        device_ms=device_ms, library_device_ms=lib_device_ms, r8_ms=r8_ms,
        r8_device_ms=r8_device_ms, r8_library_device_ms=r8_lib_device_ms,
        resources={f"n={n_},m={m_}": _build.resources("trsm_info", n_, m_)
                   for n_, m_ in ((128, 128), (128, 8), (256, 300))})
    log(f"  trsm ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
        f"bound_ms={bms:.6f} ({by}); device_ms={device_ms:.4f} "
        f"library_device_ms={lib_device_ms:.4f}; r=8 panel ms={r8_ms:.4f} "
        f"device_ms={r8_device_ms:.4f} library_device_ms={r8_lib_device_ms:.4f} "
        f"(CUDA graphs of 50 launches)")
    log("  resources trsm " + json.dumps(checks.rows["trsm"]["resources"]))


def syrk_single_leaf(checks, ops, plain, rng):
    """syrk on lstsq's gram leaf, one (2048, 512) slab a launch: against its
    plain version, a batch entry bitwise against its single launch at that
    split m, and the device time beside torch.matmul's and the bound."""
    import torch

    from repro_torch.kernels.syrk import syrk_splits

    k = syrk_splits(2048, 512)
    if k < 2:
        raise AssertionError(f"syrk_splits(2048, 512) = {k}: lstsq's leaf is not split")
    a = cuda_tensor(rng, (3, 2048, 512))
    one = ops.syrk(a[1])
    err = checks.compare(f"syrk dense single (2048,512) K={k}", one, plain["syrk"](a[1]), 2048)
    if not torch.equal(ops.syrk(a)[1], one):
        raise AssertionError("syrk: batch entry differs from its single launch at a split m")
    log(f"  syrk batched entry == single launch at m=2048 (K={k}): bitwise")
    x = a[1].contiguous()
    del a
    ms = time_ms(lambda: ops.syrk(x), runs=20)
    device_ms = graph_ms(lambda: ops.syrk(x))
    lib_device_ms = graph_ms(lambda: torch.matmul(x.T, x))
    bms, by = bound(2048 * 512 * 513, 4 * (2048 * 512 + 512 * 512))
    log(f"  syrk single (2048,512) K={k}: ms={ms:.4f} device_ms={device_ms:.4f} "
        f"library_device_ms={lib_device_ms:.4f} (CUDA graphs of 50 launches) "
        f"bound_ms={bms:.4f} ({by})")
    return dict(splits=k, max_abs_err=err, ms=ms, device_ms=device_ms,
                library_device_ms=lib_device_ms, bound_ms=bms, bound_by=by)


def phase_fused_kernels(checks, ops, plain, rng):
    """gemm_tn_fused and syrk_gather at the launches of ata 8192² fused."""
    import numpy as np
    import torch

    from repro_torch.core.ata import _level_tables
    from repro_torch.core.reference import classical_gemm_flops
    from repro_torch.core.strassen import _to_blocks
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm_tn import combine_fused_operands
    from repro_torch.kernels.syrk import syrk_splits

    def live_blocks(rows, cols, sgn):
        return len({(int(r), int(c)) for r, c, g in zip(rows.ravel(), cols.ravel(), sgn.ravel())
                    if g})

    # gemm_tn_fused: ata 8192² level 1 — 686 leaves of 512³, W = 8 slots,
    # read from the root grid (the reference's G=2, T=343 launch)
    a = cuda_tensor(rng, (8192, 8192))
    ab = _to_blocks(a, 4)[None]
    tables = _level_tables(4, 1)
    got = ops.gemm_tn_fused(ab, ab, tables)
    ref = plain["gemm_tn_fused"](ab, ab, tables)
    err = checks.compare("gemm_tn_fused ata 8192² level 1 (686 leaves of 512³, W=8)",
                         got, ref, 512)
    del ref
    torch.cuda.empty_cache()
    xa = combine_fused_operands(ab, *tables[0])
    xb = combine_fused_operands(ab, *tables[1])
    if not torch.equal(got, ops.gemm_tn(xa, xb)):
        raise AssertionError("gemm_tn_fused != gemm_tn on the combined operands")
    log("  gemm_tn_fused == gemm_tn on the materialized combined operands: bitwise")
    del got
    ms = time_ms(lambda: ops.gemm_tn_fused(ab, ab, tables))
    plain_ms = time_ms(lambda: plain["gemm_tn_fused"](ab, ab, tables), runs=3)
    lib_ms = time_ms(lambda: torch.bmm(xa.transpose(1, 2), xb))
    device_ms = graph_ms(lambda: ops.gemm_tn_fused(ab, ab, tables), launches=10)
    lib_device_ms = graph_ms(lambda: torch.bmm(xa.transpose(1, 2), xb), launches=10)
    leaves = tables[0][0].shape[0]
    flops = leaves * classical_gemm_flops(512, 512, 512)
    blk = 4 * 512 * 512
    nbytes = blk * (live_blocks(*tables[0]) + live_blocks(*tables[1]) + leaves)
    bms, by = bound(flops, nbytes)
    checks.rows["gemm_tn_fused"] = dict(
        shape=f"ata 8192² level 1: root grid (16,16,512,512), {leaves} leaves, W=8",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
        device_ms=device_ms, library_device_ms=lib_device_ms,
        resources={w: _build.resources("gemm_tn_fused_info", w) for w in (1, 2, 4, 8, 16, 32)})
    log("  resources gemm_tn_fused (by slot count W) "
        + json.dumps(checks.rows["gemm_tn_fused"]["resources"]))
    log(f"  gemm_tn_fused ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"(torch.bmm on the combined stacks) bound_ms={bms:.3f} ({by}) "
        f"rate={flops / ms / 1e9:.2f} TFLOP/s; device_ms={device_ms:.4f} "
        f"library_device_ms={lib_device_ms:.4f} (CUDA graphs of 10)")
    del xa, xb
    torch.cuda.empty_cache()

    # syrk_gather: the 256 diagonal leaves of ata 8192², (R=16, S=256)
    ab = ab[0]
    s = np.arange(256)
    rows, cols = s % 16, s // 16
    got = ops.syrk_gather(ab, rows, cols)
    err = checks.compare("syrk_gather ata 8192² diagonal (R=16, S=256)",
                         got, plain["syrk_gather"](ab, rows, cols), 512)
    D = ab.transpose(0, 1).reshape(256, *ab.shape[-2:])
    if not torch.equal(got, ops.syrk(D)):
        raise AssertionError("syrk_gather != syrk on the stacked leaves")
    log("  syrk_gather == syrk on the materialized stacked leaves: bitwise")
    del got
    ms = time_ms(lambda: ops.syrk_gather(ab, rows, cols))
    plain_ms = time_ms(lambda: plain["syrk_gather"](ab, rows, cols))
    lib_ms = time_ms(lambda: torch.matmul(D.transpose(1, 2), D))
    device_ms = burst_ms(lambda: ops.syrk_gather(ab, rows, cols))
    lib_device_ms = burst_ms(lambda: torch.matmul(D.transpose(1, 2), D))
    bms, by = bound(256 * 512 * 512 * 513, 4 * 256 * 2 * 512 * 512)
    checks.rows["syrk_gather"] = dict(
        shape="root grid (16,16,512,512), S=256", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by, device_ms=device_ms,
        library_device_ms=lib_device_ms)
    log(f"  syrk_gather ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"(torch.matmul on the stacked leaves) bound_ms={bms:.3f} ({by}); "
        f"device_ms={device_ms:.4f} library_device_ms={lib_device_ms:.4f} "
        f"(20 launches back to back)")
    del D, ab, a
    torch.cuda.empty_cache()

    # lstsq-sized leaves, split over clusters: gathered == syrk on the stack
    a = cuda_tensor(rng, (4096, 1024))
    ab = _to_blocks(a, 1)
    s = np.arange(4)
    got = ops.syrk_gather(ab, s % 2, s // 2)
    checks.compare(f"syrk_gather (2,2,2048,512) K={syrk_splits(2048, 512)}", got,
                   plain["syrk_gather"](ab, s % 2, s // 2), 2048)
    if not torch.equal(got, ops.syrk(ab.transpose(0, 1).reshape(4, 2048, 512))):
        raise AssertionError("syrk_gather != syrk on the stacked leaves at a split m")
    log("  syrk_gather == syrk on the stacked (2048,512) leaves (split m): bitwise")
    del a, ab, got

    # ragged leaves (130 columns) with a batch of 3, against plain and gemm_tn / syrk
    a = cuda_tensor(rng, (3, 1000, 520))
    ab = _to_blocks(a, 2)
    tables = _level_tables(2, 1)
    got = ops.gemm_tn_fused(ab[None], ab[None], tables, alpha=-0.5)
    checks.compare("gemm_tn_fused ragged (3,1000,520) L=2 level 1", got,
                   plain["gemm_tn_fused"](ab[None], ab[None], tables, alpha=-0.5), 250)
    xa, xb = (combine_fused_operands(ab[None], *t) for t in tables)
    want = ops.gemm_tn(xa.reshape(-1, 250, 130), xb.reshape(-1, 250, 130), alpha=-0.5)
    if not torch.equal(got, want.reshape(got.shape)):
        raise AssertionError("gemm_tn_fused ragged != gemm_tn on the combined operands")
    s = np.arange(16)
    got = ops.syrk_gather(ab, s % 4, s // 4)
    checks.compare("syrk_gather ragged (3,1000,520) L=2", got,
                   plain["syrk_gather"](ab, s % 4, s // 4), 250)
    D = ab.transpose(0, 1).reshape(16 * 3, 250, 130)
    if not torch.equal(got.reshape(D.shape[0], 130, 130), ops.syrk(D)):
        raise AssertionError("syrk_gather ragged != syrk on the stacked leaves")
    log("  ragged batched cases == gemm_tn / syrk on materialized operands: bitwise")


def phase_fused_levels(checks, ops, rng):
    """gemm_tn_fused at each of the four levels of ata 8192² (W = 8, 4, 2,
    1), bitwise against gemm_tn on that level's materialized combined
    operands, both timed, with the fused launch's rate."""
    import torch

    from repro_torch.core.ata import _level_tables
    from repro_torch.core.reference import classical_gemm_flops
    from repro_torch.core.strassen import _to_blocks
    from repro_torch.kernels.gemm_tn import combine_fused_operands

    a = cuda_tensor(rng, (8192, 8192))
    ab = _to_blocks(a, 4)[None]
    levels = {}
    for lev in range(1, 5):
        tables = _level_tables(4, lev)
        leaves, w = tables[0][0].shape
        xa = combine_fused_operands(ab, *tables[0])
        xb = combine_fused_operands(ab, *tables[1])
        if not torch.equal(ops.gemm_tn_fused(ab, ab, tables), ops.gemm_tn(xa, xb)):
            raise AssertionError(f"gemm_tn_fused level {lev} != gemm_tn on the combined operands")
        ms = time_ms(lambda: ops.gemm_tn_fused(ab, ab, tables))
        tn_ms = time_ms(lambda: ops.gemm_tn(xa, xb))
        rate = leaves * classical_gemm_flops(512, 512, 512) / ms / 1e9
        levels[lev] = dict(leaves=leaves, W=w, ms=ms, gemm_tn_ms=tn_ms, tflops=rate)
        log(f"  gemm_tn_fused level {lev} ({leaves} leaves, W={w}) == gemm_tn on the combined "
            f"operands: bitwise; ms={ms:.3f} gemm_tn_ms={tn_ms:.3f} "
            f"ratio={ms / tn_ms:.2f} rate={rate:.2f} TFLOP/s")
        del xa, xb
        torch.cuda.empty_cache()
    checks.rows["gemm_tn_fused"]["levels"] = levels


def phase_ata(ops):
    import numpy as np
    import torch

    from repro_torch.core.ata import ata
    from repro_torch.core.reference import ata_flops

    log("phase ata 8192x8192 float32, packed, n_base=512")
    rng = np.random.default_rng(SEED + 1)
    a = cuda_tensor(rng, (8192, 8192))
    results, times, peaks, launch_counts = {}, {}, {}, {}
    # (syrk, gemm_tn, syrk_gather, gemm_tn_fused) launches of one call
    want = {"unrolled": (256, 1430, 0, 0), "batched": (1, 1, 0, 0), "fused": (0, 0, 1, 4)}
    for ld in ("unrolled", "batched", "fused"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launches()
        results[ld] = ata(a, out="packed", leaf_dispatch=ld, n_base=DEFAULT_N_BASE)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        peaks[ld] = peak - base
        launch_counts[ld] = counts
        log(f"  {ld}: launches {counts}")
        log(f"  {ld}: max_memory_allocated {peak} B, {peaks[ld]} B above the "
            f"{base} B held before the call")
        got = tuple(counts[k] for k in ("syrk", "gemm_tn", "syrk_gather", "gemm_tn_fused"))
        if got != want[ld]:
            raise AssertionError(f"ata {ld}: launches {counts}, expected "
                                 f"syrk/gemm_tn/syrk_gather/gemm_tn_fused {want[ld]}")
        times[ld] = time_ms(lambda: ata(a, out="packed", leaf_dispatch=ld,
                                        n_base=DEFAULT_N_BASE), runs=3)
        rate = ata_flops(8192, 8192, 512) / times[ld] / 1e9
        log(f"  {ld}: ms={times[ld]:.2f} rate={rate:.2f} TFLOP/s (ata_flops)")
    # the fused dispatch's launches one by one: one gemm_tn_fused per ATA
    # level (W = 2^(L-ℓ) slots), then syrk_gather
    from repro_torch.core.ata import _level_tables
    from repro_torch.core.strassen import _to_blocks

    ab = _to_blocks(a, 4)
    s = np.arange(256)
    split = {f"gemm_tn_fused_L{lev}_ms": time_ms(
        lambda: ops.gemm_tn_fused(ab[None], ab[None], _level_tables(4, lev)))
        for lev in range(1, 5)}
    split["syrk_gather_ms"] = time_ms(lambda: ops.syrk_gather(ab, s % 16, s // 16))
    log("  fused launches timed alone " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    del ab
    torch.cuda.empty_cache()
    pu, pb, pf = results["unrolled"], results["batched"], results["fused"]
    if not torch.equal(pu.blocks, pb.blocks) or not torch.equal(pu.blocks, pf.blocks):
        raise AssertionError("ata: the unrolled, batched and fused dispatches differ")
    log("  unrolled == batched == fused: bitwise")
    stack = 1430 * 512 * 512 * 4
    if peaks["batched"] - peaks["fused"] < stack:
        raise AssertionError(f"ata fused peak {peaks['fused']} B is not one operand stack "
                             f"({stack} B) below batched {peaks['batched']} B")
    log(f"  fused peak is {peaks['batched'] - peaks['fused']} B below batched "
        f"(one operand stack: {stack} B)")
    del results, pb, pf
    torch.cuda.empty_cache()
    ad = a.double()
    g = torch.tril(ad.T @ ad)
    del ad
    rel = float(torch.linalg.norm(torch.tril(pu.to_dense().double()) - g) / torch.linalg.norm(g))
    log(f"  rel Frobenius error vs float64 (lower triangle): {rel:.3e}")
    if not rel <= 1e-4:
        raise AssertionError(f"ata: relative error {rel} > 1e-4")
    del g, pu
    torch.cuda.empty_cache()
    lib_ms = time_ms(lambda: torch.matmul(a.T, a), runs=3)
    log(f"  library_ms torch.matmul(a.T, a) float32: {lib_ms:.2f}")
    return launch_counts["fused"], dict(
        unrolled_ms=times["unrolled"], batched_ms=times["batched"], fused_ms=times["fused"],
        unrolled_peak_bytes=peaks["unrolled"], batched_peak_bytes=peaks["batched"],
        fused_peak_bytes=peaks["fused"], library_ms=lib_ms, rel_err=rel, fused_split=split)


def phase_strassen(ops):
    import numpy as np
    import torch

    from repro_torch.core import strassen_tn

    log("phase strassen_tn 4096³ float32, n_base=512: fused vs unrolled")
    rng = np.random.default_rng(SEED + 3)
    a = cuda_tensor(rng, (4096, 4096))
    b = cuda_tensor(rng, (4096, 4096))
    out, times = {}, {}
    for ld in ("unrolled", "fused"):
        ops.reset_launches()
        out[ld] = strassen_tn(a, b, leaf_dispatch=ld, n_base=DEFAULT_N_BASE)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        log(f"  {ld}: launches {counts}")
        want = {"unrolled": (343, 0), "fused": (0, 1)}[ld]
        if (counts["gemm_tn"], counts["gemm_tn_fused"]) != want:
            raise AssertionError(f"strassen_tn {ld}: launches {counts}, expected "
                                 f"gemm_tn/gemm_tn_fused {want}")
        times[ld] = time_ms(lambda: strassen_tn(a, b, leaf_dispatch=ld, n_base=DEFAULT_N_BASE),
                            runs=3)
        log(f"  {ld}: ms={times[ld]:.2f}")
    if not torch.equal(out["unrolled"], out["fused"]):
        raise AssertionError("strassen_tn: fused differs from unrolled")
    log("  unrolled == fused: bitwise")
    # the fused dispatch's one launch alone: 343 leaves of 512³, W = 8
    from repro_torch.core.strassen import _slot_tables, _to_blocks

    ab, bb, tables = _to_blocks(a, 3)[None], _to_blocks(b, 3)[None], _slot_tables(3)
    kernel_ms = time_ms(lambda: ops.gemm_tn_fused(ab, bb, tables))
    log(f"  gemm_tn_fused launch alone (343 leaves, W=8): ms={kernel_ms:.3f}")
    return dict(unrolled_ms=times["unrolled"], fused_ms=times["fused"],
                gemm_tn_fused_ms=kernel_ms)


def phase_lstsq(ops):
    import numpy as np
    import torch

    from repro_torch.core.ata import ata
    from repro_torch.core.strassen import _dot_tn
    from repro_torch.solve import cholesky, lstsq, solve_cholesky

    log("phase lstsq a=16384x4096 b=16384x8 float32, ridge=1e-3")
    rng = np.random.default_rng(SEED + 2)
    a = cuda_tensor(rng, (16384, 4096))
    b = cuda_tensor(rng, (16384, 8))
    ridge = 1e-3
    ops.reset_launches()
    x = lstsq(a, b, ridge=ridge, method="factor")
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    log(f"  launches {counts}")
    if min(counts[k] for k in ("syrk", "gemm_tn", "potrf", "trsm")) <= 0:
        raise AssertionError(f"lstsq: a kernel was never launched: {counts}")
    if x.shape != (4096, 8) or not bool(torch.isfinite(x).all()):
        raise AssertionError("lstsq: output not finite or of the wrong shape")
    ad, bd = a.double(), b.double()
    g = ad.T @ ad + ridge * torch.eye(4096, device="cuda", dtype=torch.float64)
    x64 = torch.linalg.solve(g, ad.T @ bd)
    del ad, bd, g
    rel = float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64))
    log(f"  rel error vs float64 solve: {rel:.3e}")
    if not rel <= 1e-3:
        raise AssertionError(f"lstsq: relative error {rel} > 1e-3")
    total_ms = time_ms(lambda: lstsq(a, b, ridge=ridge, method="factor"), runs=3)

    # stage split: each stage timed alone (CUDA-event median) on the
    # previous stage's output
    gram = ata(a, out="packed", n_base=DEFAULT_N_BASE).add_scaled_identity(ridge)
    rhs = _dot_tn(a, b, torch.float32)
    factor = cholesky(gram)
    stages = {
        "gram_ms": time_ms(lambda: ata(a, out="packed", n_base=DEFAULT_N_BASE)
                           .add_scaled_identity(ridge), runs=3),
        "rhs_ms": time_ms(lambda: _dot_tn(a, b, torch.float32), runs=3),
        "cholesky_ms": time_ms(lambda: cholesky(gram), runs=3),
        "substitution_ms": time_ms(lambda: solve_cholesky(factor, rhs), runs=3),
    }
    log(f"  ms={total_ms:.2f} stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    return counts, dict(ms=total_ms, rel_err=rel, **stages)


def phase_dtypes(checks, ops, plain):
    """bfloat16 through each of the six kernels at the main path's shapes,
    stored as float32 and as bfloat16, against the plain versions, with
    device times beside the float32 ones; then ata 4096² in bfloat16 under
    the three dispatches and in float64 on the card."""
    import numpy as np
    import torch

    from repro_torch.core.ata import _level_tables
    from repro_torch.core.strassen import _to_blocks

    log("phase dtypes: bfloat16 operands (float32 accumulation), float32 / bfloat16 stores")
    rng = np.random.default_rng(SEED + 4)
    bf16, f32 = torch.bfloat16, torch.float32

    def both_outs(name, label, k, call, plain_call, timer=None):
        """The kernel on bfloat16 operands into float32 and bfloat16, each
        against its plain version; device time of the float32 store."""
        row = {}
        for out in (f32, bf16):
            got = call(out)
            row[f"max_abs_err_{str(out)[6:]}"] = checks.compare(
                f"{name} bf16->{str(out)[6:]} {label}", got, plain_call(out), k)
            del got
        if timer is not None:
            row["device_ms"] = timer(lambda: call(f32))
            log(f"  {name} bf16 {label}: device_ms={row['device_ms']:.4f} "
                f"(float32: {checks.rows[name].get('device_ms', 'not measured')})")
        checks.rows[name]["bf16"] = row
        torch.cuda.empty_cache()

    a = cuda_tensor(rng, (1430, 512, 512)).to(bf16)
    b = cuda_tensor(rng, (1430, 512, 512)).to(bf16)
    both_outs("gemm_tn", "(1430,512,512)^2", 512, lambda o: ops.gemm_tn(a, b, out_dtype=o),
              lambda o: plain["gemm_tn"](a, b, out_dtype=o),
              lambda f: graph_ms(f, launches=10))
    del a, b
    a = cuda_tensor(rng, (256, 512, 512)).to(bf16)
    both_outs("syrk", "(256,512,512) dense", 512, lambda o: ops.syrk(a, out_dtype=o),
              lambda o: plain["syrk"](a, out_dtype=o), lambda f: graph_ms(f, launches=20))
    x = cuda_tensor(rng, (2048, 512)).to(bf16)
    packed = ops.syrk(x, out="packed")
    err = checks.compare("syrk bf16 single (2048,512) packed", packed.blocks,
                         plain["syrk"](x, out="packed", bn=packed.bn), 2048)
    checks.rows["syrk"]["bf16"]["single_2048x512"] = dict(
        max_abs_err=err, device_ms=graph_ms(lambda: ops.syrk(x)))
    log(f"  syrk bf16 single (2048,512): device_ms="
        f"{checks.rows['syrk']['bf16']['single_2048x512']['device_ms']:.4f}")
    del a, x
    root = cuda_tensor(rng, (8192, 8192)).to(bf16)
    ab = _to_blocks(root, 4)
    tables = _level_tables(4, 1)
    both_outs("gemm_tn_fused", "ata 8192² level 1", 512,
              lambda o: ops.gemm_tn_fused(ab[None], ab[None], tables, out_dtype=o),
              lambda o: plain["gemm_tn_fused"](ab[None], ab[None], tables, out_dtype=o),
              lambda f: graph_ms(f, launches=10))
    s = np.arange(256)
    both_outs("syrk_gather", "R=16 S=256", 512,
              lambda o: ops.syrk_gather(ab, s % 16, s // 16, out_dtype=o),
              lambda o: plain["syrk_gather"](ab, s % 16, s // 16, out_dtype=o), burst_ms)
    del root, ab
    torch.cuda.empty_cache()
    s1 = spd_tiles(rng, 1, 128)[0].to(bf16)
    both_outs("potrf", "(128,128)", 128, lambda o: ops.potrf(s1, out_dtype=o),
              lambda o: plain["potrf"](s1, out_dtype=o), graph_ms)
    for nb_, n_ in ((32, 104), (8, 256)):
        st = spd_tiles(rng, nb_, n_).to(bf16)
        checks.compare(f"potrf bf16 ({nb_},{n_},{n_})", ops.potrf(st), plain["potrf"](st), n_)
    lx = plain["potrf"](spd_tiles(rng, 1, 128)[0]).to(bf16).expand(31, 128, 128)
    p = cuda_tensor(rng, (31, 128, 128)).to(bf16)
    both_outs("trsm", "(128,128) expanded x (31,128,128)", 128,
              lambda o: ops.trsm(lx, p, out_dtype=o),
              lambda o: plain["trsm"](lx, p, out_dtype=o), graph_ms)
    r8 = cuda_tensor(rng, (8, 128)).to(bf16)
    checks.compare("trsm bf16 r=8 (8,128) transpose=False",
                   ops.trsm(lx[0], r8, transpose=False),
                   plain["trsm"](lx[0], r8, transpose=False), 128)
    phase_ata_dtypes(ops)


def phase_ata_dtypes(ops):
    """ata 4096² on the card in bfloat16 (three dispatches) and float64."""
    import numpy as np
    import torch

    from repro_torch.core.ata import ata

    log("  ata 4096x4096, packed: bfloat16 under the three dispatches, float64")
    rng = np.random.default_rng(SEED + 5)
    a = cuda_tensor(rng, (4096, 4096)).bfloat16()
    exact = torch.tril(a.double().T @ a.double())
    results = {}
    for ld in ("unrolled", "batched", "fused"):
        ops.reset_launches()
        results[ld] = ata(a, out="packed", leaf_dispatch=ld, n_base=DEFAULT_N_BASE)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        rel = float(torch.linalg.norm(torch.tril(results[ld].to_dense().double()) - exact)
                    / torch.linalg.norm(exact))
        ms = time_ms(lambda: ata(a, out="packed", leaf_dispatch=ld, n_base=DEFAULT_N_BASE),
                     runs=3)
        log(f"  ata bf16 {ld}: rel Frobenius error vs float64 {rel:.3e} (limit {BF16_RTOL}) "
            f"ms={ms:.2f} launches {counts}")
        if not rel <= BF16_RTOL:
            raise AssertionError(f"ata bf16 {ld}: relative error {rel} > {BF16_RTOL}")
        kernel = "syrk_gather" if ld == "fused" else "syrk"
        if counts[kernel] < 1:
            raise AssertionError(f"ata bf16 {ld}: no {kernel} launch")
    if not torch.equal(results["unrolled"].blocks, results["batched"].blocks):
        raise AssertionError("ata bf16: unrolled != batched")
    log("  ata bf16 unrolled == batched: bitwise (fused combines in float32: no bitwise contract)")
    del results, exact
    torch.cuda.empty_cache()

    a64 = a.double()
    f64 = dict(out="packed", acc_dtype=torch.float64, n_base=DEFAULT_N_BASE)
    ops.reset_launches()
    got = ata(a64, **f64)
    torch.cuda.synchronize()
    if any(ops.launches.values()) or got.blocks.dtype != torch.float64:
        raise AssertionError(f"ata float64: launches {ops.launches}, dtype {got.blocks.dtype}")
    want = ata(a64.cpu(), **f64).blocks
    err = float((got.blocks.cpu() - want).abs().max())
    tol = 8 * math.sqrt(4096) * EPS64 * float(want.abs().max())
    ms = time_ms(lambda: ata(a64, **f64), runs=3)
    log(f"  ata float64 on the card (plain bases, no launch): max_abs_err vs the CPU's "
        f"{err:.3e} tol {tol:.3e} ms={ms:.2f}")
    if not err <= tol:
        raise AssertionError(f"ata float64: card and CPU differ by {err} > {tol}")


def phase_cg(checks, ops, plain):
    """lstsq(method='cg') at 16384×4096×8 on the lstsq phase's data: error
    against the float64 solution, ms, gemm_tn launches per solve, all
    under sync debug mode 'error'; the narrow gemm_tn held against its
    plain version and timed on the device."""
    import numpy as np
    import torch

    from repro_torch.core.reference import cg_iteration_flops
    from repro_torch.solve import lstsq
    from repro_torch.tune import defaults

    log("phase cg: lstsq(method='cg') a=16384x4096 b=16384x8 float32, ridge=1e-3")
    rng = np.random.default_rng(SEED + 2)   # the lstsq phase's data
    a = cuda_tensor(rng, (16384, 4096))
    b = cuda_tensor(rng, (16384, 8))
    ridge = 1e-3
    iters = min(4096, defaults.CG_MAX_ITERS)
    lstsq(a[:256, :64], b[:256], method="cg", iters=2)   # warm: nothing left to build or load
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = lstsq(a, b, ridge=ridge, method="cg")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    log(f"  launches {counts} (under set_sync_debug_mode('error'): no host sync)")
    if counts["gemm_tn"] != iters + 1 or sum(counts.values()) != iters + 1:
        raise AssertionError(f"cg: launches {counts}, expected {iters + 1} gemm_tn only")
    if x.shape != (4096, 8) or not bool(torch.isfinite(x).all()):
        raise AssertionError("cg: output not finite or of the wrong shape")
    ad, bd = a.double(), b.double()
    x64 = torch.linalg.solve(ad.T @ ad + ridge * torch.eye(4096, device="cuda",
                                                          dtype=torch.float64), ad.T @ bd)
    del ad, bd
    rel = float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64))
    log(f"  rel error vs float64 solve: {rel:.3e} (limit 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"cg: relative error {rel} > 1e-3")
    ms = time_ms(lambda: lstsq(a, b, ridge=ridge, method="cg"), runs=3)
    # the narrow gemm_tn of each iteration, alone: Aᵀ(A·p) at (16384, 4096, 8)
    ap = a @ x
    tn_err = checks.compare("gemm_tn narrow (16384,4096,8)", ops.gemm_tn(a, ap),
                            plain["gemm_tn"](a, ap), 16384)
    tn_ms = graph_ms(lambda: ops.gemm_tn(a, ap))
    mm_ms = graph_ms(lambda: torch.matmul(a.T, ap))
    mm_call_ms = time_ms(lambda: torch.matmul(a.T, ap), runs=20)
    bms, by = bound(2 * 16384 * 4096 * 8, 4 * (16384 * 4096 + 16384 * 8 + 4096 * 8))
    rate = iters * cg_iteration_flops(16384, 4096, 8) / ms / 1e9
    log(f"  ms={ms:.2f} ({iters} iterations, {rate:.2f} TFLOP/s by cg_iteration_flops); "
        f"gemm_tn (16384,4096,8) device_ms={tn_ms:.4f} torch.matmul(a.T, ap) "
        f"device_ms={mm_ms:.4f} (one call: ms={mm_call_ms:.4f}) bound_ms={bms:.4f} ({by}) "
        f"(CUDA graphs of 50 launches)")
    return counts, dict(ms=ms, rel_err=rel, iters=iters, gemm_tn_launches=counts["gemm_tn"],
                        narrow_gemm_tn_max_abs_err=tn_err,
                        narrow_gemm_tn_device_ms=tn_ms, narrow_matmul_device_ms=mm_ms,
                        narrow_matmul_ms=mm_call_ms, narrow_bound_ms=bms, narrow_bound_by=by)


def obs_hooks_removed(ops):
    """Context manager: every obs hook of the port's paths (counters,
    gauges, spans, dispatch timing, the wrappers' ``_run``) replaced by
    nothing, so a call's time with the hooks disabled can be held against
    its time with no hooks at all in one process."""
    import contextlib

    from repro_torch import obs

    null = contextlib.nullcontext()

    def run(name, cuda, kernel, plain, *args, **kw):
        out = (kernel if cuda else plain)(*args, **kw)
        if cuda:
            ops.launches[name] += 1
        return out

    stubs = [(obs.metrics, "inc", lambda *a, **k: None),
             (obs.metrics, "set_gauge", lambda *a, **k: None),
             (obs, "span", lambda *a, **k: null),
             (obs, "dispatch_start", lambda *a, **k: None),
             (obs, "dispatch_finish", lambda plan, t0, result: result),
             (ops, "_run", run)]

    @contextlib.contextmanager
    def removed():
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stubs]
        try:
            for mod, name, fn in stubs:
                setattr(mod, name, fn)
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return removed()


def hooks_cost(ops, fn, pairs: int = 10):
    """Median over ``pairs`` interleaved pairs of (hooks disabled − hooks
    removed) for one call of ``fn``: host enqueue ms and CUDA-event ms,
    with each side's median."""
    import time

    import torch

    def one():
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        return host, start.elapsed_time(end)

    fn()
    with obs_hooks_removed(ops):
        fn()
    got = {"disabled": [], "removed": []}
    for i in range(pairs):
        for side in (("disabled", "removed") if i % 2 == 0 else ("removed", "disabled")):
            if side == "removed":
                with obs_hooks_removed(ops):
                    got[side].append(one())
            else:
                got[side].append(one())
    out = {}
    for j, what in enumerate(("enqueue_ms", "ms")):
        d = [x[j] for x in got["disabled"]]
        r = [x[j] for x in got["removed"]]
        out[what] = {"disabled": statistics.median(d), "removed": statistics.median(r),
                     "median_diff": statistics.median(a - b for a, b in zip(d, r)),
                     "pairs_disabled_higher": sum(a > b for a, b in zip(d, r))}
    return out


def phase_obs(ops):
    """Fused ata 8192² with spans off and on: ms of each, span counts,
    outputs bitwise equal; the snapshot after the run validated."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.ata import ata
    from repro_torch.core.strassen import strassen_tn

    log("phase obs: fused ata 8192x8192 with spans off and on")
    rng = np.random.default_rng(SEED + 1)
    a = cuda_tensor(rng, (8192, 8192))
    obs.disable()
    obs.trace.reset()
    obs.metrics.reset()
    fused = dict(out="packed", leaf_dispatch="fused", n_base=DEFAULT_N_BASE)
    off = ata(a, **fused)
    off_ms = time_ms(lambda: ata(a, **fused), runs=3)
    if obs.trace.span_counts():
        raise AssertionError("obs: spans recorded while disabled")
    obs.enable()
    try:
        obs.trace.reset()
        on = ata(a, **fused)
        torch.cuda.synchronize()
        spans = obs.trace.span_counts()
        on_ms = time_ms(lambda: ata(a, **fused), runs=3)
        snap = obs.metrics.validate_snapshot(obs.metrics.snapshot())
    finally:
        obs.disable()
    if not torch.equal(off.blocks, on.blocks):
        raise AssertionError("obs: output differs with spans on")
    want = {"ata": 1, "kernels.gemm_tn_fused": 4, "kernels.syrk_gather": 1}
    if any(spans.get(k) != v for k, v in want.items()):
        raise AssertionError(f"obs: span counts {spans}, expected at least {want}")
    if snap["calibration"]:
        raise AssertionError("obs: a calibration row without a plan")
    log(f"  spans off ms={off_ms:.2f} on ms={on_ms:.2f}; outputs bitwise equal; "
        f"span counts of one call {json.dumps(spans)}")
    log(f"  snapshot valid ({snap['schema']}): meta {json.dumps(snap['meta'])}, "
        f"{len(snap['counters'])} counters, {sum(snap['spans'].values())} spans")
    # what the hooks cost when disabled, on the unrolled dispatch (one
    # wrapper call a leaf): shipped hooks against no hooks, interleaved
    s = a[:4096, :4096].contiguous()
    cost = {"ata_8192_unrolled": hooks_cost(ops, lambda: ata(a, out="packed",
                                                            n_base=DEFAULT_N_BASE)),
            "strassen_tn_4096_unrolled": hooks_cost(ops, lambda: strassen_tn(
                s, s, n_base=DEFAULT_N_BASE))}
    log("  hooks disabled vs removed, 10 interleaved pairs: " + json.dumps(cost))
    return dict(spans_off_ms=off_ms, spans_on_ms=on_ms, spans=spans, disabled_hooks_cost=cost)


def phase_tune(ops):
    """The planner on the card: (a) the analytic plans of the main path's
    shapes; (b) each planned default (an unpinned call) held against the
    pinned call of the earlier phase on the same seeded inputs — within
    ``scaled_tol``, bitwise where both run the same tree — timed beside the
    pinned dispatches and the library call, with its launches and its
    calibration rows, and with the peak device memory of the planned and
    pinned calls beside the model's; (c) a measured plan for ata 8192²
    (``autotune=True``) into a temporary cache file, read back by a fresh
    memo; (d) the obs smoke ``python -m repro_torch.obs`` on the card; (e)
    ata 32768², whose batched and fused trees exceed the card's memory,
    planned and run."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs, tune
    from repro_torch.core import ata, strassen_tn
    from repro_torch.core.strassen import tree_depth
    from repro_torch.tune import cost
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.solve import lstsq

    log("phase tune: the planner (cuda machine) on the main path's shapes")
    shapes = {"ata_8192": ("ata", 8192, 8192, None, "packed"),
              "strassen_tn_4096": ("gemm_tn", 4096, 4096, 4096, "dense"),
              "lstsq_16384x4096x8": ("solve", 16384, 4096, 8, "packed"),
              "cg_product_16384x4096x8": ("gemm_tn", 16384, 4096, 8, "dense")}
    res = {}
    plans = {}
    for name, (op, m, n, k, out) in shapes.items():
        p = tune.plan(op=op, m=m, n=n, k=k, out=out, backend="cuda")
        plans[name] = p
        res[name] = dict(plan={f: getattr(p, f) for f in (
            "algorithm", "n_base", "leaf_dispatch", "method", "predicted_s")})
        log(f"  (a) {name}: analytic plan {json.dumps(res[name]['plan'])}")

    def tree(dims, algorithm, n_base, leaf_dispatch):
        """What a dispatch runs: a dense plan's cutoff covers the operand,
        and a depth-0 tree is one leaf call under every dispatch."""
        if algorithm == "dense":
            n_base = max(dims)
        depth = tree_depth(dims, n_base)
        return (depth, "winograd" if algorithm == "winograd" else "strassen",
                leaf_dispatch) if depth else (0,)

    def hold(name, planned, pinned, k, same_tree):
        tol = scaled_tol(k, pinned)
        err = float((planned.double() - pinned.double()).abs().max())
        if not err <= tol:
            raise AssertionError(f"tune {name}: planned differs from pinned by {err} > {tol}")
        if same_tree and not torch.equal(planned, pinned):
            raise AssertionError(f"tune {name}: planned and pinned run one tree but differ")
        res[name].update(max_abs_err=err, tol=tol, bitwise_checked=same_tree)
        log(f"  (b) {name}: planned vs pinned max_abs_err={err:.3e} tol={tol:.3e}"
            + (" and bitwise equal (same tree)" if same_tree else ""))

    def launched(name, fn):
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        res[name]["launches"] = {k_: v for k_, v in ops.launches.items() if v}
        log(f"  (b) {name}: planned launches {res[name]['launches']}")
        return out

    def calibrated(fn, runs=3):
        """``runs`` planned calls with obs on: one calibration row each."""
        obs.enable()
        try:
            for _ in range(runs):
                fn()
        finally:
            obs.disable()

    def held(name, label, fn, operands, model):
        """Peak device bytes of one call — the most it allocated above what
        was held before, plus its operands, which the model counts too —
        beside the model's ``peak_bytes``."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        measured = (torch.cuda.max_memory_allocated() - base
                    + sum(x.nbytes for x in operands))
        res[name].setdefault("peak_bytes", {})[label] = dict(measured=measured, model=model)
        log(f"  (b) {name} {label}: peak {measured} B, model {model} B "
            f"(measured/model {measured / model:.3f})")
        return out

    obs.calibrate.reset()
    rng = np.random.default_rng(SEED + 1)          # phase ata's data
    a = cuda_tensor(rng, (8192, 8192))
    p = plans["ata_8192"]
    planned = held("ata_8192", "planned",
                   lambda: launched("ata_8192", lambda: ata(a, out="packed")), (a,),
                   cost.peak_bytes("ata", p.algorithm, 8192, 8192, 8192, p.n_base,
                                   p.leaf_dispatch))
    for ld in ("unrolled", "batched", "fused"):
        held("ata_8192", f"pinned_{ld}",
             lambda: ata(a, out="packed", n_base=DEFAULT_N_BASE, leaf_dispatch=ld), (a,),
             cost.peak_bytes("ata", "strassen", 8192, 8192, 8192, DEFAULT_N_BASE, ld))
    pinned = ata(a, out="packed", n_base=DEFAULT_N_BASE)
    # to_dense: packed storage leaves the upper corners of diagonal tiles
    # unspecified, and two trees may fill them differently
    hold("ata_8192", planned.to_dense(), pinned.to_dense(), 8192,
         tree((8192, 8192), p.algorithm, p.n_base, p.leaf_dispatch)
         == tree((8192, 8192), "strassen", DEFAULT_N_BASE, "unrolled"))
    del planned, pinned
    torch.cuda.empty_cache()
    res["ata_8192"].update(
        planned_ms=time_ms(lambda: ata(a, out="packed"), runs=3),
        **{f"pinned_{ld}_ms": time_ms(lambda: ata(a, out="packed", n_base=DEFAULT_N_BASE,
                                                 leaf_dispatch=ld), runs=3)
           for ld in ("unrolled", "batched", "fused")},
        library_ms=time_ms(lambda: torch.matmul(a.T, a), runs=3))
    calibrated(lambda: ata(a, out="packed"))
    del a
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 3)          # phase strassen's data
    a = cuda_tensor(rng, (4096, 4096))
    b = cuda_tensor(rng, (4096, 4096))
    p = plans["strassen_tn_4096"]
    planned = held("strassen_tn_4096", "planned",
                   lambda: launched("strassen_tn_4096", lambda: strassen_tn(a, b)), (a, b),
                   cost.peak_bytes("gemm_tn", p.algorithm, 4096, 4096, 4096, p.n_base,
                                   p.leaf_dispatch))
    for ld in ("unrolled", "batched", "fused"):
        held("strassen_tn_4096", f"pinned_{ld}",
             lambda: strassen_tn(a, b, n_base=DEFAULT_N_BASE, leaf_dispatch=ld), (a, b),
             cost.peak_bytes("gemm_tn", "strassen", 4096, 4096, 4096, DEFAULT_N_BASE, ld))
    pinned = strassen_tn(a, b, n_base=DEFAULT_N_BASE)
    dims = (4096, 4096, 4096)
    hold("strassen_tn_4096", planned, pinned, 4096,
         tree(dims, p.algorithm, p.n_base, p.leaf_dispatch)
         == tree(dims, "strassen", DEFAULT_N_BASE, "unrolled"))
    res["strassen_tn_4096"].update(
        planned_ms=time_ms(lambda: strassen_tn(a, b), runs=3),
        **{f"pinned_{ld}_ms": time_ms(lambda: strassen_tn(a, b, n_base=DEFAULT_N_BASE,
                                                         leaf_dispatch=ld), runs=3)
           for ld in ("unrolled", "fused")},
        library_ms=time_ms(lambda: torch.matmul(a.T, b), runs=3))
    calibrated(lambda: strassen_tn(a, b))
    del a, b, planned, pinned
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 2)          # phase lstsq's data
    a = cuda_tensor(rng, (16384, 4096))
    b = cuda_tensor(rng, (16384, 8))
    p = plans["lstsq_16384x4096x8"]
    planned = launched("lstsq_16384x4096x8", lambda: lstsq(a, b, ridge=1e-3))
    pinned = lstsq(a, b, ridge=1e-3, method="factor")
    hold("lstsq_16384x4096x8", planned, pinned, 16384,
         p.method == "factor" and tree((16384, 4096), p.algorithm, p.n_base, p.leaf_dispatch)
         == tree((16384, 4096), "strassen", DEFAULT_N_BASE, "unrolled"))
    gram_plan = dataclasses.replace(p, op="ata", k=4096, method=None, predicted_s=None)
    res["lstsq_16384x4096x8"].update(
        planned_ms=time_ms(lambda: lstsq(a, b, ridge=1e-3), runs=3),
        planned_gram_ms=time_ms(lambda: ata(a, plan=gram_plan, out="packed"), runs=3),
        pinned_gram_ms=time_ms(lambda: ata(a, out="packed", n_base=DEFAULT_N_BASE), runs=3),
        **{f"pinned_{m_}_ms": time_ms(lambda: lstsq(a, b, ridge=1e-3, method=m_), runs=3)
           for m_ in ("factor", "cg")})
    calibrated(lambda: lstsq(a, b, ridge=1e-3))

    ap = a @ pinned                                 # CG's Aᵀ(A·p) product
    p = plans["cg_product_16384x4096x8"]
    planned = launched("cg_product_16384x4096x8", lambda: strassen_tn(a, ap))
    dims = (16384, 4096, 8)
    hold("cg_product_16384x4096x8", planned, strassen_tn(a, ap, n_base=DEFAULT_N_BASE), 16384,
         tree(dims, p.algorithm, p.n_base, p.leaf_dispatch)
         == tree(dims, "strassen", DEFAULT_N_BASE, "unrolled"))
    res["cg_product_16384x4096x8"].update(
        planned_ms=time_ms(lambda: strassen_tn(a, ap), runs=20),
        pinned_unrolled_ms=time_ms(lambda: strassen_tn(a, ap, n_base=DEFAULT_N_BASE), runs=20),
        library_ms=time_ms(lambda: torch.matmul(a.T, ap), runs=20))
    calibrated(lambda: strassen_tn(a, ap))
    del a, b, ap, planned, pinned
    torch.cuda.empty_cache()
    for name in shapes:
        r = res[name]
        log(f"  (b) {name}: " + json.dumps({k_: round(v, 3) for k_, v in r.items()
                                             if k_.endswith("_ms")}))

    table = obs.calibrate.drift_table()
    res["drift"] = {g["key"]: dict(predicted_s=g["predicted_s"], measured_s=g["measured_s"],
                                   ratio=g["ratio"], n=g["n"]) for g in table}
    log("  (b) calibration of the planned defaults (obs on, 3 calls each):")
    for line in obs.calibrate.report().splitlines():
        log("    " + line)

    # (c) a measured plan for ata 8192², persisted and read back
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        before = obs.metrics.counters("tune.")
        obs.calibrate.reset()
        tuned = tune.plan(op="ata", m=8192, n=8192, out="packed", backend="cuda",
                          autotune=True, cache_file=path)
        after = obs.metrics.counters("tune.")
        counters = {k_: v - before.get(k_, 0) for k_, v in after.items()
                    if v != before.get(k_, 0)}
        if tuned.source != "measured" or not tuned.measured_s or not tuned.baseline_s:
            raise AssertionError(f"tune autotune: not a measured plan: {tuned}")
        log(f"  (c) autotune ata 8192² packed: {tuned.algorithm} n_base={tuned.n_base} "
            f"{tuned.leaf_dispatch} measured_s={tuned.measured_s:.6f} "
            f"baseline_s={tuned.baseline_s:.6f} (speedup {tuned.baseline_s / tuned.measured_s:.2f}) "
            f"predicted_s={tuned.predicted_s} counters {json.dumps(counters)}")
        for line in obs.calibrate.report().splitlines():
            log("    " + line)
        res["autotune_ata_8192"] = dict(
            algorithm=tuned.algorithm, n_base=tuned.n_base, leaf_dispatch=tuned.leaf_dispatch,
            measured_s=tuned.measured_s, baseline_s=tuned.baseline_s,
            predicted_s=tuned.predicted_s, counters=counters,
            trials={g["key"]: dict(predicted_s=g["predicted_s"], measured_s=g["measured_s"],
                                   ratio=g["ratio"]) for g in obs.calibrate.drift_table()})
        tune.cache.clear_memo()
        back = tune.plan(op="ata", m=8192, n=8192, out="packed", backend="cuda",
                         cache_file=path)
        if back.source != "cache" or dataclasses.replace(back, source="measured") != tuned:
            raise AssertionError(f"tune autotune: the file gave back {back}, not {tuned}")
        log("  (c) read back from the cache file in a fresh memo: source=cache, same plan")

        # (d) the obs smoke on the card
        out_path = os.path.join(tmp, "obs.json")
        if obs_main(["--out", out_path]) != 0:
            raise AssertionError("tune: python -m repro_torch.obs failed")
        snap = json.loads(open(out_path).read())
        obs.metrics.validate_snapshot(snap)
        res["obs_smoke"] = dict(calibration=snap["calibration"], device=snap["meta"])

    # (e) ata 32768²: every batched and fused tree's leaf stacks exceed the
    # card's memory, so the budget leaves only the unrolled and dense plans
    rng = np.random.default_rng(SEED + 4)
    a = cuda_tensor(rng, (32768, 32768))
    p = tune.plan(op="ata", m=32768, n=32768, out="packed", backend="cuda")
    name = "ata_32768"
    res[name] = dict(plan={f: getattr(p, f) for f in (
        "algorithm", "n_base", "leaf_dispatch", "predicted_s")})
    log(f"  (e) {name}: analytic plan {json.dumps(res[name]['plan'])}")
    if p.leaf_dispatch in ("batched", "fused") and p.algorithm != "dense":
        raise AssertionError(f"tune {name}: the plan {p} keeps a leaf stack")
    planned = held(name, "planned", lambda: launched(name, lambda: ata(a, out="packed")), (a,),
                   cost.peak_bytes("ata", p.algorithm, 32768, 32768, 32768, p.n_base,
                                   p.leaf_dispatch))
    res[name]["planned_ms"] = time_ms(lambda: ata(a, out="packed"), runs=1)
    res[name]["library_ms"] = time_ms(lambda: torch.matmul(a.T, a), runs=1)
    ad = a.double()
    g = torch.tril(ad.T @ ad)
    del ad
    rel = float(torch.linalg.norm(torch.tril(planned.to_dense().double()) - g)
                / torch.linalg.norm(g))
    res[name]["rel_err"] = rel
    log(f"  (e) {name}: planned ms={res[name]['planned_ms']:.2f} library_ms="
        f"{res[name]['library_ms']:.2f} rel Frobenius error vs float64 (lower triangle) "
        f"{rel:.3e}")
    if not rel <= 1e-4:
        raise AssertionError(f"tune {name}: relative error {rel} > 1e-4")
    del a, g, planned
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase optim: the optimizers on qwen1.5-0.5b's parameter tree
# ---------------------------------------------------------------------------

# Shampoo's settings on the card: 1024-blocks (the reference's default), a
# refresh every 2 steps, 3 steps (one refresh), the gram recursion pinned at
# the static cutoff as in phases 3-8 (1024² grams: one Strassen level, 4 syrk
# + 2 gemm_tn leaves each), packed stats on 128-blocks.
OPTIM_BLOCK = 1024
OPTIM_UPDATE_EVERY = 2
OPTIM_STEPS = 3
OPTIM_GRAM_BLOCK = 128
# The p = 2 refresh's relative ridge. The reference's default, 1e-6, lies
# below float32's rounding of the Cholesky's Schur complement on
# rank-deficient stats (wq/wk/wv's L side: 1024² from 64-column blocks),
# and the walk breaks down there; the phase counts that breakdown and runs
# with 1e-4.
OPTIM_RIDGE = 1e-4
# p = 4 runs at this many of the model's 24 layers (full width)
P4_LAYERS = 24
# p = 4 leaves whose updates must stay finite: the refresh's coupled Newton
# (ridge 1e-6, the reference's) gives NaN on the other 6 of the 12 Shampoo
# leaves, whose stats are rank-deficient (wq/wk/wv and bq L sides, the
# norms' R sides), in the reference as in the port
P4_MIN_FINITE = 6


def phase_optim(checks, ops, plain):
    """Shampoo (p = 2 packed, p = 2 dense, p = 4 packed and dense), PowerSGD
    and AdamW on qwen1.5-0.5b's full parameter tree (``param_shapes``),
    seeded parameters and one seeded gradient tree on the card; see the
    module docstring for what is held and printed."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from repro_torch import tune
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.core import ata_batched, strassen_tn
    from repro_torch.core.reference import classical_gemm_flops, classical_syrk_flops
    from repro_torch.core.strassen import tree_depth
    from repro_torch.core.symmetric import SymmetricMatrix
    from repro_torch.optim import _tree, adamw, constant, powersgd, shampoo
    from repro_torch.optim.shampoo import _plan, _to_blocks, _use_shampoo
    from repro_torch.solve.cholesky import CholeskyFactor, cholesky
    from repro_torch.tune import cost

    import time

    t_phase = time.perf_counter()
    res = {}
    is_shape = lambda x: type(x) is tuple and all(isinstance(i, int) for i in x)  # noqa: E731

    def make_tree(cfg, seed, scale):
        flat, treedef = _tree.tree_flatten_with_path(param_shapes(cfg), is_leaf=is_shape)
        rng = np.random.default_rng(seed)
        return treedef.unflatten(cuda_tensor(rng, s).mul_(scale) for _, s in flat), flat

    log(f"phase optim: {CONFIG.name} parameter tree, float32 ({CONFIG.num_layers} layers, "
        f"d_model {CONFIG.d_model}, {CONFIG.num_heads}x{CONFIG.head_dim} heads, d_ff "
        f"{CONFIG.d_ff}, vocab {CONFIG.vocab_size})")
    params, flat = make_tree(CONFIG, SEED + 4, CONFIG.d_model ** -0.5)
    grads, _ = make_tree(CONFIG, SEED + 5, 1e-3)
    n_params = sum(math.prod(s) for _, s in flat)
    log(f"  {len(flat)} leaves, {n_params} parameters ({4 * n_params} B each of params, "
        f"grads, m, v); one gradient tree for every step")
    res["n_params"] = n_params
    sham = [(p, s) for p, s in flat if _use_shampoo(p, s)]
    log(f"  Shampoo takes {len(sham)} leaves, Adam "
        f"{[p for p, s in flat if not _use_shampoo(p, s)]}")
    if len(sham) != 12:
        raise AssertionError(f"optim: Shampoo takes {len(sham)} leaves, expected 12")

    # (a) the grams: each block shape's analytic plan (cuda machine) and the
    # planned call's peak memory beside the model's; the two largest stacks
    # against torch.einsum, and a sample of blocks against float64
    gram_shapes = {}
    for path, shp in sham:
        pt = _plan(shp, OPTIM_BLOCK)
        nb = pt.n1 * pt.n2
        gram_shapes.setdefault((nb, pt.b2, pt.b1), f"{path} L")
        gram_shapes.setdefault((nb, pt.b1, pt.b2), f"{path} R")
    res["grams"] = {}
    for (nb, m, n), where in gram_shapes.items():
        p = tune.plan(op="ata", m=m, n=n, batch=nb, out="packed", backend="cuda")
        model = cost.peak_bytes("ata", p.algorithm, m, n, n, p.n_base, p.leaf_dispatch,
                                batch=nb)
        a = cuda_tensor(np.random.default_rng(SEED + 6), (nb, m, n))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ata_batched(a, out="packed", packed_block=OPTIM_GRAM_BLOCK)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base + a.nbytes
        row = dict(first=where, plan=f"{p.algorithm}/{p.n_base}/{p.leaf_dispatch}",
                   depth=tree_depth((m, n), p.n_base), predicted_ms=p.predicted_s * 1e3,
                   peak_bytes=measured, model_bytes=model)
        res["grams"][f"{nb}x{m}x{n}"] = row
        log(f"  (a) gram ({nb}, {m}, {n}) [{where}]: plan {row['plan']} depth {row['depth']} "
            f"predicted {row['predicted_ms']:.3f} ms; peak {measured} B, model {model} B "
            f"(measured/model {measured / model:.3f})")
        del a
    for label, (nb, m, n) in (("wq L", (384, 64, 1024)), ("wg", (72, 1024, 1024))):
        a = cuda_tensor(np.random.default_rng(SEED + 7), (nb, m, n))
        gram = lambda: ata_batched(a, out="packed", packed_block=OPTIM_GRAM_BLOCK,  # noqa: E731
                                   n_base=DEFAULT_N_BASE)
        got = gram()
        pick = [0, nb // 2, nb - 1]
        ref = torch.einsum("bmi,bmj->bij", a[pick].double(), a[pick].double())
        dense = got.to_dense()[pick].double()
        err = float((dense - ref).abs().max())
        tol = scaled_tol(m, ref)
        if not err <= tol:
            raise AssertionError(f"optim gram {label}: {err} > {tol} against float64")
        ops.reset_launches()
        gram()
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launches.items() if v}
        planned_ms = time_ms(lambda: ata_batched(a, out="packed", packed_block=OPTIM_GRAM_BLOCK))
        ms = time_ms(gram)
        ein_ms = time_ms(lambda: torch.einsum("bmi,bmj->bij", a, a))
        packed_out = got.nbytes
        bms, by = bound(nb * classical_syrk_flops(m, n), a.nbytes + packed_out)
        res["grams"][label] = dict(shape=[nb, m, n], pinned_ms=ms, planned_ms=planned_ms,
                                   einsum_ms=ein_ms, bound_ms=bms, bound_by=by,
                                   max_abs_err=err, tol=tol, launches=launched)
        log(f"  (a) gram {label} ({nb}, {m}, {n}) packed: pinned n_base={DEFAULT_N_BASE} "
            f"ms={ms:.3f} {launched}, planned ms={planned_ms:.3f}, torch.einsum('bmi,bmj->bij') "
            f"ms={ein_ms:.3f}, bound_ms={bms:.3f} ({by}); blocks {pick} vs float64 "
            f"max_abs_err={err:.3e} tol={tol:.3e}")
        del a, got
    torch.cuda.empty_cache()

    def make_opt(p, packed, **kw):
        return shampoo(constant(1e-2), block=OPTIM_BLOCK, update_every=OPTIM_UPDATE_EVERY,
                       precond_p=p, packed_grams=packed, gram_block=OPTIM_GRAM_BLOCK,
                       precond_ridge=OPTIM_RIDGE, **kw)

    def step_syncs(opt, state, prm, grd):
        """One update with sync debug 'warn': the syncs it makes."""
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = opt.update(grd, state, prm)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, sum("synchroniz" in str(w.message) for w in seen)

    def run(p, packed, prm, grd, probe=None):
        """``OPTIM_STEPS`` Shampoo steps from init, the gram cutoff pinned;
        per step: ms (CUDA events), launches, the update tree. With a
        ``probe`` dict: each refresh step counts its host syncs, the last
        step (no refresh) runs under sync debug 'error', and the state
        after the first refresh is kept."""
        opt = make_opt(p, packed, n_base=DEFAULT_N_BASE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = opt.init(prm)
        out = []
        for i in range(1, OPTIM_STEPS + 1):
            refresh = i % OPTIM_UPDATE_EVERY == 0
            ops.reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if probe is not None and refresh:
                (u, state), probe["refresh_syncs"] = step_syncs(opt, state, prm, grd)
            elif probe is not None and i == OPTIM_STEPS:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    u, state = opt.update(grd, state, prm)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                u, state = opt.update(grd, state, prm)
            end.record()
            torch.cuda.synchronize()
            out.append(dict(ms=start.elapsed_time(end), launches=dict(ops.launches), u=u,
                            refresh=refresh))
            if probe is not None and i == OPTIM_UPDATE_EVERY:
                probe["refreshed"] = state
        return out, state, torch.cuda.max_memory_allocated()

    def slots(state):
        """The Shampoo leaves' state dicts (``l``, ``r``, ``pl``, ``pr``,
        ``mom``) in leaf order."""
        slot = lambda x: isinstance(x, dict) and "pl" in x  # noqa: E731
        return [s for s in _tree.tree_leaves(state["shampoo"], is_leaf=slot) if slot(s)]

    def stack(x):
        return x.blocks if isinstance(x, (SymmetricMatrix, CholeskyFactor)) else x

    def nonfinite(x):
        """The batch entries of a stat or factor stack that hold a value that
        is not finite."""
        b = stack(x)
        return int((~torch.isfinite(b.reshape(b.shape[0], -1))).any(-1).sum())

    def resident(state):
        sizes = dict(stats=0, precond=0)
        for s in slots(state):
            for key, kind in (("l", "stats"), ("r", "stats"), ("pl", "precond"),
                              ("pr", "precond")):
                x = stack(s[key])
                sizes[kind] += x.numel() * x.element_size()
        return sizes

    def report(name, steps, peak, sizes):
        res[name] = dict(step_ms=[s["ms"] for s in steps], peak_bytes=peak,
                         launches=[{k: v for k, v in s["launches"].items() if v} for s in steps],
                         resident=sizes)
        for i, s in enumerate(steps, 1):
            log(f"  {name} step {i}{' (refresh)' if s['refresh'] else ''}: ms={s['ms']:.2f} "
                f"launches {res[name]['launches'][i - 1]}")
        log(f"  {name}: peak device memory {peak} B; resident stats {sizes['stats']} B, "
            f"preconditioners {sizes['precond']} B")

    # (b) p = 2, packed: the paper's path. Step 2 refreshes (syncs counted),
    # step 3 runs under sync debug 'error'; the refreshed factors are held
    # against their stats.
    probe = {}
    p2, p2_state, p2_peak = run(2, True, params, grads, probe)
    report("shampoo_p2_packed", p2, p2_peak, resident(p2_state))
    log(f"  shampoo_p2_packed: step {OPTIM_STEPS} ran under set_sync_debug_mode('error'); "
        f"the refresh step made {probe['refresh_syncs']} host syncs (sync debug 'warn')")
    res["shampoo_p2_packed"]["refresh_syncs"] = probe["refresh_syncs"]
    refresh_launches = p2[1]["launches"]
    for k in ("syrk", "gemm_tn", "potrf", "trsm"):
        if not refresh_launches[k]:
            raise AssertionError(f"optim: the Shampoo refresh step launched no {k}")
    sh2 = probe.pop("refreshed")["shampoo"]
    # the refreshed factors: ‖F·Fᵀ − (stat + ridge·I)‖ / ‖stat‖ on sampled blocks
    worst = 0.0
    for key in ("wq", "wo", "wg", "bq", "norm"):
        for part in ("attn", "mlp"):
            s = sh2["layers"][part].get(key)
            if not isinstance(s, dict):
                continue
            for stat, fac in ((s["l"], s["pl"]), (s["r"], s["pr"])):
                if not isinstance(fac, CholeskyFactor):
                    raise AssertionError("optim: p = 2 packed preconditioner is not a CholeskyFactor")
                pick = sorted({0, stat.blocks.shape[0] - 1})
                d = stat.to_dense()[pick].double()
                tr = torch.diagonal(d, dim1=-2, dim2=-1).sum(-1)
                ridge = OPTIM_RIDGE * (tr / stat.n + 1e-30) + 1e-30
                f = fac.to_dense()[pick].double()
                eye = torch.eye(stat.n, device="cuda", dtype=torch.float64)
                r = float(torch.linalg.norm(f @ f.mT - d - ridge[:, None, None] * eye)
                          / torch.linalg.norm(d))
                if not r <= 1e-4:   # also fails on NaN
                    raise AssertionError(f"optim: factor residual of {part}/{key} is {r} (limit 1e-4)")
                worst = max(worst, r)
    log(f"  shampoo_p2_packed: factor residual ‖F·Fᵀ − (stat + ridge·I)‖/‖stat‖ "
        f"max {worst:.3e} over sampled blocks (limit 1e-4, each block finite)")
    res["shampoo_p2_packed"]["factor_residual"] = worst
    # every factor of the refresh, and at the reference's default ridge on
    # the same refreshed stats (a finding) wq's L factors
    bad_ridge = sum(nonfinite(s[k]) for s in slots({"shampoo": sh2}) for k in ("pl", "pr"))
    n_fac = sum(stack(s[k]).shape[0] for s in slots({"shampoo": sh2}) for k in ("pl", "pr"))
    wq_l = sh2["layers"]["attn"]["wq"]["l"]
    tr = wq_l.trace()
    f6 = cholesky(wq_l.add_scaled_identity((1e-6 * (tr / wq_l.n + 1e-30) + 1e-30)[:, None, None, None]))
    bad = nonfinite(f6)
    log(f"  shampoo_p2_packed: at precond_ridge={OPTIM_RIDGE}, {bad_ridge} of {n_fac} factors "
        f"(all 12 leaves, L and R) are not finite; at the reference's default 1e-6, {bad} of "
        f"{f6.blocks.shape[0]} factors of wq's L stats")
    if bad_ridge:
        raise AssertionError(f"optim: {bad_ridge} p = 2 factors not finite at ridge {OPTIM_RIDGE}")
    res["shampoo_p2_packed"]["nonfinite_factors"] = [bad_ridge, n_fac]
    res["shampoo_p2_packed"]["nonfinite_factors_at_1e-6"] = [bad, f6.blocks.shape[0]]
    del sh2, wq_l, f6
    # one more step, planned (no pinned cutoff) on the same state: a refresh
    opt_planned = make_opt(2, True)
    ops.reset_launches()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    (_, planned_state), planned_syncs = step_syncs(opt_planned, p2_state, params, grads)
    end.record()
    torch.cuda.synchronize()
    res["shampoo_p2_packed"]["planned_refresh_step"] = dict(
        ms=start.elapsed_time(end), syncs=planned_syncs,
        launches={k: v for k, v in ops.launches.items() if v})
    log(f"  shampoo_p2_packed step {OPTIM_STEPS + 1} (refresh), planned grams: "
        f"ms={start.elapsed_time(end):.2f} launches "
        f"{res['shampoo_p2_packed']['planned_refresh_step']['launches']} host syncs "
        f"{planned_syncs} (tables already on the card)")
    del planned_state, p2_state
    p2_updates = [s.pop("u") for s in p2]
    torch.cuda.empty_cache()
    # the grams of one step alone: both sides of all 12 leaves, as the step
    # makes them (pinned cutoff, packed)
    blocks = [_to_blocks(g, _plan(tuple(g.shape), OPTIM_BLOCK))
              for path, g in _tree.tree_flatten_with_path(grads)[0] if _use_shampoo(path, g.shape)]

    def step_grams():
        for gb in blocks:
            for x in (gb.transpose(-1, -2).contiguous(), gb):
                ata_batched(x, out="packed", packed_block=OPTIM_GRAM_BLOCK, n_base=DEFAULT_N_BASE)

    res["shampoo_p2_packed"]["grams_ms"] = time_ms(step_grams, runs=3)
    log(f"  shampoo_p2_packed: the grams of one step alone (24 ata_batched calls, with the "
        f"L sides' transposes) ms={res['shampoo_p2_packed']['grams_ms']:.2f}")
    del blocks

    # (c) p = 2, dense, on the same data: packed within 2e-3 (normwise)
    p2d, p2d_state, p2d_peak = run(2, False, params, grads)
    report("shampoo_p2_dense", p2d, p2d_peak, resident(p2d_state))
    del p2d_state
    worst = 0.0
    for i, (a_, b_) in enumerate(zip(p2_updates, (s.pop("u") for s in p2d)), 1):
        for (path, x), y in zip(_tree.tree_flatten_with_path(a_)[0], _tree.tree_leaves(b_)):
            if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())):
                raise AssertionError(f"optim: p = 2 update {path} at step {i} not finite")
            rel = float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
            if not rel <= 2e-3:   # also fails on NaN
                raise AssertionError(f"optim: p = 2 packed differs from dense by {rel} > 2e-3 "
                                     f"at {path}, step {i}")
            worst = max(worst, rel)
    log(f"  p = 2 packed vs dense: every update finite, within {worst:.3e} (normwise per leaf, "
        f"limit 2e-3)")
    res["p2_packed_vs_dense_rel"] = worst
    del p2_updates
    torch.cuda.empty_cache()

    # (d) p = 4, packed and dense: bitwise equal updates
    cfg4 = dataclasses.replace(CONFIG, num_layers=P4_LAYERS)
    if P4_LAYERS != CONFIG.num_layers:
        log(f"  p = 4 at {P4_LAYERS} of {CONFIG.num_layers} layers (full width): "
            "the Newton refresh's float32 products set the phase's time")
        prm4, _ = make_tree(cfg4, SEED + 4, CONFIG.d_model ** -0.5)
        grd4, _ = make_tree(cfg4, SEED + 5, 1e-3)
    else:
        prm4, grd4 = params, grads
    def same_bits(x, y):
        """Bit patterns equal, so a NaN of the same computation compares equal."""
        return x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32))

    p4p, p4p_state, p4p_peak = run(4, True, prm4, grd4)
    report("shampoo_p4_packed", p4p, p4p_peak, resident(p4p_state))
    # the packed run's stats (packed blocks) and preconditioners wait on the
    # host while the dense run holds the card
    p4p_host = [{k: (s[k].blocks.cpu(), s[k].n, s[k].bn) if k in ("l", "r") else s[k].cpu()
                 for k in ("l", "r", "pl", "pr")} for s in slots(p4p_state)]
    del p4p_state
    p4_updates = [s.pop("u") for s in p4p]
    torch.cuda.empty_cache()
    p4d, p4d_state, p4d_peak = run(4, False, prm4, grd4)
    report("shampoo_p4_dense", p4d, p4d_peak, resident(p4d_state))
    nan_elems = {}
    for i, (a_, b_) in enumerate(zip(p4_updates, (s.pop("u") for s in p4d)), 1):
        flat = _tree.tree_flatten_with_path(a_)[0]
        for (path, x), y in zip(flat, _tree.tree_leaves(b_)):
            if not same_bits(x, y):
                raise AssertionError(f"optim: p = 4 packed and dense updates differ at {path}, "
                                     f"step {i}")
            bad = int((~torch.isfinite(x)).sum())
            if bad:
                nan_elems[path] = max(nan_elems.get(path, 0), bad)
    # the state after the refresh: the stats (packed through to_dense) and
    # the preconditioners bitwise equal; the stats finite on every leaf
    dense_slots = slots(p4d_state)
    if not len(p4p_host) == len(dense_slots) == len(sham):
        raise AssertionError("optim: the p = 4 runs hold different Shampoo leaves")
    for j, (h, s) in enumerate(zip(p4p_host, dense_slots)):
        for k in ("l", "r"):
            blocks, n, bn = h[k]
            x = SymmetricMatrix(blocks.cuda(), n, bn).to_dense()
            if not same_bits(x, s[k]):
                raise AssertionError(f"optim: p = 4 packed and dense {k} stats of Shampoo leaf "
                                     f"{j} differ")
            if nonfinite(s[k]):
                raise AssertionError(f"optim: p = 4 {k} stats of Shampoo leaf {j} not finite")
            del x
        for k in ("pl", "pr"):
            if not same_bits(h[k].cuda(), s[k]):
                raise AssertionError(f"optim: p = 4 packed and dense {k} of Shampoo leaf {j} "
                                     f"differ")
    del p4d_state, p4p_host, dense_slots
    finite_sham = [p for p, _ in sham if p not in nan_elems]
    log(f"  p = 4 packed == dense: every update of {OPTIM_STEPS} steps, and the L/R stats and "
        f"pl/pr after them, bitwise equal (bit patterns); every stat finite; the updates of "
        f"{len(finite_sham)} of {len(sham)} Shampoo leaves finite at every step: {finite_sham}")
    if len(finite_sham) < P4_MIN_FINITE:
        raise AssertionError(f"optim: p = 4 updates finite on {len(finite_sham)} Shampoo leaves, "
                             f"fewer than {P4_MIN_FINITE}")
    log(f"  p = 4 after the refresh, not finite as in the reference (its coupled Newton at "
        f"ridge 1e-6 on rank-deficient stats): {nan_elems or 'none'}")
    res["p4_layers"] = P4_LAYERS
    res["p4_nonfinite_update_elements"] = nan_elems
    del p4_updates, prm4, grd4
    torch.cuda.empty_cache()

    # (e) PowerSGD at rank 4 on wg and wd as _plan reshapes them
    res["powersgd"] = {}
    for key, path in (("wg", ("layers", "mlp", "wg")), ("wd", ("layers", "mlp", "wd"))):
        g = grads[path[0]][path[1]][path[2]]
        pt = _plan(tuple(g.shape), OPTIM_BLOCK)
        g2 = g.reshape(pt.d1, pt.d2)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
        st = powersgd.init_state(gen, g2.shape, 4, device="cuda")
        rounds = []
        for _ in range(2):
            ops.reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            p_, q_, st = powersgd.compress(g2, st)
            end.record()
            torch.cuda.synchronize()
            g_hat = powersgd.decompress(p_, q_)
            ortho = float((p_.T @ p_ - torch.eye(4, device="cuda")).abs().max())
            rel = float(torch.linalg.norm(g2 - g_hat) / torch.linalg.norm(g2))
            if not (torch.isfinite(g_hat).all() and torch.isfinite(st.error).all()):
                raise AssertionError(f"optim: PowerSGD {key} not finite")
            if not ortho <= 1e-3:
                raise AssertionError(f"optim: PowerSGD {key} p not orthonormal ({ortho})")
            rounds.append(dict(ms=start.elapsed_time(end), rel_residual=rel, ortho_err=ortho,
                               launches={k: v for k, v in ops.launches.items() if v}))
        res["powersgd"][key] = dict(shape=list(g2.shape), rounds=rounds)
        if key == "wg":
            narrow = (g2, p_)
        log(f"  (e) PowerSGD rank 4 {key} {tuple(g2.shape)}: "
            + "; ".join(f"round {i}: ms={r['ms']:.3f} ‖G−PQᵀ‖/‖G‖={r['rel_residual']:.4f} "
                        f"‖PᵀP−I‖max={r['ortho_err']:.1e} launches {r['launches']}"
                        for i, r in enumerate(rounds, 1)))
    rng = np.random.default_rng(SEED + 9)
    u_, v_ = cuda_tensor(rng, (24576, 4)), cuda_tensor(rng, (2816, 4))
    g = u_ @ v_.T
    st = powersgd.init_state(torch.Generator(device="cuda").manual_seed(SEED + 10), g.shape, 8,
                             device="cuda")
    p_, q_, st = powersgd.compress(g, st)
    g_hat = powersgd.decompress(p_, q_)
    rec = float(((g_hat - g).abs() - 1e-3 * g.abs()).max())
    err = float(st.error.abs().max())
    log(f"  (e) PowerSGD rank 8 on a rank-4 (24576, 2816) gradient: max(|Ĝ−G| − 1e-3·|G|) "
        f"= {rec:.3e} (limit 1e-3), max|error| = {err:.3e} (limit 1e-3)")
    if not (rec <= 1e-3 and err <= 1e-3):
        raise AssertionError("optim: PowerSGD rank-sufficient reconstruction out of band")
    res["powersgd"]["rank_sufficient"] = dict(excess=rec, max_error=err)
    del g, g_hat, st, p_, q_, u_, v_
    g, p_ = narrow
    tn_err = checks.compare("gemm_tn narrow (24576,2816,4): PowerSGD's GᵀP", ops.gemm_tn(g, p_),
                            plain["gemm_tn"](g, p_), 24576)
    tn_ms = graph_ms(lambda: ops.gemm_tn(g, p_))
    st_ms = time_ms(lambda: strassen_tn(g, p_), runs=10)
    mm_ms = graph_ms(lambda: torch.matmul(g.T, p_))
    mm_call_ms = time_ms(lambda: torch.matmul(g.T, p_), runs=10)
    bms, by = bound(classical_gemm_flops(24576, 2816, 4), 4 * (24576 * 2816 + 24576 * 4 + 2816 * 4))
    res["powersgd"]["narrow_tn"] = dict(shape=[24576, 2816, 4], gemm_tn_device_ms=tn_ms,
                                        strassen_tn_ms=st_ms, matmul_device_ms=mm_ms,
                                        matmul_ms=mm_call_ms, bound_ms=bms, bound_by=by,
                                        max_abs_err=tn_err)
    log(f"  (e) strassen_tn(G, P) (24576, 2816)ᵀ×(24576, 4), planned: ms={st_ms:.4f}; gemm_tn "
        f"device_ms={tn_ms:.4f}; torch.matmul(G.T, P) device_ms={mm_ms:.4f} (one call "
        f"{mm_call_ms:.4f}); bound_ms={bms:.4f} ({by})")
    del g, p_, narrow

    # (f) AdamW, one step over the whole tree
    opt = adamw(constant(1e-2))
    state = opt.init(params)
    ops.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    u, state = opt.update(grads, state, params)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if not all(bool(torch.isfinite(x).all()) for x in _tree.tree_leaves(u)):
        raise AssertionError("optim: AdamW update not finite")
    state_bytes = sum(x.nbytes for x in _tree.tree_leaves({"m": state["m"], "v": state["v"]}))
    bms, by = bound(12 * n_params, 4 * 6 * n_params)
    res["adamw"] = dict(ms=ms, bound_ms=bms, bound_by=by, state_bytes=state_bytes)
    log(f"  (f) AdamW one step over {n_params} parameters: ms={ms:.2f} bound_ms={bms:.3f} ({by}: "
        f"params, grads, m, v read, update, m, v written once); m+v {state_bytes} B; "
        f"launches {sum(ops.launches.values())}")
    del u, state, params, grads
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase optim took {res['phase_s']:.1f} s")
    return refresh_launches, res


# phase distributed: ata 8192² over four ranks, gram_rowshard, colshard, PowerSGD
DIST_RANKS = 4
DIST_N = 8192
DIST_NB = 8                 # the pinned stripe grid: w = 1024, T = 36
DIST_MESHES = (((4,), ("model",)), ((2, 2), ("model", "data")))
DIST_REPS = 3


def _dist_inputs():
    """The phase's seeded operands (numpy, float32)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    f32 = dict(dtype="float32")
    return dict(a=rng.standard_normal((DIST_N, DIST_N), **f32),
                ga=rng.standard_normal((32768, 4096), **f32),
                ca=rng.standard_normal((16384, 4096), **f32),
                cb=rng.standard_normal((16384, 4096), **f32),
                g=rng.standard_normal((24576, 2816), **f32) * np.float32(1e-3),
                q=rng.standard_normal((2816, 4), **f32),
                u=rng.standard_normal((24576, 4), **f32),
                v=rng.standard_normal((2816, 4), **f32),
                q8=rng.standard_normal((2816, 8), **f32))


def _dist_device(rank: int, backend: str):
    """Rank ``rank``'s card: its own under NCCL, card 0 under gloo."""
    import torch

    return torch.device("cuda", rank if backend == "nccl" else 0)


def _dist_rank(rank: int, world: int, backend: str, ref_dir: str) -> dict:
    """One rank of phase distributed: every case on both meshes, each run
    once (checked, its launches, collective bytes and peak memory counted),
    then timed; returns what the parent prints and checks."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core.distributed import (ata_bfs_dfs, ata_tile_parallel,
                                              gemm_tn_colshard, gram_rowshard)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import powersgd
    from repro_torch import tune

    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(ref_dir, "plans.json")
    dev = _dist_device(rank, backend)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    host = _dist_inputs()
    ref = torch.load(os.path.join(ref_dir, "refs.pt"), map_location=dev)
    x = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    del host
    setup_s = time.perf_counter() - t0
    ops.reset_launches()
    path_launches = dict(ops.launches)
    out = dict(rank=rank, device=str(dev), setup_s=setup_s, cases={}, checks={})

    def dense(r):
        return r.to_dense() if hasattr(r, "to_dense") else r

    def measure(label, fn, ref_dense=None, k=None):
        """Run ``fn`` once (checked), then DIST_REPS times (timed), then
        once with tracing on (the collectives' seconds)."""
        dist.barrier()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        l0, b0 = dict(ops.launches), obs.metrics.counters("collective_bytes.")
        result = fn()
        torch.cuda.synchronize(dev)
        launches = {n: ops.launches[n] - l0[n] for n in l0 if ops.launches[n] - l0[n]}
        for n, v in launches.items():
            path_launches[n] += v
        b1 = obs.metrics.counters("collective_bytes.")
        rec = dict(launches=launches,
                   bytes={kk.split(".", 1)[1]: b1[kk] - b0.get(kk, 0) for kk in b1
                          if b1[kk] - b0.get(kk, 0)},
                   peak_bytes=torch.cuda.max_memory_allocated(dev) - base_mem)
        if ref_dense is not None:
            err = float((dense(result) - ref_dense).abs().max())
            tol = scaled_tol(k, ref_dense)
            rec.update(max_abs_err=err, tol=tol)
        times = []
        for _ in range(DIST_REPS):
            dist.barrier()
            torch.cuda.synchronize(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        rec["ms"] = statistics.median(times)
        h0 = obs.metrics.histograms("collective_seconds.")
        dist.barrier()
        obs.enable()
        try:
            fn()
        finally:
            obs.disable()
        h1 = obs.metrics.histograms("collective_seconds.")
        rec["collective_ms"] = {kk.split(".", 1)[1]: 1e3 * (h1[kk]["sum"] - h0.get(kk, {}).get(
            "sum", 0.0)) for kk in h1 if h1[kk]["count"] > h0.get(kk, {}).get("count", 0)}
        out["cases"][label] = rec
        return result

    a = x["a"]
    for shape, axes in DIST_MESHES:
        mesh = make_mesh(shape, axes, backend=backend, device=dev)
        two_d = len(axes) == 2
        row = "data" if two_d else None
        mid = "x".join(map(str, shape))
        kw = dict(task_axis="model", row_axis=row)
        a_loc = mesh.local_block(a, (row, None))
        pin = dict(nb=DIST_NB, n_base=DEFAULT_N_BASE, packed_block=DIST_N // DIST_NB)
        ra = ref["ata"]
        tile_p = measure(f"{mid} tile packed", lambda: ata_tile_parallel(
            a_loc, mesh, **kw, **pin, out="packed"), ra, DIST_N)
        tile_d = measure(f"{mid} tile dense", lambda: ata_tile_parallel(
            a_loc, mesh, **kw, **pin, out="dense"), ra, DIST_N)
        out["checks"][f"{mid} packed to_dense == dense"] = bool(torch.equal(tile_p.to_dense(),
                                                                            tile_d))
        del tile_d
        for il in ("D", "BD", "B"):
            r = measure(f"{mid} bfs_dfs {il} packed", lambda: ata_bfs_dfs(
                a_loc, mesh, **kw, **pin, interleaving=il, out="packed"), ra, DIST_N)
            out["checks"][f"{mid} {il} == tile_parallel"] = bool(torch.equal(r.blocks,
                                                                             tile_p.blocks))
        r = measure(f"{mid} bfs_dfs BD dense", lambda: ata_bfs_dfs(
            a_loc, mesh, **kw, **pin, interleaving="BD", out="dense"), ra, DIST_N)
        out["checks"][f"{mid} BD dense == tile_parallel"] = bool(torch.equal(r,
                                                                             tile_p.to_dense()))
        del r
        r = measure(f"{mid} tile fused packed", lambda: ata_tile_parallel(
            a_loc, mesh, **kw, **pin, leaf_dispatch="fused", out="packed"), ra, DIST_N)
        out["checks"][f"{mid} fused == unrolled"] = bool(torch.equal(r.blocks, tile_p.blocks))
        r = measure(f"{mid} tile alpha=0.5 packed", lambda: ata_tile_parallel(
            a_loc, mesh, **kw, **pin, alpha=0.5, out="packed"))
        out["checks"][f"{mid} alpha=0.5 == scale(0.5)"] = bool(torch.equal(
            r.blocks, tile_p.scale(0.5).blocks))
        del r, tile_p
        pl = tune.plan(op="ata", m=DIST_N, n=DIST_N, devices=mesh.axis_size("model"),
                       row_devices=mesh.axis_size(row) if row else 1, out="packed",
                       backend="cuda")
        out[f"{mid} plan"] = dict(algorithm=pl.algorithm, n_base=pl.n_base,
                                  leaf_dispatch=pl.leaf_dispatch, nb=pl.nb, tile_w=pl.tile_w,
                                  comm_schedule=pl.comm_schedule,
                                  packed_block=pl.packed_block, predicted_s=pl.predicted_s)
        measure(f"{mid} planned packed", lambda: ata_bfs_dfs(a_loc, mesh, **kw, out="packed"),
                ra, DIST_N)
        torch.cuda.empty_cache()
        if two_d:
            continue
        # gram_rowshard: (32768, 4096) rows over the four ranks, fused local ata
        ga = mesh.local_block(x["ga"], ("model", None))
        measure(f"{mid} gram_rowshard packed", lambda: gram_rowshard(
            ga, "model", mesh=mesh, n_base=DEFAULT_N_BASE, leaf_dispatch="fused",
            out="packed"), ref["gram"], 32768)
        del ga
        # colshard: (16384, 4096)ᵀ × (16384, 4096), B's columns over the task axis
        cb = mesh.local_block(x["cb"], (None, "model"))
        measure(f"{mid} gemm_tn_colshard", lambda: gemm_tn_colshard(
            x["ca"], cb, mesh, task_axis="model", n_base=DEFAULT_N_BASE), ref["col"], 16384)
        del cb
        # PowerSGD rank 4 on wg's (24576, 2816) gradient, 4 row shards of 6144
        g = mesh.local_block(x["g"], ("model", None))
        state = powersgd.PowerSGDState(q=x["q"], error=torch.zeros_like(g))
        p_loc, q, st = measure(f"{mid} compress_sharded rank 4", lambda: powersgd.compress_sharded(
            g, state, "model", mesh=mesh, n_base=DEFAULT_N_BASE))
        g_hat = p_loc @ q.T
        rows = slice(mesh.axis_index("model") * g.shape[0], (mesh.axis_index("model") + 1)
                     * g.shape[0])
        want = ref["p"][rows] @ ref["q"].T
        num = torch.stack([torch.linalg.norm(g_hat - want) ** 2, torch.linalg.norm(want) ** 2])
        dist.all_reduce(num, group=mesh.group("model"))
        ortho = torch.stack([p_loc.T @ p_loc])
        dist.all_reduce(ortho, group=mesh.group("model"))
        out["checks"]["compress_sharded ‖Ĝ−Ĝ₁‖/‖Ĝ₁‖ ≤ 1e-3"] = float((num[0] / num[1]).sqrt())
        out["checks"]["compress_sharded ‖Q−Q₁‖/‖Q₁‖ ≤ 1e-3"] = float(
            torch.linalg.norm(q - ref["q"]) / torch.linalg.norm(ref["q"]))
        out["checks"]["compress_sharded ‖PᵀP−I‖max ≤ 1e-3"] = float(
            (ortho[0] - torch.eye(4, device=dev)).abs().max())
        del p_loc, q, st, g_hat, want, state
        # the rank-sufficient case: rank 8 on a rank-4 gradient
        gs = mesh.local_block(x["u"] @ x["v"].T, ("model", None))
        state = powersgd.PowerSGDState(q=x["q8"], error=torch.zeros_like(gs))
        p_loc, q, st = powersgd.compress_sharded(gs, state, "model", mesh=mesh,
                                                 n_base=DEFAULT_N_BASE)
        rec = torch.stack([((p_loc @ q.T - gs).abs() - 1e-3 * gs.abs()).max(),
                           st.error.abs().max()])
        dist.all_reduce(rec, op=dist.ReduceOp.MAX, group=mesh.group("model"))
        out["checks"]["compress_sharded rank-sufficient max(|Ĝ−G|−1e-3|G|) ≤ 1e-3"] = float(rec[0])
        out["checks"]["compress_sharded rank-sufficient max|error| ≤ 1e-3"] = float(rec[1])
        del gs, state, p_loc, q, st
        torch.cuda.empty_cache()
    out["path_launches"] = path_launches
    return out


def phase_distributed(ops):
    """Phase 11: the distributed schedules on four ranks (see the module
    docstring). Returns (launches summed over the ranks' checked runs,
    results)."""
    import tempfile
    import time

    import torch

    from repro_torch.core import ata, strassen_tn
    from repro_torch.launch.mesh import spawn
    from repro_torch.optim import powersgd

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    backend = "nccl" if count >= DIST_RANKS else "gloo"
    where = ("one card per rank" if backend == "nccl" else
             f"{DIST_RANKS} ranks on card 0, time-sliced: times are not per-card times "
             "and show no scaling")
    log(f"phase distributed: backend {backend}, {DIST_RANKS} ranks, {where}")
    res = dict(backend=backend, ranks=DIST_RANKS,
               ranks_per_card=1 if backend == "nccl" else DIST_RANKS)
    host = _dist_inputs()
    dev = _dist_device(0, backend)
    x = {k: torch.as_tensor(host[k], device=dev) for k in ("a", "ga", "ca", "cb", "g", "q")}
    del host
    single = {}
    refs = {}
    refs["ata"] = ata(x["a"], n_base=DEFAULT_N_BASE, leaf_dispatch="batched")
    single["ata 8192² batched ms"] = time_ms(
        lambda: ata(x["a"], n_base=DEFAULT_N_BASE, leaf_dispatch="batched"), runs=3)
    refs["gram"] = ata(x["ga"], n_base=DEFAULT_N_BASE, leaf_dispatch="fused")
    single["gram (32768, 4096) fused ms"] = time_ms(
        lambda: ata(x["ga"], n_base=DEFAULT_N_BASE, leaf_dispatch="fused"), runs=3)
    refs["col"] = strassen_tn(x["ca"], x["cb"], n_base=DEFAULT_N_BASE)
    single["strassen_tn (16384, 4096, 4096) ms"] = time_ms(
        lambda: strassen_tn(x["ca"], x["cb"], n_base=DEFAULT_N_BASE), runs=3)
    st = powersgd.PowerSGDState(q=x["q"], error=torch.zeros_like(x["g"]))
    refs["p"], refs["q"], _ = powersgd.compress(x["g"], st, n_base=DEFAULT_N_BASE)
    single["compress rank 4 (24576, 2816) ms"] = time_ms(
        lambda: powersgd.compress(x["g"], st, n_base=DEFAULT_N_BASE), runs=3)
    log("  single-device calls on card 0 (the references): "
        + json.dumps({k: round(v, 3) for k, v in single.items()}))
    res["single_device_ms"] = single
    del x, st
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        torch.save({k: v.cpu() for k, v in refs.items()}, os.path.join(ref_dir, "refs.pt"))
        del refs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(_dist_rank, DIST_RANKS, backend=backend, timeout_s=600.0,
                      args=(backend, ref_dir))
        res["spawn_s"] = time.perf_counter() - t0
    finally:
        import shutil

        shutil.rmtree(ref_dir, ignore_errors=True)
    log(f"  spawn and run of {DIST_RANKS} ranks: {res['spawn_s']:.1f} s (rank set-up "
        + ", ".join(f"{r['setup_s']:.1f}" for r in ranks) + " s)")
    failed = []
    for label in ranks[0]["cases"]:
        per = [r["cases"][label] for r in ranks]
        line = dict(ms=[round(c["ms"], 3) for c in per],
                    collective_ms=[{k: round(v, 3) for k, v in c["collective_ms"].items()}
                                   for c in per],
                    bytes=per[0]["bytes"], launches=[c["launches"] for c in per],
                    peak_bytes=[c["peak_bytes"] for c in per])
        if "max_abs_err" in per[0]:
            line["max_abs_err"] = max(c["max_abs_err"] for c in per)
            line["tol"] = per[0]["tol"]
            if not all(c["max_abs_err"] <= c["tol"] for c in per):
                failed.append(f"{label}: max_abs_err {line['max_abs_err']} > tol {line['tol']}")
        if any(c["bytes"] != per[0]["bytes"] for c in per):
            line["bytes"] = [c["bytes"] for c in per]
        log(f"  {label}: " + json.dumps(line))
        res[label] = line
    for mid in ("4", "2x2"):
        plan = ranks[0][f"{mid} plan"]
        ms = statistics.median(ranks[r]["cases"][f"{mid} planned packed"]["ms"]
                               for r in range(DIST_RANKS))
        drift = ms / 1e3 / plan["predicted_s"]
        log(f"  {mid} plan: " + json.dumps(plan) + f" measured {ms:.3f} ms, drift {drift:.2f}")
        res[f"{mid} plan"] = dict(plan, measured_ms=ms, drift=drift)
    for name in ranks[0]["checks"]:
        vals = [r["checks"][name] for r in ranks]
        ok = all(vals) if isinstance(vals[0], bool) else max(vals) <= 1e-3
        log(f"  check {name}: {vals if not isinstance(vals[0], bool) else all(vals)} "
            f"{'ok' if ok else 'FAIL'}")
        res[f"check {name}"] = vals
        if not ok:
            failed.append(name)
    launches = {n: sum(r["path_launches"][n] for r in ranks) for n in ranks[0]["path_launches"]}
    log(f"  launches of the checked runs, summed over the ranks: {launches}")
    missing = [n for n, v in launches.items() if not v]
    if missing:
        failed.append(f"kernels never launched on the distributed path: {missing}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase distributed took {res['phase_s']:.1f} s")
    if failed:
        raise AssertionError("distributed: " + "; ".join(failed))
    return launches, res


def main(argv) -> int:
    import torch

    if argv not in ([], ["distributed"]):
        print(f"chip_smoke: unknown arguments {argv}; the only one is 'distributed'",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    # the planned calls read no plan cache outside this checkout: the file
    # named here is never written, so they take the analytic plans
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(ROOT, "build", "tune_plans.json")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gemm_tn import gemm_tn_fused_plain, gemm_tn_plain
    from repro_torch.kernels.potrf import potrf_plain
    from repro_torch.kernels.syrk import syrk_gather_plain, syrk_plain
    from repro_torch.kernels.trsm import trsm_plain

    log("phase build")
    lib, secs, blog = _build.build()
    log(f"  built {os.path.relpath(lib, ROOT)} in {secs:.1f} s")
    for line in blog.splitlines():
        if any(w in line for w in ("registers", "spill", "error", "entry function")):
            log("  " + line.strip())
    _build.load()

    if argv == ["distributed"]:
        _, dist_res = phase_distributed(ops)
        log("end_to_end " + json.dumps({"distributed": dist_res}, default=str))
        return 0
    plain = {"gemm_tn": gemm_tn_plain, "syrk": syrk_plain, "potrf": potrf_plain,
             "trsm": trsm_plain, "gemm_tn_fused": gemm_tn_fused_plain,
             "syrk_gather": syrk_gather_plain}
    checks = Checks(ops.launches)
    phase_kernels(checks, ops, plain)
    torch.cuda.empty_cache()
    phase_dtypes(checks, ops, plain)
    torch.cuda.empty_cache()
    fused_counts, ata_res = phase_ata(ops)
    torch.cuda.empty_cache()
    strassen_res = phase_strassen(ops)
    torch.cuda.empty_cache()
    counts, lstsq_res = phase_lstsq(ops)
    torch.cuda.empty_cache()
    cg_counts, cg_res = phase_cg(checks, ops, plain)
    checks.rows["gemm_tn"]["cg_launches"] = cg_counts["gemm_tn"]
    checks.rows["gemm_tn"]["narrow_16384x4096x8"] = {
        k: cg_res[k] for k in ("narrow_gemm_tn_max_abs_err", "narrow_gemm_tn_device_ms",
                               "narrow_matmul_device_ms", "narrow_matmul_ms", "narrow_bound_ms",
                               "narrow_bound_by")}
    torch.cuda.empty_cache()
    obs_res = phase_obs(ops)
    torch.cuda.empty_cache()
    tune_res = phase_tune(ops)
    torch.cuda.empty_cache()
    optim_counts, optim_res = phase_optim(checks, ops, plain)
    torch.cuda.empty_cache()
    dist_counts, dist_res = phase_distributed(ops)
    log("end_to_end " + json.dumps({"ata_8192": ata_res, "strassen_tn_4096": strassen_res,
                                    "lstsq_16384x4096x8": lstsq_res,
                                    "lstsq_cg_16384x4096x8": cg_res, "obs": obs_res,
                                    "tune": tune_res, "optim": optim_res,
                                    "distributed": dist_res}, default=str))

    # name -> (source, replaced TPU kernel, launches on the path that runs it:
    # lstsq for the first four, ata 8192² fused for the last two); beside
    # them, the launches of phase optim's Shampoo refresh step (p = 2, packed)
    table = {
        "gemm_tn": ("gemm_tn.cu", "src/repro/kernels/gemm_tn.py:78", counts),
        "syrk": ("syrk.cu", "src/repro/kernels/syrk.py:136", counts),
        "potrf": ("potrf.cu", "src/repro/kernels/potrf.py:65", counts),
        "trsm": ("trsm.cu", "src/repro/kernels/trsm.py:80", counts),
        "gemm_tn_fused": ("gemm_tn_fused.cu", "src/repro/kernels/gemm_tn.py:199", fused_counts),
        "syrk_gather": ("syrk.cu", "src/repro/kernels/syrk.py:259", fused_counts),
    }
    kernels = []
    for name, (src, replaces, path_counts) in table.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": replaces, "launches": path_counts[name],
            "optim_refresh_step_launches": optim_counts[name],
            "distributed_launches": dist_counts[name], **checks.rows[name],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
