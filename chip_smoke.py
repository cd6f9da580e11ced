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
3. ata     — ``ata(a, out="packed")`` at ``a: 8192×8192`` float32 under the
             unrolled and the batched leaf dispatch: bitwise equal to each
             other, and within 1e-4 (relative Frobenius, lower triangle) of
             the float64 product;
4. lstsq   — ``lstsq(a, b, ridge=1e-3)`` at ``a: 16384×4096``,
             ``b: 16384×8``, within 1e-3 of the float64 solution of the
             ridge normal equations, with every kernel launched (> 0).

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
SEED = 0


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


class Checks:
    """Collects per-kernel results for the final JSON line."""

    def __init__(self, launches):
        self.rows = {}
        self.launches = launches  # ops.launches: the wrappers' counters

    def compare(self, label, got, ref, k):
        err = float((got - ref).abs().max())
        tol = scaled_tol(k, ref)
        ok = err <= tol
        log(f"  {label}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'} "
            f"launches={self.launches}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        return err


def phase_kernels(checks, ops, plain):
    import numpy as np
    import torch

    from repro_torch.core.reference import classical_gemm_flops, potrf_flops, trsm_flops
    from repro_torch.core.symmetric import default_block_size

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
    bms, by = bound(1430 * classical_gemm_flops(512, 512, 512), 4 * 1430 * 3 * 512 * 512)
    checks.rows["gemm_tn"] = dict(
        shape="(1430,512,512)x(1430,512,512)", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by)
    log(f"  gemm_tn ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"bound_ms={bms:.3f} ({by}) rate={1430 * classical_gemm_flops(512, 512, 512) / ms / 1e9:.2f} TFLOP/s")
    del a, b
    a = cuda_tensor(rng, (7, 1000, 520))
    b = cuda_tensor(rng, (7, 1000, 390))
    got = ops.gemm_tn(a, b)
    checks.compare("gemm_tn ragged (7,1000,520)x(7,1000,390)", got, plain["gemm_tn"](a, b), 1000)
    one = ops.gemm_tn(a[3].contiguous(), b[3].contiguous())
    if not torch.equal(got[3], one):
        raise AssertionError("gemm_tn: batch entry differs from its single launch")
    log("  gemm_tn batched entry == single launch: bitwise")

    # syrk: dense (256,512,512) — the ata 8192² diagonal leaves — and packed (2048,1000)
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
    bms, by = bound(256 * 512 * 512 * 513, 4 * 256 * 2 * 512 * 512)
    checks.rows["syrk"] = dict(
        shape="(256,512,512) dense", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by)
    log(f"  syrk ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        f"bound_ms={bms:.3f} ({by})")
    del a
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

    # potrf: the walk's single 128 tile, and stacks of 128 and 104 tiles
    s1 = spd_tiles(rng, 1, 128)[0]
    got, ref = ops.potrf(s1), plain["potrf"](s1)
    err = checks.compare("potrf (128,128)", got, ref, 128)
    if torch.triu(got, 1).any():
        raise AssertionError("potrf: strict upper half not zero")
    for nb_, n_ in ((32, 128), (32, 104)):
        s = spd_tiles(rng, nb_, n_)
        checks.compare(f"potrf ({nb_},{n_},{n_})", ops.potrf(s), plain["potrf"](s), n_)
    ms = time_ms(lambda: ops.potrf(s1), runs=20)
    plain_ms = time_ms(lambda: plain["potrf"](s1))
    lib_ms = time_ms(lambda: torch.linalg.cholesky(s1), runs=20)
    bms, by = bound(potrf_flops(128), 4 * 2 * 128 * 128)
    checks.rows["potrf"] = dict(
        shape="(128,128)", max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bms, bound_by=by)
    log(f"  potrf ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
        f"bound_ms={bms:.6f} ({by})")

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
    bms, by = bound(31 * trsm_flops(128, 128), 4 * (128 * 128 + 2 * 31 * 128 * 128))
    checks.rows["trsm"] = dict(
        shape="(128,128) expanded x (31,128,128), transpose=True", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
        r8_ms=r8_ms)
    log(f"  trsm ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
        f"bound_ms={bms:.6f} ({by}); r=8 panel ms={r8_ms:.4f}")


def phase_ata(ops):
    import numpy as np
    import torch

    from repro_torch.core.ata import ata
    from repro_torch.core.reference import ata_flops

    log("phase ata 8192x8192 float32, packed, n_base=512")
    rng = np.random.default_rng(SEED + 1)
    a = cuda_tensor(rng, (8192, 8192))
    results, times = {}, {}
    for ld in ("unrolled", "batched"):
        ops.reset_launches()
        results[ld] = ata(a, out="packed", leaf_dispatch=ld)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        log(f"  {ld}: launches {counts}")
        want = {"unrolled": (256, 1430), "batched": (1, 1)}[ld]
        if (counts["syrk"], counts["gemm_tn"]) != want:
            raise AssertionError(f"ata {ld}: launches {counts}, expected syrk/gemm_tn {want}")
        times[ld] = time_ms(lambda: ata(a, out="packed", leaf_dispatch=ld), runs=3)
        rate = ata_flops(8192, 8192, 512) / times[ld] / 1e9
        log(f"  {ld}: ms={times[ld]:.2f} rate={rate:.2f} TFLOP/s (ata_flops)")
        torch.cuda.empty_cache()
    pu, pb = results["unrolled"], results["batched"]
    if not torch.equal(pu.blocks, pb.blocks):
        raise AssertionError("ata: unrolled and batched dispatches differ")
    log("  unrolled == batched: bitwise")
    del results, pb
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
    return dict(unrolled_ms=times["unrolled"], batched_ms=times["batched"],
                library_ms=lib_ms, rel_err=rel)


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
    x = lstsq(a, b, ridge=ridge)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    log(f"  launches {counts}")
    if min(counts.values()) <= 0:
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
    total_ms = time_ms(lambda: lstsq(a, b, ridge=ridge), runs=3)

    # stage split: each stage timed alone (CUDA-event median) on the
    # previous stage's output
    gram = ata(a, out="packed").add_scaled_identity(ridge)
    rhs = _dot_tn(a, b, torch.float32)
    factor = cholesky(gram)
    stages = {
        "gram_ms": time_ms(lambda: ata(a, out="packed").add_scaled_identity(ridge), runs=3),
        "rhs_ms": time_ms(lambda: _dot_tn(a, b, torch.float32), runs=3),
        "cholesky_ms": time_ms(lambda: cholesky(gram), runs=3),
        "substitution_ms": time_ms(lambda: solve_cholesky(factor, rhs), runs=3),
    }
    log(f"  ms={total_ms:.2f} stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    return counts, dict(ms=total_ms, rel_err=rel, **stages)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gemm_tn import gemm_tn_plain
    from repro_torch.kernels.potrf import potrf_plain
    from repro_torch.kernels.syrk import syrk_plain
    from repro_torch.kernels.trsm import trsm_plain

    log("phase build")
    lib, secs, blog = _build.build()
    log(f"  built {os.path.relpath(lib, ROOT)} in {secs:.1f} s")
    for line in blog.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())
    _build.load()

    plain = {"gemm_tn": gemm_tn_plain, "syrk": syrk_plain, "potrf": potrf_plain,
             "trsm": trsm_plain}
    checks = Checks(ops.launches)
    phase_kernels(checks, ops, plain)
    torch.cuda.empty_cache()
    ata_res = phase_ata(ops)
    torch.cuda.empty_cache()
    counts, lstsq_res = phase_lstsq(ops)
    log("end_to_end " + json.dumps({"ata_8192": ata_res, "lstsq_16384x4096x8": lstsq_res}))

    replaces = {
        "gemm_tn": "src/repro/kernels/gemm_tn.py:78",
        "syrk": "src/repro/kernels/syrk.py:136",
        "potrf": "src/repro/kernels/potrf.py:65",
        "trsm": "src/repro/kernels/trsm.py:80",
    }
    kernels = []
    for name in ("gemm_tn", "syrk", "potrf", "trsm"):
        row = checks.rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": counts[name], **row,
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
