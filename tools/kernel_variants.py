#!/usr/bin/env python3
"""Time variants of the gemm_tn tile engine, the narrow kernel's crossover,
and ablations of the trsm and syrk kernels.

    PYTHONPATH=src python3 tools/kernel_variants.py [tn] [narrow] [trsm] [syrk] [wgmma]
    PYTHONPATH=src python3 tools/kernel_variants.py narrow_bf16 --earlier=DIR
    PYTHONPATH=src python3 tools/kernel_variants.py syrk_bf16 [--earlier=DIR]

(no argument: the first five parts).

For gemm_tn's narrow-output kernel (``csrc/tn_narrow.cu``) it launches
the tile engine and the narrow kernel of one build (the C entry point's
kernel argument) and holds the two bitwise equal at (m, n) = (16384, 4096)
with k in {4, 8, 16, 32, 64} and at PowerSGD's (24576, 2816, 4) and
(67584, 1024, 4), and prints their device times (CUDA graphs of 20
launches) beside ``torch.matmul(a.T, b)``'s, taken in turns: the evidence
for the threshold ``kNarrowMaxK``. Beside them it
times builds of the narrow kernel with one choice changed
(``NARROW_ABLATIONS``): the ring's streaming alone, the chains alone, 8 or
3 stages, 1 or 4 copying warps, 1 or 2 of A's columns a thread, operands
made in registers instead of loaded, and a build in which consumer thread
0 of CTA 0 counts its cycles (waiting for stages, in the chains, handing
stages back), printed as cycles a row; those in ``NARROW_EXACT`` keep the
product and are held bitwise against the engine too.

The tile engine (``src/repro_torch/csrc/tn_tile.cuh``) fixes its copy ring
at compile time: ``kStages`` stages of ``kSlab`` rows. This script copies
the port's kernel sources into ``build/kernels/variants/<name>/``, rewrites
those two constants, builds each copy into a library of its own (all
``nvcc`` runs started together), checks every ring shape bitwise against
the shipped one on the ata 8192² leaf stack (1430, 512, 512)², and prints
median CUDA-event times taken in turns (every shape, ``torch.bmm``, then
the same in reverse order). Every shape runs the same fmaf chain, so all
must agree bitwise. One ablation of the engine, timed beside them, reads
X's fragment once for two depth steps (a wrong product): how its time
follows the loop's shared-memory reads.

For ``csrc/trsm.cu`` it builds ablations that each leave one part of the
kernel out (everything but the launch, the chain with its trailing update,
the trailing update, or the division, replaced by a multiplication), and a
variant in which every
lane divides every row of its warp instead of one row a lane, and prints
their device times
(CUDA graphs of 50 launches) at the Cholesky panel (31,128,128) against an
expanded factor and at the r = 8 substitution panel. An ablation computes
a wrong answer; only its time is read.

For ``csrc/syrk.cu`` it times the split K ∈ {1, 2, 4, 8} (the evidence for
``syrk_splits``) at lstsq's single (2048, 512) leaf, the ata 8192² diagonal
leaf alone (512, 512) and its batched stack (256, 512, 512), and three
variants beside the shipped kernel: without the diagonal tiles' quadrant
skip (one engine instance for every tile); with the staged epilogue
replaced by the register-direct scalar dual write it replaced (K = 1 only:
that epilogue cannot sum a cluster's partials); and with the multiply
unrolled over a whole stage as gemm_tn's is (the shipped kernel unrolls
one depth-8 slab). These compute the shipped values and are held bitwise
against it. Two more leave out the mirror half of the output stores, or
every global store of the epilogue (a wrong answer; only the time is
read): what the output writes cost. Device times are CUDA graphs of 20
launches, taken in turns.

For gemm_tn's bfloat16 tensor-core kernel (``csrc/gemm_tn.cu``'s
``gemm_tn_wgmma_kernel``) it times the ring shapes (``WGMMA_SHAPES``: rows
a stage × stages, held bitwise against the shipped one) and ablations
(``WGMMA_ABLATIONS``, wrong products: the epilogue's stores left out, the
wgmma left out, both — the TMA loads alone —, and the grid capped at the
resident CTAs so each walks several batch entries, which computes the
shipped product and is held bitwise) on the ata 8192² leaf stack
(1430, 512, 512)² in bfloat16 with a float32 store, beside ``torch.bmm``,
device times in CUDA graphs of 10, in turns.

``narrow_bf16`` times gemm_tn on bfloat16 operands at k ≤ 64 (CG's
(16384, 4096, 8), PowerSGD's (24576, 2816, 4) and (67584, 1024, 4), float32
store) as this tree runs it (the tensor-core kernel) beside a build of an
earlier tree's kernel sources (``--earlier=DIR``: its ``csrc`` directory,
e.g. unpacked by ``git archive``), whose C entry point takes no kernel
argument (there bfloat16 at k ≤ 64 ran the narrow kernel, converting on the
read), and ``torch.matmul``: each within tolerance of the plain version,
device times in CUDA graphs of 20, in turns.

``syrk_bf16`` times syrk's bfloat16 tensor-core kernel (``csrc/syrk.cu``'s
``syrk_wgmma_kernel``) at the ata 8192² diagonal leaves (256, 512, 512)
dense with a float32 and a bfloat16 store, their gather (R = 16, S = 256)
and lstsq's single (2048, 512) leaf (K = 8), beside builds with one choice
changed (``SYRK_BF16``): one CTA an SM (``__launch_bounds__(288, 1)``,
no register cap), the epilogue's loop not unrolled, the ring's shape, a
diagonal tile loading both sides, and ablations that leave out the wgmma, the epilogue,
its mirror stores or every global store (wrong products: only the time is
read), and, with ``--earlier=DIR``, an earlier tree's syrk build (whose
``syrk_f32`` ran bfloat16 operands on the FMA engine), and
``torch.matmul``. It prints each build's registers, stack and spill bytes
(``-Xptxas -v``) and resident CTAs an SM; the exact variants are held
bitwise against the shipped kernel. Device times in CUDA graphs of 20
(the gather: bursts of 20), in turns.

It needs an NVIDIA Hopper card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SLAB, STAGES = "constexpr int kSlab = 32;", "constexpr int kStages = 3;"
# gemm_tn.cu launches tn_narrow.cu's kernel for narrow k: a gemm_tn build holds both
TN_SOURCES = ("gemm_tn.cu", "tn_narrow.cu")
# name -> (rows a stage, stages); the first is the shipped shape
SHAPES = {"32x3": (32, 3), "32x2": (32, 2), "16x4": (16, 4), "16x3": (16, 3), "8x4": (8, 4)}
# name -> textual edit of tn_tile.cuh timed beside the shapes but not held
# bitwise: it reads X's fragment once for two depth steps (a wrong product),
# to see how the loop's time follows its shared-memory reads
ENGINE_ABLATIONS = {
    "half_x_reads": ("const T* xr = xs + kk * kTile",
                     "const T* xr = xs + (kk & ~1) * kTile"),
}
# name -> the kernel gemm_tn_f32 is told to run (kernels.gemm_tn.TN_KERNELS),
# both from one build
NARROW = {"engine": "tile", "narrow": "narrow"}
# name -> textual edits of tn_narrow.cu on the k <= 64 build, timed beside it
# (a wrong product: only the time is read): the ring without the chains,
# the chains on whatever the ring holds, and half as many stages of twice
# the rows
NARROW_CHAIN = """      narrow_chain<W, P>(st.a + i0, st.bt + jp * pl.bp, min(pl.rows, g.m - s * pl.rows), acc);
"""
NARROW_COPIES = """          mbar_arrive_tx(&full[slot], pl.rows * W * static_cast<int>(sizeof(T)));
          tma_load(st.a, &g.ta, c0, l0, bt, &full[slot]);
"""
NARROW_COPY_B = "          copy_pair(st.bt + jp * pl.bp + 2 * r, bb + r * g.ldb + 2 * jp);\n"
NARROW_STAGES = "constexpr int kNarrowStages = 4;"
NARROW_COPIERS = ("pl.copiers = 32 * (kq / 2 < 2 ? 2 : kq / 2 > kNarrowMaxCopyWarps ? "
                  "kNarrowMaxCopyWarps : kq / 2);")
NARROW_LOAD_A = "  for (int u = 0; u < kNarrowGroup; ++u) ld_vec<P>(xa + (r + u) * W, fa[u]);\n"
NARROW_LOAD_B = ("  for (int u = 0; u < kNarrowGroup; u += 2) "
                 "ld_rows2(xb + (r + u) * 2, fb[u], fb[u + 1]);\n")
NARROW_P = "auto cols = [kq](int w) { return w / 2 * kq >= 64 ? 2 : 1; };"
NARROW_ABLATIONS = {
    "stream_only": {"tn_narrow.cu": [(NARROW_CHAIN, "")]},
    # the copies replaced by an arrival: the chains on whatever the ring holds
    "chains_only": {"tn_narrow.cu": [(NARROW_COPIES, "          mbar_arrive(&full[slot]);\n"),
                                     (NARROW_COPY_B, "          (void)jp;\n")]},
    # the same ring in 8 or 3 stages
    "stages8": {"tn_narrow.cu": [(NARROW_STAGES, "constexpr int kNarrowStages = 8;")]},
    "stages3": {"tn_narrow.cu": [(NARROW_STAGES, "constexpr int kNarrowStages = 3;")]},
    # one or four warps copying, whatever k (2 to 4 shipped)
    "copiers1": {"tn_narrow.cu": [(NARROW_COPIERS, "pl.copiers = 32;")]},
    "copiers4": {"tn_narrow.cu": [(NARROW_COPIERS, "pl.copiers = 128;")]},
    # one or two of A's columns a thread, whatever k
    "p1": {"tn_narrow.cu": [(NARROW_P, "auto cols = [](int) { return 1; };")]},
    "p2": {"tn_narrow.cu": [(NARROW_P, "auto cols = [](int) { return 2; };")]},
    # the operands made in registers: the chains and the loop alone
    "registers_only": {"tn_narrow.cu": [
        (NARROW_LOAD_B, "  for (int u = 0; u < kNarrowGroup; ++u) "
                        "fb[u][0] = fb[u][1] = __int_as_float(0x3f800000 + r + u);\n"),
        (NARROW_LOAD_A, "  for (int u = 0; u < kNarrowGroup; ++u) "
                        "fa[u][0] = fa[u][P - 1] = __int_as_float(0x3f7f0000 + r + u);\n")]},
}
# consumer thread 0 of CTA 0 counts its cycles waiting for stages, in the
# chains and handing stages back, and stores them in C[0, 0:3]
NARROW_TIMED_LOOP = """      mbar_wait(&full[slot], (gs / S) & 1);
      const NarrowStage<T, W> st(ring, pl, slot);
""" + NARROW_CHAIN + """      mbar_arrive(&empty[slot]);
"""
NARROW_TIMED = NARROW_TIMED_LOOP.replace(
    "      mbar_wait", "      long long t0 = clock64();\n      mbar_wait").replace(
    "      const NarrowStage", "      long long t1 = clock64();\n      const NarrowStage").replace(
    "      mbar_arrive", "      long long t2 = clock64();\n      mbar_arrive") + (
    "      cyc[0] += t1 - t0, cyc[1] += t2 - t1, cyc[2] += clock64() - t2;\n")
NARROW_TIMED_END = "        store1(cb + (long long)i * g.k + j, g.alpha * v);\n      }\n    }\n"
NARROW_ABLATIONS["timed"] = {"tn_narrow.cu": [
    (NARROW_TIMED_LOOP, NARROW_TIMED),
    ("    float acc[P][2];\n", "    float acc[P][2];\n    long long cyc[3] = {0, 0, 0};\n"),
    (NARROW_TIMED_END, NARROW_TIMED_END + "    if (tid == 0 && blockIdx.x == 0 && bt == 0)\n"
     "      for (int e = 0; e < 3; ++e) store1(static_cast<TO*>(g.c) + e, float(cyc[e]));\n")]}
# ablations that keep the product (held bitwise against the engine)
NARROW_EXACT = ("stages8", "stages3", "copiers1", "copiers4", "p1", "p2")
NARROW_SHAPES = [(16384, 4096, k) for k in (4, 8, 16, 32, 64)] + [(24576, 2816, 4),
                                                                  (67584, 1024, 4)]
# bfloat16 at k <= 64 on the main path's shapes: CG's, PowerSGD's wg and wd
NARROW_BF16_SHAPES = [(16384, 4096, 8), (24576, 2816, 4), (67584, 1024, 4)]
# name -> textual edits of trsm.cu; the first is the shipped kernel
TRSM = {
    "full": [],
    "launch_only": [("for (int bt = blockIdx.y; bt < batch; bt += gridDim.y) {",
                     "for (int bt = blockIdx.y; bt < 0; bt += gridDim.y) {")],
    "no_chain": [("for (int j = 0; j < kPanel; ++j) {\n        float lvn",
                  "for (int j = 0; j < 0; ++j) {\n        float lvn")],
    "no_trailing": [("later[p] = p > P && p < np;", "later[p] = false;")],
    "multiply_for_divide": [(" / d;", " * d;")],
    "divide_every_row": [("if constexpr (R == 1) {", "if constexpr (true) {")],
}
# the register-direct dual write that the staged epilogue of syrk.cu
# replaced: alpha * acc straight from the engine's registers, the transposed
# half one scalar a lane in 32 rows at once
REGISTER_EPILOGUE = """    __syncthreads();  // register-direct epilogue (ablation), K = 1 only
    {
      TO* dst;
      int ld, ilim, i0, j0;
      if (g.packed) {
        dst = static_cast<TO*>(g.c) + ((long long)bt * t_total + tl.t) * g.bn * g.bn;
        ld = ilim = g.bn, i0 = tl.p * kTile, j0 = tl.q * kTile;
      } else {
        dst = static_cast<TO*>(g.c) + (long long)bt * g.n * g.n;
        ld = ilim = g.n, i0 = tl.r0, j0 = tl.c0;
      }
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii) {
        const int i = i0 + map.row(ii);
        if (i >= ilim) continue;
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj) {
          const int j = j0 + map.col(jj);
          if (j >= ilim) continue;
          const float v = __fmul_rn(g.alpha, acc[ii][jj]);
          if (!tl.sym) {
            store1(dst + (long long)i * ld + j, v);
          } else if (!tl.diag || i >= j) {
            store1(dst + (long long)i * ld + j, v);
            store1(dst + (long long)j * ld + i, v);
          }
        }
      }
    }
    __syncthreads();
"""
SYRK_LOOP = """    if (tl.diag)
      tn_tile<float, kVec16, true, true>(x, y, l0, l1, smem, map, acc);
    else
      tn_tile<float, kVec16, false, true>(x, y, l0, l1, smem, map, acc);
"""
SYRK_EPILOGUE = ("    __syncthreads();  // every warp is done with the ring",
                 "      __syncthreads();     // the next entry refills the ring\n")
# name -> textual edits of syrk.cu (None: the shipped library)
SYRK = {
    "shipped": None,
    "no_quadrant_skip": [
        (SYRK_LOOP, "    tn_tile<float, kVec16, false, true>(x, y, l0, l1, smem, map, acc);\n")],
    "full_unroll": [(SYRK_LOOP, SYRK_LOOP.replace(", true>", ">"))],
    "register_epilogue": [SYRK_EPILOGUE],
    "no_mirror": [("      if (tl.sym) {\n", "      if (false) {\n")],
    "no_global_stores": [("  if (i >= t.lim) return;", "  return;")],
}
# ablations that compute a wrong answer: timed, not held bitwise
SYRK_WRONG = ("no_mirror", "no_global_stores")
SYRK_SHAPES = {"single (2048,512)": (2048, 512), "single (512,512)": (512, 512),
               "batched (256,512,512)": (256, 512, 512)}
# gemm_tn's bfloat16 kernel: name -> (rows a stage, stages); the first is shipped
WG_ROWS, WG_STAGES = "constexpr int kWgRows = 64;", "constexpr int kWgStages = 3;"
WGMMA_SHAPES = {"64x3": (64, 3), "32x4": (32, 4), "32x6": (32, 6), "64x4": (64, 4),
                "128x2": (128, 2)}
WG_STORE = ("    wg::store_tile(static_cast<TO*>(g.c) + (long long)bt * g.n * g.k, acc, r0 + 64 * wgi, c0,\n"
            "                   g.n, g.k, g.alpha);\n")
WG_KEEP = "    if (acc[0] == 123.0f) store1(static_cast<TO*>(g.c), acc[1]);  // keeps acc live\n"
WG_MMA = "      wg::mma_stage(acc, xs, xs + kWgSide, kWgRows, wgi, n16);\n"
WG_GRID = ("  const dim3 grid((k + wg::kTileN - 1) / wg::kTileN, (n + wg::kTileM - 1) / wg::kTileM,\n"
           "                  batch < 65535 ? batch : 65535);\n")
WG_RESIDENT = ("  int sms = 0;\n  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
               "  const int tk = (k + 127) / 128, tn = (n + 127) / 128;\n"
               "  const int fit = 2 * sms / (tk * tn) < 1 ? 1 : 2 * sms / (tk * tn);\n"
               "  const dim3 grid(tk, tn, batch < fit ? batch : fit);\n")
WGMMA_ABLATIONS = {"no_stores": [(WG_STORE, WG_KEEP)], "no_wgmma": [(WG_MMA, "")],
                   "loads_only": [(WG_STORE, WG_KEEP), (WG_MMA, "")],
                   "resident_grid": [(WG_GRID, WG_RESIDENT)]}
# ablations that keep the shipped product: held bitwise
WGMMA_EXACT = ("resident_grid",)


# syrk's bfloat16 kernel: name -> textual edits of syrk.cu (None: the
# shipped library); those in SYRK_BF16_EXACT keep the product
SW_BOUNDS = "__global__ void __launch_bounds__(kSwThreads, 2)\n    syrk_wgmma_kernel"
SW_ROWS, SW_STAGES = "constexpr int kSwRows = 64;", "constexpr int kSwStages = 3;"
SW_MMA = "      wg::mma_stage(acc, xs, tl.diag ? xs : xs + kSwSide, kSwRows, wgi, n16);\n"
SW_EPILOGUE = ("    write_tile<TO, kSplits>(g, s_tile, partial, bt, "
               "(long long)gridDim.x / kSplits, who / 32,\n                            who % 32);\n")
SW_DIAG = [("tl.diag ? kSwSide : kSwStageBytes", "kSwStageBytes"),
           ("            if (!tl.diag) {\n              wg::tma_load5(ys",
            "            if (true) {\n              wg::tma_load5(ys"),
           ("          if (!tl.diag)\n            wg::fill_side",
            "          if (true)\n            wg::fill_side"),
           ("tl.diag ? xs : xs + kSwSide", "xs + kSwSide")]
SYRK_BF16 = {
    "shipped": None,
    "one_cta_bound": [(SW_BOUNDS, SW_BOUNDS.replace("(kSwThreads, 2)", "(kSwThreads, 1)"))],
    "epi_unroll1": [("#pragma unroll\n  for (int u = 0;", "#pragma unroll 1\n  for (int u = 0;")],
    "rows32x6": [(SW_ROWS, "constexpr int kSwRows = 32;"),
                 (SW_STAGES, "constexpr int kSwStages = 6;")],
    "rows32x4": [(SW_ROWS, "constexpr int kSwRows = 32;"),
                 (SW_STAGES, "constexpr int kSwStages = 4;")],
    "diag_both_sides": SW_DIAG,
    "no_wgmma": [(SW_MMA, "")],
    "no_epilogue": [(SW_EPILOGUE, "")],
    "loads_only": [(SW_MMA, ""), (SW_EPILOGUE, "")],
    "no_mirror": [("      if (tl.sym) {\n", "      if (false) {\n")],
    "no_global_stores": [("  if (i >= t.lim) return;", "  return;")],
}
SYRK_BF16_EXACT = ("one_cta_bound", "epi_unroll1", "rows32x6", "rows32x4", "diag_both_sides")


def sources(name, edits):
    from repro_torch.kernels import _build

    out = os.path.join(ROOT, "build", "kernels", "variants", name)
    os.makedirs(out, exist_ok=True)
    for f in ("dtype.cuh", "tn_tile.cuh", "tn_narrow.cuh", "tn_wgmma.cuh", "gemm_tn.cu",
              "tn_narrow.cu", "trsm.cu", "syrk.cu"):
        text = (_build.CSRC / f).read_text()
        for old, new in edits.get(f, ()):
            if f == "syrk.cu" and (old, new) == SYRK_EPILOGUE:  # splice between two anchors
                start, end = text.find(old), text.find(new)
                if start < 0 or end < 0:
                    raise RuntimeError(f"{f} lost an epilogue anchor: update this script")
                text = text[:start] + REGISTER_EPILOGUE + text[end + len(new):]
                continue
            if old not in text:
                raise RuntimeError(f"{f} no longer contains {old!r}: update this script")
            text = text.replace(old, new)
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
    return out


def time_tn(libs, cs, rng):
    """The engine's ring shapes and its ablation on the ata 8192² leaf stack."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm_tn import TN_KERNELS

    a = cs.cuda_tensor(rng, (1430, 512, 512))
    b = cs.cuda_tensor(rng, (1430, 512, 512))
    c = torch.empty_like(a)
    runs, want = {}, None
    for name in (*SHAPES, *ENGINE_ABLATIONS):
        fn = libs[("tn", name)].gemm_tn_f32
        fn.argtypes = list(_build.SIGNATURES["gemm_tn_f32"])

        def run(fn=fn):
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1430, 512, 512, 512, 512 * 512, 512,
                     512 * 512, 512, 1.0, 3, 0, TN_KERNELS.index("tile"),
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, "gemm_tn variant")
        run()
        torch.cuda.synchronize()
        want = c.clone() if want is None else want
        if name in SHAPES and not torch.equal(c, want):
            raise AssertionError(f"ring shape {name} differs from {next(iter(SHAPES))}")
        runs[name] = run
    print("every ring shape bitwise equal to the shipped one", flush=True)
    del want
    runs["torch.bmm"] = lambda: torch.bmm(a.transpose(1, 2), b)
    times = {}
    for name in list(runs) + list(runs)[::-1]:
        times.setdefault(name, []).append(cs.time_ms(runs[name]))
    print("gemm_tn (1430,512,512)² ms, in turns: " + json.dumps(times), flush=True)


def time_wgmma(libs, cs, rng):
    """gemm_tn's bfloat16 kernel: ring shapes and ablations on the ata 8192²
    leaf stack, bfloat16 operands, float32 store."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm_tn import TN_KERNELS

    a = cs.cuda_tensor(rng, (1430, 512, 512)).bfloat16()
    b = cs.cuda_tensor(rng, (1430, 512, 512)).bfloat16()
    c = torch.empty(1430, 512, 512, device="cuda")
    runs, want = {}, None
    for name in (*WGMMA_SHAPES, *WGMMA_ABLATIONS):
        fn = libs[("wgmma", name)].gemm_tn_f32
        fn.argtypes = list(_build.SIGNATURES["gemm_tn_f32"])

        def run(fn=fn):
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1430, 512, 512, 512, 512 * 512, 512,
                     512 * 512, 512, 1.0, 3, 1, TN_KERNELS.index("wgmma"),
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, "gemm_tn wgmma variant")
        run()
        torch.cuda.synchronize()
        want = c.clone() if want is None else want
        if (name in WGMMA_SHAPES or name in WGMMA_EXACT) and not torch.equal(c, want):
            raise AssertionError(f"wgmma variant {name} differs from {next(iter(WGMMA_SHAPES))}")
        runs[name] = run
    print("every wgmma ring shape and the resident grid bitwise equal to the shipped one",
          flush=True)
    del want
    runs["torch.bmm"] = lambda: torch.bmm(a.transpose(1, 2), b)
    times = {}
    for name in list(runs) + list(runs)[::-1]:
        times.setdefault(name, []).append(cs.graph_ms(runs[name], launches=10))
    print("gemm_tn bf16 (1430,512,512)² device ms, float32 store, in turns: "
          + json.dumps(times), flush=True)


def time_narrow(libs, cs, rng):
    """gemm_tn on the tile engine alone against the narrow kernel up to
    k = 64, bitwise and in device time, beside torch.matmul."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm_tn import TN_KERNELS

    for m, n, k in NARROW_SHAPES:
        a = cs.cuda_tensor(rng, (m, n))
        b = cs.cuda_tensor(rng, (m, k))
        outs, runs = {}, {}
        for name in (*NARROW, *NARROW_ABLATIONS):
            fn = libs[("narrow", "narrow" if name in NARROW else name)].gemm_tn_f32
            fn.argtypes = list(_build.SIGNATURES["gemm_tn_f32"])
            c = torch.empty((n, k), device="cuda")
            kernel = TN_KERNELS.index(NARROW.get(name, "narrow"))

            def run(fn=fn, c=c, kernel=kernel):
                err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1, m, n, k, 0, n, 0, k, 1.0, 3,
                         0, kernel, torch.cuda.current_stream().cuda_stream)
                _build.check(err, "gemm_tn crossover build")
            run()
            torch.cuda.synchronize()
            outs[name], runs[name] = c, run
        for name in ("narrow", *NARROW_EXACT):
            if not torch.equal(outs["engine"].view(torch.int32), outs[name].view(torch.int32)):
                raise AssertionError(f"narrow kernel {name} differs from the engine at {(m, n, k)}")
        runs["torch.matmul"] = lambda: torch.matmul(a.T, b)
        times = {}
        for name in list(runs) + list(runs)[::-1]:
            times.setdefault(name, []).append(round(cs.graph_ms(runs[name], 20), 5))
        cyc = [round(float(x)) for x in outs["timed"].flatten()[:3]]
        print(f"gemm_tn {(m, n, k)} timed: consumer 0 of CTA 0, cycles waiting for stages "
              f"{cyc[0]}, in the chains {cyc[1]} ({cyc[1] / m:.2f} a row), handing stages "
              f"back {cyc[2]}", flush=True)
        bms, by = cs.bound(2 * m * n * k, 4 * (m * n + m * k + n * k))
        print(f"gemm_tn {(m, n, k)} bitwise engine == narrow; device ms, in turns: "
              + json.dumps(times) + f"; bound_ms {bms:.4f} ({by})", flush=True)
        del a, b, outs, runs
        torch.cuda.empty_cache()


def time_narrow_bf16(libs, cs, rng):
    """gemm_tn on bfloat16 operands at k ≤ 64: this tree's kernel (through
    ``ops.gemm_tn``) against the earlier build's, both into float32, each
    within tolerance of the plain version, beside torch.matmul."""
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gemm_tn import gemm_tn_plain, vec16

    fn = libs[("narrow_bf16", "earlier")].gemm_tn_f32
    argtypes = list(_build.SIGNATURES["gemm_tn_f32"])
    del argtypes[-2]   # the earlier entry point takes no kernel argument
    fn.argtypes = argtypes
    for m, n, k in NARROW_BF16_SHAPES:
        a = cs.cuda_tensor(rng, (m, n)).bfloat16()
        b = cs.cuda_tensor(rng, (m, k)).bfloat16()
        c = torch.empty((n, k), device="cuda")
        v16 = int(vec16(a, n) and vec16(b, k))

        def earlier_run():
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1, m, n, k, 0, n, 0, k, 1.0, v16,
                     1, torch.cuda.current_stream().cuda_stream)
            _build.check(err, "earlier gemm_tn build")
        earlier_run()
        ops.reset_launches()
        now = ops.gemm_tn(a, b)
        torch.cuda.synchronize()
        if ops.wgmma_launches["gemm_tn_wgmma"] != 1:
            raise AssertionError(f"gemm_tn bf16 {(m, n, k)} did not launch the wgmma kernel")
        ref = gemm_tn_plain(a, b)
        checks = cs.Checks({})
        errs = {"this tree": checks.compare(f"gemm_tn bf16 {(m, n, k)} this tree", now, ref, m),
                "earlier": checks.compare(f"gemm_tn bf16 {(m, n, k)} earlier", c, ref, m)}
        runs = {"this tree": lambda: ops.gemm_tn(a, b), "earlier": earlier_run,
                "torch.matmul": lambda: torch.matmul(a.T, b)}
        times = {}
        for name in list(runs) + list(runs)[::-1]:
            times.setdefault(name, []).append(round(cs.graph_ms(runs[name], 20), 5))
        bms, by = cs.bound_bf16(2 * m * n * k, 2 * (m * n + m * k) + 4 * n * k)
        print(f"gemm_tn bf16 {(m, n, k)} float32 store: max_abs_err {json.dumps(errs)}; "
              f"device ms, in turns: {json.dumps(times)}; bound_ms {bms:.4f} ({by})",
              flush=True)
        del a, b, c, now, ref
        torch.cuda.empty_cache()


def time_trsm(libs, cs, rng):
    """The trsm ablations at the Cholesky panel and the r = 8 row panel."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.potrf import potrf_plain

    l1 = potrf_plain(cs.spd_tiles(rng, 1, 128)[0])
    lx = l1.expand(31, 128, 128)
    p = cs.cuda_tensor(rng, (31, 128, 128))
    r8 = cs.cuda_tensor(rng, (8, 128))
    xp, x8 = torch.empty_like(p), torch.empty_like(r8)
    cases = {}
    for name in TRSM:
        fn = libs[("trsm", name)].trsm_f32
        fn.argtypes = list(_build.SIGNATURES["trsm_f32"])
        cases[name] = (
            lambda fn=fn: fn(lx.data_ptr(), p.data_ptr(), xp.data_ptr(), 31, 128, 128, 0, 1, 0,
                             torch.cuda.current_stream().cuda_stream),
            lambda fn=fn: fn(l1.data_ptr(), r8.data_ptr(), x8.data_ptr(), 1, 8, 128, 0, 0, 0,
                             torch.cuda.current_stream().cuda_stream))
    ttimes = {}
    for name in list(cases) + list(cases)[::-1]:
        panel, rows8 = cases[name]
        ttimes.setdefault(name, []).append([cs.graph_ms(panel), cs.graph_ms(rows8)])
    print("trsm device ms [panel (31,128,128), r = 8], in turns: " + json.dumps(ttimes),
          flush=True)


def time_syrk(libs, cs, rng):
    """syrk's split K and its ablations at lstsq's and ata's leaf shapes."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.syrk import syrk_plain, syrk_splits

    for label, shape in SYRK_SHAPES.items():
        a = cs.cuda_tensor(rng, shape)
        m, n = shape[-2:]
        batch = shape[0] if len(shape) == 3 else 1
        c = torch.empty((*shape[:-2], n, n), device="cuda")
        ref = syrk_plain(a)
        runs, shipped = {}, {}
        for name in SYRK:  # "shipped" first: the others are held against it
            lib = _build.load() if SYRK[name] is None else libs[("syrk", name)]
            fn = lib.syrk_f32
            fn.argtypes = list(_build.SIGNATURES["syrk_f32"])
            for k in ((1,) if name == "register_epilogue" else (1, 2, 4, 8)):
                def run(fn=fn, k=k):
                    err = fn(a.data_ptr(), c.data_ptr(), batch, m, n, m * n, n, 1.0, 0, 0, k, 1, 0,
                             torch.cuda.current_stream().cuda_stream)
                    _build.check(err, "syrk variant")
                run()
                torch.cuda.synchronize()
                if name == "shipped":
                    cs.Checks({}).compare(f"syrk {label} K={k}", c, ref, m)
                    shipped[k] = c.clone()
                elif name not in SYRK_WRONG and not torch.equal(c, shipped[k]):
                    raise AssertionError(f"syrk {name} K={k} differs from the shipped kernel")
                if name == "shipped" or k in (1, syrk_splits(m, n)):
                    runs[f"{name} K={k}"] = run
        runs["torch.matmul"] = lambda: torch.matmul(a.transpose(-1, -2), a)
        times = {}
        for name in list(runs) + list(runs)[::-1]:
            times.setdefault(name, []).append(round(cs.graph_ms(runs[name], 20), 5))
        print(f"syrk {label} device ms (syrk_splits = {syrk_splits(m, n)}), in turns: "
              + json.dumps(times), flush=True)
        del a, c, ref, shipped
        torch.cuda.empty_cache()


def _wgmma_ptxas(log):
    """(registers, stack frame, spill store bytes) of each syrk_wgmma_kernel
    instance in an nvcc -Xptxas -v log, by its mangled name's tail."""
    out, name, frame = {}, None, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("for")[-1].strip()
        elif name and "bytes stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "syrk_wgmma_kernel" in name:
            out[name[-24:]] = (line.split("Used")[-1].split(",")[0].strip(), frame)
            name = None
    return out


def time_syrk_bf16(libs, cs, rng):
    """syrk's bfloat16 kernel: variants and ablations at the ata 8192² diagonal
    leaves (dense and gathered) and lstsq's (2048, 512) leaf, beside the
    earlier build (``--earlier``) and torch.matmul."""
    import numpy as np
    import torch

    from repro_torch.core.strassen import _to_blocks
    from repro_torch.kernels import _build
    from repro_torch.kernels.syrk import gather_coords, syrk_plain, syrk_splits

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bf16 = torch.bfloat16
    built = [name for name in SYRK_BF16 if SYRK_BF16[name] is None or ("syrk_bf16", name) in libs]
    for name in built:
        lib = _build.load() if SYRK_BF16[name] is None else libs[("syrk_bf16", name)]
        fn = lib.syrk_wgmma_info
        fn.argtypes = list(_build.SIGNATURES["syrk_wgmma_info"])
        for k in (1, 8):
            out = (ctypes.c_int * 10)()
            _build.check(fn(k, out), f"syrk_wgmma_info {name}")
            print(f"syrk_bf16 {name} K={k}: " + json.dumps(
                dict(zip(_build.RESOURCE_FIELDS["syrk_wgmma_info"], out))), flush=True)
    root = cs.cuda_tensor(rng, (8192, 8192)).to(bf16)
    ab = _to_blocks(root, 4)
    s = np.arange(256)
    offs = torch.as_tensor(s % 16 * ab.stride(0) + s // 16 * ab.stride(1), device="cuda")
    coords = torch.as_tensor(gather_coords(s % 16, s // 16), device="cuda")
    cases = {"dense (256,512,512)": (ab.transpose(0, 1).reshape(256, 512, 512).contiguous(), 0),
             "dense (256,512,512) bf16 store": (None, 2),
             "gather R=16 S=256": (None, 0),
             "single (2048,512)": (cs.cuda_tensor(rng, (2048, 512)).to(bf16), 0)}
    cases["dense (256,512,512) bf16 store"] = (cases["dense (256,512,512)"][0], 2)
    for label, (a, store) in cases.items():
        gather = a is None
        x = cases["dense (256,512,512)"][0] if gather else a
        m, n = x.shape[-2:]
        batch = x.shape[0] if x.ndim == 3 else 1
        k = syrk_splits(m, n)
        c = torch.empty((batch, n, n), device="cuda", dtype=bf16 if store else torch.float32)
        ref = syrk_plain(x, out_dtype=c.dtype)
        runs, shipped = {}, None
        names = built + (["earlier"] if ("syrk_bf16", "earlier") in libs else [])
        for name in names:
            lib = _build.load() if SYRK_BF16.get(name, 0) is None else libs[("syrk_bf16", name)]
            if name == "earlier":
                fn = lib.syrk_gather_f32 if gather else lib.syrk_f32
                fn.argtypes = list(_build.SIGNATURES["syrk_gather_f32" if gather else "syrk_f32"])
                if gather:
                    def run(fn=fn):
                        _build.check(fn(ab.data_ptr(), offs.data_ptr(), c.data_ptr(), 256, 1, m,
                                        n, 0, 8192, 1.0, k, 1, 1 | store, stream()), name)
                else:
                    def run(fn=fn):
                        _build.check(fn(x.data_ptr(), c.data_ptr(), batch, m, n, m * n, n, 1.0,
                                        0, 0, k, 1, 1 | store, stream()), name)
            elif gather:
                fn = lib.syrk_gather_wgmma
                fn.argtypes = list(_build.SIGNATURES["syrk_gather_wgmma"])

                def run(fn=fn):
                    used = ctypes.c_int(0)
                    _build.check(fn(ab.data_ptr(), offs.data_ptr(), coords.data_ptr(),
                                    c.data_ptr(), 256, 1, m, n, 0, 8192, 16, 16, ab.stride(0),
                                    ab.stride(1), 1.0, k, 1, 1 | store, ctypes.byref(used),
                                    stream()), name)
                    if not used.value:
                        raise AssertionError(f"syrk_gather {name}: the tensor map was refused")
            else:
                fn = lib.syrk_wgmma
                fn.argtypes = list(_build.SIGNATURES["syrk_wgmma"])

                def run(fn=fn):
                    used = ctypes.c_int(0)
                    _build.check(fn(x.data_ptr(), c.data_ptr(), batch, m, n, m * n, n, 1.0, 0,
                                    0, k, 1, 1 | store, ctypes.byref(used), stream()), name)
                    if not used.value:
                        raise AssertionError(f"syrk {name}: the tensor map was refused")
            run()
            torch.cuda.synchronize()
            if name == "shipped":
                cs.Checks({}).compare(f"syrk bf16 {label} K={k}", c.reshape(ref.shape), ref, m)
                shipped = c.clone()
            elif name in SYRK_BF16_EXACT and not torch.equal(c, shipped):
                raise AssertionError(f"syrk bf16 {name} {label} differs from the shipped kernel")
            elif name == "earlier":
                cs.Checks({}).compare(f"syrk bf16 {label} earlier", c.reshape(ref.shape), ref, m)
            runs[name] = run
        runs["torch.matmul"] = lambda: torch.matmul(x.transpose(-1, -2), x)
        timer = cs.burst_ms if gather else (lambda f: cs.graph_ms(f, 20))
        times = {}
        for name in list(runs) + list(runs)[::-1]:
            times.setdefault(name, []).append(round(timer(runs[name]), 5))
        print(f"syrk bf16 {label} (K = {k}) device ms, in turns: " + json.dumps(times),
              flush=True)
        del c, ref, shipped
        torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    earlier = next((os.path.abspath(x.split("=", 1)[1]) for x in sys.argv[1:]
                    if x.startswith("--earlier=")), None)
    parts = {x for x in sys.argv[1:] if not x.startswith("--earlier=")} or {
        "tn", "narrow", "trsm", "syrk", "wgmma"}
    if not parts <= {"tn", "narrow", "trsm", "syrk", "wgmma", "narrow_bf16", "syrk_bf16"}:
        print(f"kernel_variants: unknown parts {sorted(parts)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    jobs = {}
    if "tn" in parts:
        for name, (slab, stages) in SHAPES.items():
            d = sources("tn_" + name, {"tn_tile.cuh": [
                (SLAB, f"constexpr int kSlab = {slab};"),
                (STAGES, f"constexpr int kStages = {stages};")]})
            jobs[("tn", name)] = (d, TN_SOURCES)
        for name, edit in ENGINE_ABLATIONS.items():
            jobs[("tn", name)] = (sources("tn_" + name, {"tn_tile.cuh": [edit]}), TN_SOURCES)
    if "narrow" in parts:
        jobs[("narrow", "narrow")] = (sources("narrow_narrow", {}), TN_SOURCES)
        for name, edits in NARROW_ABLATIONS.items():
            jobs[("narrow", name)] = (sources("narrow_" + name, edits), TN_SOURCES)
    if "narrow_bf16" in parts:
        if earlier is None:
            print("kernel_variants: narrow_bf16 needs --earlier=DIR (an earlier csrc)",
                  file=sys.stderr)
            return 2
        jobs[("narrow_bf16", "earlier")] = (earlier, TN_SOURCES)
    if "wgmma" in parts:
        for name, (rows, stages) in WGMMA_SHAPES.items():
            d = sources("wgmma_" + name, {"gemm_tn.cu": [
                (WG_ROWS, f"constexpr int kWgRows = {rows};"),
                (WG_STAGES, f"constexpr int kWgStages = {stages};")]})
            jobs[("wgmma", name)] = (d, TN_SOURCES)
        for name, edits in WGMMA_ABLATIONS.items():
            jobs[("wgmma", name)] = (sources("wgmma_" + name, {"gemm_tn.cu": edits}), TN_SOURCES)
    if "trsm" in parts:
        for name, edits in TRSM.items():
            jobs[("trsm", name)] = (sources("trsm_" + name, {"trsm.cu": edits}), ("trsm.cu",))
    if "syrk" in parts:
        _build.load()
        for name, edits in SYRK.items():
            if edits is not None:
                jobs[("syrk", name)] = (sources("syrk_" + name, {"syrk.cu": edits}), ("syrk.cu",))
    if "syrk_bf16" in parts:
        _build.load()
        for name, edits in SYRK_BF16.items():
            if edits is not None:
                jobs[("syrk_bf16", name)] = (sources("syrk_bf16_" + name, {"syrk.cu": edits}),
                                             ("syrk.cu",))
        if earlier is not None:
            jobs[("syrk_bf16", "earlier")] = (earlier, ("syrk.cu",))
    procs = {key: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", d,
         *(os.path.join(d, src) for src in srcs), "-o", os.path.join(d, "lib.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (d, srcs) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode and key[0] == "syrk_bf16" and key[1] != "earlier":
            print(f"{key[0]} {key[1]}: nvcc failed, left out:\n{log[-2000:]}", flush=True)
            continue
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed on {key}")
        if key[0] == "syrk_bf16":
            print(f"{key[0]} {key[1]}: {json.dumps(_wgmma_ptxas(log))}", flush=True)
        else:
            regs = [ln.split(":")[-1].strip() for ln in log.splitlines() if "Used" in ln]
            print(f"{key[0]} {key[1]}: {regs}", flush=True)
        libs[key] = ctypes.CDLL(os.path.join(jobs[key][0], "lib.so"))

    rng = np.random.default_rng(0)
    if "tn" in parts:
        time_tn(libs, cs, rng)
        torch.cuda.empty_cache()
    if "narrow" in parts:
        time_narrow(libs, cs, rng)
    if "wgmma" in parts:
        time_wgmma(libs, cs, rng)
        torch.cuda.empty_cache()
    if "narrow_bf16" in parts:
        time_narrow_bf16(libs, cs, rng)
        torch.cuda.empty_cache()
    if "trsm" in parts:
        time_trsm(libs, cs, rng)
    if "syrk" in parts:
        time_syrk(libs, cs, rng)
    if "syrk_bf16" in parts:
        print("syrk_bf16 shipped: " + json.dumps(_wgmma_ptxas(_build.build()[2])), flush=True)
        time_syrk_bf16(libs, cs, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
