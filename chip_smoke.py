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
             bfloat16 ulp for a bfloat16 store), with device times beside
             the bfloat16 bound (989 TFLOP/s) and the library's bfloat16
             call ("none" where torch has none on CUDA); gemm_tn,
             gemm_tn_fused, syrk and syrk_gather counted on their
             tensor-core (wgmma) kernels, fused bitwise equal to gemm_tn
             on the bfloat16 combined operands, syrk_gather to syrk on
             the stacked leaves, syrk's bfloat16 store and lstsq's single
             leaf beside their bounds, the wgmma instances' resources (no
             spills); ata 4096² and
             strassen_tn 2048³ and 4096³ in bfloat16 under the three
             dispatches (the bfloat16 main path, its wgmma launches
             counted, every syrk / syrk_gather launch of ata on the
             tensor cores) bitwise equal,
             ata and strassen_tn 2048³ within 2e-2 (the reference's
             bfloat16 rtol, normwise) of the float64 product and
             strassen_tn 4096³ within ``PLAIN_RTOL`` (normwise) of the same
             recursion on plain bases (three levels of bfloat16 operand
             sums put both at the band's edge: their errors against
             float64 are recorded); ata 8192² in bfloat16,
             fused, batched and ``torch.matmul(a.mT, a)``: wall and
             device-busy ms (``tools/profile_ata.py``); ata 4096² in
             float64 on the card (plain bases, no launch) within
             ``8·√k·eps64`` of the same call on the CPU;
             ``python3 chip_smoke.py dtypes`` runs the build and this
             phase alone;
7. cg      — ``lstsq(a, b, ridge=1e-3, method="cg")`` on the lstsq
             phase's data under ``torch.cuda.set_sync_debug_mode("error")``
             (no host sync in the loop), within 1e-3 of the float64
             solution, exactly ``iters + 1`` gemm_tn launches, every one on
             the narrow-output kernel (``csrc/tn_narrow.cu``); gemm_tn at
             (16384, 4096, 8) (``narrow_case``): bitwise equal to
             ``gemm_tn_fused`` on W = 1 tables on float32 operands (the
             narrow kernel) and bfloat16 ones (the wgmma kernel), within
             tolerance of its plain version, its device times in both
             types beside ``torch.matmul(a.T, ap)``'s and the bounds;
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
             parameter tree (``param_shapes``, the shapes of the port's
             ``transformer.init`` on the meta device: 24 layers, d_model 1024,
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
             ``GᵀP`` on wg (24576, 2816, 4) and wd (67584, 1024, 4) by
             ``narrow_case`` beside ``strassen_tn(G, P)``; one AdamW step
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
             rank: ms (CUDA events over ``DIST_REPS`` = 1 run after a
             checked run), the collectives' ms (one run with tracing on) and bytes
             by kind, kernel launches and peak memory. Each of the six
             kernels must be launched by the ranks' checked runs.

12. serve  — the serving layer (``repro_torch.serve``): (a) the smoke
             lattice (``smoke_config``) under the card's rule and the CLI's
             mixed workload of 100 requests, every served slice bitwise equal
             to its per-request twin on the card, none refused by the card's
             rule, zero recaptures; (b) a lattice at the sizes users serve
             (lstsq n ∈ {256, 512} over m bands {512, 8192}, r bands
             {1, 8, 64}, B = 8; whiten n = 1024, m = 4096, r = 64, B = 4):
             256 seeded requests back to back, every slice bitwise equal to
             its twin, two requests of every bucket against float64 (the
             backward error within (m + n)·eps32, the forward error within
             max(1e-3, 2·κ·(m + n)·eps32)), zero recaptures, the share of
             the reference lattice's request shapes the card's rule admits;
             (c) a ``torch.profiler`` trace of one replay per bucket naming
             csrc's syrk, potrf, trsm and (m ≤ 512 lstsq buckets) gemm_tn
             kernels as many times as the capture launched them; (d) per
             bucket: warm seconds (eager run, capture), the cold first
             request of a fresh server, replay ms, request p50/p95/p99 (a
             bucket's ~20 requests, arriving back to back), the same batch
             run eagerly, the per-request loop, the library
             (``a.mT @ a + λI``, ``cholesky_ex``, ``cholesky_solve``) by
             events and in a CUDA graph, and the flush's bound;
             requests/s, graph memory held.

13. check  — the contract checker (``repro_torch.check``) on the card:
             ``python -m repro_torch.check --json`` (the canonical grid on
             fake CUDA tensors, planned on ``cuda_h100``), ``--quick`` and
             ``--serve``, each exiting 0 with zero findings (the three at
             once, in the background beside phase train); for every plan
             of the grid, the ``repro_torch.*`` nodes of its trace equal
             the ``ops.launches`` of one real run of the same callable;
             traces at full width with zero findings, each beside a real
             run whose launches equal its kernel nodes: planned ata 8192²
             packed, the same fused and unrolled (``n_base=512`` pinned),
             planned strassen_tn 4096³ and the lstsq 16384×4096×8 factor
             path at ``packed_block=512``; that lstsq run on the card in
             float32 (every diagonal tile through the wrappers' potrf/trsm
             split) within 1e-3 of float64, its launches on the kernels
             line; the split's device times at n = 512 (potrf of one tile,
             trsm of a 7-tile panel) beside ``torch.linalg`` and their
             bounds; and the host time of one wrapper call through the
             dispatcher operator against the bare launch.

14. train — (after optim) the trainer (``repro_torch.models``,
             ``train.train_step``, ``launch.train``) on qwen1.5-0.5b at full
             width and depth (24 layers, 619.57 M float32 parameters from a
             seeded ``torch.Generator``), batch 4 × 2048 tokens from
             ``SyntheticLM`` (one query block against two KV blocks, so the
             flash recurrence runs across blocks), remat ``dots``, bfloat16
             compute: (a) the first step's loss and global grad norm in
             float32 and bfloat16 against the same step in float64 (remat
             ``full``): within 1e-4 / 1e-3 (float32) and 2e-2 (bfloat16),
             relative; (b) three AdamW and three Shampoo steps through
             ``make_train_step`` with the reference's ``OptimizerConfig``
             defaults apart from the name (no Shampoo refresh before step
             10): step ms (CUDA events, median of steps 2–3), tokens/s,
             peak memory, each gram stack's plan, each step's launches,
             every loss and grad norm finite, and every kernel the plans
             name (syrk; gemm_tn where a plan recurses) launched by each
             Shampoo step; (c) ``python -m repro_torch.launch.train --arch
             qwen1.5-0.5b --optimizer shampoo --steps 4 --save-every 2
             --layers 2`` in a subprocess (full width, the depth cut to 2
             layers so that phase mesh fits the script's time), then the
             same command after deleting the step-4 checkpoint: the resumed
             steps 3–4 within 1e-5 (relative) of the straight run's, and
             whether they are bitwise equal.

15. decode — (after train) the model server (``launch.serve``,
             ``train.serve_step``, ``forward_decode``) for every family and
             modality at full width, seeded weights: (a) qwen1.5-0.5b at
             full depth through ``launch.serve.serve`` (4 slots, 8 requests,
             prompt 512, gen 64, greedy, bfloat16): prefill ms, decode ms a
             step, tokens/s, peak memory; one bfloat16 decode step under
             ``torch.profiler`` (kernels, device busy ms) beside the bytes
             of the weights' casts; (b) mamba2-1.3b and (c) hymba-1.5b
             (prefill 3072, so hymba's 2048 window masks, decode 32), each
             with one AdamW step at batch 2 × 2048; (d) deepseek-moe-16b at
             4 of its 28 layers (prefill 512, decode 32, bfloat16): two
             identical decode steps bitwise equal, one AdamW step at batch
             2 × 1024 on 3 of the layers (AdamW's state of 4 does not fit),
             loss and aux finite; (e) musicgen-medium (4 codebooks) and (f)
             llava-next-mistral-7b (2880 stub patches, 128 text tokens),
             prefill and 16 decode steps. Every config but the MoE's runs
             the float32 teacher-forced check: each prefill and decode
             step's logits within rtol = atol = 2e-3 (the reference's
             bound) of ``forward_train`` over the whole sequence. Every
             config's bfloat16 prefill and decode steps (the served path)
             must be finite and no farther from the same float32 logits
             (the MoE's: its float32 prefill and decode) than
             ``DECODE_BF16_RATIO`` times bfloat16 ``forward_train``'s
             distance from float32 ``forward_train`` at those positions;
             qwen's served greedy tokens of the first batch must each be,
             under ``forward_train`` in float32 over the same prompts and
             tokens, within twice that bound of the largest logit. No kernel of the six is on this path: their launches
             over the phase are recorded (0).
16. mesh   — the sharding layer (``repro_torch.parallel``) on four ranks
             (``launch.mesh.spawn``: NCCL with one card a rank when four
             cards are there, at full depth; else gloo with all four on
             card 0, hymba-1.5b cut to 2 layers (one global, one
             sliding-window) and qwen2-moe-a2.7b to 1; widths are never
             cut; qwen1.5-0.5b 1 layer there): (a) qwen1.5-0.5b ZeRO-1 at
             (data 4, model 1), batch 4 × 2048, float32: two AdamW steps
             and two Shampoo steps (p = 2 packed, the second refreshes),
             each step's loss and grad norm within phase train's float32
             bounds of the single-rank steps on the same batches, and the
             parameters after both steps (each block's ZeRO-1 update, then
             the all-gather) within ``MESH_UPDATE_RTOL`` of the single
             rank's, each leaf's distance over its update; each rank's
             optimizer bytes beside the single rank's, syrk on every rank
             and potrf/trsm in every refresh; Shampoo's owned stats
             bitwise (sha256) equal to the single rank's on the same
             seeded gradients (a check beside the path, not counted); (b) hymba-1.5b at (1, 4):
             context-parallel attention and the P-split SSD in
             ``forward_train`` and one train step, then prefill 4088 and 8
             sequence-parallel decode steps, against rank 0 alone; (c)
             qwen2-moe-a2.7b at (2, 2): its 60 experts (``pad_experts``
             pads to a multiple of ``model`` = 2: none added), 30 a rank,
             forward, aux and one decode step against rank 0 alone on the
             padded weights, each data shard routed on its own; (d) the
             train CLI (qwen1.5-0.5b; under gloo ``--layers 1``) at ``--mesh 2x2`` for 3
             steps saving step 2, then step 3 again at ``--mesh 4x1``
             through ``restore_sharded``, the losses within phase train's
             bfloat16 bound; the serve CLI (hymba-1.5b) at ``--mesh 1x4``,
             beside the train CLIs:
             each greedy float32 token within ``MESH_SERVE_MARGIN`` of the
             largest logit of one rank's float32 ``forward_train`` over the
             same tokens. Every rank computes with its tensor-parallel
             blocks of ``held(param_specs)`` (PR 26), and one rank's
             results are on the blocks gathered. (e) qwen1.5-0.5b
             tensor-parallel at (1, 4): two AdamW steps on (a)'s batches
             against (a)'s single rank (loss, grad norm, parameters), a
             rank's parameter bytes against one rank's (at full depth at
             most ``MESH_TP_BYTES_SHARE``) and the collective bytes by kind
             a step; (f) one sequence at (2, 2) (mamba2-1.3b and hymba-1.5b,
             2 layers under gloo): a train step with the sequence sharded
             over data, then a prefill and decode steps with a cache of
             1025 slots (whole on every rank: model = 2 does not divide
             it), against one rank; (g) qwen2-moe-a2.7b at (4, 1): the
             global batch routed with one capacity, logits and aux against
             one rank on the global batch (and the old per-shard rule's
             distance beside it). Step ms per rank and the collective
             bytes by kind are logged.
17. dryrun — (last) the production dry-run (``repro_torch.launch.dryrun``)
             and its abstraction held against real runs: (a) ``python -m
             repro_torch.launch.dryrun --arch gram --shape 65536x16384
             --mesh single`` and ``--arch qwen1.5-0.5b --shape decode_32k
             --mesh single --no-analysis``, subprocesses on fake CUDA
             tensors over the (16, 16) fake group, each exiting 0 with
             status ok, qwen's peak under 80e9 B a rank; (b) qwen1.5-0.5b's
             single-rank train step at phase train's shape (remat
             ``dots``, AdamW) traced on fake CUDA tensors, then run once on
             the card under the same counters: equal flops, kernel nodes
             equal to ``ops.launches``, and ``max_memory_allocated`` over
             the step (arguments resident, less what was held before they
             were made) within ``DRYRUN_PEAK_BAND`` of the predicted peak;
             (c) ``ata_tile_parallel`` of a (16384, 8192) operand on mesh
             (2, 2), rows over ``data``: each rank traced over a fake (2, 2)
             group, then four gloo ranks on card 0 (``launch.mesh.spawn``)
             each run once: equal flops and collective bytes by kind,
             kernel nodes equal to launches (gemm_tn: every tile is a
             ``strassen_tn`` product), the peak in the same band; (d)
             qwen1.5-0.5b's tensor-parallel train step (4 layers, 2 × 1024,
             AdamW) on (1, 4): each rank traced over a fake (1, 4) group,
             then four gloo ranks run it: equal flops, collective bytes and
             kernel nodes, the peak in the same band.

Phases 3–8, Shampoo's checked runs in phase 10 and the pinned cases of
phase 11 pin ``n_base`` (or ``method``) to the static defaults: unpinned
calls are planned, and those phases measure the dispatches they name.
``python3 chip_smoke.py distributed`` runs the build and phase 11 alone
(what a call on four cards needs), ``python3 chip_smoke.py serve`` the
build and phase 12 alone, ``python3 chip_smoke.py check`` the build and
phase 13 alone, ``python3 chip_smoke.py train`` the build and phase 14
alone, ``python3 chip_smoke.py decode`` the build and phase 15 alone and
``python3 chip_smoke.py mesh`` the build and phase 16 alone and
``python3 chip_smoke.py dryrun`` the build and phase 17 alone; none of them
prints the final line.

Inputs are made with numpy from fixed seeds. Times are medians of CUDA
events over a few runs after one warm-up. Output: the card's name and
power limit first, a JSON line ``{"kernels": [...]}`` before the last, and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense bfloat16 on the tensor cores and HBM3 bandwidth. Used only
# for the bound columns.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
EPS32 = 1.19e-7
EPS64 = 2.2e-16
BF16_ULP = 2.0 ** -7
# the reference's bfloat16 band (tests/test_kernels.py): rtol, here normwise
BF16_RTOL = 2e-2
# strassen_tn 4096³ in bfloat16 against the same recursion on plain bases,
# normwise: scaled_tol's factor at the 512-deep leaves (their float32 sums
# are all that differ; the CPU's plain version against float64 leaves
# differs by 2.4e-7 at 1024³ on 128² leaves)
PLAIN_RTOL = 8 * math.sqrt(512) * EPS32
SEED = 0
# the static cutoff: the phases before `tune` pin it, so they keep measuring
# the dispatches they name now that unpinned calls are planned
DEFAULT_N_BASE = 512


def log(*args):
    print(*args, flush=True)


class Background:
    """``fn()`` in a thread of this process, for work that waits on
    subprocesses while the script goes on: ``result()`` joins it and
    returns what ``fn`` returned, or raises what it raised. Whoever starts
    one calls ``result()`` on every path, so no subprocess outlives the
    script."""

    def __init__(self, fn):
        self._out = {}

        def run():
            try:
                self._out["value"] = fn()
            except BaseException as exc:  # handed to result()
                self._out["error"] = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


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


def bound_bf16(flops: float, nbytes: float):
    """(least time in ms, what bounds it) for work on bfloat16 inputs: the
    operations at the tensor cores' bfloat16 rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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
    """Shapes of ``models.transformer.init``'s tree for ``cfg``, as the
    same tree of shape tuples (dicts with sorted keys): the port's ``init``
    on the ``meta`` device, which allocates nothing."""
    from repro_torch.models.transformer import init
    from repro_torch.optim import _tree

    return _tree.tree_map(lambda x: tuple(x.shape), init(None, cfg, device="meta"))


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
    # of the gemm_tn launches, those on the narrow kernel (Aᵀb's leaves)
    counts["gemm_tn_narrow"] = ops.narrow_launches["gemm_tn_narrow"]
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
    device times beside the float32 ones, the bfloat16 bound (the tensor
    cores' rate) and the library's bfloat16 call ("none" where torch has no
    bfloat16 call on CUDA); gemm_tn and gemm_tn_fused on the tensor-core
    kernels (counted), fused bitwise equal to gemm_tn on the bfloat16
    combined operands; then ata 4096² and strassen_tn 4096³ in bfloat16
    under the three dispatches and ata in float64 on the card. Returns the
    wgmma launches of the bfloat16 main path (phase_ata_dtypes)."""
    import numpy as np
    import torch

    from repro_torch.core.ata import _level_tables
    from repro_torch.core.reference import classical_gemm_flops, potrf_flops, trsm_flops
    from repro_torch.core.strassen import _to_blocks
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm_tn import combine_fused_operands
    from repro_torch.kernels.syrk import syrk_splits

    log("phase dtypes: bfloat16 operands (float32 accumulation), float32 / bfloat16 stores")
    rng = np.random.default_rng(SEED + 4)
    bf16, f32 = torch.bfloat16, torch.float32
    def library(timer, call):
        """The library call's (device ms, ms of one call), or "none" twice
        where torch has no bfloat16 call on CUDA (it raises)."""
        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as exc:
            log(f"    (no bfloat16 library call: {str(exc).splitlines()[0][:100]})")
            return "none", "none"
        return timer(call), time_ms(call)

    def both_outs(name, label, k, call, plain_call, timer, work, lib_call, wgmma=None):
        """The kernel on bfloat16 operands into float32 and bfloat16, each
        against its plain version (and counted on the tensor-core kernel
        ``wgmma`` where named); device time of the float32 store beside the
        bfloat16 bound of ``work`` (flops, bytes) and the library's bfloat16
        call."""
        row = {}
        for out in (f32, bf16):
            before = ops.wgmma_launches[wgmma] if wgmma else 0
            got = call(out)
            if wgmma and ops.wgmma_launches[wgmma] != before + 1:
                raise AssertionError(f"{name} bf16: the {wgmma} kernel did not launch")
            row[f"max_abs_err_{str(out)[6:]}"] = checks.compare(
                f"{name} bf16->{str(out)[6:]} {label}", got, plain_call(out), k)
            del got
        row["device_ms"] = timer(lambda: call(f32))
        row["ms"] = time_ms(lambda: call(f32))
        row["plain_ms"] = time_ms(lambda: plain_call(f32), runs=3)
        row["bound_ms"], row["bound_by"] = bound_bf16(*work)
        row["library_device_ms"], row["library_ms"] = library(timer, lib_call)
        log(f"  {name} bf16 {label}: device_ms={row['device_ms']:.4f} "
            f"(float32: {checks.rows[name].get('device_ms', 'not measured')}) "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, bfloat16 peak) "
            f"library_device_ms={row['library_device_ms']}")
        checks.rows[name]["bf16"] = row
        torch.cuda.empty_cache()
        return row

    a = cuda_tensor(rng, (1430, 512, 512)).to(bf16)
    b = cuda_tensor(rng, (1430, 512, 512)).to(bf16)
    row = both_outs("gemm_tn", "(1430,512,512)^2", 512, lambda o: ops.gemm_tn(a, b, out_dtype=o),
                    lambda o: plain["gemm_tn"](a, b, out_dtype=o),
                    lambda f: graph_ms(f, launches=10),
                    (1430 * classical_gemm_flops(512, 512, 512), 1430 * 512 * 512 * (2 + 2 + 4)),
                    lambda: torch.bmm(a.transpose(1, 2), b), wgmma="gemm_tn_wgmma")
    # the kernel's bfloat16 store against torch.bmm's (which stores bfloat16)
    row["device_ms_bf16_store"] = graph_ms(lambda: ops.gemm_tn(a, b, out_dtype=bf16),
                                           launches=10)
    row["bound_ms_bf16_store"] = bound_bf16(1430 * classical_gemm_flops(512, 512, 512),
                                            1430 * 512 * 512 * 6)[0]
    one = ops.gemm_tn(a[3], b[3])
    if not torch.equal(ops.gemm_tn(a[:8], b[:8])[3], one):
        raise AssertionError("gemm_tn bf16: batch entry differs from its single launch")
    log(f"  gemm_tn bf16 store: device_ms={row['device_ms_bf16_store']:.4f} "
        f"(torch.bmm bf16: {row['library_device_ms']}) bound_ms={row['bound_ms_bf16_store']:.4f}; "
        f"batch entry == single launch: bitwise")
    del a, b
    a = cuda_tensor(rng, (256, 512, 512)).to(bf16)
    row = both_outs("syrk", "(256,512,512) dense", 512, lambda o: ops.syrk(a, out_dtype=o),
                    lambda o: plain["syrk"](a, out_dtype=o), lambda f: graph_ms(f, launches=20),
                    (256 * 512 * 512 * 513, 256 * 512 * 512 * (2 + 4)),
                    lambda: torch.matmul(a.transpose(1, 2), a), wgmma="syrk_wgmma")
    row.update(syrk_bf16_store(ops, 256 * 512 * 512 * 513, 256 * 512 * 512 * (2 + 2),
                               lambda f: graph_ms(f, launches=20),
                               lambda o: ops.syrk(a, out_dtype=o)))
    x = cuda_tensor(rng, (2048, 512)).to(bf16)
    packed = ops.syrk(x, out="packed")
    err = checks.compare("syrk bf16 single (2048,512) packed", packed.blocks,
                         plain["syrk"](x, out="packed", bn=packed.bn), 2048)
    if not torch.equal(packed.to_dense(), ops.syrk(x)):
        raise AssertionError("syrk bf16 single (2048,512): packed != dense")
    bound, by = bound_bf16(2048 * 512 * 513, 2048 * 512 * 2 + 512 * 512 * 4)
    row["single_2048x512"] = dict(
        max_abs_err=err, device_ms=graph_ms(lambda: ops.syrk(x)), bound_ms=bound, bound_by=by,
        library_device_ms=graph_ms(lambda: torch.matmul(x.T, x)))
    log(f"  syrk bf16 single (2048,512) K={syrk_splits(2048, 512)}: packed == dense bitwise; "
        f"device_ms={row['single_2048x512']['device_ms']:.4f} bound_ms={bound:.4f} ({by}) "
        f"torch.matmul {row['single_2048x512']['library_device_ms']:.4f}")
    row["resources"] = {k: _build.resources("syrk_wgmma_info", k) for k in (1, 2, 4, 8)}
    log("  resources bf16 wgmma (syrk, syrk_gather; by split K) " + json.dumps(row["resources"]))
    if any(r["local_bytes"] for r in row["resources"].values()):
        raise AssertionError("syrk's wgmma instances use local memory (spills)")
    del a, x
    root = cuda_tensor(rng, (8192, 8192)).to(bf16)
    ab = _to_blocks(root, 4)
    tables = _level_tables(4, 1)
    xa = combine_fused_operands(ab[None], *tables[0])
    xb = combine_fused_operands(ab[None], *tables[1])
    live = sum(len({(int(r), int(c)) for r, c, g in zip(*(t.ravel() for t in side)) if g})
               for side in tables)
    leaves = tables[0][0].shape[0]
    row = both_outs("gemm_tn_fused", "ata 8192² level 1", 512,
                    lambda o: ops.gemm_tn_fused(ab[None], ab[None], tables, out_dtype=o),
                    lambda o: plain["gemm_tn_fused"](ab[None], ab[None], tables, out_dtype=o),
                    lambda f: graph_ms(f, launches=10),
                    (leaves * classical_gemm_flops(512, 512, 512),
                     2 * 512 * 512 * live + 4 * 512 * 512 * leaves),
                    lambda: torch.bmm(xa.transpose(1, 2), xb), wgmma="gemm_tn_fused_wgmma")
    if xa.dtype != bf16 or not torch.equal(ops.gemm_tn_fused(ab[None], ab[None], tables),
                                           ops.gemm_tn(xa, xb)):
        raise AssertionError("gemm_tn_fused bf16 != gemm_tn on the bfloat16 combined operands")
    row["gemm_tn_on_combined_device_ms"] = graph_ms(lambda: ops.gemm_tn(xa, xb), launches=10)
    log(f"  gemm_tn_fused bf16 == gemm_tn on the bfloat16 combined operands: bitwise; "
        f"gemm_tn on them device_ms={row['gemm_tn_on_combined_device_ms']:.4f} "
        f"(torch.bmm on them: {row['library_device_ms']})")
    del xa, xb
    res = {"gemm_tn_wgmma": _build.resources("gemm_tn_wgmma_info"),
           "gemm_tn_fused_wgmma": {w: _build.resources("gemm_tn_fused_wgmma_info", w)
                                   for w in (1, 2, 4, 8, 16, 32)}}
    checks.rows["gemm_tn"]["bf16"]["resources"] = res["gemm_tn_wgmma"]
    checks.rows["gemm_tn_fused"]["bf16"]["resources"] = res["gemm_tn_fused_wgmma"]
    log("  resources bf16 wgmma (gemm_tn; gemm_tn_fused by slot count W) " + json.dumps(res))
    s = np.arange(256)
    D = ab.transpose(0, 1).reshape(256, *ab.shape[-2:])
    row = both_outs("syrk_gather", "R=16 S=256", 512,
                    lambda o: ops.syrk_gather(ab, s % 16, s // 16, out_dtype=o),
                    lambda o: plain["syrk_gather"](ab, s % 16, s // 16, out_dtype=o), burst_ms,
                    (256 * 512 * 512 * 513, 256 * 512 * 512 * (2 + 4)),
                    lambda: torch.matmul(D.transpose(1, 2), D), wgmma="syrk_gather_wgmma")
    row.update(syrk_bf16_store(ops, 256 * 512 * 512 * 513, 256 * 512 * 512 * (2 + 2),
                               burst_ms, lambda o: ops.syrk_gather(ab, s % 16, s // 16,
                                                                    out_dtype=o)))
    for out in (f32, bf16):
        if not torch.equal(ops.syrk_gather(ab, s % 16, s // 16, out_dtype=out),
                           ops.syrk(D.contiguous(), out_dtype=out)):
            raise AssertionError(f"syrk_gather bf16 != syrk on the stacked leaves ({out})")
    log("  syrk_gather bf16 == syrk on the stacked leaves, float32 and bfloat16 stores: bitwise")
    del root, ab, D
    torch.cuda.empty_cache()
    s1 = spd_tiles(rng, 1, 128)[0].to(bf16)
    both_outs("potrf", "(128,128)", 128, lambda o: ops.potrf(s1, out_dtype=o),
              lambda o: plain["potrf"](s1, out_dtype=o), graph_ms,
              (potrf_flops(128), 128 * 128 * (2 + 4)), lambda: torch.linalg.cholesky_ex(s1))
    for nb_, n_ in ((32, 104), (8, 256)):
        st = spd_tiles(rng, nb_, n_).to(bf16)
        checks.compare(f"potrf bf16 ({nb_},{n_},{n_})", ops.potrf(st), plain["potrf"](st), n_)
    lx = plain["potrf"](spd_tiles(rng, 1, 128)[0]).to(bf16).expand(31, 128, 128)
    p = cuda_tensor(rng, (31, 128, 128)).to(bf16)
    lu = lx[0].transpose(0, 1)
    both_outs("trsm", "(128,128) expanded x (31,128,128)", 128,
              lambda o: ops.trsm(lx, p, out_dtype=o),
              lambda o: plain["trsm"](lx, p, out_dtype=o), graph_ms,
              (31 * trsm_flops(128, 128), 2 * (128 * 128 + 31 * 128 * 128) + 4 * 31 * 128 * 128),
              lambda: torch.linalg.solve_triangular(lu, p, upper=True, left=False))
    r8 = cuda_tensor(rng, (8, 128)).to(bf16)
    checks.compare("trsm bf16 r=8 (8,128) transpose=False",
                   ops.trsm(lx[0], r8, transpose=False),
                   plain["trsm"](lx[0], r8, transpose=False), 128)
    return phase_ata_dtypes(ops)


def syrk_bf16_store(ops, flops, nbytes, timer, call):
    """The bfloat16 store of a syrk launch on the tensor-core kernel: its
    device ms beside its bound (``nbytes`` with a 2-byte output), and no
    tensor map refused on these aligned operands."""
    import torch

    from repro_torch.kernels.syrk import tma_refused

    ops.reset_launches()
    call(torch.bfloat16)
    torch.cuda.synchronize()
    if any(tma_refused.values()):
        raise AssertionError(f"syrk bf16: the card refused the tensor map {tma_refused}")
    bound, by = bound_bf16(flops, nbytes)
    ms = timer(lambda: call(torch.bfloat16))
    log(f"    bfloat16 store: device_ms={ms:.4f} bound_ms={bound:.4f} ({by}); tensor maps taken")
    return {"device_ms_bf16_store": ms, "bound_ms_bf16_store": bound}


def phase_ata_dtypes(ops):
    """ata 4096² and strassen_tn 4096³ on the card in bfloat16 under the
    three dispatches (the bfloat16 main path: bitwise equal, within the
    reference's bfloat16 rtol of float64 — strassen_tn 4096³ within
    PLAIN_RTOL of its plain bases —, the gemm_tn / gemm_tn_fused launches
    on the tensor-core kernels counted, ata's syrk / syrk_gather launched),
    ata 8192² in bfloat16 timed by dispatch (tools/profile_ata.py, in a
    process of its own), and ata 4096² in float64. Returns the wgmma
    launches of the bfloat16 main path by kernel, and the timing."""
    import numpy as np
    import torch

    from repro_torch.core import strassen_tn
    from repro_torch.core.ata import ata
    from repro_torch.kernels.gemm_tn import gemm_tn_plain

    log("  ata 4096x4096 packed and strassen_tn 4096³ in bfloat16 under the three dispatches; "
        "float64")
    rng = np.random.default_rng(SEED + 5)
    a = cuda_tensor(rng, (4096, 4096)).bfloat16()
    wgmma = {"gemm_tn_wgmma": 0, "gemm_tn_fused_wgmma": 0, "syrk_wgmma": 0,
             "syrk_gather_wgmma": 0}
    # the wgmma kernel each dispatch's gemm_tn leaves run on
    leaf_kernel = {"unrolled": "gemm_tn_wgmma", "batched": "gemm_tn_wgmma",
                   "fused": "gemm_tn_fused_wgmma"}

    def dispatches(label, call, exact, expect=None, plain=None):
        """The three dispatches of ``call`` bitwise equal, their gemm_tn /
        gemm_tn_fused launches all on wgmma and each kernel of ``expect``
        (dispatch -> name) launched. Each within BF16_RTOL of ``exact``;
        where ``plain`` (the same call on plain bases) is given, within
        PLAIN_RTOL of it normwise instead, its error against ``exact``
        recorded. Returns the errors against ``exact`` by dispatch (and
        ``plain``'s)."""
        results, errors = {}, {}
        if plain is not None:
            errors["plain"] = float(torch.linalg.norm(plain - exact) / torch.linalg.norm(exact))
        for ld in ("unrolled", "batched", "fused"):
            ops.reset_launches()
            results[ld] = call(ld)
            torch.cuda.synchronize()
            counts = dict(ops.launches)
            tc = dict(ops.wgmma_launches)
            got = results[ld]
            got = torch.tril(got.to_dense().double()) if hasattr(got, "blocks") else got.double()
            rel = float(torch.linalg.norm(got - exact) / torch.linalg.norm(exact))
            line = (f"  {label} bf16 {ld}: rel Frobenius error vs float64 {rel:.6e}")
            if plain is None:
                line += f" (limit {BF16_RTOL})"
                ok = rel <= BF16_RTOL
            else:
                to_plain = float(torch.linalg.norm(got - plain) / torch.linalg.norm(plain))
                line += (f" (the plain bases': {errors['plain']:.6e}), vs the plain bases "
                         f"{to_plain:.3e} (limit {PLAIN_RTOL:.3e})")
                ok = to_plain <= PLAIN_RTOL
            errors[ld] = rel
            del got
            log(line + f" launches {counts} wgmma {tc}")
            if not ok:
                raise AssertionError(f"{label} bf16 {ld}: off its reference: {line}")
            kernel = leaf_kernel[ld]
            total = counts["gemm_tn_fused" if ld == "fused" else "gemm_tn"]
            if total < 1 or tc[kernel] != total:
                raise AssertionError(f"{label} bf16 {ld}: {tc[kernel]} {kernel} launches of "
                                     f"{total}")
            if expect and counts[expect[ld]] < 1:
                raise AssertionError(f"{label} bf16 {ld}: no {expect[ld]} launch")
            # every syrk / syrk_gather launch of the bfloat16 path on the tensor cores
            for name in ("syrk", "syrk_gather"):
                if tc[f"{name}_wgmma"] != counts[name]:
                    raise AssertionError(f"{label} bf16 {ld}: {tc[f'{name}_wgmma']} of "
                                         f"{counts[name]} {name} launches on the tensor cores")
                wgmma[f"{name}_wgmma"] += counts[name]
            wgmma[kernel] += tc[kernel]
        blocks = {ld: getattr(r, "blocks", r) for ld, r in results.items()}
        if not (torch.equal(blocks["unrolled"], blocks["batched"])
                and torch.equal(blocks["unrolled"], blocks["fused"])):
            raise AssertionError(f"{label} bf16: the three dispatches differ")
        log(f"  {label} bf16 unrolled == batched == fused: bitwise")
        return errors

    exact = torch.tril(a.double().T @ a.double())
    dispatches("ata 4096²", lambda ld: ata(a, out="packed", leaf_dispatch=ld,
                                             n_base=DEFAULT_N_BASE), exact,
               expect={"unrolled": "syrk", "batched": "syrk", "fused": "syrk_gather"})
    del exact
    # strassen_tn in bfloat16: at 2048³ (two Strassen levels at the pinned
    # cutoff) within the band; at 4096³ (three levels, phase strassen's
    # shape) each level rounds the operand sums to bfloat16 and three reach
    # the band's edge, in the plain version as in the kernels (the CPU's
    # plain version: 2.0e-2 at 1024³ on 128² leaves), so 4096³ is held to
    # the same recursion on plain bases (torch.matmul in float32 on the
    # same bfloat16 leaf operands): they differ only in the leaves'
    # summation order
    b = cuda_tensor(rng, (4096, 4096)).bfloat16()
    exact = a[:2048, :2048].double().T @ b[:2048, :2048].double()
    h, g = a[:2048, :2048].contiguous(), b[:2048, :2048].contiguous()
    dispatches("strassen_tn 2048³", lambda ld: strassen_tn(h, g, leaf_dispatch=ld,
                                                             n_base=DEFAULT_N_BASE), exact)
    exact = a.double().T @ b.double()
    plain_l3 = strassen_tn(a, b, leaf_dispatch="unrolled", n_base=DEFAULT_N_BASE,
                           base_dot=lambda x, y: gemm_tn_plain(x, y)).double()
    strassen_l3 = dispatches("strassen_tn 4096³",
                             lambda ld: strassen_tn(a, b, leaf_dispatch=ld,
                                                    n_base=DEFAULT_N_BASE),
                             exact, plain=plain_l3)
    del exact, b, h, g, plain_l3
    torch.cuda.empty_cache()

    # ata 8192² in bfloat16 by dispatch: wall ms and device-busy ms
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "profile_ata.py"),
                           "--dtype", "bfloat16"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode:
        raise AssertionError(f"dtypes: tools/profile_ata.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    timing = json.loads(proc.stdout.strip().splitlines()[-1])
    timing["strassen_tn_4096_bf16_rel_err"] = strassen_l3
    log("  ata 8192² bfloat16, n_base=512 (tools/profile_ata.py): " + ", ".join(
        f"{k} wall {timing[k]['wall_ms']:.2f} ms, events {timing[k]['events_ms']:.2f} ms, "
        f"device busy {timing[k]['device_busy_ms']:.2f} ms, {timing[k]['kernels']:.0f} kernels"
        for k in ("fused", "batched", "matmul")))

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
    return wgmma, timing


def narrow_case(checks, ops, plain, label, a, b):
    """gemm_tn at a narrow ``k`` (≤ ``narrow_max_k()``) on ``Aᵀb`` at the
    main path's shape: float32 operands on the narrow-output kernel
    (``csrc/tn_narrow.cu``), bfloat16 ones on the tensor-core kernel
    (``csrc/tn_wgmma.cuh``), each counted, bitwise equal to
    ``gemm_tn_fused`` on W = 1 tables of the same operands (the same
    summation order), within ``scaled_tol`` of the plain version, and timed
    in CUDA graphs of 50 launches beside ``torch.matmul(a.T, b)`` on the
    same operands and the bound, with the narrow instance's resources."""
    import torch

    from repro_torch.core.strassen import _slot_tables
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm_tn import narrow_max_k

    (m, n), k = a.shape, b.shape[1]
    if k > narrow_max_k():
        raise AssertionError(f"{label}: k = {k} is not the narrow kernel's")

    def bits(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)

    res = {}
    operands = {"float32": (a, b), "bfloat16": (a.bfloat16(), b.bfloat16())}
    for name, (x, y) in operands.items():
        counter, key = ((ops.narrow_launches, "gemm_tn_narrow") if name == "float32"
                        else (ops.wgmma_launches, "gemm_tn_wgmma"))
        before = counter[key]
        got = ops.gemm_tn(x, y)
        if counter[key] != before + 1:
            raise AssertionError(f"{label} {name}: the {key} kernel did not launch")
        lead = (None,) * 3
        fused = ops.gemm_tn_fused(x[lead], y[lead], _slot_tables(0)).reshape(n, k)
        if not torch.equal(bits(got), bits(fused)):
            raise AssertionError(f"{label} {name}: gemm_tn != W = 1 gemm_tn_fused, bitwise")
        res[f"max_abs_err_{name}"] = checks.compare(f"{label} {name} operands", got,
                                                    plain["gemm_tn"](x, y), m)
        del got, fused
    bms, by = bound(2 * m * n * k, 4 * (m * n + m * k + n * k))
    x, y = operands["bfloat16"]
    res.update(
        shape=[m, n, k], bitwise_to_engine=True, bound_ms=bms, bound_by=by,
        device_ms=graph_ms(lambda: ops.gemm_tn(a, b)),
        matmul_device_ms=graph_ms(lambda: torch.matmul(a.T, b)),
        ms=time_ms(lambda: ops.gemm_tn(a, b), runs=20),
        matmul_ms=time_ms(lambda: torch.matmul(a.T, b), runs=20),
        bf16_device_ms=graph_ms(lambda: ops.gemm_tn(x, y)),
        bf16_matmul_device_ms=graph_ms(lambda: torch.matmul(x.T, y)),
        bf16_bound_ms=bound_bf16(2 * m * n * k, 2 * (m * n + m * k) + 4 * n * k)[0],
        resources=_build.resources("gemm_tn_narrow_info", n, k, 1))
    log(f"  {label} ({m},{n},{k}): bitwise == W = 1 gemm_tn_fused (float32 on the narrow "
        f"kernel, bfloat16 on wgmma); float32 device_ms={res['device_ms']:.4f} torch.matmul "
        f"device_ms={res['matmul_device_ms']:.4f} bound_ms={bms:.4f} ({by}); bfloat16 "
        f"device_ms={res['bf16_device_ms']:.4f} torch.matmul device_ms="
        f"{res['bf16_matmul_device_ms']:.4f} bound_ms={res['bf16_bound_ms']:.4f}; one call "
        f"ms={res['ms']:.4f} (torch.matmul {res['matmul_ms']:.4f}); resources "
        f"{json.dumps(res['resources'])}")
    return res


def phase_cg(checks, ops, plain):
    """lstsq(method='cg') at 16384×4096×8 on the lstsq phase's data: error
    against the float64 solution, ms, gemm_tn launches per solve (every one
    the narrow kernel), all under sync debug mode 'error'; the narrow
    gemm_tn by ``narrow_case``."""
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
    narrow = ops.narrow_launches["gemm_tn_narrow"]
    log(f"  launches {counts}, {narrow} of them the narrow kernel "
        f"(under set_sync_debug_mode('error'): no host sync)")
    if counts["gemm_tn"] != iters + 1 or sum(counts.values()) != iters + 1:
        raise AssertionError(f"cg: launches {counts}, expected {iters + 1} gemm_tn only")
    if narrow != iters + 1:
        raise AssertionError(f"cg: {narrow} narrow launches, expected {iters + 1}")
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
    rate = iters * cg_iteration_flops(16384, 4096, 8) / ms / 1e9
    log(f"  ms={ms:.2f} ({iters} iterations, {rate:.2f} TFLOP/s by cg_iteration_flops)")
    # the narrow gemm_tn of each iteration, alone: Aᵀ(A·p) at (16384, 4096, 8)
    ap = a @ x
    tn = narrow_case(checks, ops, plain, "gemm_tn narrow: CG's Aᵀ(A·p)", a, ap)
    tn["plain_ms"] = time_ms(lambda: plain["gemm_tn"](a, ap), runs=20)
    return counts, dict(ms=ms, rel_err=rel, iters=iters, gemm_tn_launches=counts["gemm_tn"],
                        narrow_launches=narrow, narrow_16384x4096x8=tn)


def obs_hooks_removed(ops):
    """Context manager: every obs hook of the port's paths (counters,
    gauges, spans, dispatch timing, the wrappers' ``_run``) replaced by
    nothing, so a call's time with the hooks disabled can be held against
    its time with no hooks at all in one process."""
    import contextlib

    from repro_torch import obs

    null = contextlib.nullcontext()

    def run(name, cuda, *args):
        return ops.OPS[name](*args)      # the operator counts its launch

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
    from repro_torch.core.reference import classical_syrk_flops
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
    res["powersgd"], narrow = {}, {}
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
        narrow[key] = (g2, p_)
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
    # (e) the narrow gemm_tn of a round, GᵀP, alone on wg's and wd's shapes
    for key, (g, p_) in narrow.items():
        tn = narrow_case(checks, ops, plain, f"(e) gemm_tn narrow: PowerSGD's GᵀP on {key}", g,
                         p_)
        tn["strassen_tn_ms"] = time_ms(lambda: strassen_tn(g, p_), runs=10)
        log(f"  (e) strassen_tn(G, P) on {key}, planned: ms={tn['strassen_tn_ms']:.4f}")
        res["powersgd"][f"narrow_tn_{key}"] = tn
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


# ---------------------------------------------------------------------------
# phase train: the trainer at qwen1.5-0.5b's full width and depth
# ---------------------------------------------------------------------------

# 4 sequences of 2048 tokens a step: one 2048 query block against two 1024
# KV blocks, so the flash recurrence runs across blocks
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 3
# the first step in float32 and bfloat16 against float64 (loss, grad norm)
TRAIN_F32_RTOL = (1e-4, 1e-3)
TRAIN_BF16_RTOL = 2e-2
# the CLI on the card: a straight run of 4 steps saving every 2, then the
# same command resumed from step 2; full width, 2 of the 24 layers (its
# checkpoints' I/O, not its steps, set its time)
TRAIN_CLI = ("--arch", "qwen1.5-0.5b", "--optimizer", "shampoo", "--steps", "4",
             "--save-every", "2", "--log-every", "1", "--layers", "2")


def phase_train(ops):
    """The trainer (``repro_torch.launch.train``'s stack) on qwen1.5-0.5b at
    full width and depth, batch 4 × 2048 tokens, remat ``dots``, bfloat16
    compute (the reference's ``RunConfig`` defaults); see the module
    docstring. Returns the launches of one Shampoo step and the results."""
    import time

    import torch

    from repro_torch import tune
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.core.strassen import tree_depth
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init
    from repro_torch.optim import _tree
    from repro_torch.optim.shampoo import _plan, _use_shampoo
    from repro_torch.train.train_step import loss_and_grads, make_loss_fn, make_train_step

    t_phase = time.perf_counter()
    res = {}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shape = ShapeConfig("train_phase", TRAIN_SEQ, TRAIN_BATCH, "train")
    log(f"phase train: {CONFIG.name} ({CONFIG.num_layers} layers, d_model {CONFIG.d_model}, "
        f"vocab {CONFIG.vocab_size}), batch {TRAIN_BATCH} x seq {TRAIN_SEQ} = {tokens} tokens "
        "a step")
    params = init(torch.Generator(device="cuda").manual_seed(SEED + 20), CONFIG, device="cuda")
    flat, _ = _tree.tree_flatten_with_path(params)
    n_params = sum(x.numel() for _, x in flat)
    data = SyntheticLM(CONFIG, shape, seed=SEED)
    try:
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
                   for _ in range(TRAIN_STEPS)]
    finally:
        data.close()
    sham = [(p, tuple(x.shape)) for p, x in flat if _use_shampoo(p, x.shape)]
    log(f"  {len(flat)} leaves, {n_params} float32 parameters; Shampoo takes {len(sham)} "
        f"leaves, Adam {[p for p, x in flat if not _use_shampoo(p, x.shape)]}")
    if len(sham) != 12:
        raise AssertionError(f"train: Shampoo takes {len(sham)} leaves of the model, expected 12")
    res["n_params"] = n_params

    # (a) the first step's loss and global grad norm on batch 0 with the same
    # parameters: float64 (the yardstick), float32 and bfloat16
    def first_step(dtype, remat, prm):
        run = RunConfig(model=CONFIG, shape=shape, remat=remat, compute_dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m, g = loss_and_grads(make_loss_fn(CONFIG, None, run), prm, batches[0])
        sq = sum(torch.sum(torch.square(x.double())) for x in _tree.tree_leaves(g))
        out = dict(loss=float(m["loss"]), grad_norm=float(torch.sqrt(sq)), remat=remat,
                   s=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated())
        del m, g
        torch.cuda.empty_cache()
        return out

    params64 = _tree.tree_map(lambda x: x.double(), params)
    first = {"float64": first_step("float64", "full", params64)}
    del params64
    torch.cuda.empty_cache()
    first["float32"] = first_step("float32", "dots", params)
    first["bfloat16"] = first_step("bfloat16", "dots", params)
    ref = first["float64"]
    for name, (tl, tg) in (("float32", TRAIN_F32_RTOL),
                           ("bfloat16", (TRAIN_BF16_RTOL, TRAIN_BF16_RTOL))):
        r = first[name]
        r["loss_rel"] = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        r["grad_norm_rel"] = abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        ok = r["loss_rel"] <= tl and r["grad_norm_rel"] <= tg
        log(f"  (a) first step {name} (remat {r['remat']}): loss {r['loss']!r} grad_norm "
            f"{r['grad_norm']!r}; against float64 loss rel {r['loss_rel']:.3e} (limit {tl}), "
            f"grad_norm rel {r['grad_norm_rel']:.3e} (limit {tg}); {r['s']:.2f} s, peak "
            f"{r['peak_bytes']} B {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train: the {name} first step is off float64's")
    log(f"  (a) first step float64 (remat full, batch {TRAIN_BATCH}): loss {ref['loss']!r} "
        f"grad_norm {ref['grad_norm']!r}; {ref['s']:.2f} s, peak {ref['peak_bytes']} B")
    res["first_step"] = first

    # (b) three AdamW and three Shampoo steps through make_train_step, the
    # reference's OptimizerConfig defaults apart from the name
    # the kernels a Shampoo step must launch follow from the grams' plans:
    # syrk for every gram (each has a diagonal leaf), gemm_tn where a plan
    # recurses (or the fused pair under the fused dispatch)
    grams, path_kernels = {}, {"syrk"}
    for path, shp in sham:
        pt = _plan(shp, OptimizerConfig().shampoo_block)
        nb = pt.n1 * pt.n2
        for side, (m, n) in (("L", (pt.b2, pt.b1)), ("R", (pt.b1, pt.b2))):
            p = tune.plan(op="ata", m=m, n=n, batch=nb, out="packed", backend="cuda")
            depth = tree_depth((m, n), p.n_base)
            if depth and p.leaf_dispatch == "fused":
                path_kernels |= {"gemm_tn_fused", "syrk_gather"}
            elif depth:
                path_kernels.add("gemm_tn")
            grams.setdefault(f"{nb}x{m}x{n}", dict(
                first=f"{path} {side}", depth=depth,
                plan=f"{p.algorithm}/{p.n_base}/{p.leaf_dispatch}"))
    log("  (b) Shampoo's gram plans (cuda_h100, unpinned): " + "; ".join(
        f"({k}) {v['plan']} depth {v['depth']} [{v['first']}]" for k, v in grams.items())
        + f"; so each step must launch {sorted(path_kernels)}")
    res["gram_plans"] = grams
    res["path_kernels"] = sorted(path_kernels)
    shampoo_launches = None
    for name in ("adamw", "shampoo"):
        run = RunConfig(model=CONFIG, shape=shape, optimizer=OptimizerConfig(name=name))
        step_fn, opt = make_train_step(CONFIG, None, run)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            ops.reset_launches()
            start.record()
            state, m = step_fn(state, batches[i])
            end.record()
            torch.cuda.synchronize()
            launched = {k: v for k, v in ops.launches.items() if v}
            steps.append(dict(ms=start.elapsed_time(end), loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]), launches=launched))
            log(f"  (b) {name} step {i + 1}: ms={steps[-1]['ms']:.2f} loss "
                f"{steps[-1]['loss']!r} grad_norm {steps[-1]['grad_norm']!r} launches {launched}")
            if not (math.isfinite(steps[-1]["loss"]) and math.isfinite(steps[-1]["grad_norm"])):
                raise AssertionError(f"train: {name} step {i + 1} is not finite")
            missing = sorted(k for k in path_kernels if not launched.get(k))
            if name == "shampoo" and missing:
                raise AssertionError(f"train: Shampoo step {i + 1} launched no {missing}")
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(s["ms"] for s in steps[1:])
        res[name] = dict(steps=steps, step_ms=ms, tokens_per_s=tokens / (ms / 1e3),
                         peak_bytes=peak)
        log(f"  (b) {name}: step ms {ms:.2f} (median of steps 2-{TRAIN_STEPS}), "
            f"{res[name]['tokens_per_s']:.0f} tokens/s, peak device memory {peak} B")
        if name == "shampoo":
            shampoo_launches = dict(ops.launches)
        del state, step_fn, opt
        torch.cuda.empty_cache()
    del params, batches
    torch.cuda.empty_cache()

    # (c) the CLI on the card: a straight run, then the same command after
    # deleting the step-4 checkpoint, which resumes from step 2
    out = os.path.join(ROOT, "build", "train_cli")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI, "--out", out]
    runs = []
    try:
        for label in ("straight", "resumed"):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                                  timeout=600)
            runs.append(time.perf_counter() - t0)
            if proc.returncode:
                raise AssertionError(f"train: the CLI ({label}) exited {proc.returncode}:\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            log(f"  (c) CLI {label} (2 of 24 layers): {runs[-1]:.1f} s; " + " | ".join(
                line for line in proc.stdout.splitlines() if "loss" in line or "resumed" in line))
            if label == "straight":
                shutil.rmtree(os.path.join(out, "ckpt", "step_000000004"))
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if [r["step"] for r in recs] != [1, 2, 3, 4, 3, 4]:
        raise AssertionError(f"train: the CLI logged steps {[r['step'] for r in recs]}")
    pairs = [((a["loss"], a["grad_norm"]), (b["loss"], b["grad_norm"]))
             for a, b in zip(recs[2:4], recs[4:6])]
    bitwise = all(a == b for a, b in pairs)
    worst = max(abs(x - y) / abs(x) for a, b in pairs for x, y in zip(a, b))
    log(f"  (c) resumed steps 3-4 against the straight run: "
        f"{'bitwise equal' if bitwise else f'max relative difference {worst:.3e}'} "
        f"(losses {[p[0][0] for p in pairs]} / {[p[1][0] for p in pairs]})")
    if not worst <= 1e-5:
        raise AssertionError("train: the resumed CLI run does not match the straight run")
    res["cli"] = dict(seconds=runs, bitwise=bitwise, max_rel=worst,
                      losses=[r["loss"] for r in recs])
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase train took {res['phase_s']:.1f} s")
    return shampoo_launches, res


# ---------------------------------------------------------------------------
# phase decode: the model server (prefill, then one token a step against the
# KV/SSM cache) for every family and modality at full width
# ---------------------------------------------------------------------------

# teacher-forced decode against forward_train over the whole sequence, float32:
# the reference's own bound (tests/test_train_serve.py), rtol = atol = 2e-3
DECODE_TF_TOL = 2e-3
# the bfloat16 prefill and decode may be this many times as far from
# float32 as bfloat16 forward_train is over the same sequence (largest
# difference over the largest |logit|). Bfloat16 forward_train itself
# drifts with depth in the SSD families with random weights (mamba2-1.3b
# 1.6e-2 at 1 layer, 0.72 at 48; qwen1.5-0.5b 2.2e-2 at 24), and at full
# width the decode path read 0.83-1.08 times it (PERF.md §6)
DECODE_BF16_RATIO = 1.5
# (a) launch.serve's loop at qwen1.5-0.5b
DECODE_SERVE = dict(batch=4, requests=8, prompt_len=512, gen_len=64)
# (arch, layers kept or None for full depth, prompt, decode steps, batch of the
# float32 check, (train batch, seq, layers trained or None) or None);
# musicgen's and llava's prompts are 128 text tokens (llava's behind 2880 stub
# patches). deepseek-moe-16b trains its first 3 of the 4 layers: AdamW holds
# parameters, gradients and the old and new moments (6 copies of 2.35 GB a
# layer, plus one leaf's temporaries), which at 4 layers exceeds 80 GB
DECODE_CASES = (
    ("mamba2-1.3b", None, 3072, 32, 2, (2, 2048, None)),
    ("hymba-1.5b", None, 3072, 32, 2, (2, 2048, None)),
    ("deepseek-moe-16b", 4, 512, 32, 4, (2, 1024, 3)),
    ("musicgen-medium", None, 128, 16, 2, None),
    ("llava-next-mistral-7b", None, 128, 16, 2, None),
)


def _decode_inputs(cfg, batch: int, seq: int):
    """Tokens (and stub patch embeddings) of ``seq`` text positions from the
    data pipeline's stub front ends, on the card."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch

    extra = cfg.num_patches if cfg.modality == "vision_text" else 0
    b = make_batch(cfg, ShapeConfig("decode", seq + extra, batch, "prefill"), SEED, 0)
    return {k: torch.as_tensor(v, device="cuda") for k, v in b.items() if k != "labels"}


def _prefill_decode(cfg, params, inputs, s_p: int, dtype, ref=None):
    """Prefill the first ``s_p`` text positions of ``inputs``, then decode
    the rest one token a step, teacher-forced. With ``ref`` (float32 logits
    at positions ``s_p - 1`` on) every step's logits are held against it.
    Returns times (CUDA events), errors and whether every logit is finite,
    the logits of every step (B, steps, ...) and the last cache."""
    import torch

    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    toks = inputs["tokens"]
    n_img = inputs["image_embeds"].shape[1] if "image_embeds" in inputs else 0
    s = toks.shape[1]
    prefill = make_prefill_step(cfg, None, dtype, cache_len=n_img + s)
    decode = make_decode_step(cfg, None, dtype)
    pre = dict(inputs, tokens=toks[:, :s_p])
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(s - s_p + 1)]
    marks[0].record()
    lg, cache = prefill(params, pre)
    marks[1].record()
    outs = [lg]
    for t in range(s_p, s - 1):
        pos = torch.full((toks.shape[0],), n_img + t, dtype=torch.int32, device="cuda")
        lg, cache = decode(params, toks[:, t:t + 1], cache, pos)
        marks[t - s_p + 2].record()
        outs.append(lg)
    torch.cuda.synchronize()
    steps = [a.elapsed_time(b) for a, b in zip(marks[1:-1], marks[2:])]
    got = torch.cat(outs, dim=1).float()
    del outs
    res = dict(prefill_ms=marks[0].elapsed_time(marks[1]), decode_steps=len(steps),
               decode_ms=statistics.median(steps), finite=bool(torch.isfinite(got).all()))
    if ref is not None:
        ref = ref[:, :got.shape[1]]
        d = (got - ref).abs()
        n = got.shape[1]
        top = float(ref.abs().max())
        norm = (d.transpose(0, 1).reshape(n, -1).norm(dim=1)
                / ref.transpose(0, 1).reshape(n, -1).norm(dim=1))
        res.update(max_abs_err=float(d.max()), max_abs_ref=top,
                   max_rel_err=float(d.max()) / top, max_norm_err=float(norm.max()))
        if dtype == torch.float32:
            res["allclose_ratio"] = float((d / (DECODE_TF_TOL + DECODE_TF_TOL * ref.abs())).max())
        del d
    return res, got, cache


def _decode_checks(cfg, params, inputs, s_p: int):
    """The float32 check, then the bfloat16 one. Float32: prefill and
    teacher-forced decode within rtol = atol = 2e-3 of ``forward_train``
    over the whole sequence (not for the MoE, whose capacity drops differ
    between a sequence and a token). Bfloat16 (the served path): every
    step's logits finite and no farther from the same float32 logits (the
    MoE's: its own float32 prefill and decode) than ``DECODE_BF16_RATIO``
    times bfloat16 ``forward_train``'s distance from float32's at those
    positions, each distance the largest difference over the largest
    |logit|. Returns both results and the bfloat16 run's cache."""
    import torch

    from repro_torch.models.transformer import forward_train

    with torch.no_grad():
        full, _ = forward_train(params, inputs, cfg, compute_dtype=torch.float32)
        full = full[:, s_p - 1:].clone()
        full16, _ = forward_train(params, inputs, cfg, compute_dtype=torch.bfloat16)
        full16 = full16[:, s_p - 1:].float()
    ft_rel = float((full16 - full).abs().max()) / float(full.abs().max())
    del full16
    if cfg.moe is None:
        f32, _, cache = _prefill_decode(cfg, params, inputs, s_p, torch.float32, ref=full)
        ref = full
        ok = f32["finite"] and f32["allclose_ratio"] <= 1.0
        log(f"  {cfg.name} float32 teacher-forced: prefill {s_p} ms={f32['prefill_ms']:.2f}, "
            f"{f32['decode_steps']} steps ms={f32['decode_ms']:.3f} (median); max_abs_err="
            f"{f32['max_abs_err']:.3e} of max|logit| {f32['max_abs_ref']:.3e} (relative "
            f"{f32['max_rel_err']:.3e}), allclose ratio {f32['allclose_ratio']:.3f} (rtol = atol = "
            f"{DECODE_TF_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode: {cfg.name}'s teacher-forced decode is off forward_train")
    else:
        f32, ref, cache = _prefill_decode(cfg, params, inputs, s_p, torch.float32)
        log(f"  {cfg.name} float32: prefill {s_p} ms={f32['prefill_ms']:.2f}, "
            f"{f32['decode_steps']} steps ms={f32['decode_ms']:.3f} (median), logits "
            f"{'finite' if f32['finite'] else 'NOT FINITE'} (the bfloat16 run's reference)")
        if not f32["finite"]:
            raise AssertionError(f"decode: {cfg.name}'s float32 logits are not finite")
    del cache, full
    bf, _, cache = _prefill_decode(cfg, params, inputs, s_p, torch.bfloat16, ref=ref)
    del ref
    bf.update(forward_train_rel_err=ft_rel, bound_rel=DECODE_BF16_RATIO * ft_rel)
    ok = bf["finite"] and bf["max_rel_err"] <= bf["bound_rel"]
    log(f"  {cfg.name} bfloat16 at batch {inputs['tokens'].shape[0]}: prefill {s_p} "
        f"ms={bf['prefill_ms']:.2f}, {bf['decode_steps']} steps ms={bf['decode_ms']:.3f} "
        f"(median); logits {'finite' if bf['finite'] else 'NOT FINITE'}, max_abs_err "
        f"{bf['max_abs_err']:.3e} of max|logit| {bf['max_abs_ref']:.3e} (relative "
        f"{bf['max_rel_err']:.3e}, worst step normwise {bf['max_norm_err']:.3e}); bfloat16 "
        f"forward_train {ft_rel:.3e} from float32, so {bf['max_rel_err'] / ft_rel:.3f} times it "
        f"(bound {DECODE_BF16_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode: {cfg.name}'s bfloat16 decode is off float32")
    return f32, bf, cache


def _served_tokens_check(cfg, params, out, bound_rel: float):
    """The first served batch's bfloat16 greedy tokens against float32:
    ``forward_train`` in float32 over its prompts and generated tokens;
    each chosen token's float32 logit must be within ``2 · bound_rel ·
    max|logit|`` of the position's largest (the argmax of logits within
    ``bound_rel · max|logit|`` of float32 can lose no more), ``bound_rel``
    the bound the teacher-forced bfloat16 decode was held to."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import forward_train

    b, p = DECODE_SERVE["batch"], DECODE_SERVE["prompt_len"]
    seq = np.concatenate([out["prompts"][:b], out["tokens"][:b, :-1]], axis=1)
    with torch.no_grad():
        full, _ = forward_train(params, {"tokens": torch.as_tensor(seq, device="cuda")}, cfg,
                                compute_dtype=torch.float32)
    lg = full[:, p - 1:]
    del full
    tok = torch.as_tensor(out["tokens"][:b], device="cuda").long()
    gap = lg.amax(-1) - lg.gather(-1, tok[..., None])[..., 0]
    res = dict(max_gap=float(gap.max()), max_abs_ref=float(lg.abs().max()),
               argmax_agree=float((lg.argmax(-1) == tok).float().mean()))
    res["bound"] = 2 * bound_rel * res["max_abs_ref"]
    ok = res["max_gap"] <= res["bound"]
    log(f"  (a) the first served batch's {tuple(tok.shape)} bfloat16 greedy tokens under float32 "
        f"forward_train: {res['argmax_agree']:.4f} of them the float32 argmax, the largest "
        f"shortfall from the float32 maximum {res['max_gap']:.3e} (bound {res['bound']:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode: the served bfloat16 tokens are off float32's choice")
    return res


def _decode_train_step(cfg, batch: int, seq: int, layers, params):
    """One AdamW step through ``make_train_step`` (remat ``dots``, bfloat16,
    the reference's ``RunConfig`` defaults) on the synthetic stream; with
    ``layers``, on the first ``layers`` layers of the stack only."""
    import dataclasses
    import time

    import torch

    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim._tree import tree_map
    from repro_torch.train.train_step import make_train_step

    if layers is not None and layers < cfg.num_layers:
        log(f"  {cfg.name}: the train step keeps {layers} of the {cfg.num_layers} layers "
            "(AdamW's state of all of them does not fit)")
        cfg = dataclasses.replace(cfg, num_layers=layers)
        params = dict(params, layers=tree_map(lambda x: x[:layers], params["layers"]))

    shape = ShapeConfig("decode_train", seq, batch, "train")
    run = RunConfig(model=cfg, shape=shape, optimizer=OptimizerConfig(name="adamw"))
    step_fn, opt = make_train_step(cfg, None, run)
    data = {k: torch.as_tensor(v, device="cuda")
            for k, v in make_batch(cfg, shape, SEED, 0).items()}
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, data)
    torch.cuda.synchronize()
    res = dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(m["loss"]), aux=float(m["aux"]),
               grad_norm=float(m["grad_norm"]), batch=batch, seq=seq, layers=cfg.num_layers,
               peak_bytes=torch.cuda.max_memory_allocated())
    ok = all(math.isfinite(res[k]) for k in ("loss", "aux", "grad_norm"))
    log(f"  {cfg.name} AdamW step at {batch} x {seq}, {cfg.num_layers} layers (remat dots, "
        f"bfloat16): ms={res['ms']:.1f} (first step) loss {res['loss']!r} aux {res['aux']!r} "
        f"grad_norm {res['grad_norm']!r}, peak {res['peak_bytes'] / 1e9:.2f} GB "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode: {cfg.name}'s train step is not finite")
    del state, step_fn, opt
    return res


def phase_decode(ops):
    """The model server (``repro_torch.launch.serve``, ``train.serve_step``,
    ``models.transformer.forward_decode``) for every family and modality at
    full width; see the module docstring. Returns the six kernels' launches
    over the phase (none is on this path) and the results."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_leaves
    from repro_torch.train.serve_step import make_decode_step

    t_phase = time.perf_counter()
    ops.reset_launches()
    res = {}

    # (a) qwen1.5-0.5b, full depth: launch.serve's loop, greedy, bfloat16
    cfg = get_config("qwen1.5-0.5b")
    t0 = time.perf_counter()
    params = init(torch.Generator(device="cuda").manual_seed(SEED + 30), cfg, device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"phase decode: (a) {cfg.name}, {cfg.num_layers} layers (full depth), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} float32 parameters; launch.serve "
        f"{DECODE_SERVE}, greedy, bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, params, temperature=0.0, seed=SEED, device="cuda",
                compute_dtype=torch.bfloat16, log=lambda line: log("  " + line),
                **DECODE_SERVE)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(out["decode_ms"])
    toks = out["tokens"]
    a = dict(prefill_ms=out["prefill_ms"], decode_ms=step_ms, decode_steps=len(out["decode_ms"]),
             tokens_per_s=out["tokens_out"] / out["seconds"],
             decode_tokens_per_s=DECODE_SERVE["batch"] / (step_ms / 1e3), peak_bytes=peak,
             seconds=out["seconds"], distinct_tokens=int(np.unique(toks).size))
    log(f"  (a) prefill ms {[round(x, 2) for x in a['prefill_ms']]} (4 x 512 tokens), decode "
        f"ms {step_ms:.3f} a step (median of {a['decode_steps']}), {a['tokens_per_s']:.1f} "
        f"tokens/s over the run ({a['decode_tokens_per_s']:.1f} a decode step), peak "
        f"{peak / 1e9:.2f} GB, {a['distinct_tokens']} distinct tokens generated")
    if toks.shape != (DECODE_SERVE["requests"], DECODE_SERVE["gen_len"]):
        raise AssertionError(f"decode: launch.serve returned tokens of shape {toks.shape}")
    # one bfloat16 decode step under torch.profiler, in a process of its
    # own (a profiler session here would leave CUPTI missing kernels of
    # phase serve's profiled replays): launches or bytes?
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "profile_decode.py"),
                           "--batch", str(DECODE_SERVE["batch"]),
                           "--prompt", str(DECODE_SERVE["prompt_len"])],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"decode: tools/profile_decode.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  (a) one bfloat16 decode step under torch.profiler (tools/profile_decode.py): "
        f"{prof['events_ms']:.3f} ms events, device busy {prof['device_busy_ms']:.3f} ms, "
        f"{prof['kernels']} kernels; the weights' bytes (float32 read, bfloat16 written and "
        f"read) bound it at {prof['bytes_bound_ms']:.3f} ms; top operators by device time: "
        + ", ".join(f"{op['op']} {op['device_ms']:.3f} ms x{op['count']}"
                    for op in prof["top_ops"]))
    a["profile"] = prof
    a["teacher_forced"], a["bfloat16"], _ = _decode_checks(
        cfg, params, _decode_inputs(cfg, 2, DECODE_SERVE["prompt_len"] + DECODE_SERVE["gen_len"]),
        DECODE_SERVE["prompt_len"])
    a["served_tokens"] = _served_tokens_check(cfg, params, out, a["bfloat16"]["bound_rel"])
    a["s"] = time.perf_counter() - t0
    log(f"  (a) {cfg.name} took {a['s']:.1f} s")
    res[cfg.name] = a
    del params
    torch.cuda.empty_cache()

    # (b)-(f) each family and modality at full width
    for label, (arch, layers, s_p, n_dec, b_tf, train) in zip("bcdef", DECODE_CASES):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cut = ""
        if layers is not None and layers < cfg.num_layers:
            cut = f" (depth cut from {cfg.num_layers}: float32 weights must fit)"
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = init(torch.Generator(device="cuda").manual_seed(SEED + 31), cfg, device="cuda")
        n_params = sum(x.numel() for x in tree_leaves(params))
        log(f"phase decode: ({label}) {cfg.name}, {cfg.num_layers} layers{cut}, d_model "
            f"{cfg.d_model}, {n_params} float32 parameters; prefill {s_p}, decode {n_dec}")
        r = dict(layers=cfg.num_layers, full_layers=get_config(arch).num_layers, n_params=n_params)
        inputs = _decode_inputs(cfg, b_tf, s_p + n_dec + 1)
        f32, r["bfloat16"], cache = _decode_checks(cfg, params, inputs, s_p)
        r["teacher_forced" if cfg.moe is None else "float32"] = f32
        if cfg.moe is not None:
            # two identical decode steps on two copies of the cache: bitwise
            dec = make_decode_step(cfg, None, torch.bfloat16)
            pos = torch.full((b_tf,), s_p + n_dec - 1, dtype=torch.int32, device="cuda")
            tok = inputs["tokens"][:, -1:]
            outs = []
            for _ in range(2):
                c2 = {"layers": {k: v.clone() for k, v in cache["layers"].items()}}
                lg, c2 = dec(params, tok, c2, pos)
                outs.append((lg, c2))
            same = (torch.equal(outs[0][0].view(torch.int16), outs[1][0].view(torch.int16))
                    and all(torch.equal(outs[0][1]["layers"][k], outs[1][1]["layers"][k])
                            for k in cache["layers"]))
            finite = bool(torch.isfinite(outs[0][0]).all())
            log(f"  {cfg.name}: two identical bfloat16 decode steps "
                f"{'bitwise equal' if same else 'DIFFER'} (logits and caches), logits "
                f"{'finite' if finite else 'NOT FINITE'}")
            if not (same and finite):
                raise AssertionError(f"decode: {cfg.name}'s decode step does not repeat bitwise")
            r["repeat_bitwise"] = same
            del outs, c2
        del cache, inputs
        torch.cuda.empty_cache()
        if train is not None:
            r["train"] = _decode_train_step(cfg, *train, params)
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["s"] = time.perf_counter() - t0
        log(f"  ({label}) {cfg.name} took {r['s']:.1f} s, peak {r['peak_bytes'] / 1e9:.2f} GB")
        res[cfg.name] = r
        del params
        torch.cuda.empty_cache()

    counts = dict(ops.launches)
    res["launches"] = {k: v for k, v in counts.items() if v}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase decode: kernel launches {res['launches'] or 'none'}; took "
        f"{res['phase_s']:.1f} s")
    return counts, res


# phase distributed: ata 8192² over four ranks, gram_rowshard, colshard, PowerSGD
DIST_RANKS = 4
DIST_N = 8192
DIST_NB = 8                 # the pinned stripe grid: w = 1024, T = 36
DIST_MESHES = (((4,), ("model",)), ((2, 2), ("model", "data")))
# timed runs a case (after its checked run): the four ranks share card 0,
# so the times are time-sliced and one run says what three did
DIST_REPS = 1


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



# ---------------------------------------------------------------------------
# phase mesh: the sharding layer on four ranks
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# (a) ZeRO-1 training, qwen1.5-0.5b, global batch 4 × 2048 over data = 4
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 2048
# the loss and grad norm of step 1 against the single-rank step: phase
# train's float32 bounds
MESH_TRAIN_RTOL = TRAIN_F32_RTOL
# (b) hymba-1.5b at model = 4: forward (B, S), prefill S_p then 8 decode steps
MESH_HYB_BATCH, MESH_HYB_SEQ, MESH_HYB_PREFILL, MESH_HYB_STEPS = 1, 4096, 4088, 8
# (c) qwen2-moe-a2.7b at 2 × 2: 4 sequences, prefill 255 then one decode step
MESH_MOE_BATCH, MESH_MOE_SEQ = 4, 256
# meshed logits against one rank's: relative to the largest reference logit
MESH_LOGIT_RTOL = 1e-4
# (a)'s parameters after two steps against the single rank's: each leaf's
# distance over its update, normwise (tests/test_torch_mesh.py's bounds):
# 1e-3, and 1e-2 for the key bias, whose gradient is rounding noise that
# the data-parallel mean rounds differently and Adam's g / (|g| + eps)
# turns into steps of the step size's order
MESH_UPDATE_RTOL, MESH_UPDATE_BK_RTOL = 1e-3, 1e-2
MESH_CLI_STEPS = 3
# (e) qwen1.5-0.5b tensor-parallel at (1, 4): (a)'s batches and AdamW
# reference; a rank's parameter bytes at full depth over one rank's
MESH_TP_BYTES_SHARE = 0.27
# (f) one sequence at (2, 2), sharded over data: train 4096 tokens; prefill
# then decode with a cache of 1025 slots (model = 2 does not divide it)
MESH_B1_SEQ, MESH_B1_PREFILL, MESH_B1_STEPS = 4096, 1021, 4
# (g) qwen2-moe-a2.7b at (4, 1): 8 sequences of 256 routed over the global
# batch (one capacity)
MESH_C7_BATCH, MESH_C7_SEQ = 8, 256


def _mesh_shampoo():
    """Phase optim's Shampoo: p = 2, packed, block 1024, refresh every 2nd
    step, n_base pinned, ridge 1e-4."""
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.optim.shampoo import shampoo

    return shampoo(warmup_cosine(3e-4, 1, 100), block=1024, update_every=2, precond_p=2,
                   n_base=DEFAULT_N_BASE, precond_ridge=1e-4)


def _mesh_grads(params, seed: int, device):
    """Seeded float32 gradients shaped like ``params`` on ``device`` (the
    same on every rank and in the parent)."""
    import torch

    from repro_torch.optim._tree import tree_map

    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda p: torch.randn(p.shape, generator=gen, device=device) * 1e-3, params)


def _stat_hashes(state, ranks: int, rank=None):
    """sha256 of each Shampoo stat block (l, r, pl, pr): per data rank's
    slice of the block dim where ``ranks`` divides it (``rank`` None: every
    rank's slice from the whole stats), else of the whole stack."""
    import hashlib

    from repro_torch.optim._tree import tree_flatten_with_path

    out = {}
    for key, s in tree_flatten_with_path(state["shampoo"])[0]:
        if not any(key.endswith(f"['{k}']") for k in ("l", "r", "pl", "pr")):
            continue
        blocks = getattr(s, "blocks", s)
        nb = blocks.shape[0]
        if rank is None:
            full = blocks.shape[0]
            split = full % ranks == 0
            parts = ([blocks[i * full // ranks:(i + 1) * full // ranks] for i in range(ranks)]
                     if split else [blocks] * ranks)
            out[key] = [hashlib.sha256(p.contiguous().cpu().numpy().tobytes()).hexdigest()
                        for p in parts]
        else:
            out[key] = hashlib.sha256(blocks.contiguous().cpu().numpy().tobytes()).hexdigest()
    return out


def _update_rel(p0, got, want) -> dict:
    """Each parameter's distance from the single rank's after the same
    steps, over the single rank's update: ``|got - want| / |want - p0|``
    (Frobenius norms; 0 where both are equal)."""
    import torch

    from repro_torch.optim._tree import tree_flatten_with_path

    norm = torch.linalg.vector_norm
    out = {}
    for (k, a), (_, g), (_, w) in zip(*(tree_flatten_with_path(t)[0] for t in (p0, got, want))):
        diff = float(norm(g - w))
        out[k] = 0.0 if diff == 0 else diff / max(float(norm(w - a)), 1e-30)
    return out


def _crop_vocab(tree, like):
    """``tree`` with ``embed``'s rows and ``lm_head``'s columns cut to
    ``like``'s (the padded vocab of another mesh; the padding is zeros that
    no token reaches)."""
    out = dict(tree)
    out["embed"] = tree["embed"][:like["embed"].shape[0]]
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"][:, :like["lm_head"].shape[1]]
    return out


def _tree_bytes(tree) -> int:
    from repro_torch.optim._tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _state_bytes(tree) -> int:
    from repro_torch.optim._tree import tree_leaves

    return sum(getattr(x, "blocks", x).numel() * getattr(x, "blocks", x).element_size()
               for x in tree_leaves(tree) if hasattr(getattr(x, "blocks", x), "numel"))


def _mesh_depth(cfg, backend: str, **kw):
    """``cfg`` at full depth with a card a rank; on one card (gloo) the
    fewest layers that run every layer kind: ``kw`` (hymba's one global
    and one sliding-window layer), else one layer."""
    import dataclasses

    if backend == "nccl":
        return cfg
    return dataclasses.replace(cfg, **(kw or {"num_layers": 1}))


def _mesh_rank(rank: int, world: int, backend: str, ref_path: str) -> dict:
    """One rank of phase mesh: cases (a)-(c) on the meshes (4, 1), (1, 4)
    and (2, 2) of the same four ranks."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.collectives import all_gather_dim
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim._tree import tree_leaves
    from repro_torch.parallel.sharding import gather_tree, held, param_specs
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.train_step import (held_state_specs, init_state, loss_and_grads,
                                              make_loss_fn, make_train_step)

    dev = _dist_device(rank, backend)
    torch.cuda.set_device(dev)
    ref = torch.load(ref_path)
    out = dict(rank=rank, device=str(dev), cases={})
    path = {n: 0 for n in ops.launches}

    def counted(fn):
        """One run of the meshed main path: ``fn()``'s result, the kernel
        launches it made (the counts are set to 0 just before it and read
        just after, and added to the path's) and its collective bytes."""
        dist.barrier()
        torch.cuda.synchronize(dev)
        b0 = obs.metrics.counters("collective_bytes.")
        for n in ops.launches:
            ops.launches[n] = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launched = {n: v for n, v in ops.launches.items() if v}
        for n, v in launched.items():
            path[n] += v
        b1 = obs.metrics.counters("collective_bytes.")
        return res, dict(ms=ms, launches=launched,
                         bytes={k.split(".", 1)[1]: b1[k] - b0.get(k, 0) for k in b1
                                if b1[k] - b0.get(k, 0)})

    # (a) ZeRO-1 training at data = 4
    from repro_torch.configs.qwen15_05b import CONFIG as QWEN

    qcfg = _mesh_depth(QWEN, backend)
    mesh = make_mesh((4, 1), ("data", "model"), backend=backend, device=dev)
    shape = ShapeConfig("mesh_a", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, "train")
    data = SyntheticLM(qcfg, shape, seed=SEED)
    try:
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
                   for _ in range(2)]
    finally:
        data.close()
    params = T.init(torch.Generator(device=dev).manual_seed(SEED + 40), qcfg, mesh, device=dev)
    for name in ("adamw", "shampoo"):
        run = RunConfig(model=qcfg, shape=shape, compute_dtype="float32", remat="dots",
                        optimizer=OptimizerConfig(name=name))
        opt = _mesh_shampoo() if name == "shampoo" else None
        step, opt = make_train_step(qcfg, mesh, run, optimizer=opt)
        state = init_state(qcfg, mesh, run, opt, params)
        opt_bytes = _state_bytes(state["opt"])
        steps = []
        for i in range(2):
            obs.metrics.reset()
            (state, m), rec = counted(lambda: step(state, batches[i]))
            rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
            steps.append(rec)
        case = dict(steps=steps, opt_bytes=opt_bytes,
                    peak_bytes=torch.cuda.max_memory_allocated(dev))
        if rank == 0:
            # the parameters after both steps (the ZeRO-1 update of each
            # block, then the all-gather) against the single rank's
            want = torch.load(os.path.join(os.path.dirname(ref_path), f"params_{name}.pt"),
                              map_location=dev)
            case["update_rel"] = _update_rel(params, state["params"], want)
            del want
        out["cases"][f"a {name}"] = case
        del state, step
        torch.cuda.empty_cache()
    # the owned stats against the single rank's on the same gradients (a
    # check beside the path: its launches are not counted)
    opt = _mesh_shampoo()
    run = RunConfig(model=qcfg, shape=shape, optimizer=OptimizerConfig(name="shampoo"))
    specs = held_state_specs(qcfg, mesh, run, opt, params)["opt"]
    s_blk = init_state(qcfg, mesh, run, opt, params)["opt"]
    torch.cuda.empty_cache()
    for i in range(2):
        g = _mesh_grads(params, SEED + 41 + i, dev)
        _, s_blk = opt.update(g, s_blk, params, mesh=mesh, specs=specs)
        del g
    mine = _stat_hashes(s_blk, MESH_RANKS, rank=mesh.axis_index("data"))
    want = ref["stat_hashes"]
    out["owned_stats"] = dict(
        leaves=len(mine), bitwise=all(mine[k] == want[k][mesh.axis_index("data")]
                                      for k in want),
        owned_blocks={k: int(getattr(s, "blocks", s).shape[0]) for k, s in
                      __import__("repro_torch.optim._tree", fromlist=["x"])
                      .tree_flatten_with_path(s_blk["shampoo"])[0] if k.endswith("['l']")})
    del s_blk, params
    torch.cuda.empty_cache()

    # (e) qwen1.5-0.5b tensor-parallel at (1, 4): (a)'s batches, two AdamW
    # steps against (a)'s single rank
    mesh = make_mesh((1, 4), ("data", "model"), backend=backend, device=dev)
    params = T.init(torch.Generator(device=dev).manual_seed(SEED + 40), qcfg, mesh, device=dev)
    run = RunConfig(model=qcfg, shape=shape, compute_dtype="float32", remat="dots",
                    optimizer=OptimizerConfig(name="adamw"))
    step, opt = make_train_step(qcfg, mesh, run)
    state = init_state(qcfg, mesh, run, opt, params)
    p_specs = held(param_specs(mesh, qcfg), qcfg, mesh)
    res_e = dict(param_bytes=_tree_bytes(params), layers=qcfg.num_layers, steps=[])
    for i in range(2):
        obs.metrics.reset()
        (state, m), rec = counted(lambda: step(state, batches[i]))
        rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        res_e["steps"].append(rec)
    res_e["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    got = gather_tree(state["params"], mesh, p_specs)
    if rank == 0:
        want = torch.load(os.path.join(os.path.dirname(ref_path), "params_adamw.pt"),
                          map_location=dev)
        p0 = T.init(torch.Generator(device=dev).manual_seed(SEED + 40), qcfg, device=dev)
        res_e["update_rel"] = _update_rel(p0, _crop_vocab(got, want), want)
        del want, p0
    out["cases"]["e qwen tp 1x4"] = res_e
    del state, step, params, got, batches
    torch.cuda.empty_cache()

    # (b) hymba-1.5b at model = 4: context-parallel attention, the P-split SSD
    from repro_torch.configs.hymba_15b import CONFIG as HYMBA

    hcfg = _mesh_depth(HYMBA, backend, num_layers=2, global_attn_layers=(0,))
    mesh = make_mesh((1, 4), ("data", "model"), backend=backend, device=dev)
    params = T.init(torch.Generator(device=dev).manual_seed(SEED + 50), hcfg, mesh, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    toks = torch.randint(0, hcfg.vocab_size, (MESH_HYB_BATCH, MESH_HYB_SEQ + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    run = RunConfig(model=hcfg, shape=ShapeConfig("mesh_b", MESH_HYB_SEQ, MESH_HYB_BATCH,
                                                  "train"), compute_dtype="float32",
                    remat="dots")
    with torch.no_grad():
        (logits, _), rec_f = counted(lambda: T.forward_train(
            params, {"tokens": batch["tokens"]}, hcfg, mesh, compute_dtype=torch.float32))
    logits = T.gather_vocab(logits, hcfg, mesh, T.padded_vocab(hcfg, mesh))
    step, opt = make_train_step(hcfg, mesh, run)
    state = init_state(hcfg, mesh, run, opt, params)
    (state, m), rec_s = counted(lambda: step(state, batch))
    del state, step
    torch.cuda.empty_cache()
    prefill = make_prefill_step(hcfg, mesh, torch.float32, cache_len=MESH_HYB_SEQ)
    decode = make_decode_step(hcfg, mesh, torch.float32, sp_decode=True)

    def serve(prefill, decode):
        lg, cache = prefill(params, {"tokens": batch["tokens"][:, :MESH_HYB_PREFILL]})
        outs = [lg]
        for t in range(MESH_HYB_PREFILL, MESH_HYB_PREFILL + MESH_HYB_STEPS):
            pos = torch.full((MESH_HYB_BATCH,), t, dtype=torch.int32, device=dev)
            lg, cache = decode(params, batch["tokens"][:, t:t + 1], cache, pos)
            outs.append(lg)
        return torch.cat(outs, 1)

    dec, rec_d = counted(lambda: serve(prefill, decode))
    res_b = dict(forward=rec_f, step=rec_s, decode=rec_d, loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), layers=hcfg.num_layers)
    whole = gather_tree(params, mesh, held(param_specs(mesh, hcfg), hcfg, mesh))
    if rank == 0:
        # the same on this rank alone, on the blocks gathered
        params = whole
        with torch.no_grad():
            ref_logits, _ = T.forward_train(params, {"tokens": batch["tokens"]}, hcfg, None,
                                            compute_dtype=torch.float32)
        res_b["forward_max_rel"] = float((logits - ref_logits).abs().max()
                                         / ref_logits.abs().max())
        del logits, ref_logits
        torch.cuda.empty_cache()
        mr, g = loss_and_grads(make_loss_fn(hcfg, None, run), params, batch)
        res_b["loss_ref"] = float(mr["loss"])
        res_b["grad_norm_ref"] = float(torch.sqrt(sum(torch.sum(torch.square(x))
                                                      for x in tree_leaves(g))))
        del g
        torch.cuda.empty_cache()
        one = serve(make_prefill_step(hcfg, None, torch.float32, cache_len=MESH_HYB_SEQ),
                    make_decode_step(hcfg, None, torch.float32))
        res_b["decode_max_rel"] = float((dec - one).abs().max() / one.abs().max())
        res_b["decode_steps"] = MESH_HYB_STEPS
    out["cases"]["b hymba 1x4"] = res_b
    del params, dec, whole
    torch.cuda.empty_cache()

    # (c) qwen2-moe-a2.7b at 2 × 2: expert parallelism, 30 of the 60 experts a rank
    from repro_torch.configs.qwen2_moe_a27b import CONFIG as MOE

    mcfg = _mesh_depth(MOE, backend)
    mesh = make_mesh((2, 2), ("data", "model"), backend=backend, device=dev)
    params = T.init(torch.Generator(device=dev).manual_seed(SEED + 60), mcfg, mesh, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    toks = torch.randint(0, mcfg.vocab_size, (MESH_MOE_BATCH, MESH_MOE_SEQ), generator=gen,
                         device=dev, dtype=torch.int32)
    half = MESH_MOE_BATCH // 2
    mine = toks[mesh.axis_index("data") * half:(mesh.axis_index("data") + 1) * half]
    with torch.no_grad():
        (lg, aux), rec_f = counted(lambda: T.forward_train(
            params, {"tokens": mine}, mcfg, mesh, compute_dtype=torch.float32))
    prefill = make_prefill_step(mcfg, mesh, torch.float32, cache_len=MESH_MOE_SEQ)
    decode = make_decode_step(mcfg, mesh, torch.float32, sp_decode=True)

    def moe_serve(prefill, decode, p, t):
        l1, cache = prefill(p, {"tokens": t[:, :-1]})
        pos = torch.full((t.shape[0],), MESH_MOE_SEQ - 1, dtype=torch.int32, device=dev)
        l2, _ = decode(p, t[:, -1:], cache, pos)
        return torch.cat([l1, l2], 1)

    dec, rec_d = counted(lambda: moe_serve(prefill, decode, params, mine))
    lg = T.gather_vocab(lg, mcfg, mesh, T.padded_vocab(mcfg, mesh))
    lg_all = all_gather_dim(lg, mesh, "data", 0)
    dec_all = all_gather_dim(dec, mesh, "data", 0)
    p_specs = held(param_specs(mesh, mcfg), mcfg, mesh)
    full = gather_tree(params, mesh, p_specs)
    res_c = dict(forward=rec_f, decode=rec_d, aux=float(aux), layers=mcfg.num_layers,
                 experts_held=int(params["layers"]["moe"]["wg"].shape[1]),
                 experts_padded=int(full["layers"]["moe"]["wg"].shape[1]))
    del params
    torch.cuda.empty_cache()
    if rank == 0:
        # one rank, no mesh, on the padded weights, each data shard alone
        # (each routes with its own capacity)
        with torch.no_grad():
            outs = [T.forward_train(full, {"tokens": toks[i * half:(i + 1) * half]}, mcfg, None,
                                    compute_dtype=torch.float32) for i in range(2)]
        ref_lg = torch.cat([o[0] for o in outs])
        res_c["aux_ref"] = float(sum(o[1] for o in outs) / 2)
        res_c["forward_max_rel"] = float((lg_all - ref_lg).abs().max() / ref_lg.abs().max())
        del outs, ref_lg
        one = torch.cat([moe_serve(make_prefill_step(mcfg, None, torch.float32,
                                                     cache_len=MESH_MOE_SEQ),
                                   make_decode_step(mcfg, None, torch.float32), full,
                                   toks[i * half:(i + 1) * half]) for i in range(2)])
        res_c["decode_max_rel"] = float((dec_all - one).abs().max() / one.abs().max())
    out["cases"]["c qwen2-moe 2x2"] = res_c
    del full
    torch.cuda.empty_cache()

    # (f) one sequence at (2, 2): its train step (the sequence sharded over
    # data) and a decode with a cache of 1025 slots (whole: model = 2 does
    # not divide it; the batch whole on both data ranks), against one rank
    from repro_torch.configs.mamba2_13b import CONFIG as MAMBA

    mesh = make_mesh((2, 2), ("data", "model"), backend=backend, device=dev)
    for label, cfg_b in (("mamba2", _mesh_depth(MAMBA, backend, num_layers=2)),
                         ("hymba", _mesh_depth(HYMBA, backend, num_layers=2,
                                               global_attn_layers=(0,)))):
        params = T.init(torch.Generator(device=dev).manual_seed(SEED + 70), cfg_b, mesh,
                        device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 71)
        toks = torch.randint(0, cfg_b.vocab_size, (1, MESH_B1_SEQ + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        run = RunConfig(model=cfg_b, shape=ShapeConfig("mesh_f", MESH_B1_SEQ, 1, "train"),
                        compute_dtype="float32", remat="dots")
        step, opt = make_train_step(cfg_b, mesh, run)
        state = init_state(cfg_b, mesh, run, opt, params)
        (state, m), rec_s = counted(lambda: step(state, batch))
        del state, step
        cache_len = MESH_B1_PREFILL + MESH_B1_STEPS
        prompt = batch["tokens"][:, :MESH_B1_PREFILL]

        def serve1(p, msh):
            prefill = make_prefill_step(cfg_b, msh, torch.float32, cache_len=cache_len)
            decode = make_decode_step(cfg_b, msh, torch.float32, sp_decode=True,
                                      cache_len=cache_len)
            lg, cache = prefill(p, {"tokens": prompt})
            outs = [lg]
            for t in range(MESH_B1_PREFILL, cache_len):
                pos = torch.full((1,), t, dtype=torch.int32, device=dev)
                lg, cache = decode(p, batch["tokens"][:, t:t + 1], cache, pos)
                outs.append(lg)
            return torch.cat(outs, 1)

        dec, rec_d = counted(lambda: serve1(params, mesh))
        res_f = dict(step=rec_s, decode=rec_d, loss=float(m["loss"]),
                     grad_norm=float(m["grad_norm"]), layers=cfg_b.num_layers,
                     seq=MESH_B1_SEQ, cache_len=cache_len)
        whole = gather_tree(params, mesh, held(param_specs(mesh, cfg_b), cfg_b, mesh))
        del params
        torch.cuda.empty_cache()
        if rank == 0:
            mr, g = loss_and_grads(make_loss_fn(cfg_b, None, run), whole, batch)
            res_f["loss_ref"] = float(mr["loss"])
            res_f["grad_norm_ref"] = float(torch.sqrt(sum(torch.sum(torch.square(x))
                                                          for x in tree_leaves(g))))
            del g
            one = serve1(whole, None)
            res_f["decode_max_rel"] = float((dec - one).abs().max() / one.abs().max())
        out["cases"][f"f {label} batch 1 2x2"] = res_f
        del whole, dec
        torch.cuda.empty_cache()

    # (g) qwen2-moe-a2.7b at (4, 1): the global batch routed with one
    # capacity, against one rank on the global batch
    mcfg = _mesh_depth(MOE, backend)
    mesh = make_mesh((4, 1), ("data", "model"), backend=backend, device=dev)
    params = T.init(torch.Generator(device=dev).manual_seed(SEED + 80), mcfg, mesh, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    toks = torch.randint(0, mcfg.vocab_size, (MESH_C7_BATCH, MESH_C7_SEQ), generator=gen,
                         device=dev, dtype=torch.int32)
    n = MESH_C7_BATCH // 4
    mine = toks[mesh.axis_index("data") * n:(mesh.axis_index("data") + 1) * n]
    with torch.no_grad():
        (lg, aux), rec_f = counted(lambda: T.forward_train(
            params, {"tokens": mine}, mcfg, mesh, compute_dtype=torch.float32))
    lg_all = all_gather_dim(lg, mesh, "data", 0)
    res_g = dict(forward=rec_f, aux=float(aux), layers=mcfg.num_layers)
    if rank == 0:
        with torch.no_grad():
            ref_lg, ref_aux = T.forward_train(params, {"tokens": toks}, mcfg, None,
                                              compute_dtype=torch.float32)
            shard_lg = torch.cat([T.forward_train(params, {"tokens": toks[i * n:(i + 1) * n]},
                                                  mcfg, None, compute_dtype=torch.float32)[0]
                                  for i in range(4)])
        res_g["aux_ref"] = float(ref_aux)
        res_g["forward_max_rel"] = float((lg_all - ref_lg).abs().max() / ref_lg.abs().max())
        # the old rule (each data rank's own capacity) against the global one
        res_g["per_shard_max_rel"] = float((shard_lg - ref_lg).abs().max()
                                           / ref_lg.abs().max())
        del ref_lg, shard_lg
    out["cases"]["g qwen2-moe 4x1 global routing"] = res_g
    del params, lg_all
    torch.cuda.empty_cache()
    out["path_launches"] = path
    return out


# a served greedy token must be, under one rank's float32 forward over the
# same prompt and tokens, within this share of the largest |logit| of the
# position's maximum (an argmax may flip on a near tie: 32 random-weight
# layers amplify the 1e-6 differences of phase mesh (b))
MESH_SERVE_MARGIN = 1e-3


def _serve_margins(served) -> dict:
    """The meshed server's tokens held to one rank's float32
    ``forward_train`` of hymba-1.5b (the serve CLI's weights: seed 0; the
    padded vocab's rows are zeros, so they are one rank's weights) over its
    own prompts and tokens: each token's shortfall from the position's
    largest logit, over the largest |logit|."""
    import numpy as np
    import torch

    from repro_torch.configs.hymba_15b import CONFIG
    from repro_torch.models.transformer import forward_train, init

    prompts, toks = np.asarray(served["prompts"]), np.asarray(served["tokens"])
    params = init(torch.Generator(device="cuda").manual_seed(0), CONFIG, device="cuda")
    seq = torch.as_tensor(np.concatenate([prompts, toks[:, :-1]], 1), dtype=torch.int32,
                          device="cuda")
    with torch.no_grad():
        lg, _ = forward_train(params, {"tokens": seq}, CONFIG, compute_dtype=torch.float32)
    lg = lg[:, prompts.shape[1] - 1:].float()
    chosen = lg.gather(-1, torch.as_tensor(toks, device="cuda").long()[..., None])[..., 0]
    short = float((lg.amax(-1) - chosen).max() / lg.abs().max())
    argmax = float((lg.argmax(-1).cpu().numpy() == toks).mean())
    del params, lg
    torch.cuda.empty_cache()
    return dict(argmax_share=argmax, max_shortfall=short, margin=MESH_SERVE_MARGIN,
                ok=short <= MESH_SERVE_MARGIN)


def _mesh_cli(args, label, timeout=900):
    import time

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"mesh: {label} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc, secs


def phase_mesh(ops):
    """Phase 16: the sharding layer on four ranks (see the module
    docstring). Returns (launches on the meshed path, summed over the
    ranks, results)."""
    import tempfile
    import time

    import torch

    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG as QWEN
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_leaves, tree_map
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    backend = "nccl" if count >= MESH_RANKS else "gloo"
    where = ("one card per rank, full depth" if backend == "nccl" else
             f"{MESH_RANKS} ranks on card 0, time-sliced (times are not per-card times); "
             "the fewest layers that run every layer kind: qwen1.5-0.5b and "
             "qwen2-moe-a2.7b 1 layer (the train CLI too, through --layers), hymba-1.5b 2 "
             "(one global, one sliding-window); the serve CLI at full depth")
    log(f"phase mesh: backend {backend}, {MESH_RANKS} ranks, {where}")
    res = dict(backend=backend, ranks=MESH_RANKS)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    failed = []
    try:
        # (a)'s single-rank references on card 0: two steps of each
        # optimizer (loss, grad norm, the parameters after them), and
        # Shampoo's stats after two updates on seeded gradients
        t0 = time.perf_counter()
        qcfg = _mesh_depth(QWEN, backend)
        shape = ShapeConfig("mesh_a", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, "train")
        data = SyntheticLM(qcfg, shape, seed=SEED)
        try:
            batches = [{k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
                       for _ in range(2)]
        finally:
            data.close()
        params = init(torch.Generator(device="cuda").manual_seed(SEED + 40), qcfg,
                      device="cuda")
        ref = {}
        for name in ("adamw", "shampoo"):
            run = RunConfig(model=qcfg, shape=shape, compute_dtype="float32", remat="dots",
                            optimizer=OptimizerConfig(name=name))
            step, opt = make_train_step(qcfg, None, run,
                                        optimizer=_mesh_shampoo() if name == "shampoo" else None)
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            ref[f"opt_bytes_{name}"] = _state_bytes(state["opt"])
            ref[name] = []
            for b in batches:
                state, m = step(state, b)
                ref[name].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
            torch.save(tree_map(lambda x: x.cpu(), state["params"]),
                       os.path.join(tmp, f"params_{name}.pt"))
            del state, step, m
            torch.cuda.empty_cache()
        del batches
        opt = _mesh_shampoo()
        state = opt.init(params)
        for i in range(2):
            g = _mesh_grads(params, SEED + 41 + i, "cuda")
            _, state = opt.update(g, state, params)
            del g
        ref["stat_hashes"] = _stat_hashes(state, MESH_RANKS)
        del state, params
        torch.cuda.empty_cache()
        log(f"  (a) single-rank references ({time.perf_counter() - t0:.1f} s): AdamW "
            f"{ref['adamw']}, Shampoo {ref['shampoo']}; optimizer state bytes AdamW "
            f"{ref['opt_bytes_adamw']}, Shampoo {ref['opt_bytes_shampoo']}")
        path = os.path.join(tmp, "ref.pt")
        torch.save(ref, path)
        # the ranks share one card under gloo: keep their caches from
        # fragmenting it (their environment only)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        ranks = spawn(_mesh_rank, MESH_RANKS, backend=backend, timeout_s=900.0,
                      args=(backend, path))
        res["spawn_s"] = time.perf_counter() - t0
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  ranks (a)-(c): {res['spawn_s']:.1f} s")

    # (a)
    for name in ("adamw", "shampoo"):
        per = [r["cases"][f"a {name}"] for r in ranks]
        rel = [dict(loss_rel=abs(s["loss"] - w["loss"]) / abs(w["loss"]),
                    grad_norm_rel=abs(s["grad_norm"] - w["grad_norm"]) / w["grad_norm"])
               for s, w in zip(per[0]["steps"], ref[name])]
        upd = per[0]["update_rel"]
        worst = {k: v for k, v in upd.items() if v > 0.1 * MESH_UPDATE_RTOL}
        bad_upd = {k: v for k, v in upd.items()
                   if v > (MESH_UPDATE_BK_RTOL if k.endswith("['bk']") else MESH_UPDATE_RTOL)}
        ok = not bad_upd and all(r["loss_rel"] <= MESH_TRAIN_RTOL[0]
                                 and r["grad_norm_rel"] <= MESH_TRAIN_RTOL[1] for r in rel)
        line = dict(step_ms=[[round(s["ms"], 1) for s in c["steps"]] for c in per],
                    losses=[s["loss"] for s in per[0]["steps"]], rel=rel,
                    update_rel_max=max(upd.values()), update_rel_over_tenth_bound=worst,
                    opt_bytes=[c["opt_bytes"] for c in per],
                    opt_bytes_single=ref[f"opt_bytes_{name}"],
                    opt_share=max(c["opt_bytes"] for c in per) / ref[f"opt_bytes_{name}"],
                    collective_bytes=[s["bytes"] for s in per[0]["steps"]],
                    peak_bytes=[c["peak_bytes"] for c in per],
                    launches=[[s["launches"] for s in c["steps"]] for c in per])
        log(f"  (a) ZeRO-1 {name} at 4x1, steps 1-2 against the single rank's: "
            + json.dumps(line) + (" ok" if ok else " FAIL"))
        res[f"a {name}"] = line
        if not ok:
            failed.append(f"(a) {name}: off the single rank's ({rel}, parameters {bad_upd})")
        if name == "shampoo":
            for r, c in zip(ranks, per):
                if not c["steps"][0]["launches"].get("syrk"):
                    failed.append(f"(a) rank {r['rank']} launched no syrk")
                refresh = c["steps"][1]["launches"]
                if not (refresh.get("potrf") and refresh.get("trsm")):
                    failed.append(f"(a) rank {r['rank']}'s refresh launched {refresh}")
    owned = [r["owned_stats"] for r in ranks]
    log("  (a) Shampoo owned stats against the single rank's on the same gradients: "
        + json.dumps(dict(bitwise=[o["bitwise"] for o in owned], leaves=owned[0]["leaves"],
                          blocks_owned=owned[0]["owned_blocks"])))
    res["a owned stats"] = owned[0]
    if not all(o["bitwise"] for o in owned):
        failed.append("(a) owned stats differ from the single rank's")
    # (b), (c)
    for label, keys in (("b hymba 1x4", ("forward_max_rel", "decode_max_rel")),
                        ("c qwen2-moe 2x2", ("forward_max_rel", "decode_max_rel"))):
        c0 = ranks[0]["cases"][label]
        line = {k: v for k, v in c0.items() if not isinstance(v, dict)}
        line.update({k: dict(ms=[round(r["cases"][label][k]["ms"], 1) for r in ranks],
                             bytes=c0[k]["bytes"]) for k, v in c0.items() if isinstance(v, dict)})
        bad = [k for k in keys if not c0[k] <= MESH_LOGIT_RTOL]
        if label.startswith("b"):
            loss_rel = abs(c0["loss"] - c0["loss_ref"]) / abs(c0["loss_ref"])
            gn_rel = abs(c0["grad_norm"] - c0["grad_norm_ref"]) / c0["grad_norm_ref"]
            line.update(loss_rel=loss_rel, grad_norm_rel=gn_rel)
            if not (loss_rel <= MESH_TRAIN_RTOL[0] and gn_rel <= MESH_TRAIN_RTOL[1]):
                bad.append("loss or grad norm")
        else:
            if not abs(c0["aux"] - c0["aux_ref"]) <= MESH_LOGIT_RTOL * abs(c0["aux_ref"]):
                bad.append("aux")
            if c0["experts_held"] * 2 != c0["experts_padded"]:
                bad.append("experts_held")
        log(f"  ({label}): " + json.dumps(line, default=str) + (" FAIL" if bad else " ok"))
        res[label] = line
        if bad:
            failed.append(f"({label}) off one rank's: {bad}")

    # (e) qwen1.5-0.5b tensor-parallel at (1, 4)
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.sharding import held, param_specs, spec_leaves

    per = [r["cases"]["e qwen tp 1x4"] for r in ranks]
    e0 = per[0]
    rel = [dict(loss_rel=abs(s["loss"] - w["loss"]) / abs(w["loss"]),
                grad_norm_rel=abs(s["grad_norm"] - w["grad_norm"]) / w["grad_norm"])
           for s, w in zip(e0["steps"], ref["adamw"])]
    upd = e0["update_rel"]
    bad_upd = {k: v for k, v in upd.items()
               if v > (MESH_UPDATE_BK_RTOL if k.endswith("['bk']") else MESH_UPDATE_RTOL)}
    one_bytes = _tree_bytes(init(None, qcfg, device="meta")) // 1
    four = AbstractMesh((1, 4), ("data", "model"))
    full_leaves = [x for x in tree_leaves(init(None, QWEN, four, device="meta"))]
    full_one = sum(x.numel() for x in tree_leaves(init(None, QWEN, device="meta")))
    full_mine = sum(x.numel() // math.prod(four.axis_size(a) for a in sp if a is not None)
                    for x, sp in zip(full_leaves,
                                     spec_leaves(held(param_specs(four, QWEN), QWEN, four))))
    share = full_mine / full_one
    line = dict(layers=e0["layers"], step_ms=[[round(st["ms"], 1) for st in c["steps"]]
                                              for c in per],
                losses=[st["loss"] for st in e0["steps"]], rel=rel,
                update_rel_max=max(upd.values()),
                param_bytes_rank=[c["param_bytes"] for c in per],
                param_bytes_single=one_bytes,
                param_share=max(c["param_bytes"] for c in per) / one_bytes,
                param_share_full_depth=share,
                collective_bytes_a_step=[st["bytes"] for st in e0["steps"]],
                peak_bytes=[c["peak_bytes"] for c in per])
    ok = (not bad_upd and share <= MESH_TP_BYTES_SHARE
          and all(r["loss_rel"] <= MESH_TRAIN_RTOL[0]
                  and r["grad_norm_rel"] <= MESH_TRAIN_RTOL[1] for r in rel))
    log("  (e) qwen1.5-0.5b tensor-parallel at 1x4, AdamW steps 1-2 against (a)'s single "
        "rank: " + json.dumps(line) + (" ok" if ok else " FAIL"))
    res["e qwen tp 1x4"] = line
    if not ok:
        failed.append(f"(e) off the single rank's ({rel}, parameters {bad_upd}, share {share})")
    # (f) one sequence at (2, 2); (g) the MoE's global routing at (4, 1)
    for label in ("f mamba2 batch 1 2x2", "f hymba batch 1 2x2"):
        c0 = ranks[0]["cases"][label]
        loss_rel = abs(c0["loss"] - c0["loss_ref"]) / abs(c0["loss_ref"])
        gn_rel = abs(c0["grad_norm"] - c0["grad_norm_ref"]) / c0["grad_norm_ref"]
        line = {k: v for k, v in c0.items() if not isinstance(v, dict)}
        line.update(loss_rel=loss_rel, grad_norm_rel=gn_rel,
                    step=dict(ms=[round(r["cases"][label]["step"]["ms"], 1) for r in ranks],
                              bytes=c0["step"]["bytes"]),
                    decode=dict(ms=[round(r["cases"][label]["decode"]["ms"], 1) for r in ranks],
                                bytes=c0["decode"]["bytes"]))
        bad = not (loss_rel <= MESH_TRAIN_RTOL[0] and gn_rel <= MESH_TRAIN_RTOL[1]
                   and c0["decode_max_rel"] <= MESH_LOGIT_RTOL)
        log(f"  ({label}): " + json.dumps(line) + (" FAIL" if bad else " ok"))
        res[label] = line
        if bad:
            failed.append(f"({label}) off one rank's")
    c0 = ranks[0]["cases"]["g qwen2-moe 4x1 global routing"]
    line = dict(c0, forward=dict(ms=[round(r["cases"]["g qwen2-moe 4x1 global routing"]
                                           ["forward"]["ms"], 1) for r in ranks],
                                 bytes=c0["forward"]["bytes"]))
    bad = not (c0["forward_max_rel"] <= MESH_LOGIT_RTOL
               and abs(c0["aux"] - c0["aux_ref"]) <= MESH_LOGIT_RTOL * abs(c0["aux_ref"]))
    log("  (g qwen2-moe 4x1 global routing) against one rank on the global batch (and the "
        "old per-shard routing's distance from it): " + json.dumps(line)
        + (" FAIL" if bad else " ok"))
    res["g qwen2-moe 4x1"] = line
    if bad:
        failed.append("(g) the global routing is off one rank's")

    # (d) the CLIs: 3 steps at 2x2, checkpointed at step 2 (the unbroken
    # run), then step 3 again at 4x1 from that checkpoint; the serve CLI
    # at 1x4 beside them (the train CLIs' time is their checkpoints' I/O)
    serve_args = ["repro_torch.launch.serve", "--arch", "hymba-1.5b", "--requests", "4",
                  "--batch", "4", "--prompt-len", "32", "--gen-len", "4", "--temperature", "0",
                  "--compute-dtype", "float32"]
    o = os.path.join(ROOT, "build", "mesh_serve.json")
    serve_cli = Background(lambda: _mesh_cli(serve_args + ["--mesh", "1x4", "--out", o],
                                             "serve --mesh 1x4"))
    out = os.path.join(ROOT, "build", "mesh_cli")
    shutil.rmtree(out, ignore_errors=True)
    layers = QWEN.num_layers if backend == "nccl" else 1
    base = ["repro_torch.launch.train", "--arch", "qwen1.5-0.5b", "--batch", "4", "--seq", "256",
            "--log-every", "1", "--save-every", str(MESH_CLI_STEPS - 1), "--steps",
            str(MESH_CLI_STEPS), "--layers", str(layers), "--out", out]
    try:
        procs = []
        for m, label in (("2x2", "train --mesh 2x2"), ("4x1", "train --mesh 4x1 resumed")):
            procs.append(_mesh_cli(base + ["--mesh", m], label))
            log(f"  (d) {label}: {procs[-1][1]:.1f} s; " + " | ".join(
                line for line in procs[-1][0].stdout.splitlines()))
        (_, s1), (proc, s2) = procs
        if f"resumed from checkpoint step {MESH_CLI_STEPS - 1}" not in proc.stdout:
            failed.append(f"(d) the 4x1 run did not resume from step {MESH_CLI_STEPS - 1}")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        a, b = recs[-1], recs[-2]
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        res["d train"] = dict(seconds=[s1, s2], steps=[r["step"] for r in recs],
                              resumed_loss=a["loss"], unbroken_loss=b["loss"], loss_rel=rel)
        ok = a["step"] == b["step"] == MESH_CLI_STEPS and rel <= TRAIN_BF16_RTOL
        log(f"  (d) train CLI qwen1.5-0.5b ({layers} of 24 layers, bfloat16 compute, the CLI's "
            "default): "
            f"{MESH_CLI_STEPS} steps at 2x2 saving step {MESH_CLI_STEPS - 1}, step "
            f"{MESH_CLI_STEPS} again at 4x1 from it: " + json.dumps(res["d train"])
            + (" ok" if ok else " FAIL"))
        if not ok:
            failed.append("(d) the resumed step is off the unbroken run's")
    finally:
        shutil.rmtree(out, ignore_errors=True)
        _, secs = serve_cli.result()
    with open(o) as f:
        served = json.load(f)
    os.remove(o)
    res["d serve"] = dict(_serve_margins(served), seconds=secs)
    log("  (d) serve CLI hymba-1.5b (32 layers) --mesh 1x4 (beside the train CLIs), greedy "
        "float32, against one rank's float32 forward: " + json.dumps(res["d serve"]))
    if not res["d serve"]["ok"]:
        failed.append("(d) the 1x4 server's tokens are not float32's greedy choices")

    launches = {n: sum(r["path_launches"][n] for r in ranks) for n in ranks[0]["path_launches"]}
    log(f"  launches on the meshed path, summed over the ranks: {launches}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase mesh took {res['phase_s']:.1f} s")
    if failed:
        raise AssertionError("mesh: " + "; ".join(failed))
    return launches, res


# ---------------------------------------------------------------------------
# phase serve: the serving layer (repro_torch.serve) on the card
# ---------------------------------------------------------------------------

# (b)'s lattice: lstsq at n ∈ {256, 512} over m bands {512, 8192} and r bands
# {8, 64} (r = 1 added: the card's rule makes every bucket of n ≥ 256 exact in
# r — n spans two packed blocks or more —, so a vector right-hand side needs a
# bucket of its own), and whiten at qwen1.5-0.5b's Shampoo block n = 1024
# (phase optim); 256 requests.
SERVE_LSTSQ = dict(ops=("lstsq",), n_values=(256, 512), m_bands=(512, 8192),
                   r_bands=(1, 8, 64), batch=8)
SERVE_WHITEN = dict(ops=("whiten",), n_values=(1024,), m_bands=(4096,), r_bands=(64,),
                    batch=4)
SERVE_REQUESTS = 256
SERVE_RIDGES = (0.0, 1e-3, 1e-2)


def serve_one(op, a, b, twin, ridge=0.0):
    """One request solved alone under its twin plan: ``lstsq``, or the
    whiten pipeline (the reference's ``_whiten_ref``: the ridge always
    added)."""
    import dataclasses

    import torch

    from repro_torch.core.ata import ata
    from repro_torch.solve import cholesky, lstsq, solve_triangular

    if op == "lstsq":
        return lstsq(a, b, ridge=ridge, plan=twin)
    ata_plan = dataclasses.replace(twin, op="ata", k=twin.n, out="packed", method=None,
                                   predicted_s=None)
    gram = ata(a.to(torch.float32), plan=ata_plan, out="packed",
               packed_block=twin.packed_block).add_scaled_identity(ridge)
    return solve_triangular(cholesky(gram, plan=twin), b.to(torch.float32), transpose=False,
                            plan=twin)


def serve_twin(server, ticket):
    """The per-request twin of one served ticket on the server's device,
    as numpy."""
    import torch

    req = ticket.request
    a = torch.as_tensor(req.a, device=server.device)
    b = torch.as_tensor(req.b, device=server.device)
    twin = server.request_twin(ticket.bucket, a.shape[0], 1 if b.ndim == 1 else b.shape[-1])
    return serve_one(req.op, a, b, twin, req.ridge).cpu().numpy()


def serve_check_twins(server, served):
    """Every served slice bitwise (by bit pattern, so a NaN of the same
    bits is equal) against its twin; returns the failures."""
    import numpy as np

    bad = []
    for t in served:
        got, ref = np.asarray(t.result()), serve_twin(server, t)
        if got.shape != ref.shape or got.dtype != ref.dtype or got.tobytes() != ref.tobytes():
            bad.append(f"ticket {t.id} {t.bucket.label()} m={t.request.a.shape[0]} "
                       f"max|d|={float(np.abs(got - ref).max()) if got.shape == ref.shape else 'shape'}")
    return bad


def serve_float64(ticket) -> dict:
    """One served ticket against float64 on the host: the forward relative
    error, its bound, the backward error, its bound, κ, and whether the
    result is finite. lstsq: ``x`` against the
    ridge normal equations' solution, the backward error
    ``‖Gx − Aᵀb‖ / (‖G‖‖x‖ + ‖Aᵀb‖)``; whiten: ``z`` against ``L⁻¹v``, L
    the float64 Cholesky factor of ``AᵀA + λI``, the backward error
    ``‖Lz − v‖ / (‖L‖‖z‖ + ‖v‖``). The backward bound ``(m + n)·eps32`` is
    the gram's and the solves' rounding; the forward bound scales it by
    twice κ, the condition number of the matrix the request inverts (G, or
    L for whiten), and is never below 1e-3. A forward bound of 1 or more
    says float32 cannot promise a digit of the answer: there a non-finite
    result (float32 Cholesky breaking down, as the twin's does) passes
    (:func:`serve_float64_ok`)."""
    import numpy as np

    req = ticket.request
    a = req.a.astype(np.float64)
    m, n = a.shape
    g = a.T @ a + req.ridge * np.eye(n)
    w = np.linalg.eigvalsh(g)
    v = req.b.astype(np.float64)
    got = np.asarray(ticket.result(), np.float64)
    if req.op == "lstsq":
        mat, rhs, norm, kappa = g, a.T @ v, w[-1], w[-1] / w[0]
    else:
        mat, rhs = np.linalg.cholesky(g), v
        norm, kappa = math.sqrt(w[-1]), math.sqrt(w[-1] / w[0])
    want = np.linalg.solve(mat, rhs)
    fwd = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    bwd = float(np.linalg.norm(mat @ got - rhs)
                / (norm * np.linalg.norm(got) + np.linalg.norm(rhs)))
    bwd_bound = (m + n) * EPS32
    return dict(bucket=ticket.bucket.label(), m=m, ridge=req.ridge, kappa=float(kappa),
                finite=bool(np.isfinite(got).all()), forward=fwd,
                forward_bound=max(1e-3, 2 * kappa * bwd_bound), backward=bwd,
                backward_bound=bwd_bound)


def serve_float64_ok(d) -> bool:
    if not d["finite"]:
        return d["forward_bound"] >= 1
    return d["forward"] <= d["forward_bound"] and d["backward"] <= d["backward_bound"]


def admitted_shapes(specs) -> int:
    """How many request shapes ``(op, n, dtype, m, r)`` some bucket of
    ``specs`` admits (m from 1 to the largest capacity, r likewise)."""
    groups = {}
    for s in specs:
        groups.setdefault((s.op, s.n, s.dtype), []).append(s)
    total = 0
    for group in groups.values():
        for m in range(1, max(s.m for s in group) + 1):
            rs = set()
            for s in group:
                if m == s.m if s.exact_m else m <= s.m:
                    rs |= {s.r} if s.exact_r else set(range(1, s.r + 1))
            total += len(rs)
    return total


def serve_requests(lattice, rng, count):
    """(b)'s workload: buckets drawn uniformly, ragged m and r inside each
    band where the bucket bands them (``m = spec.m`` where it is exact_m,
    ``r = spec.r`` where exact_r), a quarter of the requests with a vector
    right-hand side (routed to r = 1 buckets), ridges from
    ``SERVE_RIDGES``."""
    from repro_torch.serve.__main__ import _make_request

    specs = lattice.specs
    reqs = []
    for i in range(count):
        vector = i % 4 == 3
        pool = [s for s in specs if s.r == 1 or not s.exact_r] if vector else \
            [s for s in specs if s.r > 1]
        s = pool[int(rng.integers(len(pool)))]
        lower = max([t.m for t in specs if (t.op, t.n) == (s.op, s.n) and t.m < s.m],
                    default=s.n - 1)
        m = s.m if s.exact_m else int(rng.integers(lower + 1, s.m + 1))
        r = 0 if vector else (s.r if s.exact_r else int(rng.integers(1, s.r + 1)))
        ridge = SERVE_RIDGES[int(rng.integers(len(SERVE_RIDGES)))]
        reqs.append(_make_request(rng, s.op, m, s.n, r, ridge))
    return reqs


def flush_bound(spec):
    """(ms, by) of one flush of ``spec`` on an H100: the gram (symmetric),
    the factor (unblocked count), ``Aᵀb`` and the substitutions, each
    entry's inputs read and its output written once."""
    from repro_torch.core.reference import (classical_gemm_flops, classical_syrk_flops,
                                            potrf_flops, trsm_flops)

    m, n, r, B = spec.m, spec.n, spec.r, spec.batch
    flops = classical_syrk_flops(m, n) + potrf_flops(n)
    if spec.op == "lstsq":
        flops += classical_gemm_flops(m, n, r) + 2 * trsm_flops(n, r)
        rows = m
    else:
        flops += trsm_flops(n, r)
        rows = n
    return bound(B * flops, 4 * B * (m * n + rows * r + 1 + n * r))


def serve_yardstick(spec, a, b, ridge):
    """The library computing one flush — never called by the port: batched
    ``aᵀa + λI`` and ``torch.linalg.cholesky_ex``, then
    ``torch.cholesky_solve`` (lstsq) or ``torch.linalg.solve_triangular``
    (whiten), on the padded batch. Returns (CUDA-event ms, device ms in a
    CUDA graph): ``cholesky_solve`` cannot be captured (MAGMA's batched
    ``potrs`` allocates), so the graph runs its two triangular solves with
    ``torch.linalg.solve_triangular`` instead."""
    import torch

    eye = torch.eye(spec.n, device="cuda")

    def factor():
        return torch.linalg.cholesky_ex(a.mT @ a + ridge.reshape(-1, 1, 1) * eye).L

    def lib():
        low = factor()
        if spec.op == "lstsq":
            return torch.cholesky_solve(a.mT @ b, low)
        return torch.linalg.solve_triangular(low, b, upper=False)

    def lib_capturable():
        low = factor()
        if spec.op == "lstsq":
            y = torch.linalg.solve_triangular(low, a.mT @ b, upper=False)
            return torch.linalg.solve_triangular(low.mT, y, upper=True)
        return torch.linalg.solve_triangular(low, b, upper=False)

    return time_ms(lib), graph_ms(lib_capturable, launches=10)


# seconds of idle card at each end of a profiled window (serve_profile)
PROFILE_PAD_S = 0.05
# kernel -> the names its launches take in a profile (gemm_tn's are the
# tile engine's or, for k ≤ 64, the narrow-output kernel's in float32, the
# tensor-core kernel's in bfloat16)
SERVE_PROFILED = {"syrk": ("syrk_kernel",), "potrf": ("potrf_kernel",), "trsm": ("trsm_kernel",),
                  "gemm_tn": ("gemm_tn_kernel", "gemm_tn_narrow_kernel", "gemm_tn_wgmma_kernel")}


def serve_profile(program):
    """Kernel names and counts of one replay of ``program``'s graph, from a
    ``torch.profiler`` trace of the card (CUPTI).

    The trace keeps only device activity whose timestamps, converted to the
    host's clock, fall inside its window; a replay launched the moment the
    window opens can lose its first kernels that way. So the replay starts
    ``PROFILE_PAD_S`` after the window opens and the window closes
    ``PROFILE_PAD_S`` after the replay has finished."""
    import collections
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        program._graph.replay()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    names = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            names[ev.name] += 1
    return names


def phase_serve(ops):
    """Phase 12: the serving layer (see the module docstring). Returns
    (launches of (b)'s warm, launches of (b)'s workload — each bucket's
    replays times the launches its capture recorded —, the largest
    bucket's launches per flush, results)."""
    import time

    import numpy as np
    import torch

    from repro_torch.serve import metrics as serve_metrics
    from repro_torch.serve.__main__ import _mixed_workload, _refused_by_rule, _run_workload
    from repro_torch.serve.bucketing import make_buckets
    from repro_torch.serve.engine import Server, ServeConfig, smoke_config

    t_phase = time.perf_counter()
    log("phase serve")
    res = {}
    failed = []

    # (a) the smoke lattice under the card's rule, the CLI's mixed workload
    server = Server(smoke_config())
    server.warm()
    reqs = list(_mixed_workload(100, SEED))
    served, rejected = _run_workload(server, reqs)
    refused = _refused_by_rule(server, reqs)
    bad = serve_check_twins(server, served)
    res["smoke"] = dict(buckets=[s.label() for s in server.buckets], served=len(served),
                        rejected=rejected, refused_by_card_rule=refused,
                        recaptures=server.retraces(), twin_mismatches=len(bad))
    log(f"  (a) smoke ({time.perf_counter() - t_phase:.1f} s): " + json.dumps(res["smoke"]))
    failed += bad[:5]
    if server.retraces() or not all(t.done() for t in served) or not served:
        failed.append("smoke: recaptures, unserved tickets or nothing served")
    if refused:
        failed.append(f"smoke: the card's rule refused {refused} requests the reference admits")
    del server
    torch.cuda.empty_cache()

    # (b) the lattice at the sizes users serve; the server adds the card's rule
    buckets = make_buckets(**SERVE_LSTSQ) + make_buckets(**SERVE_WHITEN)
    cfg = ServeConfig(buckets=buckets, capacity=2 * SERVE_REQUESTS, max_wait_s=0.005)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ops.reset_launches()
    server = Server(cfg)
    warm = server.warm()
    warm_counts = dict(ops.launches)
    held = torch.cuda.memory_allocated() - mem0
    peak = torch.cuda.max_memory_allocated() - mem0
    shapes_ref, shapes_card = admitted_shapes(buckets), admitted_shapes(server.buckets)
    rng = np.random.default_rng(SEED + 12)
    reqs = serve_requests(server.lattice, rng, SERVE_REQUESTS)
    serve_metrics.reset()
    t0 = time.perf_counter()
    served, rejected = _run_workload(server, reqs)
    wall = time.perf_counter() - t0
    workload_counts = {k: 0 for k in ops.launches}
    for spec in server.buckets:
        fn, _ = server.bucket_callable(spec)
        for k, v in fn.capture_launches.items():
            workload_counts[k] += v * fn.replays
    log(f"  (b) {len(buckets)} buckets warmed in {sum(warm.values()):.2f} s; "
        f"{len(served)} served, {rejected} rejected in {wall:.3f} s "
        f"({len(served) / wall:.1f} requests/s); recaptures {server.retraces()}; "
        f"graphs and buffers held {held} B, warm peak {peak} B; launches of warm "
        f"{warm_counts}, replayed by the workload {workload_counts}; the card's rule admits "
        f"{shapes_card} of the reference lattice's {shapes_ref} request shapes "
        f"({shapes_card / shapes_ref:.4%}): " + ", ".join(s.label() for s in server.buckets))
    if rejected or server.retraces() or not all(t.done() for t in served):
        failed.append(f"(b): {rejected} rejected, {server.retraces()} recaptures")
    if dict(ops.launches) != warm_counts:
        failed.append(f"(b): the workload launched kernels outside the graphs: {ops.launches}")
    bad = serve_check_twins(server, served)
    log(f"  (b) every served slice against its twin: {len(served) - len(bad)} of "
        f"{len(served)} bitwise")
    failed += bad[:5]
    # two requests of every bucket, and every non-finite result, against
    # float64 (serve_float64)
    picked = [t for spec in server.buckets for t in [t for t in served if t.bucket == spec][:2]]
    nonfinite = [t for t in served if not np.isfinite(t.result()).all()]
    sample = [serve_float64(t) for t in picked + [t for t in nonfinite if t not in picked]]
    failed += [f"(b) float64: {d}" for d in sample if not serve_float64_ok(d)]
    log(f"  (b) {len(sample)} requests against float64 ({len(nonfinite)} served results not "
        "finite): " + json.dumps(sample))
    if len({t.bucket for t in picked}) != len(server.buckets):
        failed.append("(b) float64: a bucket served nothing to sample")
    lat = serve_metrics.percentiles("request")
    res["lattice"] = dict(buckets=[s.label() for s in server.buckets], served=len(served),
                          rejected=rejected, recaptures=server.retraces(), wall_s=wall,
                          requests_per_s=len(served) / wall,
                          latency_ms={k: lat[k] * 1e3 for k in ("p50", "p95", "p99")},
                          held_bytes=held, warm_peak_bytes=peak, warm_launches=warm_counts,
                          workload_launches=workload_counts,
                          admitted_shapes=dict(card=shapes_card, reference=shapes_ref),
                          non_finite=len(nonfinite),
                          float64_max_backward=max(d["backward"] for d in sample if d["finite"]))

    # (c) and (d) per bucket: the replay profiled, its launches, the readings
    per = {}
    names_seen = set()
    for spec in server.buckets:
        fn, sp = server.bucket_callable(spec)
        a, b, ridge = fn._inputs()
        names = serve_profile(fn)
        launched = {k: sum(v for name, v in names.items() if any(p in name for p in kernel_names))
                    for k, kernel_names in SERVE_PROFILED.items()}
        names_seen |= {k for k, v in launched.items() if v}
        if launched != {k: fn.capture_launches[k] for k in launched}:
            failed.append(f"{spec.label()}: profiled replay {launched} != capture "
                          f"{fn.capture_launches}")
        replay_ms = time_ms(fn._graph.replay, runs=10)
        eager_ms = time_ms(lambda: fn.run(a, b, ridge), runs=5)
        # B per-request lstsq calls on the batch's slices (what batching saves)
        twin = server.request_twin(spec, spec.m, spec.r)
        loop_ms = time_ms(lambda: [serve_one(spec.op, a[i], b[i], twin)
                                   for i in range(spec.batch)], runs=3)
        lib_ms, lib_device_ms = serve_yardstick(spec, a, b, ridge)
        bms, by = flush_bound(spec)
        lat = serve_metrics.percentiles(f"request.{spec.label()}") or {}
        # the cold first request of a fresh server on this one bucket
        cold = Server(ServeConfig(buckets=(spec,), capacity=8, max_wait_s=0.005))
        req = next(t.request for t in served if t.bucket == spec)
        t0 = time.perf_counter()
        cold.submit(req)
        cold.drain()
        cold_s = time.perf_counter() - t0
        del cold
        per[spec.label()] = dict(
            warm_s=fn.warm_s, cold_first_request_s=cold_s, replay_ms=replay_ms,
            eager_batch_ms=eager_ms, per_request_loop_ms=loop_ms, library_ms=lib_ms,
            library_device_ms=lib_device_ms, bound_ms=bms, bound_by=by,
            flushes=fn.replays, launches_per_flush=fn.capture_launches,
            profiled=launched, requests=lat.get("count", 0),
            latency_ms={k: lat[k] * 1e3 for k in ("p50", "p95", "p99")} if lat else None)
        log(f"  {spec.label()} ({time.perf_counter() - t_phase:.1f} s): "
            + json.dumps(per[spec.label()], default=str))
    res["buckets"] = per
    if names_seen != {"syrk", "potrf", "trsm", "gemm_tn"}:
        failed.append(f"profiled replays named only {sorted(names_seen)} of syrk, potrf, trsm, "
                      "gemm_tn")
    largest = max(server.buckets, key=lambda s: (s.batch * s.m * s.n, s.r))
    per_flush = server.bucket_callable(largest)[0].capture_launches
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  largest bucket {largest.label()}: launches per flush {per_flush}; "
        f"phase serve took {res['phase_s']:.1f} s")
    if failed:
        raise AssertionError("serve: " + "; ".join(failed))
    return warm_counts, workload_counts, per_flush, res



CHECK_SPLIT_N = 512     # the packed block of phase check's lstsq (two 256 tiles)


def check_clis():
    """Phase check's (a): the checker's CLI on the card three times — the
    grid (JSON), the quick subset and the serve layer —, the three at once.
    Returns ``(seconds for the three, [(argv, exit code, output)])``; main
    runs this in the background beside phase train's CLI runs."""
    import tempfile
    import time

    out_json = os.path.join(ROOT, "build", "check_report.json")
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = []
    runs = []
    try:
        for argv in (["--json", out_json], ["--quick"], ["--serve"]):
            f = tempfile.TemporaryFile(mode="w+")
            procs.append((argv, f, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.check", *argv], cwd=ROOT, env=env,
                stdout=f, stderr=subprocess.STDOUT, text=True)))
        for argv, f, proc in procs:
            proc.wait(timeout=600)
            f.seek(0)
            runs.append((argv, proc.returncode, f.read()))
    finally:
        for _, f, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    return time.perf_counter() - t0, runs


def phase_check(checks, ops, clis=None):
    """Phase 13 (module docstring): the contract checker on the card.
    ``clis``: (a)'s runs (``check_clis()``) when main ran them earlier."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from repro_torch import tune
    from repro_torch.check import harness, run, trace_plan
    from repro_torch.check.artifacts import abstract_args, is_kernel
    from repro_torch.core.reference import potrf_flops, trsm_flops
    from repro_torch.kernels.gemm_tn import gemm_tn_cuda
    from repro_torch.kernels.syrk import syrk_cuda
    from repro_torch.solve import lstsq
    from repro_torch.tune import apply

    log("phase check")
    rng = np.random.default_rng(SEED + 13)
    res = {}

    # (a) the CLI: the grid (JSON), the quick subset and the serve layer
    secs, runs = check_clis() if clis is None else clis
    log(f"  (a) the three CLI runs together: {secs:.1f} s"
        + (" (beside phase train)" if clis is not None else ""))
    for argv, rc, out in runs:
        summary = [ln for ln in out.splitlines() if ln.startswith("repro_torch.check:")]
        log(f"  python -m repro_torch.check {' '.join(argv)}: exit {rc}, {summary}")
        if rc or not summary or " 0 findings" not in summary[0]:
            raise AssertionError(f"check {argv} failed:\n{out[-6000:]}")
        res["grid" if argv[0] == "--json" else argv[0].lstrip("-")] = summary[0]
    out_json = runs[0][0][1]
    with open(out_json) as f:
        report = json.load(f)
    if report["counts"]["findings"] or report["meta"]["backend"] != "cuda":
        raise AssertionError(f"check report: {report['counts']} {report['meta']}")
    res["grid_artifacts"] = report["counts"]["artifacts"]
    res["grid_allowlisted"] = report["counts"]["allowlisted"]

    def traced_and_run(plan, label, allowlist=()):
        """Trace ``plan`` on fake CUDA tensors, check it, run it for real:
        its kernel nodes must equal the run's launches."""
        t0 = time.perf_counter()
        art = trace_plan(plan, device="cuda")
        trace_s = time.perf_counter() - t0
        found = run(art, allowlist=allowlist).findings
        nodes = sum(1 for site in art.sites() if is_kernel(site.node))
        args = [torch.as_tensor(rng.standard_normal(x.shape, dtype=np.float32),
                                device="cuda").to(x.dtype)
                for x in abstract_args(plan, "cuda")]
        ops.reset_launches()
        apply.build_callable(plan)(*args)
        torch.cuda.synchronize()
        launched = dict(ops.launches)
        del args
        if found or nodes != sum(launched.values()):
            raise AssertionError(f"{label}: findings {[f.message for f in found]}, kernel "
                                 f"nodes {nodes} vs launches {launched}")
        return dict(label=harness.plan_label(plan), kernel_nodes=nodes, trace_s=trace_s,
                    graph_nodes=len(art.graph.graph.nodes), findings=0)

    # (b) every plan of the card's grid: kernel nodes == launches of a real run
    for plan in harness.canonical_plans("cuda"):
        traced_and_run(plan, harness.plan_label(plan), harness.CARD_ALLOWLIST)
    log(f"  grid: {len(harness.canonical_plans('cuda'))} plans, kernel nodes == launches")

    # (c) full width: zero findings, kernel nodes == launches
    planned = tune.plan(op="ata", m=8192, n=8192, out="packed", backend="cuda")
    full = {
        "ata_8192_planned": planned,
        "ata_8192_fused": dataclasses.replace(planned, algorithm="strassen",
                                              n_base=DEFAULT_N_BASE, leaf_dispatch="fused",
                                              use_kernels=True),
        "ata_8192_unrolled": dataclasses.replace(planned, algorithm="strassen",
                                                 n_base=DEFAULT_N_BASE,
                                                 leaf_dispatch="unrolled", use_kernels=True),
        "strassen_tn_4096_planned": tune.plan(op="gemm_tn", m=4096, n=4096, k=4096,
                                              backend="cuda"),
        "lstsq_16384x4096x8_factor_pb512": dataclasses.replace(
            tune.plan(op="solve", m=16384, n=4096, k=8, out="packed", backend="cuda"),
            method="factor", packed_block=CHECK_SPLIT_N),
    }
    res["full_width"] = {}
    for name, plan in full.items():
        got = traced_and_run(plan, name)
        log(f"  {name} ({got['label']}): {got['graph_nodes']} nodes, {got['kernel_nodes']} "
            f"kernel nodes == launches, 0 findings, traced in {got['trace_s']:.1f} s")
        res["full_width"][name] = got
        torch.cuda.empty_cache()

    # (d) the 256-wide refusal repaired at full width: lstsq at packed_block=512
    a = cuda_tensor(rng, (16384, 4096))
    b = cuda_tensor(rng, (16384, 8))
    ops.reset_launches()
    x = lstsq(a, b, ridge=1e-3, method="factor", packed_block=CHECK_SPLIT_N)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    ad = a.double()
    x64 = torch.linalg.solve(ad.T @ ad + 1e-3 * torch.eye(4096, device="cuda",
                                                          dtype=torch.float64),
                             ad.T @ b.double())
    del ad
    rel = float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64))
    nbk = 4096 // CHECK_SPLIT_N
    want_potrf = nbk * ops.split_launches("potrf", CHECK_SPLIT_N)["potrf"]
    ms = time_ms(lambda: lstsq(a, b, ridge=1e-3, method="factor", packed_block=CHECK_SPLIT_N),
                 runs=3)
    log(f"  lstsq 16384x4096x8 packed_block={CHECK_SPLIT_N} float32: rel err {rel:.3e}, "
        f"{ms:.2f} ms, launches {counts}")
    if not rel <= 1e-3 or counts["potrf"] != want_potrf or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"lstsq packed_block={CHECK_SPLIT_N}: rel {rel}, potrf "
                             f"{counts['potrf']} != {want_potrf}")
    res["lstsq_packed512"] = dict(rel_err=rel, ms=ms, launches=counts)
    del a, b, x, x64
    torch.cuda.empty_cache()

    # (e) the split's device times at n = 512 beside torch.linalg and the bound
    n = CHECK_SPLIT_N
    g = torch.as_tensor(rng.standard_normal((n + 64, n)), device="cuda")
    s = (g.T @ g / n + torch.eye(n, device="cuda", dtype=torch.float64)).float()
    l = ops.potrf(s)
    panel = cuda_tensor(rng, (7, n, n))
    lx = l.expand(7, n, n)
    split = {}
    for name, fn, lib_fn, flops, nbytes in (
            ("potrf", lambda: ops.potrf(s), lambda: torch.linalg.cholesky_ex(s),
             potrf_flops(n), 4 * (n * n + n * n)),
            ("trsm", lambda: ops.trsm(lx, panel), lambda: torch.linalg.solve_triangular(
                lx.mT, panel, upper=True, left=False),
             7 * trsm_flops(n, n), 4 * (n * n + 2 * 7 * n * n))):
        ops.reset_launches()
        fn()
        launched = {k: v for k, v in ops.launches.items() if v}
        if launched != ops.split_launches(name, n):
            raise AssertionError(f"{name} split at n={n}: launches {launched}")
        want = (torch.linalg.cholesky(s.double()) if name == "potrf"
                else torch.linalg.solve_triangular(lx.double().mT, panel.double(), upper=True,
                                                   left=False))
        err = float((fn().double() - want).abs().max() / want.abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{name} split at n={n}: rel err {err} vs float64")
        bms, by = bound(flops, nbytes)
        split[name] = dict(n=n, launches=launched, rel_err_vs_float64=err,
                           device_ms=graph_ms(fn, 20), ms=time_ms(fn),
                           library_ms=time_ms(lib_fn), library_device_ms=graph_ms(lib_fn, 20),
                           bound_ms=bms, bound_by=by)
        checks.rows.setdefault(name, {})[f"split_{n}"] = split[name]
        log(f"  {name} split n={n}: {json.dumps(split[name])}")
    res["split"] = split

    # (f) host time of one wrapper call (counter, dispatcher operator,
    # launch) against the bare launch, on a 512² leaf (best of bursts)
    x5, y5 = cuda_tensor(rng, (512, 512)), cuda_tensor(rng, (512, 512))

    def host_us(fn, calls=200):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return best

    host = {"ops.gemm_tn": host_us(lambda: ops.gemm_tn(x5, y5)),
            "gemm_tn_cuda": host_us(lambda: gemm_tn_cuda(x5, y5)),
            "ops.syrk": host_us(lambda: ops.syrk(x5)),
            "syrk_cuda": host_us(lambda: syrk_cuda(x5)),
            "add": host_us(lambda: x5 + y5)}
    host["gemm_tn_op_us"] = host["ops.gemm_tn"] - host["gemm_tn_cuda"]
    host["syrk_op_us"] = host["ops.syrk"] - host["syrk_cuda"]
    log(f"  host us a call: {json.dumps(host)}")
    res["host_us"] = host
    return res



# ---------------------------------------------------------------------------
# phase 17: the dry-run on the card
# ---------------------------------------------------------------------------

# (c)'s gram and its mesh: ata_tile_parallel of a (16384, 8192) operand on
# (data 2, model 2), rows over data
DRYRUN_GRAM = (16384, 8192)
DRYRUN_MESH = (2, 2)
# the measured peak over the predicted one, both ends included
DRYRUN_PEAK_BAND = (0.90, 1.10)


def _dryrun_gram_fn(mesh):
    """(c)'s call on one rank: the tile schedule with the static cutoff and
    the unrolled leaves (every tile, diagonal ones too, is a ``strassen_tn``
    product: gemm_tn launches, no syrk)."""
    import functools

    from repro_torch.core.distributed import ata_tile_parallel

    return functools.partial(ata_tile_parallel, mesh=mesh, task_axis="model", row_axis="data",
                             n_base=DEFAULT_N_BASE, leaf_dispatch="unrolled")


def _dryrun_peak(run):
    """(``run()``, the device's peak allocated bytes over it); the caller
    subtracts what it held before it made the arguments."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def _dryrun_gram_rank(rank: int, world: int) -> dict:
    """One gloo rank of (c): its row block of the seeded operand, one real
    call under the dry-run's counters; returns the artifact, the
    allocator's peak above what the rank held before it made its block,
    and the kernels' launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(DRYRUN_MESH, ("data", "model"), backend="gloo", device=dev)
    base = torch.cuda.memory_allocated(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    full = torch.randn(DRYRUN_GRAM, generator=g, device=dev)
    a = mesh.local_block(full, ("data", None)).clone()
    del full
    fn = _dryrun_gram_fn(mesh)
    ops.reset_launches()
    art, peak = _dryrun_peak(lambda: dryrun._artifact(fn, a, device=dev))
    return dict(rank=rank, art=art, peak=peak - base, launches=dict(ops.launches))


# (d)'s tensor-parallel train step: qwen1.5-0.5b at full width, 4 layers,
# batch 2 x 1024, on (data 1, model 4)
DRYRUN_TP_MESH = (1, 4)
DRYRUN_TP_LAYERS, DRYRUN_TP_BATCH, DRYRUN_TP_SEQ = 4, 2, 1024


def _dryrun_tp_setup(mesh):
    """(d)'s config, run config, step and optimizer on ``mesh``."""
    import dataclasses

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(CONFIG, num_layers=DRYRUN_TP_LAYERS)
    shape = ShapeConfig("dryrun_tp", DRYRUN_TP_SEQ, DRYRUN_TP_BATCH, "train")
    run = RunConfig(model=cfg, shape=shape, remat="dots")
    step_fn, opt = make_train_step(cfg, mesh, run)
    return cfg, shape, run, step_fn, opt


def _dryrun_tp_rank(rank: int, world: int) -> dict:
    """One gloo rank of (d): its blocks of the seeded parameters, the
    global batch, one real step under the dry-run's counters; returns the
    artifact, the allocator's peak above what the rank held before it made
    its arguments, and the kernels' launches."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init
    from repro_torch.train.train_step import init_state

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(DRYRUN_TP_MESH, ("data", "model"), backend="gloo", device=dev)
    cfg, shape, run, step_fn, opt = _dryrun_tp_setup(mesh)
    base = torch.cuda.memory_allocated(dev)
    params = init(torch.Generator(device=dev).manual_seed(SEED + 18), cfg, mesh, device=dev)
    state = init_state(cfg, mesh, run, opt, params)
    del params
    data = SyntheticLM(cfg, shape, seed=SEED + 18)
    try:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
    finally:
        data.close()
    kept = {}

    def step_kept(st, b):
        kept["out"] = step_fn(st, b)
        return kept["out"]

    ops.reset_launches()
    art, peak = _dryrun_peak(lambda: dryrun._artifact(step_kept, state, batch, device=dev))
    loss = float(kept.pop("out")[1]["loss"])
    return dict(rank=rank, art=art, peak=peak - base, launches=dict(ops.launches), loss=loss)


def _dryrun_tp_traced_and_run():
    """(d): each rank's step traced over a fake (1, 4) group, then four
    gloo ranks on card 0 run it. Returns (the ranks' results, the seconds
    of their spawn and run, the traced artifacts)."""
    import time

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, spawn
    from repro_torch.train.train_step import init_state

    fakes = []
    for r in range(math.prod(DRYRUN_TP_MESH)):
        mesh = fake_mesh(DRYRUN_TP_MESH, ("data", "model"), rank=r, device="cuda")
        try:
            cfg_d, shape_d, run_d, step_d, opt_d = _dryrun_tp_setup(mesh)
            with FakeTensorMode():
                params = dryrun._abstract_params(cfg_d, mesh)
                state = init_state(cfg_d, mesh, run_d, opt_d, params)
                del params
                batch = dryrun._abstract_batch(cfg_d, shape_d, "train", mesh, local=False)
                fakes.append(dryrun._artifact(step_d, state, batch, device="cuda"))
                del state, batch
        finally:
            torch.distributed.destroy_process_group()
    t0 = time.perf_counter()
    ranks = spawn(_dryrun_tp_rank, math.prod(DRYRUN_TP_MESH), backend="gloo", timeout_s=300.0)
    return ranks, time.perf_counter() - t0, fakes


def _dryrun_band(label, predicted, measured):
    ratio = measured / predicted
    ok = DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]
    log(f"  {label}: peak predicted {predicted} B, measured {measured} B "
        f"(max_memory_allocated), ratio {ratio:.4f} (band {DRYRUN_PEAK_BAND}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dryrun {label}: the measured peak is outside the band")
    return ratio


def _dryrun_equal(label, what, predicted, measured):
    ok = predicted == measured
    log(f"  {label}: {what} predicted {predicted}, measured {measured} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dryrun {label}: {what} differ")


def phase_dryrun(ops):
    """Phase 17: the production dry-run (``repro_torch.launch.dryrun``) and
    its abstraction held against real runs on the card (see the module
    docstring). Returns the kernels' launches of (b)'s and (c)'s real runs
    (summed over (c)'s ranks) and the results."""
    import tempfile
    import time

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.qwen15_05b import CONFIG
    from repro_torch.configs.registry import input_specs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, spawn
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_map
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    log("phase dryrun")
    res = {}
    path_launches = {k: 0 for k in ops.launches}

    # (a) the CLI on the production mesh, fake CUDA tensors, in two
    # subprocesses that run while (b) and (c) do
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cells = {"gram": ["--arch", "gram", "--shape", "65536x16384", "--mesh", "single"],
             "qwen_decode": ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh",
                             "single", "--no-analysis"]}
    procs = {k: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                                  "--out", os.path.join(out_dir, k)],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, argv in cells.items()}
    try:
        # (b) qwen1.5-0.5b's single-rank train step at phase train's shape:
        # traced on fake CUDA tensors, then run once for real
        shape = ShapeConfig("dryrun_train", TRAIN_SEQ, TRAIN_BATCH, "train")
        run = RunConfig(model=CONFIG, shape=shape, remat="dots")
        step_fn, opt = make_train_step(CONFIG, None, run)
        with FakeTensorMode():
            params = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="cuda"),
                              init(None, CONFIG, device="meta"))
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            batch = {k: torch.zeros(x.shape, dtype=x.dtype, device="cuda")
                     for k, x in input_specs(CONFIG, shape, "train").items()}
            fake = dryrun._artifact(step_fn, state, batch, device="cuda")
            del params, state, batch
        log(f"  (b) {CONFIG.name} train step {TRAIN_BATCH} x {TRAIN_SEQ}, remat dots, "
            f"AdamW, traced on fake CUDA tensors in {fake['trace_s']} s: "
            + json.dumps({k: fake[k] for k in ("memory", "cost", "kernels")}))
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = init(torch.Generator(device="cuda").manual_seed(SEED + 17), CONFIG,
                      device="cuda")
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        data = SyntheticLM(CONFIG, shape, seed=SEED + 17)
        try:
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
        finally:
            data.close()
        del params
        kept = {}

        def step_kept(st, b):
            kept["out"] = step_fn(st, b)
            return kept["out"]

        ops.reset_launches()
        real, peak = _dryrun_peak(lambda: dryrun._artifact(step_kept, state, batch,
                                                           device="cuda"))
        peak -= base
        loss = float(kept.pop("out")[1]["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"dryrun (b): the real step's loss is {loss}")
        launches = dict(ops.launches)
        for k, v in launches.items():
            path_launches[k] += v
        log(f"  (b) the same step run once on the card in {real['trace_s']} s, loss {loss!r}: "
            + json.dumps({k: real[k] for k in ("memory", "cost", "kernels")}))
        _dryrun_equal("(b)", "flops", fake["cost"]["flops"], real["cost"]["flops"])
        _dryrun_equal("(b)", "kernel nodes / launches", fake["kernels"],
                      {k: v for k, v in launches.items() if v})
        res["train_step"] = dict(
            trace_s=fake["trace_s"], run_s=real["trace_s"], flops=fake["cost"]["flops"],
            kernels=fake["kernels"], predicted_peak=fake["memory"]["peak_bytes_est"],
            measured_peak=peak, tracked_peak_real=real["memory"]["peak_bytes_est"],
            argument_bytes=fake["memory"]["argument_bytes"],
            ratio=_dryrun_band("(b)", fake["memory"]["peak_bytes_est"], peak))
        del state, batch
        torch.cuda.empty_cache()

        # (c) ata_tile_parallel on (2, 2): each rank traced over a fake group
        # here, then the four ranks run for real (gloo, all on card 0), in
        # the background while (d) is traced and its four ranks run
        m, n = DRYRUN_GRAM
        p_data, _ = DRYRUN_MESH
        fakes = []
        for r in range(math.prod(DRYRUN_MESH)):
            mesh = fake_mesh(DRYRUN_MESH, ("data", "model"), rank=r, device="cuda")
            try:
                with FakeTensorMode():
                    a = torch.empty((m // p_data, n), device="cuda")
                    fakes.append(dryrun._artifact(_dryrun_gram_fn(mesh), a, device="cuda"))
                    del a
            finally:
                torch.distributed.destroy_process_group()
        fakes_c = fakes

        def gram_ranks():
            t0 = time.perf_counter()
            ranks = spawn(_dryrun_gram_rank, math.prod(DRYRUN_MESH), backend="gloo",
                          timeout_s=300.0)
            return ranks, time.perf_counter() - t0

        gram = Background(gram_ranks)
        try:
            tp_ranks, tp_s, fakes_d = _dryrun_tp_traced_and_run()
        finally:
            ranks, gram_s = gram.result()
        log(f"  (c) ata_tile_parallel {m}x{n} on {DRYRUN_MESH} (rows over data), four gloo "
            f"ranks on card 0 (beside (d)'s): spawn and run {gram_s:.1f} s")
        res["gram"] = []
        for f, rk in zip(fakes_c, ranks):
            r = rk["rank"]
            log(f"  (c) rank {r}: traced in {f['trace_s']} s, ran in {rk['art']['trace_s']} s; "
                f"predicted {json.dumps({k: f[k] for k in ('memory', 'cost', 'collectives')})}")
            _dryrun_equal(f"(c) rank {r}", "flops", f["cost"]["flops"],
                          rk["art"]["cost"]["flops"])
            _dryrun_equal(f"(c) rank {r}", "collective bytes", f["collectives"],
                          rk["art"]["collectives"])
            got = {k: v for k, v in rk["launches"].items() if v}
            _dryrun_equal(f"(c) rank {r}", "kernel nodes / launches", f["kernels"], got)
            if "gemm_tn" not in got:
                raise AssertionError(f"dryrun (c) rank {r}: launched {got}, no gemm_tn")
            for k, v in got.items():
                path_launches[k] += v
            res["gram"].append(dict(
                rank=r, trace_s=f["trace_s"], run_s=rk["art"]["trace_s"],
                flops=f["cost"]["flops"], collectives=f["collectives"], kernels=f["kernels"],
                predicted_peak=f["memory"]["peak_bytes_est"], measured_peak=rk["peak"],
                ratio=_dryrun_band(f"(c) rank {r}", f["memory"]["peak_bytes_est"],
                                   rk["peak"])))

        # (d) qwen1.5-0.5b's tensor-parallel train step on (1, 4): traced and
        # run above, beside (c)'s ranks
        log(f"  (d) {CONFIG.name} tensor-parallel train step ({DRYRUN_TP_LAYERS} layers, "
            f"{DRYRUN_TP_BATCH} x {DRYRUN_TP_SEQ}, remat dots, AdamW) on {DRYRUN_TP_MESH}, "
            f"four gloo ranks on card 0 (beside (c)'s): spawn and run {tp_s:.1f} s")
        res["tp_train"] = []
        for f, rk in zip(fakes_d, tp_ranks):
            r = rk["rank"]
            log(f"  (d) rank {r}: traced in {f['trace_s']} s, ran in {rk['art']['trace_s']} s, "
                f"loss {rk['loss']!r}; predicted "
                f"{json.dumps({k: f[k] for k in ('memory', 'cost', 'collectives')})}")
            if not math.isfinite(rk["loss"]):
                raise AssertionError(f"dryrun (d) rank {r}: loss {rk['loss']}")
            _dryrun_equal(f"(d) rank {r}", "flops", f["cost"]["flops"],
                          rk["art"]["cost"]["flops"])
            _dryrun_equal(f"(d) rank {r}", "collective bytes", f["collectives"],
                          rk["art"]["collectives"])
            got = {k: v for k, v in rk["launches"].items() if v}
            _dryrun_equal(f"(d) rank {r}", "kernel nodes / launches", f["kernels"], got)
            res["tp_train"].append(dict(
                rank=r, trace_s=f["trace_s"], run_s=rk["art"]["trace_s"],
                flops=f["cost"]["flops"], collectives=f["collectives"], kernels=f["kernels"],
                predicted_peak=f["memory"]["peak_bytes_est"], measured_peak=rk["peak"],
                ratio=_dryrun_band(f"(d) rank {r}", f["memory"]["peak_bytes_est"],
                                   rk["peak"])))

        # (a) the two CLI cells
        for k, p in procs.items():
            out, _ = p.communicate(timeout=max(10.0, 100.0 - (time.perf_counter() - t_phase)))
            if p.returncode != 0:
                raise AssertionError(f"dryrun (a) {k}: exit {p.returncode}\n{out[-3000:]}")
            (fname,) = os.listdir(os.path.join(out_dir, k))
            with open(os.path.join(out_dir, k, fname)) as f:
                rec = json.load(f)
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun (a) {k}: status {rec['status']}")
            summary = {label: dict(trace_s=a["trace_s"],
                                   peak_bytes=a["memory"]["peak_bytes_est"],
                                   flops=a["cost"]["flops"], collectives=a["collectives"],
                                   kernels=a["kernels"])
                       for label, a in rec["artifacts"].items()}
            log(f"  (a) python -m repro_torch.launch.dryrun {' '.join(cells[k])}: exit 0, "
                f"status ok, {rec['wall_s']} s: {json.dumps(summary)}")
            res[k] = dict(wall_s=rec["wall_s"], artifacts=summary)
        peak = res["qwen_decode"]["artifacts"]["main"]["peak_bytes"]
        ok = 0 < peak < 80e9
        log(f"  (a) qwen1.5-0.5b decode_32k on (16, 16): peak {peak} B a rank, under 80e9 B "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("dryrun (a): the decode cell's peak does not fit a card")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase dryrun took {res['phase_s']:.1f} s; real-run launches {path_launches}")
    return path_launches, res


def main(argv) -> int:
    import time

    import torch

    t_start = time.perf_counter()

    if argv not in ([], ["distributed"], ["serve"], ["check"], ["train"], ["decode"], ["mesh"],
                    ["dryrun"], ["dtypes"]):
        print(f"chip_smoke: unknown arguments {argv}; the only ones are 'distributed', "
              "'serve', 'check', 'train', 'decode', 'mesh', 'dryrun' and 'dtypes'",
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
    if argv == ["serve"]:
        _, _, _, serve_res = phase_serve(ops)
        log("end_to_end " + json.dumps({"serve": serve_res}, default=str))
        return 0
    if argv == ["check"]:
        check_res = phase_check(Checks(ops.launches), ops)
        log("end_to_end " + json.dumps({"check": check_res}, default=str))
        return 0
    if argv == ["train"]:
        _, train_res = phase_train(ops)
        log("end_to_end " + json.dumps({"train": train_res}, default=str))
        return 0
    if argv == ["decode"]:
        _, decode_res = phase_decode(ops)
        log("end_to_end " + json.dumps({"decode": decode_res}, default=str))
        return 0
    if argv == ["mesh"]:
        _, mesh_res = phase_mesh(ops)
        log("end_to_end " + json.dumps({"mesh": mesh_res}, default=str))
        return 0
    if argv == ["dryrun"]:
        _, dryrun_res = phase_dryrun(ops)
        log("end_to_end " + json.dumps({"dryrun": dryrun_res}, default=str))
        return 0
    plain = {"gemm_tn": gemm_tn_plain, "syrk": syrk_plain, "potrf": potrf_plain,
             "trsm": trsm_plain, "gemm_tn_fused": gemm_tn_fused_plain,
             "syrk_gather": syrk_gather_plain}
    checks = Checks(ops.launches)
    if argv == ["dtypes"]:
        checks.rows = {name: {} for name in plain}
        _, ata16 = phase_dtypes(checks, ops, plain)
        log("end_to_end " + json.dumps({"dtypes": checks.rows, "ata_8192_bf16": ata16},
                                       default=str))
        return 0
    def at(name):
        """The script's clock at the start of a phase (the phases' own
        timings do not cover them all)."""
        torch.cuda.empty_cache()
        log(f"[{time.perf_counter() - t_start:.1f} s] {name}")

    at("kernels")
    phase_kernels(checks, ops, plain)
    at("dtypes")
    wgmma_counts, ata16 = phase_dtypes(checks, ops, plain)
    at("ata")
    fused_counts, ata_res = phase_ata(ops)
    at("strassen")
    strassen_res = phase_strassen(ops)
    at("lstsq")
    counts, lstsq_res = phase_lstsq(ops)
    at("cg")
    cg_counts, cg_res = phase_cg(checks, ops, plain)
    checks.rows["gemm_tn"]["cg_launches"] = cg_counts["gemm_tn"]
    at("obs")
    obs_res = phase_obs(ops)
    at("tune")
    tune_res = phase_tune(ops)
    at("optim")
    optim_counts, optim_res = phase_optim(checks, ops, plain)
    at("train")
    # phase check's CLI runs, beside phase train (whose CLI runs leave the
    # card and the host's cores mostly idle)
    clis = Background(check_clis)
    try:
        train_counts, train_res = phase_train(ops)
    finally:
        clis = clis.result()
    at("decode")
    decode_counts, decode_res = phase_decode(ops)
    at("distributed")
    dist_counts, dist_res = phase_distributed(ops)
    at("mesh")
    mesh_counts, mesh_res = phase_mesh(ops)
    at("serve")
    serve_warm, serve_workload, serve_flush, serve_res = phase_serve(ops)
    at("check")
    check_res = phase_check(checks, ops, clis)
    at("dryrun")
    dryrun_counts, dryrun_res = phase_dryrun(ops)
    log("end_to_end " + json.dumps({"ata_8192": ata_res, "ata_8192_bf16": ata16,
                                    "strassen_tn_4096": strassen_res,
                                    "lstsq_16384x4096x8": lstsq_res,
                                    "lstsq_cg_16384x4096x8": cg_res, "obs": obs_res,
                                    "tune": tune_res, "optim": optim_res, "train": train_res,
                                    "decode": decode_res,
                                    "distributed": dist_res, "mesh": mesh_res,
                                    "serve": serve_res,
                                    "check": check_res, "dryrun": dryrun_res}, default=str))

    # name -> (source, replaced TPU kernel, launches on the path that runs it:
    # lstsq for the first four, ata 8192² fused for the last two); beside
    # them, the launches of phase optim's Shampoo refresh step (p = 2, packed),
    # of one Shampoo step of phase train (p = 4, planned grams), of phase
    # decode (none: the server's path runs no kernel of the six),
    # of phase distributed, of phase mesh (summed over its ranks), of phase
    # serve's warm (b) (eager runs and
    # captures), the launches (b)'s workload replayed (each bucket's replays
    # times its capture's launches), the launches one flush of serve's
    # largest bucket replays, and those of phase dryrun's real runs
    table = {
        "gemm_tn": ("gemm_tn.cu", "src/repro/kernels/gemm_tn.py:78", counts),
        "syrk": ("syrk.cu", "src/repro/kernels/syrk.py:136", counts),
        "potrf": ("potrf.cu", "src/repro/kernels/potrf.py:65", counts),
        "trsm": ("trsm.cu", "src/repro/kernels/trsm.py:80", counts),
        "gemm_tn_fused": ("gemm_tn_fused.cu", "src/repro/kernels/gemm_tn.py:199", fused_counts),
        "syrk_gather": ("syrk.cu", "src/repro/kernels/syrk.py:259", fused_counts),
    }
    kernels = []
    # the narrow-output kernel that gemm_tn launches for k ≤ narrow_max_k():
    # its launches in phase cg's solve, its numbers at CG's shape, and at
    # PowerSGD's two shapes beside them
    cg_tn = cg_res["narrow_16384x4096x8"]
    kernels.append({
        "name": "gemm_tn_narrow", "route": "cuda", "source": "src/repro_torch/csrc/tn_narrow.cu",
        "replaces": "src/repro/kernels/gemm_tn.py:78", "launches": cg_res["narrow_launches"],
        "lstsq_factor_launches": counts["gemm_tn_narrow"],
        "max_abs_err": cg_tn["max_abs_err_float32"], "ms": cg_tn["ms"],
        "plain_ms": cg_tn["plain_ms"], "bound_ms": cg_tn["bound_ms"],
        "bound_by": cg_tn["bound_by"], "library_ms": cg_tn["matmul_ms"],
        "device_ms": cg_tn["device_ms"], "library_device_ms": cg_tn["matmul_device_ms"],
        "narrow": {"cg_16384x4096x8": cg_tn,
                   **{f"powersgd_{key}": optim_res["powersgd"][f"narrow_tn_{key}"]
                      for key in ("wg", "wd")}},
    })
    # the bfloat16 tensor-core kernels that gemm_tn, gemm_tn_fused, syrk and
    # syrk_gather launch for bfloat16 operands: their launches on the
    # bfloat16 main path (ata 4096² and strassen_tn 4096³ under the three
    # dispatches, phase dtypes), their numbers at the shapes of phase 2 in
    # bfloat16
    for name, src, replaced, base in (
            ("gemm_tn_wgmma", "gemm_tn.cu", "gemm_tn.py:121", "gemm_tn"),
            ("gemm_tn_fused_wgmma", "gemm_tn_fused.cu", "gemm_tn.py:290", "gemm_tn_fused"),
            ("syrk_wgmma", "syrk.cu", "syrk.py:222", "syrk"),
            ("syrk_gather_wgmma", "syrk.cu", "syrk.py:331", "syrk_gather")):
        row = checks.rows[base]["bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaced}", "launches": wgmma_counts[name],
            "max_abs_err": row["max_abs_err_float32"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "library_device_ms": row["library_device_ms"],
            "shape": checks.rows[base].get("shape"), "bf16": row,
        })
    for name, (src, replaces, path_counts) in table.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": replaces, "launches": path_counts[name],
            "optim_refresh_step_launches": optim_counts[name],
            "train_shampoo_step_launches": train_counts[name],
            "decode_launches": decode_counts[name],
            "distributed_launches": dist_counts[name],
            "mesh_launches": mesh_counts[name],
            "serve_warm_launches": serve_warm[name],
            "serve_workload_launches": serve_workload[name],
            "serve_launches": serve_flush.get(name, 0),
            "lstsq_packed512_launches": check_res["lstsq_packed512"]["launches"][name],
            "dryrun_launches": dryrun_counts[name],
            **checks.rows[name],
        })
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
