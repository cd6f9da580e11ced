"""Multi-pod dry-run: trace one rank's program of every (arch × shape ×
mesh) cell on fake tensors (port of ``repro.launch.dryrun``).

For each cell the dry-run:

  1. builds rank 0's view of the production mesh (16×16
     single-pod / 2×16×16 multi-pod) over torch's fake process group
     (``launch.mesh.make_production_mesh``);
  2. builds the rank's arguments as fake tensors on ``--device``
     (``torch._subclasses.FakeTensorMode``: shapes, dtypes and devices, no
     storage): parameters from ``models.init`` on the ``meta`` device, the
     train state from ``train_step.init_state``, inputs from
     ``configs.registry.input_specs``, decode caches from ``init_cache``;
  3. runs the step (train_step / prefill / decode) once on them, with
     every counter of :func:`_artifact` on;
  4. records the peak of live bytes on the device (fits-per-rank proof),
     the flops, bytes and transcendentals of the operators, and the bytes
     of every collective the rank runs;
  5. additionally traces 1-layer/2-layer *analysis variants* of train and
     prefill cells, whose affine composition (``analysis.roofline``)
     recovers the cell's costs.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out results/dryrun
    python -m repro_torch.launch.dryrun ... --device cpu    # no card needed

The record keeps the reference's keys where their meaning carries over.
Departures:

* the reference compiles the SPMD program of every device for a TPU pod;
  the port traces rank 0's program, the rank's blocks as its arguments,
  on ``--device`` (default ``cuda``; the card's code paths). The record
  adds ``rank``, ``device``, ``target: "h100"`` and, per artifact,
  ``kernels``: the ``repro_torch::*`` operators (the hand-written kernels'
  launches) the trace met, by name;
* ``trace_s`` (seconds of the traced call) replaces ``lower_s`` and
  ``compile_s``;
* ``memory``: ``peak_bytes_est`` is the peak of the bytes of live
  storages on the device over the call, the arguments included (each
  storage rounded up to 512 bytes on a card, as its caching allocator
  rounds); ``argument_bytes`` and ``output_bytes`` are the storages of the
  arguments and of the result; ``temp_bytes`` = peak − arguments;
  ``alias_bytes`` and ``generated_code_bytes`` are 0. Memory a kernel
  takes outside PyTorch's allocator is not seen;
* ``cost.flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count
  (matmuls, convolutions) plus :data:`FLOP_FORMULAS`: the exact counts of
  ``core.reference`` for the six kernels and one flop per output element
  of an elementwise add, sub, mul or div (the paper's 14/3·n^log₂7
  counts its additions). ``cost.bytes_accessed`` sums the input and output
  bytes of every operator that is not a view (eager traffic, nothing
  fused; :class:`_Tally` says what moves none);
  ``cost.transcendentals`` counts the output elements of exp, log, tanh,
  rsqrt and sigmoid;
* ``collectives`` are the ``collective_bytes.<kind>`` counters of
  ``launch.collectives`` over the call (the result bytes of each, as the
  reference reads them off the HLO);
* the analysis variants keep the config's layer stacking (the port's
  layers are a Python loop either way, and an unscanned stack would drop
  the remat policy), and a decode cell traces only ``main``: it is exact,
  so there is no ``analysis_unrolled`` artifact;
* the meshed train step takes the global batch (``train_step``), prefill
  and decode take the rank's block of theirs (``serve_step``): a batch the
  data axes do not divide is whole on every rank, as long_500k's single
  sequence and its cache are (the cache's sequence chunked over
  ``model``); every rank computes with its tensor-parallel blocks of
  ``held(param_specs)``;
* the gram cell's ``normal_eq_model`` is priced at ``roofline.HBM_BW``
  (an H100's).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import threading
import time
import traceback
import weakref
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.analysis.roofline import COLLECTIVE_KINDS
from repro_torch.configs.base import SHAPES, OptimizerConfig, RunConfig
from repro_torch.configs.registry import ARCHS, cell_supported, get_config, input_specs
from repro_torch.core import reference as R
from repro_torch.kernels._library import NAMESPACE
from repro_torch.launch.mesh import make_production_mesh

__all__ = ["run_cell", "main", "FLOP_FORMULAS"]

# the caching allocator's smallest block: every allocation is a multiple
_CUDA_BLOCK = 512


def _batch(shape) -> int:
    return math.prod(shape[:-2])


def _syrk_flops(a, *args, out_shape, **kw):
    return _batch(a) * R.classical_syrk_flops(a[-2], a[-1])


def _syrk_gather_flops(a_blocks, *args, out_shape, **kw):
    return _batch(out_shape) * R.classical_syrk_flops(a_blocks[-2], a_blocks[-1])


def _gemm_tn_flops(a, b, *args, out_shape, **kw):
    return _batch(out_shape) * R.classical_gemm_flops(a[-2], a[-1], b[-1])


def _gemm_tn_fused_flops(a_blocks, b_blocks, *args, out_shape, **kw):
    # each leaf's product; the sums that form its operands are not counted
    return _batch(out_shape) * R.classical_gemm_flops(a_blocks[-2], a_blocks[-1], b_blocks[-1])


def _potrf_flops(a, *args, out_shape, **kw):
    return _batch(a) * R.potrf_flops(a[-1])


def _trsm_flops(l, b, *args, out_shape, **kw):
    return _batch(b) * R.trsm_flops(l[-1], b[-2])


def _elementwise_flops(*args, out_shape, **kw):
    return math.prod(out_shape)


_OPS = getattr(torch.ops, NAMESPACE)
_A = torch.ops.aten
# FlopCounterMode's ``custom_mapping``: operator packet -> flops from the
# shapes of its arguments and result
FLOP_FORMULAS = {
    _OPS.syrk: _syrk_flops,
    _OPS.syrk_gather: _syrk_gather_flops,
    _OPS.gemm_tn: _gemm_tn_flops,
    _OPS.gemm_tn_fused: _gemm_tn_fused_flops,
    _OPS.potrf: _potrf_flops,
    _OPS.trsm: _trsm_flops,
    **{op: _elementwise_flops for op in (_A.add, _A.add_, _A.sub, _A.sub_, _A.rsub, _A.mul,
                                         _A.mul_, _A.div, _A.div_)},
}
_TRANSCENDENTAL = frozenset((_A.exp, _A.exp_, _A.log, _A.log_, _A.tanh, _A.tanh_, _A.rsqrt,
                             _A.rsqrt_, _A.sigmoid, _A.sigmoid_))


def _flop_counter():
    """A ``FlopCounterMode`` that counts what ``cost.flops`` counts
    (:data:`FLOP_FORMULAS` beside torch's own formulas)."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Tally(TorchDispatchMode):
    """Counts, over every operator that runs under it: the bytes of its
    inputs and outputs (operators that return no tensor, or only views of
    their inputs, move none; a mutating operator counts its whole
    destination, so ``index_put_`` over-counts a scattered write), the
    output elements of the transcendental ones, the ``repro_torch::*``
    kernels by name, and the live bytes of the storages on ``device`` with
    their peak. A storage counts from the first operator that returns it
    (or :meth:`hold`) until Python frees it."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.kernels = Counter()
        self.live = 0
        self.peak = 0
        self._sizes = {}   # id(storage) -> counted bytes
        self._lock = threading.Lock()

    def _release(self, key):
        with self._lock:
            self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage if it lies on the device and is not
        counted yet; returns its counted bytes (0 off the device)."""
        if t.device.type != self.device.type:
            return 0
        st = t.untyped_storage()
        nbytes = st.nbytes()
        if self.device.type == "cuda":
            nbytes = -(-nbytes // _CUDA_BLOCK) * _CUDA_BLOCK
        key = id(st)
        with self._lock:
            old = self._sizes.get(key)
            if old is None:
                self._sizes[key] = nbytes
                self.live += nbytes
                weakref.finalize(st, self._release, key)
            elif nbytes > old:   # resized in place
                self._sizes[key] = nbytes
                self.live += nbytes - old
            self.peak = max(self.peak, self.live)
        return nbytes

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (the arguments); returns
        their bytes on the device, each storage once."""
        seen, total = set(), 0
        for t in _tensors(tree):
            key = id(t.untyped_storage())
            nbytes = self._track(t)
            if key not in seen:
                seen.add(key)
                total += nbytes
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if func.namespace == NAMESPACE:
            self.kernels[func._opname] += 1
        ins = _tensors((args, kwargs))
        if outs and (func._schema.is_mutable or not _aliases(outs, ins)):
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        if func._overloadpacket in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


def _aliases(outs, ins) -> bool:
    """Whether every output shares its storage with an input (a view, a
    reshape without a copy): metadata, no traffic."""
    held = {id(t.untyped_storage()) for t in ins}
    return all(id(t.untyped_storage()) in held for t in outs)


@contextlib.contextmanager
def _big_flash_blocks(enable: bool, block: int = 8192):
    """Analysis-trace context: enlarge flash q/kv blocks so the variants
    trace fewer bodies. The matmul flops are invariant to the block size
    (every q×kv pair is computed either way); the online softmax's
    rescaling adds and bytes scale with the number of kv blocks, so a
    composition from variants traced this way differs from ``main`` in
    those at sequences longer than a block."""
    import repro_torch.models.layers as L

    if not enable:
        yield
        return
    old = (L.Q_BLOCK, L.KV_BLOCK)
    L.Q_BLOCK = L.KV_BLOCK = block
    try:
        yield
    finally:
        L.Q_BLOCK, L.KV_BLOCK = old


def _artifact(fn, *args, device, big_blocks: bool = False) -> dict:
    """Run ``fn(*args)`` once under the counters and return the artifact
    record (module docstring). ``args`` are fake tensors made in the
    caller's ``FakeTensorMode`` (a trace), or real tensors (a run measured
    the same way)."""
    with _big_flash_blocks(big_blocks):
        tally = _Tally(device)
        argument_bytes = tally.hold(args)
        before = obs.metrics.counters("collective_bytes.")
        t0 = time.perf_counter()
        with _flop_counter() as flops, tally:
            out = fn(*args)
        trace_s = time.perf_counter() - t0
        after = obs.metrics.counters("collective_bytes.")
    moved = {k.removeprefix("collective_bytes."): v - before.get(k, 0) for k, v in after.items()}
    peak = tally.peak
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": _Tally(device).hold(out),
            "temp_bytes": peak - argument_bytes,
            "alias_bytes": 0,
            "generated_code_bytes": 0,
            "peak_bytes_est": peak,
        },
        "cost": {
            "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(tally.bytes_accessed),
            "transcendentals": float(tally.transcendentals),
        },
        "collectives": {k: int(moved.get(k, 0)) for k in COLLECTIVE_KINDS},
        "kernels": dict(sorted(tally.kernels.items())),
    }


def _abstract_params(cfg, mesh, dtype=None):
    """The rank's parameters (``models.init`` on ``mesh``) as empty tensors
    on the mesh's device, floating leaves cast to ``dtype`` where given.
    Call under a ``FakeTensorMode``."""
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_map

    meta = init(None, cfg, mesh, device="meta")

    def leaf(x):
        dt = dtype if dtype is not None and x.is_floating_point() else x.dtype
        return torch.empty(x.shape, dtype=dt, device=mesh.device)

    return tree_map(leaf, meta)


def _abstract_batch(cfg, shape, mode, mesh, local: bool):
    """The cell's inputs on the mesh's device: the global batch, or with
    ``local`` the rank's block of it (``batch_input_specs``)."""
    from repro_torch.parallel.sharding import batch_input_specs

    specs = dict(input_specs(cfg, shape, mode))
    if local:
        where = batch_input_specs(mesh, specs)
        specs = {k: mesh.local_block(x, where[k]) for k, x in specs.items()}
    return {k: torch.zeros(x.shape, dtype=x.dtype, device=mesh.device) for k, x in specs.items()}


def _train_artifacts(cfg, shape, mesh, run, analysis=True):
    """Main artifact + L∈{1,2} analysis variants."""
    from repro_torch.train.train_step import init_state, make_train_step

    out = {}

    def one(cfg_v, label, big_blocks):
        step_fn, opt = make_train_step(cfg_v, mesh, run)
        with FakeTensorMode():
            params = _abstract_params(cfg_v, mesh)
            state = init_state(cfg_v, mesh, run, opt, params)
            del params
            batch = _abstract_batch(cfg_v, shape, "train", mesh, local=False)
            out[label] = _artifact(step_fn, state, batch, device=mesh.device,
                                   big_blocks=big_blocks)

    one(cfg, "main", big_blocks=False)
    if analysis:
        for variants in _layer_variants(cfg):
            one(variants["cfg"], variants["label"], big_blocks=True)
    return out


def _prefill_artifacts(cfg, shape, mesh, run, analysis=True, serve_dtype=None):
    from repro_torch.train.serve_step import make_prefill_step

    out = {}

    def one(cfg_v, label, big_blocks):
        prefill = make_prefill_step(cfg_v, mesh, compute_dtype=torch.bfloat16)
        with FakeTensorMode():
            params = _abstract_params(cfg_v, mesh, serve_dtype)
            batch = _abstract_batch(cfg_v, shape, "prefill", mesh, local=True)
            out[label] = _artifact(prefill, params, batch, device=mesh.device,
                                   big_blocks=big_blocks)

    one(cfg, "main", big_blocks=False)
    if analysis:
        for variants in _layer_variants(cfg):
            one(variants["cfg"], variants["label"], big_blocks=True)
    return out


def _decode_artifacts(cfg, shape, mesh, run, serve_dtype=None, sp_decode=False):
    """Decode: one trace of the step on the rank's block of the tokens,
    positions and cache (the trace counts every layer, so ``main`` is
    exact)."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.train.serve_step import make_decode_step

    decode = make_decode_step(cfg, mesh, compute_dtype=torch.bfloat16, sp_decode=sp_decode,
                              cache_len=shape.seq_len)
    with FakeTensorMode():
        params = _abstract_params(cfg, mesh, serve_dtype)
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, mesh, dtype=torch.bfloat16,
                           device=mesh.device)
        inp = _abstract_batch(cfg, shape, "decode", mesh, local=True)
        art = _artifact(decode, params, inp["tokens"], cache, inp["pos"], device=mesh.device)
    return {"main": art}


def _gram_artifacts(mesh, *, m=65536, n=16384, n_base=None):
    """The paper's own workload on the production mesh: distributed
    C = AᵀA via the ATA-S/ATA-D tile schedule (``core.distributed``),
    traced in six flavors on the rank's ``(m/data, n)`` row block:

      * ``naive``     — classical gram (no Strassen) — the pdsyrk baseline;
      * ``strassen``  — paper-faithful ATA leaves (7-mult recursion);
      * ``winograd``  — beyond-paper 15-add variant;
      * ``strassen_packed`` — packed low(C) retrieval: the result stays a
        ``SymmetricMatrix`` tile stack end-to-end (compare its
        ``collectives`` and ``output_bytes`` against ``strassen``'s dense
        replication);
      * ``strassen_nb<alt>`` / ``strassen_wide<nb>`` — the planner's
        neighbouring candidates: one cutoff step down, two extra stripes.

    The planned cutoff and stripe count come from the port's planner for
    the mesh's device.
    """
    from repro_torch import tune
    from repro_torch.core.distributed import ata_tile_parallel

    backend = mesh.device.type
    plan = tune.plan(op="ata", m=m, n=n, devices=mesh.shape["model"], backend=backend)
    base = plan.n_base if n_base is None else n_base
    alt = max((c for c in tune.defaults.N_BASE_CANDIDATES if c < base), default=base)
    wide = (plan.nb or tune.cost.distributed_tiling(n, mesh.shape["model"])[0]) + 2

    out = {}
    row_axis = "data"
    a_meta = mesh.local_block(torch.empty((m, n), dtype=torch.float32, device="meta"),
                              (row_axis, None))
    for label, kwargs in (
        ("naive", dict(use_strassen=False)),
        ("strassen", dict(use_strassen=True, variant="strassen")),
        ("winograd", dict(use_strassen=True, variant="winograd")),
        ("strassen_packed", dict(use_strassen=True, variant="strassen", out="packed")),
        (f"strassen_nb{alt}", dict(use_strassen=True, variant="strassen", n_base=alt)),
        (f"strassen_wide{wide}", dict(use_strassen=True, variant="strassen", nb=wide)),
    ):
        kw = dict(kwargs)
        nb_val = kw.pop("nb", None)
        fn = functools.partial(
            ata_tile_parallel, mesh=mesh, task_axis="model",
            row_axis=row_axis, n_base=kw.pop("n_base", base),
            nb=nb_val, **kw,
        )
        with FakeTensorMode():
            a = torch.empty(a_meta.shape, dtype=a_meta.dtype, device=mesh.device)
            out[label] = _artifact(fn, a, device=mesh.device)
    return out


def _layer_variants(cfg):
    """Reduced-depth configs for the affine flop composition. Hybrid layers
    are cost-uniform under masked flash (the window only changes the
    mask), so the same L∈{1,2} differencing applies with
    global_attn_layers=(0,)."""
    extra = {"global_attn_layers": (0,)} if cfg.family == "hybrid" else {}
    return [
        {"label": "analysis_l1", "cfg": dataclasses.replace(cfg, num_layers=1, **extra)},
        {"label": "analysis_l2", "cfg": dataclasses.replace(cfg, num_layers=2, **extra)},
    ]


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             optimizer: str = "adamw", analysis: bool = True,
             remat: str = "full", microbatch: int = 1,
             zero1: bool = True, variant_tag: str = "",
             serve_dtype: str = "", sp_decode: bool = False,
             shampoo_n_base=None, device: str = "cuda") -> dict:
    """One cell's record, traced as rank 0 of the production mesh on
    ``device`` (module docstring)."""
    where = {"rank": 0, "device": str(torch.device(device)), "target": "h100"}
    if arch == "gram":
        rec = {"arch": "gram", "shape": shape_name, "mesh": mesh_kind,
               "mode": "gram", "optimizer": "-", "num_layers": 0,
               "global_attn_layers": [], "params": 0, "active_params": 0,
               "variant_tag": variant_tag, **where}
        try:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=device)
            m, n = (int(x) for x in shape_name.split("x"))
            rec["artifacts"] = _gram_artifacts(mesh, m=m, n=n)
            # analytic full-pipeline pricing (the paper's "time to solution"):
            # the gram's write roofline extended by the potrf/trsm traffic of
            # the packed normal-equations tail, per RHS count
            from repro_torch.analysis import roofline as _rl
            from repro_torch.core.symmetric import default_block_size as _dbs
            from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK as _PB

            bn = _dbs(n, _PB)
            rec["normal_eq_model"] = {
                "packed_block": bn,
                "rhs": {
                    str(r): {
                        "packed_write_s": _rl.normal_eq_write_seconds(
                            n, bn, r, _rl.HBM_BW, mode="packed"),
                        "dense_write_s": _rl.normal_eq_write_seconds(
                            n, bn, r, _rl.HBM_BW, mode="dense"),
                        "factor_tail_bytes": _rl.normal_eq_write_traffic(n, bn, r),
                    }
                    for r in (1, 16, 128)
                },
            }
            rec["status"] = "ok"
        except Exception as e:  # a failure here is a bug in the system
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
        return rec
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mode": shape.kind, "optimizer": optimizer,
        "remat": remat, "microbatch": microbatch, "zero1": zero1,
        "variant_tag": variant_tag,
        "num_layers": cfg.num_layers,
        "global_attn_layers": list(cfg.global_attn_layers),
        "params": cfg.num_params(), "active_params": cfg.active_params(),
        **where,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    run = RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(name=optimizer, zero1=zero1,
                                  shampoo_n_base=shampoo_n_base),
        remat=remat, microbatch=microbatch,
    )
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=device)
        sdt = getattr(torch, serve_dtype) if serve_dtype else None
        if shape.kind == "train":
            rec["artifacts"] = _train_artifacts(cfg, shape, mesh, run, analysis)
        elif shape.kind == "prefill":
            rec["artifacts"] = _prefill_artifacts(cfg, shape, mesh, run, analysis,
                                                  serve_dtype=sdt)
        else:
            rec["artifacts"] = _decode_artifacts(cfg, shape, mesh, run,
                                                 serve_dtype=sdt,
                                                 sp_decode=sp_decode)
        rec["status"] = "ok"
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS) + ["gram"], default=None)
    ap.add_argument("--shape", default=None,
                    help="shape name, or MxN for --arch gram")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--optimizer", choices=["adamw", "shampoo"], default="adamw")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--no-analysis", action="store_true",
                    help="skip the 1/2-layer analysis variants")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag in the output name")
    # default None: the planner picks the gram cutoff per shape
    ap.add_argument("--shampoo-n-base", type=int, default=None)
    ap.add_argument("--sp-decode", action="store_true",
                    help="use the sequence-parallel flash-decode")
    ap.add_argument("--serve-dtype", default="",
                    help="cast float params to this dtype for serve cells "
                         "(e.g. bfloat16); default keeps init dtype (f32)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose output JSON already exists and is ok")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="the device of the fake tensors (cuda: the card's code paths)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                for mesh in ("single", "multi"):
                    cells.append((arch, shape, mesh))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, args.mesh)]

    n_ok = n_skip = n_err = 0
    for arch, shape, mesh in cells:
        tag = f"__{args.tag}" if args.tag else ""
        fname = f"{arch}__{shape}__{mesh}{tag}.json".replace("/", "_")
        fpath = os.path.join(args.out, fname)
        if args.resume and os.path.exists(fpath):
            try:
                with open(fpath) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[ resumed] {arch} × {shape} × {mesh}", flush=True)
                    n_ok += prev["status"] == "ok"
                    n_skip += prev["status"] == "skipped"
                    continue
            except (OSError, ValueError):
                pass
        # each mesh kind has its own world size: a fresh fake group a cell
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        t0 = time.time()
        rec = run_cell(arch, shape, mesh, optimizer=args.optimizer,
                       analysis=not args.no_analysis, remat=args.remat,
                       microbatch=args.microbatch, zero1=not args.no_zero1,
                       variant_tag=args.tag, serve_dtype=args.serve_dtype,
                       sp_decode=args.sp_decode,
                       shampoo_n_base=args.shampoo_n_base, device=args.device)
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(fpath, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        n_ok += status == "ok"
        n_skip += status == "skipped"
        n_err += status == "error"
        extra = ""
        if status == "ok":
            main_art = rec["artifacts"].get("main") or next(iter(rec["artifacts"].values()))
            mem = main_art.get("memory", {})
            extra = f" peak/dev={mem.get('peak_bytes_est', 0)/2**30:.2f}GiB"
        if status == "error":
            extra = " " + rec["error"][:120]
        print(f"[{status:>7}] {arch} × {shape} × {mesh} ({rec['wall_s']}s){extra}",
              flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
