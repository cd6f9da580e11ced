"""The six kernels as PyTorch dispatcher operators, ``torch.ops.repro_torch.*``.

Each operator has three implementations, and the dispatcher picks one by
the device of its tensor arguments:

* ``CUDA`` — the hand-written kernel's launch (``*_cuda`` of the kernel
  modules), counted in :data:`launches` right after it returns and
  nowhere else;
* ``CPU`` — the kernel's plain PyTorch version (``*_plain``);
* fake — shapes and dtypes only, so ``make_fx`` and ``torch.export`` trace
  a program through the kernels: each launch is one node of the graph,
  whose body the trace does not enter (the counterpart of the reference's
  opaque ``pallas_call`` equation, ``repro_torch.check``).

The operators are defined with ``torch.library.Library(..., "DEF")`` and
``impl``, not ``@torch.library.custom_op``, whose Python layer about
doubles the host time of a call; the unrolled dispatches make one call per
leaf. Schemas take tensors, ints, floats and bools only: the output dtype
is an index into :data:`DTYPES`, and the gather and slot tables are
integer tensors on the host (the wrappers view the callers' numpy tables
in place), which the CUDA launches read without a copy from the card. A CPU tensor beside CUDA operands does not change the
dispatch: the CUDA implementation runs.

Nothing falls back: a CUDA operand launches its kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import gemm_tn as _gemm_tn
from repro_torch.kernels import potrf as _potrf
from repro_torch.kernels import syrk as _syrk
from repro_torch.kernels import trsm as _trsm

__all__ = ["NAMESPACE", "DTYPES", "dtype_code", "launches", "OPS"]

NAMESPACE = "repro_torch"
# output dtypes an operator takes, by index (the schemas' ``out_dtype``)
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_CODES = {dt: i for i, dt in enumerate(DTYPES)}

# kernel name -> CUDA launches since the last ops.reset_launches()
launches = {"syrk": 0, "gemm_tn": 0, "gemm_tn_fused": 0, "syrk_gather": 0, "potrf": 0,
            "trsm": 0}


def dtype_code(dtype) -> int:
    """The schema's index of an output dtype; raises ``TypeError`` for one
    no operator stores."""
    try:
        return _CODES[dtype]
    except KeyError:
        raise TypeError(f"the kernels store one of {DTYPES}, got out_dtype={dtype}") from None


def _syrk_call(fn):
    def impl(a, alpha, out_dtype, packed, bn):
        return fn()(a, alpha=alpha, out_dtype=DTYPES[out_dtype],
                    out="packed" if packed else "dense", bn=bn)
    return impl


def _syrk_fake(a, alpha, out_dtype, packed, bn):
    n = a.shape[-1]
    if packed:
        nb = -(-n // bn)
        tail = (nb * (nb + 1) // 2, bn, bn)
    else:
        tail = (n, n)
    return a.new_empty((*a.shape[:-2], *tail), dtype=DTYPES[out_dtype])


def _gather_call(fn):
    def impl(a_blocks, rows, cols, alpha, out_dtype):
        return fn()(a_blocks, rows, cols, alpha=alpha, out_dtype=DTYPES[out_dtype])
    return impl


def _gather_fake(a_blocks, rows, cols, alpha, out_dtype):
    n = a_blocks.shape[-1]
    lead = (rows.shape[0], a_blocks.shape[2]) if a_blocks.ndim == 5 else (rows.shape[0],)
    return a_blocks.new_empty((*lead, n, n), dtype=DTYPES[out_dtype])


def _tn_call(fn):
    def impl(a, b, alpha, out_dtype):
        return fn()(a, b, alpha=alpha, out_dtype=DTYPES[out_dtype])
    return impl


def _tn_fake(a, b, alpha, out_dtype):
    return a.new_empty((*a.shape[:-2], a.shape[-1], b.shape[-1]), dtype=DTYPES[out_dtype])


def _fused_call(fn):
    def impl(a_blocks, b_blocks, a_rows, a_cols, a_sgn, b_rows, b_cols, b_sgn, alpha,
             out_dtype):
        return fn()(a_blocks, b_blocks, ((a_rows, a_cols, a_sgn), (b_rows, b_cols, b_sgn)),
                    alpha=alpha, out_dtype=DTYPES[out_dtype])
    return impl


def _fused_fake(a_blocks, b_blocks, a_rows, a_cols, a_sgn, b_rows, b_cols, b_sgn, alpha,
                out_dtype):
    leaves = a_blocks.shape[0] * a_rows.shape[0]
    lead = (leaves, a_blocks.shape[3]) if a_blocks.ndim == 6 else (leaves,)
    return a_blocks.new_empty((*lead, a_blocks.shape[-1], b_blocks.shape[-1]),
                              dtype=DTYPES[out_dtype])


def _potrf_call(fn):
    def impl(a, out_dtype):
        return fn()(a, out_dtype=DTYPES[out_dtype])
    return impl


def _potrf_fake(a, out_dtype):
    return a.new_empty(a.shape, dtype=DTYPES[out_dtype])


def _trsm_call(fn):
    def impl(l, b, transpose, out_dtype):
        return fn()(l, b, transpose=transpose, out_dtype=DTYPES[out_dtype])
    return impl


def _trsm_fake(l, b, transpose, out_dtype):
    return b.new_empty(b.shape, dtype=DTYPES[out_dtype])


# name -> (schema, adapter from the schema's arguments to the kernel
# module's keywords, fake, kernel module, its plain and CUDA functions).
# The functions are looked up at each call, so one replaced on its module
# is the one the operator runs.
_SPECS = {
    "syrk": ("syrk(Tensor a, float alpha, int out_dtype, bool packed, int bn) -> Tensor",
             _syrk_call, _syrk_fake, _syrk, "syrk_plain", "syrk_cuda"),
    "syrk_gather": ("syrk_gather(Tensor a_blocks, Tensor rows, Tensor cols, float alpha, "
                    "int out_dtype) -> Tensor",
                    _gather_call, _gather_fake, _syrk, "syrk_gather_plain", "syrk_gather_cuda"),
    "gemm_tn": ("gemm_tn(Tensor a, Tensor b, float alpha, int out_dtype) -> Tensor",
                _tn_call, _tn_fake, _gemm_tn, "gemm_tn_plain", "gemm_tn_cuda"),
    "gemm_tn_fused": ("gemm_tn_fused(Tensor a_blocks, Tensor b_blocks, Tensor a_rows, "
                      "Tensor a_cols, Tensor a_sgn, Tensor b_rows, Tensor b_cols, "
                      "Tensor b_sgn, float alpha, int out_dtype) -> Tensor",
                      _fused_call, _fused_fake, _gemm_tn, "gemm_tn_fused_plain",
                      "gemm_tn_fused_cuda"),
    "potrf": ("potrf(Tensor a, int out_dtype) -> Tensor",
              _potrf_call, _potrf_fake, _potrf, "potrf_plain", "potrf_cuda"),
    "trsm": ("trsm(Tensor l, Tensor b, bool transpose, int out_dtype) -> Tensor",
             _trsm_call, _trsm_fake, _trsm, "trsm_plain", "trsm_cuda"),
}


def _counted(name, impl):
    def launch(*args):
        out = impl(*args)
        launches[name] += 1
        return out
    return launch


_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_schema, _adapt, _fake, _mod, _plain, _cuda) in _SPECS.items():
    _LIB.define(_schema)
    _LIB.impl(_name, _adapt(lambda m=_mod, f=_plain: getattr(m, f)), "CPU")
    _LIB.impl(_name, _counted(_name, _adapt(lambda m=_mod, f=_cuda: getattr(m, f))), "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)

# name -> the operator's overload, called by the ops wrappers
OPS = {name: getattr(getattr(torch.ops, NAMESPACE), name).default for name in _SPECS}
