"""Build and load the port's CUDA kernels.

All sources under ``repro_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` — one ``nvcc -c`` per source, all started together — and linked
into one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library lives
in ``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the sources and flags, so a fresh checkout builds it at first use and an
unchanged one reuses it.

Nothing here runs at import: the first kernel launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "build", "check", "resources", "source_hash", "CSRC", "BUILD_ROOT",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "librepro_torch_kernels.so"

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argtypes (all return a cudaError_t as int). The
# launches (*_f32: float32 accumulation) take a dtypes int before the
# stream (bit 0 bfloat16 operands, bit 1 bfloat16 output; csrc/dtype.cuh);
# gemm_tn_f32 then the kernel the wrapper chose (kernels.gemm_tn.tn_route);
# syrk_wgmma / syrk_gather_wgmma (bfloat16 operands, kernels.syrk.syrk_route)
# then an int out-pointer (whether the stages arrived by TMA) before it.
# The *_info entry points fill an int array with the resources of a
# kernel's float32 instance (gemm_tn_narrow_info: the instance and plan
# gemm_tn_f32 launches at (n, k, batch) for k up to its max_k; the *_wgmma_
# ones: the bfloat16 tensor-core instances, float32 output).
SIGNATURES = {
    "gemm_tn_f32": (P, P, P, I, I, I, I, LL, LL, LL, LL, F, I, I, I, P),
    "gemm_tn_info": (I, P),
    "gemm_tn_wgmma_info": (P,),
    "gemm_tn_narrow_info": (I, I, I, P),
    "gemm_tn_fused_f32": (P, P, P, P, P, I, I, I, I, I, I, LL, LL, LL, LL, F, I, I, P),
    "gemm_tn_fused_info": (I, P),
    "gemm_tn_fused_wgmma_info": (I, P),
    "syrk_f32": (P, P, I, I, I, LL, LL, F, I, I, I, I, I, P),
    "syrk_gather_f32": (P, P, P, I, I, I, I, LL, LL, F, I, I, I, P),
    "syrk_info": (I, I, P),
    "syrk_wgmma": (P, P, I, I, I, LL, LL, F, I, I, I, I, I, P, P),
    "syrk_gather_wgmma": (P, P, P, P, I, I, I, I, LL, LL, I, I, LL, LL, F, I, I, I, P, P),
    "syrk_wgmma_info": (I, P),
    "potrf_f32": (P, P, I, I, I, P),
    "potrf_info": (I, P),
    "trsm_f32": (P, P, P, I, I, I, LL, I, I, P),
    "trsm_info": (I, I, P),
}
# what each *_info entry point writes, in order
RESOURCE_FIELDS = {
    "gemm_tn_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                     "ctas_per_sm", "ring_stages", "stage_rows"),
    "gemm_tn_wgmma_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                           "ctas_per_sm", "ring_stages", "stage_rows", "threads"),
    "gemm_tn_narrow_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                            "local_bytes", "ctas_per_sm", "threads", "strip_columns",
                            "columns_a_thread", "stage_rows", "ring_stages", "ctas", "max_k",
                            "copy_threads"),
    "gemm_tn_fused_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                           "local_bytes", "ctas_per_sm", "active_clusters", "ring_stages",
                           "cluster_edge", "stage_slabs"),
    "gemm_tn_fused_wgmma_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                                 "local_bytes", "ctas_per_sm", "active_clusters", "ring_stages",
                                 "cluster_edge", "stage_steps"),
    "syrk_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                  "ctas_per_sm", "cluster_size", "active_clusters"),
    "syrk_wgmma_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                        "ctas_per_sm", "cluster_size", "active_clusters", "ring_stages",
                        "stage_rows", "threads"),
    "potrf_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                   "ctas_per_sm"),
    "trsm_info": ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                  "ctas_per_sm", "rows_per_warp"),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "repro_torch build only where the CUDA toolkit is installed"
        )
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, hdrs = _sources()
    for path in srcs + hdrs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile every source in parallel and link the shared library.

    Returns ``(library path, seconds, compiler log)``; raises
    ``RuntimeError`` with the compiler's output if any step fails.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        log = (out_dir / "build.log").read_text() if (out_dir / "build.log").exists() else ""
        return lib, 0.0, log
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs, _ = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(srcs, objs)
        ]
        logs, failed = [], []
        for s, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            logs.append(f"== {s.name}\n{out}")
            if proc.returncode:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        staged = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        os.replace(staged, lib)
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare every entry point."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def resources(entry: str, *args: int) -> dict:
    """A kernel's registers, shared memory and occupancy on the current card,
    as its ``*_info`` entry point reads them (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and, for clusters,
    ``cudaOccupancyMaxActiveClusters``). ``args`` select the instance: the
    entry point's int arguments before its output array."""
    fields = RESOURCE_FIELDS[entry]
    out = (ctypes.c_int * len(fields))()
    check(getattr(load(), entry)(*args, out), entry)
    return dict(zip(fields, out))
