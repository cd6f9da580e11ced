"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _top(name: str) -> str:
    return name.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES if "src" in p.parts}
    for mod in ("repro_torch/__init__.py", "repro_torch/backend.py", "repro_torch/convert.py",
                "repro_torch/tune/defaults.py", "repro_torch/core/reference.py",
                "repro_torch/core/symmetric.py", "repro_torch/core/strassen.py",
                "repro_torch/core/ata.py", "repro_torch/kernels/_build.py",
                "repro_torch/kernels/ops.py", "repro_torch/kernels/gemm_tn.py",
                "repro_torch/kernels/syrk.py", "repro_torch/kernels/potrf.py",
                "repro_torch/kernels/trsm.py", "repro_torch/solve/cholesky.py",
                "repro_torch/solve/triangular.py", "repro_torch/solve/lstsq.py",
                "repro_torch/solve/cg.py", "repro_torch/obs/__init__.py",
                "repro_torch/obs/trace.py", "repro_torch/obs/metrics.py",
                "repro_torch/obs/calibrate.py", "repro_torch/obs/__main__.py",
                "repro_torch/analysis/roofline.py", "repro_torch/tune/cost.py",
                "repro_torch/tune/cache.py", "repro_torch/tune/search.py",
                "repro_torch/tune/apply.py", "repro_torch/optim/__init__.py",
                "repro_torch/optim/_tree.py", "repro_torch/optim/adamw.py",
                "repro_torch/optim/schedules.py", "repro_torch/optim/shampoo.py",
                "repro_torch/optim/powersgd.py", "repro_torch/configs/base.py",
                "repro_torch/configs/qwen15_05b.py", "repro_torch/core/distributed.py",
                "repro_torch/launch/__init__.py", "repro_torch/launch/mesh.py",
                "repro_torch/launch/collectives.py", "repro_torch/serve/__init__.py",
                "repro_torch/serve/bucketing.py", "repro_torch/serve/queue.py",
                "repro_torch/serve/metrics.py", "repro_torch/serve/engine.py",
                "repro_torch/serve/__main__.py", "repro_torch/kernels/_library.py",
                "repro_torch/kernels/ref.py", "repro_torch/check/__init__.py",
                "repro_torch/check/findings.py", "repro_torch/check/artifacts.py",
                "repro_torch/check/rules.py", "repro_torch/check/harness.py",
                "repro_torch/check/__main__.py", "repro_torch/core/task_tree.py",
                "repro_torch/analysis/perf_diff.py", "repro_torch/configs/registry.py",
                "repro_torch/data/pipeline.py", "repro_torch/models/layers.py",
                "repro_torch/models/transformer.py", "repro_torch/train/train_step.py",
                "repro_torch/checkpoint/manager.py", "repro_torch/runtime/fault_tolerance.py",
                "repro_torch/launch/train.py", "repro_torch/models/moe.py",
                "repro_torch/models/ssm.py", "repro_torch/train/serve_step.py",
                "repro_torch/launch/serve.py"):
        assert mod in names, mod
    for src in ("gemm_tn.cu", "syrk.cu", "potrf.cu", "trsm.cu", "dtype.cuh"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / src).is_file(), src


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _top(m) in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_ast_scan_catches_forbidden_imports(tmp_path):
    """The scan itself: each forbidden form is found, the port's own name is not."""
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom repro.core import ata\nimport repro\n"
        "from repro_torch import lstsq\n__import__('jax')\n"
    )
    tops = [_top(m) for m in _imported_modules(probe)]
    assert tops.count("jax") == 2 and tops.count("repro") == 2 and "repro_torch" in tops


def test_package_imports_without_jax():
    """Importing the port with JAX made unimportable still works."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.convert, repro_torch.kernels._build\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_obs_imports_neither_jax_nor_the_reference():
    """``import repro_torch.obs`` loads no module of JAX or of ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.obs, repro_torch.solve.cg, repro_torch.optim\n"
        "import repro_torch.optim.powersgd, repro_torch.configs.qwen15_05b\n"
        "import repro_torch.serve, repro_torch.serve.__main__\n"
        "import repro_torch.check, repro_torch.check.__main__, repro_torch.kernels.ref\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", (out.stdout, out.stderr)


def test_tf32_disabled_at_import():
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_cuda():
    """On a machine without a card the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal path is not reachable")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# front doors and kernel wrappers: (module path under src/<package>/, function)
FRONT_DOORS = [("core/ata.py", "ata"), ("core/ata.py", "ata_batched"),
               ("core/strassen.py", "strassen_tn"), ("solve/cholesky.py", "cholesky"),
               ("solve/triangular.py", "solve_triangular"),
               ("solve/triangular.py", "solve_cholesky"), ("solve/cg.py", "cg_lstsq"),
               ("solve/lstsq.py", "lstsq")] + [
    ("core/distributed.py", f) for f in ("gram_rowshard", "ata_tile_parallel", "ata_bfs_dfs",
                                         "gemm_tn_colshard")] + [
    ("kernels/ops.py", f) for f in ("syrk", "gemm_tn", "gemm_tn_fused", "syrk_gather", "potrf",
                                    "trsm")]


def _params(package: str, module: str, name: str) -> set:
    path = ROOT / "src" / package / module
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            a = node.args
            return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    raise AssertionError(f"{package}/{module} defines no {name}")


@pytest.mark.parametrize("module,name", FRONT_DOORS, ids=lambda x: str(x))
def test_plan_keywords_where_the_reference_has_them(module, name):
    """An AST diff of the two packages: every ``plan=``/``gemm_plan=`` of a
    reference front door or kernel wrapper exists on the port's."""
    want = _params("repro", module, name) & {"plan", "gemm_plan"}
    assert want <= _params("repro_torch", module, name), (module, name)


def test_plan_keyword_diff_sees_the_reference():
    assert _params("repro", "solve/cg.py", "cg_lstsq") >= {"plan", "gemm_plan"}
    assert "plan" not in _params("repro", "kernels/ops.py", "potrf")
    assert "plan" in _params("repro", "core/distributed.py", "ata_bfs_dfs")


# the serving layer's public functions and methods: (module, class or None, name)
SERVE_SIGNATURES = [("serve/bucketing.py", None, f) for f in (
    "make_buckets", "pad_operands", "crop_result")] + [
    ("serve/bucketing.py", "BucketSpec", f) for f in ("admits", "label", "to_json",
                                                       "from_json")] + [
    ("serve/bucketing.py", "BucketLattice", f) for f in ("__init__", "bucket_for")] + [
    ("serve/engine.py", None, f) for f in ("smoke_config", "per_slice_trsm",
                                           "serve_abstract_args")] + [
    ("serve/engine.py", "Server", f) for f in (
        "__init__", "bucket_plan", "request_twin", "bucket_callable", "warm", "submit",
        "pump", "drain", "retraces", "stats")] + [
    ("serve/queue.py", "MicroBatchQueue", f) for f in ("__init__", "offer", "due", "depth",
                                                       "lane_depths")] + [
    ("serve/queue.py", "Ticket", f) for f in ("__init__", "result", "set_result", "done")] + [
    ("serve/queue.py", "Rejected", "__init__")] + [
    ("serve/metrics.py", None, f) for f in (
        "record_latency", "samples", "percentile", "percentiles", "latency_summary",
        "publish_percentiles", "reset")] + [
    ("serve/__main__.py", None, f) for f in ("main", "_mixed_workload", "_make_request",
                                             "_parity_spot_check", "_run_workload")]


def _member_params(package: str, module: str, cls, name: str):
    """Parameter names of ``cls.name`` (or module-level ``name``) and the
    names the module lists in ``__all__``."""
    path = ROOT / "src" / package / module
    tree = ast.parse(path.read_text(), filename=str(path))
    scope = tree.body
    if cls is not None:
        scope = next(n.body for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    for node in scope:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            a = node.args
            return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    raise AssertionError(f"{package}/{module} defines no {cls}.{name}")


@pytest.mark.parametrize("module,cls,name", SERVE_SIGNATURES, ids=lambda x: str(x))
def test_serve_signatures_cover_the_reference(module, cls, name):
    """Every parameter of a reference serving function or method exists on
    the port's, in the same order (the port may add keyword-only ones, such
    as ``device=`` and ``out=``); no serving signature takes ``plan=`` in
    either package."""
    want = _member_params("repro", module, cls, name)
    got = _member_params("repro_torch", module, cls, name)
    assert got[:len(want)] == want, (want, got)
    assert "plan" not in want and "plan" not in got


def test_serve_exports_match_the_reference():
    for module in ("serve/__init__.py", "serve/bucketing.py", "serve/queue.py",
                   "serve/metrics.py", "serve/engine.py"):
        def names(package):
            path = ROOT / "src" / package / module
            for node in ast.parse(path.read_text()).body:
                if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
                    return {e.value for e in node.value.elts}
        assert names("repro") <= names("repro_torch"), module


# names of a reference module's __all__ the port leaves out on purpose:
# the Pallas entry points and interpret mode (the CUDA kernels and the
# device routing take their place), and ``MeshAxes``, which the
# reference's sharding module names in its __all__ but never defines
EXPORT_DEPARTURES = {
    "kernels/gemm_tn.py": {"gemm_tn_pallas", "gemm_tn_fused_pallas"},
    "kernels/syrk.py": {"syrk_pallas", "syrk_gather_pallas"},
    "kernels/potrf.py": {"potrf_pallas"},
    "kernels/trsm.py": {"trsm_pallas"},
    "kernels/ops.py": {"interpret_default"},
    "parallel/sharding.py": {"MeshAxes"},
}
# reference modules with no port, having no counterpart: HLO text (its
# collective-time model lives in the port's analysis/roofline.py) and JAX
# version shims
UNPORTED = {"analysis/hlo.py", "compat.py"}
REFERENCE_MODULES = sorted(p.relative_to(ROOT / "src" / "repro").as_posix()
                           for p in (ROOT / "src" / "repro").rglob("*.py"))


def _exports(package: str, module: str):
    path = ROOT / "src" / package / module
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "__all__"):
            return {e.value for e in node.value.elts}
    return set()


def test_unported_modules_are_the_known_ones():
    missing = {m for m in REFERENCE_MODULES if not (ROOT / "src" / "repro_torch" / m).is_file()}
    assert missing == UNPORTED


@pytest.mark.parametrize("module", [m for m in REFERENCE_MODULES if m not in UNPORTED])
def test_exports_match_the_reference(module):
    """Every name of a ported module's reference ``__all__`` is in the
    port's, apart from the listed departures (which the port must indeed
    lack: a departure that got ported leaves the list)."""
    want, got = _exports("repro", module), _exports("repro_torch", module)
    departures = EXPORT_DEPARTURES.get(module, set())
    assert want - departures <= got, sorted(want - departures - got)
    assert not departures & got, sorted(departures & got)
