"""The port's dry-run (``repro_torch.launch.dryrun``), its production mesh
(``launch.mesh.make_production_mesh`` over torch's fake process group) and
the roofline and tables it feeds (``analysis.roofline``,
``analysis.fill_experiments``), on the CPU at small sizes.

* **Roofline parity.** ``compose_cell``, ``render_markdown``,
  ``collective_seconds``, ``dryrun_table`` and both ``main`` s equal the
  reference's on the same synthetic records (the decode, affine, hybrid
  and raw compositions, a gram, a skipped and an error row), with the
  port's H100 rates and levers monkeypatched to the reference's TPU v5e
  ones; the dry-run table's "compile s" column is "trace s" in the port.
* **The traces**, on a fake (2, 2) group (``launch.mesh.fake_mesh``, torch's
  fake backend; the group is torn down after each test, so nothing leaks
  to the next file on the worker): a dense config at 3 layers, whose
  ``_affine`` of the L = 1 and L = 2 variants reproduces the main
  artifact's flops and collective bytes exactly; rank 0 and rank 3 give
  the same record; the gram cell's rank-0 flops are
  ``core.distributed.tile_parallel_device_flops`` plus the additions of
  the symmetric assembly, each named.
* **The CLI.** Skipped cells carry the reference's ``cell_supported``
  reason; qwen1.5-0.5b × decode_32k on the (16, 16) production mesh runs
  in a subprocess (``--device cpu``, fake tensors: nothing is allocated)
  and fits 80e9 bytes a rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.analysis import fill_experiments as jfill
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.analysis import fill_experiments as tfill
from repro_torch.analysis import roofline as troof
from repro_torch.configs.base import SHAPES, RunConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the traced cell: the dense smoke config at 3 layers, 8 sequences of 64
TRAIN_SHAPE = ShapeConfig("small", 64, 8, "train")
LAYERS = 3
GRAM_M, GRAM_N = 2048, 1024


# ---------------------------------------------------------------------------
# roofline and tables against the reference
# ---------------------------------------------------------------------------


@pytest.fixture
def v5e(monkeypatch):
    """The port's roofline at the reference's TPU v5e rates and with its
    levers' wording (the levers name each device's remedies)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "_SUGGEST"):
        monkeypatch.setattr(troof, name, getattr(jroof, name))


def _artifact(flops, nbytes, coll, peak=None, seconds=7.0):
    art = {"cost": {"flops": flops, "bytes_accessed": nbytes, "transcendentals": 0.0},
           "collectives": dict(coll), "memory": {},
           "compile_s": seconds, "trace_s": seconds}
    if peak is not None:
        art["memory"]["peak_bytes_est"] = peak
    return art


def _records():
    """Dry-run records of each composition the roofline knows, and rows it
    leaves out: decode (unrolled artifact), a uniform stack (l1/l2), a
    hybrid stack (g1/gs2/ss2), a raw main artifact, a gram cell, a skipped
    and an error cell, and a tagged variant."""
    coll = {"all-reduce": 3.0e9, "all-gather": 1.5e9, "reduce-scatter": 0.7e9,
            "all-to-all": 0.0, "collective-permute": 2.5e8}
    base = dict(status="ok", arch="qwen1.5-0.5b", active_params=619_570_176,
                num_layers=24, variant_tag="")
    decode = dict(base, mode="decode", shape="decode_32k", mesh="single", artifacts={
        "main": _artifact(1e12, 2e11, coll, 3 * 2**30),
        "analysis_unrolled": _artifact(2.2e12, 4.4e11, coll)})
    train = dict(base, mode="train", shape="train_4k", mesh="multi", artifacts={
        "main": _artifact(5e14, 7e12, coll, 41 * 2**30, seconds=123.4),
        "analysis_l1": _artifact(3.1e13, 2.2e11, coll),
        "analysis_l2": _artifact(5.3e13, 3.9e11, {k: 2 * v for k, v in coll.items()})})
    hybrid = dict(base, arch="hymba-1.5b", mode="prefill", shape="prefill_32k",
                  mesh="single", global_attn_layers=[0, 15, 31], num_layers=32, artifacts={
                      "main": _artifact(9e14, 3e12, coll, 17 * 2**30),
                      "analysis_g1": _artifact(6e13, 1e12, coll),
                      "analysis_gs2": _artifact(9e13, 1.7e12, coll),
                      "analysis_ss2": _artifact(1.1e14, 2.1e12, coll)})
    raw = dict(base, arch="gemma-7b", mode="train", shape="train_4k", mesh="single",
               artifacts={"main": _artifact(4e14, 0.0, {k: 0 for k in coll}, 2**30)})
    gram = dict(base, arch="gram", mode="gram", shape="65536x16384", mesh="single",
                artifacts={"naive": _artifact(1e13, 1e12, coll)})
    skipped = dict(arch="qwen1.5-4b", shape="long_500k", mesh="single", mode="decode",
                   variant_tag="", status="skipped", reason="long_500k skipped")
    error = dict(arch="mamba2-1.3b", shape="long_500k", mesh="multi", mode="decode",
                 variant_tag="", status="error", error="ValueError: " + "x" * 200)
    tagged = dict(train, variant_tag="bf16")
    return [decode, train, hybrid, raw, gram, skipped, error, tagged]


@pytest.mark.parametrize("i", range(8))
def test_compose_cell_equals_the_reference(i, v5e):
    rec = _records()[i]
    assert troof.compose_cell(rec) == jroof.compose_cell(rec)


def test_render_markdown_equals_the_reference(v5e):
    rows = [troof.compose_cell(r) for r in _records()]
    got = troof.render_markdown(rows)
    assert got == jroof.render_markdown([jroof.compose_cell(r) for r in _records()])
    assert got.count("\n") == 2 + 5 and "**memory**" in got


def test_port_levers_cover_every_term():
    assert set(troof._SUGGEST) == set(jroof._SUGGEST)


@pytest.mark.parametrize("by_kind,link_bw,scale", [
    ({"all-reduce": 100e9, "all-gather": 50e9}, 50e9, 1.0),
    ({"reduce-scatter": 3e9, "all-to-all": 1e9, "collective-permute": 7}, 25e9, 2.5),
    ({"something-new": 1e6}, 50e9, 1.0),
])
def test_collective_seconds_equals_the_reference(by_kind, link_bw, scale):
    assert troof.collective_seconds(by_kind, link_bw, scale) == jhlo.collective_seconds(
        by_kind, link_bw, scale)
    assert troof.COLLECTIVE_KINDS == jhlo.COLLECTIVE_KINDS


def test_h100_rates():
    """Data-sheet rates of one H100 SXM 80 GB; the memory rate is the
    planner's ``cuda`` machine's."""
    from repro_torch.tune.cost import MACHINES

    assert troof.PEAK_FLOPS == 989e12 and troof.LINK_BW == 50e9
    assert troof.HBM_BW == MACHINES["cuda"]().hbm_bw == 3.35e12
    assert troof.CHIPS == jroof.CHIPS


def test_model_flops_per_device_equals_the_reference():
    for rec in _records()[:4]:
        assert troof.model_flops_per_device(rec) == jroof.model_flops_per_device(rec)
    assert {k: (s.seq_len, s.global_batch) for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch) for k, s in JSHAPES.items()}


def test_dryrun_table_equals_the_reference():
    recs = _records()
    want = jfill.dryrun_table(recs).replace("| compile s |", "| trace s |")
    assert tfill.dryrun_table(recs) == want
    assert "skipped (documented)" in want and "**ERROR**" in want


def _write_records(tmp_path):
    d = tmp_path / "dryrun"
    d.mkdir()
    for i, rec in enumerate(_records()):
        (d / f"cell{i}.json").write_text(json.dumps(rec))
    return d


def test_fill_experiments_main_equals_the_reference(tmp_path, monkeypatch, capsys, v5e):
    d = _write_records(tmp_path)
    text = "# E\n\n## Dry-run\n<!-- DRYRUN_TABLE -->\nold\n\n## Roofline\n<!-- ROOFLINE_TABLE -->\n"
    (tmp_path / "t.md").write_text(text)
    (tmp_path / "j.md").write_text(text)
    tfill.main(["--dryrun", str(d), "--experiments", str(tmp_path / "t.md")])
    monkeypatch.setattr(sys, "argv", ["fill", "--dryrun", str(d), "--experiments",
                                      str(tmp_path / "j.md")])
    jfill.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "EXPERIMENTS.md updated: 5 ok, 1 skipped, 1 errors"
    want = (tmp_path / "j.md").read_text().replace("| compile s |", "| trace s |")
    assert (tmp_path / "t.md").read_text() == want and "old" not in want


def test_roofline_main_equals_the_reference(tmp_path, monkeypatch, capsys, v5e):
    d = _write_records(tmp_path)
    troof.main(["--dryrun", str(d), "--out", str(tmp_path / "t")])
    monkeypatch.setattr(sys, "argv", ["roofline", "--dryrun", str(d), "--out",
                                      str(tmp_path / "j")])
    jroof.main()
    capsys.readouterr()
    for name in ("roofline.json", "roofline.md"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


# ---------------------------------------------------------------------------
# traces on a fake (2, 2) group
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _fake_world(rank: int = 0):
    """Rank ``rank``'s (data 2, model 2) mesh over a fake group, destroyed on
    exit."""
    assert not dist.is_initialized()
    try:
        yield tmesh.fake_mesh((2, 2), ("data", "model"), rank=rank, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dense_cfg():
    return dataclasses.replace(get_smoke("qwen1.5-0.5b"), num_layers=LAYERS)


def _train_record(rank: int, analysis: bool) -> dict:
    cfg = _dense_cfg()
    run = RunConfig(model=cfg, shape=TRAIN_SHAPE, remat="full")
    with _fake_world(rank) as mesh:
        return dryrun._train_artifacts(cfg, TRAIN_SHAPE, mesh, run, analysis=analysis)


def test_affine_composition_reproduces_the_main_artifact():
    arts = _train_record(0, analysis=True)
    assert set(arts) == {"main", "analysis_l1", "analysis_l2"}
    got = troof._affine(troof._cost_vec(arts["analysis_l1"]),
                        troof._cost_vec(arts["analysis_l2"]), LAYERS)
    want = troof._cost_vec(arts["main"])
    assert got["flops"] == want["flops"] > 0
    for kind in troof.COLLECTIVE_KINDS:
        assert got[f"coll_{kind}"] == want[f"coll_{kind}"], kind
    # the step all-reduces the gradients over data and all-gathers the
    # ZeRO-1 updates: both the bytes of the parameters (and a few scalars)
    main = arts["main"]
    params = main["memory"]["argument_bytes"]
    assert main["collectives"]["all-gather"] > 0
    assert main["collectives"]["all-reduce"] >= main["collectives"]["all-gather"]
    assert 0 < main["memory"]["temp_bytes"] == main["memory"]["peak_bytes_est"] - params
    assert main["kernels"] == {}


def test_rank_symmetry():
    """A rank's program depends on its coordinates only through which block
    it holds: rank 3 (data 1, model 1) gives rank 0's record."""
    def strip(arts):
        return {k: {f: v for f, v in a.items() if f != "trace_s"} for k, a in arts.items()}

    assert strip(_train_record(0, analysis=False)) == strip(_train_record(3, analysis=False))


def test_gram_flops_equal_the_tile_model():
    """Rank 0 of the gram cell at m = 2048, n = 1024 on (2, 2) (rows over
    data: a (1024, 1024) block): ``tile_parallel_device_flops`` of its
    tiles, plus the symmetric assembly's additions, one a element:
    ``sym_tile`` of the nb diagonal stripe tiles (nb·w²), of the packed
    storage's diagonal blocks (nb_pack·bn², ``_symmetrize_diag``) and, for
    a dense result, of the n × n mirror (n², ``to_dense``)."""
    from repro_torch.core.distributed import choose_tiling, tile_parallel_device_flops
    from repro_torch.core.symmetric import default_block_size
    from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

    with _fake_world(0) as mesh:
        arts = dryrun._gram_artifacts(mesh, m=GRAM_M, n=GRAM_N, n_base=128)
    assert set(arts) == {"naive", "strassen", "winograd", "strassen_packed", "strassen_nb128",
                         "strassen_wide5"}
    n = GRAM_N
    nb, w = choose_tiling(n, 2)
    bn = default_block_size(n, DEFAULT_PACKED_BLOCK)
    nb_pack = -(-n // bn)
    assembly = nb * w * w + nb_pack * bn * bn + n * n
    for label, use_strassen in (("naive", False), ("strassen", True)):
        model = tile_parallel_device_flops(GRAM_M // 2, n, 2, n_base=128,
                                           use_strassen=use_strassen, backend="cpu")
        assert arts[label]["cost"]["flops"] == model[0] + assembly, label
        assert arts[label]["memory"]["argument_bytes"] == GRAM_M // 2 * n * 4
    # each rank all-reduces its (t_per, w, w) float32 partials over data,
    # then all-gathers the task ranks' stacks
    t_per = -(-(nb * (nb + 1) // 2) // 2)
    assert arts["naive"]["collectives"]["all-reduce"] == t_per * w * w * 4
    assert arts["naive"]["collectives"]["all-gather"] == 2 * t_per * w * w * 4
    assert arts["strassen"]["kernels"] == {"gemm_tn": t_per * 7 ** 2}
    # the packed retrieval returns no dense square
    assert arts["strassen_packed"]["memory"]["output_bytes"] < n * n * 4


def test_fake_mesh_refuses_another_group():
    with _fake_world(1) as mesh:
        assert (mesh.rank, mesh.coords, mesh.backend) == (1, {"data": 0, "model": 1}, "fake")
        assert mesh.group("model") is not None and mesh.group(("data", "model")) is not None
        with pytest.raises(ValueError, match="not the fake group of world 4 and rank 0"):
            tmesh.fake_mesh((2, 2), ("data", "model"), rank=0, device="cpu")
        with pytest.raises(ValueError, match="world 256"):
            tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="outside a mesh of 4"):
        tmesh.fake_mesh((2, 2), ("data", "model"), rank=4, device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS if not get_config(a).sub_quadratic))
def test_skipped_cells_carry_the_reference_reason(arch):
    rec = dryrun.run_cell(arch, "long_500k", "single", device="cpu")
    _, reason = jreg.cell_supported(jreg.get_config(arch), JSHAPES["long_500k"])
    assert rec["status"] == "skipped" and rec["reason"] == reason
    assert (rec["rank"], rec["device"], rec["target"]) == (0, "cpu", "h100")
    assert not dist.is_initialized()


def test_one_production_cell_traces(tmp_path):
    """qwen1.5-0.5b × decode_32k on the 16×16 mesh, end to end
    (subprocess), the counterpart of the reference's
    ``test_one_production_cell_compiles``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
         "--mesh", "single", "--no-analysis", "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    with open(tmp_path / "qwen1.5-0.5b__decode_32k__single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and set(rec["artifacts"]) == {"main"}
    art = rec["artifacts"]["main"]
    mem = art["memory"]
    assert 0 < mem["peak_bytes_est"] < 80e9  # fits an H100
    assert mem["peak_bytes_est"] == mem["argument_bytes"] + mem["temp_bytes"]
    # over model, each rank all-reduces the sequence-parallel attention's
    # partials and the row-parallel products' (wo, the MLP's wd, the
    # vocab-parallel embedding), and all-gathers the q/k/v heads and the
    # last position's vocab blocks; nothing else moves
    c = art["collectives"]
    assert c["all-reduce"] > 0 and c["all-gather"] > 0
    assert sum(c.values()) == c["all-reduce"] + c["all-gather"]
    assert art["cost"]["flops"] > 0 and art["kernels"] == {}
    assert "ok] qwen1.5-0.5b × decode_32k × single" in r.stdout
    assert "done: 1 ok, 0 skipped, 0 errors" in r.stdout
