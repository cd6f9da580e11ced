"""``repro_torch.check`` against ``repro.check``: every rule fires on a
small violating FX graph and stays silent on the planned grid, the grid's
labels and findings equal the reference's field for field, and the CLI
runs in-process and in a subprocess with JAX absent.

The port's counterpart of ``tests/test_check.py``, case for case. Each
kernel launch is one ``repro_torch.*`` node of an FX graph (``make_fx`` on
fake tensors), where the reference sees one ``pallas_call`` equation.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import backend, check
from repro_torch.check import rules as check_rules
from repro_torch.check.artifacts import node_outputs, trace_fn
from repro_torch.tune import cost

ROOT = Path(__file__).resolve().parents[1]


def _art(fn, *args, label="synthetic", plan=None, collective_bytes=None, **overrides):
    """Trace ``fn`` (fake tensors) into an Artifact with override-pinned rules."""
    return check.Artifact(label=label, graph=trace_fn(fn, *args), plan=plan,
                          collective_bytes=collective_bytes, overrides=overrides)


def _violations(art, rule_id):
    return check.run(art, rules=[rule_id]).violations


def _plan(op, *dims, **kw):
    base = cost.default_plan(op, *dims, backend="cpu")
    kw.setdefault("algorithm", "strassen")
    kw.setdefault("n_base", 32)
    return dataclasses.replace(base, **kw)


# ---------------------------------------------------------------------------
# registry basics
# ---------------------------------------------------------------------------


def test_registry_ships_the_eight_rules():
    assert check.rule_ids() == sorted([
        "no-dense-square", "no-operand-stacks", "dot-budget",
        "launch-budget", "no-full-transpose", "acc-dtype",
        "no-vmap-of-pallas", "collective-budget",
    ])
    for rid in check.rule_ids():
        r = check.REGISTRY[rid]
        assert r.doc, f"rule {rid} has no docstring"
        assert r.severity in ("error", "warning")


def test_unknown_rule_id_raises():
    art = _art(lambda x: x + 1, torch.zeros((2, 2)))
    with pytest.raises(KeyError, match="no-such-rule"):
        check.run(art, rules=["no-such-rule"])


# ---------------------------------------------------------------------------
# no-dense-square
# ---------------------------------------------------------------------------


def test_no_dense_square_fires_on_materialized_square():
    a = torch.zeros((16, 8))
    art = _art(lambda x: x.T @ x, a, forbidden_squares={(8, 8)})
    found = _violations(art, "no-dense-square")
    assert found and found[0].shape == (8, 8)
    assert found[0].primitive == "aten.mm"
    assert found[0].eqn_index is not None
    assert "eqn#" in found[0].provenance


def test_no_dense_square_descends_nested_graphs():
    """The square hides inside a submodule's graph — provenance carries the
    path."""
    a = torch.zeros((16, 8))
    sub = trace_fn(lambda y: y.T @ y, a)
    g = torch.fx.Graph()
    x = g.placeholder("x")
    g.output(g.call_module("gram", (x,)))
    outer = torch.fx.GraphModule({"gram": sub}, g)
    art = check.Artifact(label="nested", graph=outer, overrides={"forbidden_squares": {(8, 8)}})
    found = _violations(art, "no-dense-square")
    assert any(f.path == ("gram",) and f.primitive == "aten.mm" for f in found), found


def test_no_dense_square_skips_views():
    """A view of an operand that happens to be (n, n) materializes nothing."""
    art = _art(lambda x: x[:8] * 1.0, torch.zeros((16, 8)), forbidden_squares={(8, 8)})
    found = _violations(art, "no-dense-square")
    assert [f.primitive for f in found] == ["aten.mul"]


def test_no_dense_square_clean_on_planned_packed_grid():
    plan = _plan("ata", 192, 128, packed_block=32, out="packed", use_kernels=False)
    art = check.trace_plan(plan, device="cpu")
    assert not _violations(art, "no-dense-square")


# ---------------------------------------------------------------------------
# no-operand-stacks
# ---------------------------------------------------------------------------


def _fused_gemm_plan(m=96, n=32, k=16, n_base=4):
    return _plan("gemm_tn", m, n, k, leaf_dispatch="fused", n_base=n_base, use_kernels=False)


def test_no_operand_stacks_fires_on_seven_multiple_stack():
    # leaf operand shape at L=2 for (96, 32, 16)/4 is (24, 8); a 49-deep
    # stack of it is exactly the batched dispatch's signature traffic
    plan = _fused_gemm_plan()
    art = _art(lambda x: torch.broadcast_to(x, (49, 24, 8)) * 2.0, torch.zeros((24, 8)),
               plan=plan)
    found = _violations(art, "no-operand-stacks")
    assert found and found[0].shape == (49, 24, 8)


def test_no_operand_stacks_ignores_product_stacks_and_pow2_relayouts():
    plan = _fused_gemm_plan()
    # (49, 8, 4) is the product stack (materialized by design); (16, 24, 8)
    # is a 4^L block-major relayout — neither is a violation
    art = _art(lambda x, y: (torch.broadcast_to(x, (49, 8, 4)) * 1.0,
                             torch.broadcast_to(y, (16, 24, 8)) * 1.0),
               torch.zeros((8, 4)), torch.zeros((24, 8)), plan=plan)
    assert not _violations(art, "no-operand-stacks")


# ---------------------------------------------------------------------------
# dot-budget
# ---------------------------------------------------------------------------


def test_dot_budget_fires_on_count_mismatch():
    art = _art(lambda x: x @ x, torch.zeros((8, 8)), expected_dots=2)
    found = _violations(art, "dot-budget")
    assert found and "predicts 2" in found[0].message


def test_dot_budget_clean_on_planned_unrolled_ata():
    plan = _plan("ata", 192, 128, leaf_dispatch="unrolled", use_kernels=False)
    art = check.trace_plan(plan, device="cpu")
    assert not _violations(art, "dot-budget")
    # and the closed form really is s + g
    s, g = cost._ata_leaves(192, 128, 32)
    got = sum(1 for st in art.sites() if st.name in check_rules.DOT_OPS)
    assert got == s + g


# ---------------------------------------------------------------------------
# launch-budget
# ---------------------------------------------------------------------------


def _one_syrk(x):
    from repro_torch.kernels import ops

    return ops.syrk(x)


def test_launch_budget_fires_on_count_and_ceiling():
    art = _art(_one_syrk, torch.zeros((64, 64)), expected_launches=0, launch_ceiling=0)
    found = _violations(art, "launch-budget")
    # one launch vs expected 0, and 1 > ceiling 0: both findings
    assert len(found) == 2
    assert any("closed" in f.message for f in found)
    assert any("budget" in f.message for f in found)


def test_launch_budget_clean_on_planned_fused_kernels():
    plan = _plan("ata", 192, 128, leaf_dispatch="fused", packed_block=32, use_kernels=True)
    art = check.trace_plan(plan, device="cpu")
    assert not _violations(art, "launch-budget")
    kernels = [s.name for s in art.sites() if s.name.startswith("repro_torch.")]
    assert kernels and len(kernels) == check_rules.expected_launches(plan)


# ---------------------------------------------------------------------------
# no-full-transpose
# ---------------------------------------------------------------------------


def test_no_full_transpose_fires_above_tile_bound():
    art = _art(lambda x: x.T.contiguous(), torch.zeros((8, 16)), max_transpose_dim=4)
    found = _violations(art, "no-full-transpose")
    assert found and found[0].shape == (16, 8)
    assert found[0].primitive == "aten.permute"          # what make_fx records for .T
    assert "aten.clone" in found[0].message


def test_no_full_transpose_mirror_budget_consumed_once():
    # two (8, 8) mirrors against a budget of one: the second must fire
    art = _art(lambda x: x.T.contiguous() + x.T.contiguous() * 2.0, torch.zeros((8, 8)),
               max_transpose_dim=4, mirror_budget=1, mirror_shape=(8, 8))
    assert len(_violations(art, "no-full-transpose")) == 1


def test_no_full_transpose_allows_tile_granular():
    art = _art(lambda x: x.T.contiguous(), torch.zeros((4, 4)), max_transpose_dim=4)
    assert not _violations(art, "no-full-transpose")


def test_no_full_transpose_reads_in_place_are_not_copies():
    """``Aᵀ`` read by a product (or elementwise op) in place is the TN
    contract kept; a copy through further views is not."""
    a = torch.zeros((8, 16))
    assert not _violations(_art(lambda x: x.T @ x, a, max_transpose_dim=4),
                           "no-full-transpose")
    found = _violations(_art(lambda x: x.T[1:].contiguous(), a, max_transpose_dim=4),
                        "no-full-transpose")
    assert len(found) == 1


def test_no_full_transpose_sees_the_wrappers_strided_copy():
    """A strided operand handed to a kernel wrapper on the card is copied
    once (``kernels.copy.<name>``); the copy is a node the rule reads."""
    from repro_torch.kernels import ops

    def copied(x):
        return ops._unit_columns("gemm_tn", x.T)

    art = _art(copied, torch.zeros((8, 16)), max_transpose_dim=4)
    assert len(_violations(art, "no-full-transpose")) == 1


# ---------------------------------------------------------------------------
# acc-dtype
# ---------------------------------------------------------------------------


def test_acc_dtype_fires_on_bf16_accumulation():
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    art = _art(lambda x, y: x @ y, a, a)
    found = _violations(art, "acc-dtype")
    assert found and "bfloat16" in found[0].message


def test_acc_dtype_clean_with_float32_cast():
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    art = _art(lambda x, y: x.float() @ y.float(), a, a)
    assert not _violations(art, "acc-dtype")


def test_acc_dtype_clean_on_planned_bf16_grid():
    """The planned bfloat16 paths all sum in float32."""
    plan = _plan("ata", 192, 128, leaf_dispatch="unrolled", use_kernels=False,
                 dtype="bfloat16")
    art = check.trace_plan(plan, device="cpu")
    assert not _violations(art, "acc-dtype")


# ---------------------------------------------------------------------------
# no-vmap-of-pallas
# ---------------------------------------------------------------------------


def test_no_vmap_of_pallas_is_registered_and_always_clean():
    """The port never vmaps a kernel: a stack is the kernel's native leading
    grid dim (one node, one launch), and the rule has nothing to find."""
    art = _art(_one_syrk, torch.zeros((2, 64, 64)))
    assert [s.name for s in art.sites()] == ["repro_torch.syrk"]
    assert not _violations(art, "no-vmap-of-pallas")
    assert "vmap" in check.REGISTRY["no-vmap-of-pallas"].doc


def test_no_vmap_of_pallas_clean_on_native_batch_grid():
    art = _art(_one_syrk, torch.zeros((2, 64, 64)), expected_launches=1)
    assert not _violations(art, "no-vmap-of-pallas")
    assert not _violations(art, "launch-budget")


# ---------------------------------------------------------------------------
# collective-budget
# ---------------------------------------------------------------------------

_AR = {"all-reduce": 128 * 128 * 4}


def test_collective_budget_fires_over_budget():
    art = _art(lambda x: x, torch.zeros((2, 2)), collective_bytes=_AR,
               collective_budget_bytes=1024)
    found = _violations(art, "collective-budget")
    assert found and "65536" in found[0].message   # 128·128·4


def test_collective_budget_respects_slack_and_budget():
    art = _art(lambda x: x, torch.zeros((2, 2)), collective_bytes=_AR,
               collective_budget_bytes=65536)
    assert not _violations(art, "collective-budget")
    art2 = _art(lambda x: x, torch.zeros((2, 2)), collective_bytes=_AR,
                collective_budget_bytes=32768, collective_slack=2.0)
    assert not _violations(art2, "collective-budget")


def test_collective_budget_skips_without_counters():
    art = _art(lambda x: x, torch.zeros((2, 2)), collective_budget_bytes=0)
    assert not _violations(art, "collective-budget")


# ---------------------------------------------------------------------------
# report / allowlist / obs wiring
# ---------------------------------------------------------------------------


def test_allowlist_suppresses_but_keeps_auditable():
    art = _art(lambda x: x.T @ x, torch.zeros((16, 8)), label="known:debt",
               forbidden_squares={(8, 8)})
    allow = check.Allow(rule="no-dense-square", artifact="known:*",
                        reason="legacy retrieval path, tracked in §9")
    report = check.run(art, rules=["no-dense-square"], allowlist=[allow])
    assert report.exit_code == 0 and not report.violations
    assert len(report.allowlisted) == 1
    j = report.to_json()
    assert j["counts"] == {"artifacts": 1, "findings": 0, "violations": 0, "allowlisted": 1}
    assert j["allowlist"][0]["reason"].startswith("legacy")


def test_allowlist_pattern_must_match_artifact():
    art = _art(lambda x: x.T @ x, torch.zeros((16, 8)), label="other:site",
               forbidden_squares={(8, 8)})
    allow = check.Allow(rule="no-dense-square", artifact="known:*")
    report = check.run(art, rules=["no-dense-square"], allowlist=[allow])
    assert report.exit_code == 1 and report.violations


def test_report_json_schema_and_summary():
    art = _art(lambda x: x.T @ x, torch.zeros((16, 8)), forbidden_squares={(8, 8)})
    report = check.run(art, rules=["no-dense-square"])
    j = report.to_json()
    assert j["schema"] == check.REPORT_SCHEMA == "repro.check/v1"
    assert j["meta"]["torch_version"] == torch.__version__ and "jax_version" not in j["meta"]
    f = j["findings"][0]
    assert f["rule"] == "no-dense-square" and f["shape"] == [8, 8]
    assert f["provenance"]
    assert "no-dense-square" in report.summary()


def _counter_deltas(metrics, run_one):
    names = ("check.violations", "check.findings.no-dense-square", "check.artifacts",
             "check.rules_run")
    before = {n: metrics.get(n) for n in names}
    run_one()
    return {n: metrics.get(n) - before[n] for n in names}


def test_run_increments_obs_counters():
    """The same ``check.*`` counter deltas as the reference's runner on the
    same violating program."""
    import jax
    import jax.numpy as jnp
    from repro import check as ref_check
    from repro.obs import metrics as ref_metrics

    from repro_torch.obs import metrics

    art = _art(lambda x: x.T @ x, torch.zeros((16, 8)), forbidden_squares={(8, 8)})
    ref_art = ref_check.Artifact(
        label="synthetic", jaxpr=jax.make_jaxpr(lambda x: x.T @ x)(jnp.zeros((16, 8))).jaxpr,
        overrides={"forbidden_squares": {(8, 8)}})
    got = _counter_deltas(metrics, lambda: check.run(art, rules=["no-dense-square"]))
    want = _counter_deltas(ref_metrics,
                           lambda: ref_check.run(ref_art, rules=["no-dense-square"]))
    assert got == want
    assert got["check.violations"] == 1 and got["check.artifacts"] == 1


# ---------------------------------------------------------------------------
# the grid against the reference's, the CLI
# ---------------------------------------------------------------------------


def test_canonical_grid_covers_the_dispatch_matrix():
    plans = check.canonical_plans()
    assert len(plans) >= 20
    assert {p.op for p in plans} == {"ata", "gemm_tn", "solve"}
    assert {p.leaf_dispatch for p in plans if p.op == "ata"} >= {"unrolled", "batched", "fused"}
    assert any(p.use_kernels for p in plans)
    assert any(p.dtype == "bfloat16" for p in plans)
    assert {p.method for p in plans if p.op == "solve"} == {"factor", "cg"}


def test_canonical_plans_equal_the_reference():
    from repro import check as ref_check

    ref = ref_check.canonical_plans()
    port = check.canonical_plans()
    assert [check.plan_label(p) for p in port] == [ref_check.plan_label(p) for p in ref]
    for p, r in zip(port, ref):
        for field in ("m", "n", "k", "n_base", "packed_block", "leaf_dispatch", "out",
                      "use_kernels", "method", "dtype", "algorithm"):
            assert getattr(p, field) == getattr(r, field), (check.plan_label(p), field)


def test_bfsdfs_plans_are_planner_selected():
    """The distributed sweep's BFS/DFS artifacts run the interleaving the
    planner picked — a BFS-containing comm_schedule on a pool-divisible
    triangle — for both output modes of the harness mesh."""
    plans = check.bfsdfs_plans(2, 4)
    assert {p.out for p in plans} == {"dense", "packed"}
    for p in plans:
        assert p.comm_schedule and "B" in p.comm_schedule
        assert p.devices == 2 and p.row_devices == 4
        t = p.nb * (p.nb + 1) // 2
        assert t % (p.devices * p.row_devices) == 0


@pytest.fixture(scope="module")
def grid_reports(tmp_path_factory):
    """The port's CLI run in-process on the CPU grid, and the reference's
    grid, each once per module."""
    from repro import check as ref_check
    from repro_torch.check.__main__ import main

    out = tmp_path_factory.mktemp("check") / "CHECK_report.json"
    # --lower is accepted and not applicable (the port compiles no HLO)
    rc = main(["--device", "cpu", "--lower", "--json", str(out)])
    return rc, json.loads(out.read_text()), ref_check.run_grid().to_json()


def test_cli_grid_exits_zero_in_process(grid_reports):
    rc, port, _ = grid_reports
    assert rc == 0
    assert port["schema"] == "repro.check/v1"
    assert port["meta"]["device"] == "cpu"


def test_grid_labels_and_rules_equal_the_reference(grid_reports):
    _, port, ref = grid_reports
    assert port["artifacts"] == ref["artifacts"]


def test_grid_findings_equal_the_reference(grid_reports):
    _, port, ref = grid_reports
    for key in ("findings", "allowlisted", "allowlist", "counts"):
        assert port[key] == ref[key], key
    assert port["counts"]["findings"] == 0


@pytest.mark.parametrize("rule_id", sorted(check_rules.REGISTRY))
def test_each_rule_ran_clean_on_every_grid_artifact(grid_reports, rule_id):
    _, port, _ = grid_reports
    assert all(rule_id in a["rules"] for a in port["artifacts"])
    assert not [f for f in port["findings"] if f["rule"] == rule_id]


def test_grid_trace_leaves_no_fake_tensor_in_the_table_cache():
    """Tracing a packed plan (tables from ``backend.device_table``) neither
    stores nor returns what the trace made: the cache is as it was."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.core.ata import ata

    ata(torch.zeros((192, 128)), n_base=32, out="packed", packed_block=32)  # real entries
    before = dict(backend._TABLES)
    plan = _plan("ata", 192, 128, packed_block=32, out="packed", use_kernels=True,
                 leaf_dispatch="fused")
    art = check.trace_plan(plan, device="cpu")
    assert art.graph is not None
    assert dict(backend._TABLES).keys() == before.keys()
    for key, value in backend._TABLES.items():
        assert value is before[key]
        leaves = value if isinstance(value, (tuple, list)) else (value,)
        assert not any(isinstance(x, FakeTensor) for x in leaves), key


def test_cli_refuses_without_a_card():
    """Without ``--device cpu`` the CLI runs on the card, and with no card
    it exits nonzero (this machine has none)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.check.__main__ import main

    assert main(["--quick"]) == 2


_NO_JAX = ("import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None; "
           "sys.modules['repro'] = None\n"
           "from repro_torch.check.__main__ import main\n"
           "rc = main(sys.argv[1:])\n"
           "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')"
           " and sys.modules[m] is not None)\n"
           "assert not bad, bad\n"
           "sys.exit(rc)\n")


def _cli(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _NO_JAX, *argv], env=env,
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_cli_quick_json_smoke_without_jax(tmp_path):
    out = tmp_path / "CHECK_report.json"
    proc = _cli("--quick", "--device", "cpu", "--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    j = json.loads(out.read_text())
    assert j["schema"] == "repro.check/v1"
    assert j["counts"]["violations"] == 0
    assert j["counts"]["artifacts"] == 3
    assert "repro_torch.check:" in proc.stdout


def test_cli_list_rules_without_jax():
    proc = _cli("--list")
    assert proc.returncode == 0, proc.stderr
    for rid in check.rule_ids():
        assert rid in proc.stdout


def test_cli_lower_is_accepted_and_not_applicable(grid_reports):
    rc, port, _ = grid_reports
    assert rc == 0 and port["counts"]["artifacts"] == len(check.canonical_plans())


# ---------------------------------------------------------------------------
# distributed sweep (a gloo world of 4 ranks, spawned once for the module)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dist_report():
    return check.run_distributed(world=4, device="cpu", timeout_s=240)


def test_run_distributed_is_clean(dist_report):
    assert dist_report.exit_code == 0, dist_report.summary()
    labels = [a["label"] for a in dist_report.artifacts]
    assert sum(lb.startswith("tile:") for lb in labels) == 2
    assert sum(lb.startswith("rowshard:") for lb in labels) == 2
    assert sum(lb.startswith("bfsdfs:") for lb in labels) == 2
    for a in dist_report.artifacts:
        assert "collective-budget" in a["rules"]


def test_distributed_plans_match_the_reference():
    from repro import check as ref_check

    for p, r in zip(check.distributed_plans(4), ref_check.distributed_plans(4)):
        assert check.plan_label(p) == ref_check.plan_label(r)
        assert (p.nb, p.tile_w, p.n_base, p.out) == (r.nb, r.tile_w, r.n_base, r.out)


def test_collective_budget_fires_on_a_bfs_plan_that_moves_the_full_stack():
    """A BFS plan holds its reduction to one chunk a rank; the psum
    schedule's full-stack payload breaks it."""
    plan = check.bfsdfs_plans(1, 4)[0]
    full = cost.retrieval_bytes(plan.out, plan.nb, plan.tile_w, 4)
    art = check.Artifact(label="bfs", graph=trace_fn(lambda x: x, torch.zeros(2)), plan=plan,
                         collective_bytes={"all-reduce": full})
    assert _violations(art, "collective-budget")
    t = plan.nb * (plan.nb + 1) // 2
    chunk = -(-t // 4) * plan.tile_w ** 2 * 4
    art.collective_bytes = {"reduce-scatter": chunk}
    assert not _violations(art, "collective-budget")


def test_node_outputs_reads_fake_values():
    g = trace_fn(lambda x: (x * 2.0, x.sum()), torch.zeros((3, 5)))
    shapes = [[tuple(v.shape) for v in node_outputs(s.node)] for s in check.walk_nodes(g)]
    assert shapes == [[(3, 5)], [()]]
    assert check.walk_eqns is check.walk_nodes


def test_trace_plan_runs_nothing_and_allocates_nothing():
    """A fake trace takes no memory of the plan's size: ata 4096² (fused,
    kernels: one launch a level plus the gathered diagonal) traces clean."""
    from torch._subclasses.fake_tensor import FakeTensor

    plan = dataclasses.replace(cost.default_plan("ata", 4096, 4096, backend="cpu"),
                               algorithm="strassen", n_base=512, leaf_dispatch="fused",
                               use_kernels=True, out="packed")
    args = check.abstract_args(plan, "cpu")
    assert isinstance(args[0], FakeTensor) and np.prod(args[0].shape) == 4096 * 4096
    art = check.trace_plan(plan, device="cpu")
    assert check.run(art).exit_code == 0
    assert sum(1 for s in art.sites() if s.name.startswith("repro_torch.")) == 4
