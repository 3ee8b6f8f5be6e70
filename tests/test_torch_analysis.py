"""repro_torch.analysis (twin of tests/test_analysis.py): rule fixtures
(exact ids and line numbers), suppression mechanics, path scoping, the
dispatch, launch and substrate audits, and the CLI gate.  The paired
good/bad fixtures live under ``tests/torch_analysis_fixtures/`` and are
parsed only, never imported."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from repro.analysis import linter as jlinter
from repro_torch.analysis import launch_audit, linter, rules
from repro_torch.analysis.dispatch_audit import audit_fn, call_counter
from repro_torch.analysis.linter import lint_paths, lint_source
from repro_torch.kernels import launch as L

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")
SRC_DIR = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
SRC_PKG = os.path.join(SRC_DIR, "repro_torch")


def lint_fixture(name, rule_id=None):
    only = [rules.get_rule(rule_id)] if rule_id else None
    return lint_paths([os.path.join(FIXTURES, name)], rules=only,
                      all_paths=True)


def fixture_source(name):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        return fh.read()


#: rule id -> (bad fixture, exact lines the rule must flag)
BAD_EXPECT = {
    "silent-downcast": ("silent_downcast_bad.py", [8, 12]),
    "host-sync-in-hot-path": ("host_sync_bad.py",
                              [9, 10, 14, 15, 16, 17, 19, 19]),
    "raw-einsum-in-plan": ("raw_einsum_bad.py", [7]),
    "untiled-gram-call": ("untiled_gram_bad.py", [7]),
    "env-dependent-dtype": ("env_dtype_bad.py", [7, 11, 12]),
    "telemetry-read-in-kernel": ("telemetry_kernel_bad.py", [4, 9]),
}

GOOD_FIXTURES = [
    "silent_downcast_good.py", "host_sync_good.py", "raw_einsum_good.py",
    "untiled_gram_good.py", "env_dtype_good.py", "telemetry_kernel_good.py",
]


# ----------------------------------------------------------------------
# lint rules on the paired fixtures
# ----------------------------------------------------------------------


def test_every_registered_rule_has_a_true_positive_fixture():
    assert set(BAD_EXPECT) == {r.id for r in rules.all_rules()}
    assert len(rules.all_rules()) == 6
    assert "scalar-closure-in-scan" in rules.DROPPED_RULES
    assert not rules.is_known("scalar-closure-in-scan")


@pytest.mark.parametrize("rule_id", sorted(BAD_EXPECT))
def test_bad_fixture_exact_ids_and_lines(rule_id):
    name, lines = BAD_EXPECT[rule_id]
    findings = lint_fixture(name, rule_id)
    assert [f.line for f in findings] == lines
    assert all(f.rule == rule_id for f in findings)
    assert not any(f.suppressed for f in findings)


@pytest.mark.parametrize("name", GOOD_FIXTURES)
def test_good_fixture_is_clean_under_all_rules(name):
    assert lint_fixture(name) == []


def test_host_sync_flags_each_torch_sync_form():
    msgs = [f.message for f in lint_fixture("host_sync_bad.py")]
    for word in ("print()", ".item()", "np.linalg.norm", "float()",
                 ".cpu()", "torch.cuda.synchronize", ".numpy()",
                 ".tolist()"):
        assert any(word in m for m in msgs), word


def test_row_product_regression_is_caught_at_its_path():
    """The exact shape of the port's row-product fault: a shard_map
    rank's neighbor sum as a (1, V) row product.  ``nbr_reduce`` is a per-iteration root only in
    core/dtsvm_dist.py, so the same source elsewhere is not hot."""
    src = fixture_source("row_product_regression.py")
    at = os.path.join(SRC_PKG, "core", "dtsvm_dist.py")
    found = lint_source(src, path=at, all_paths=False)
    assert [(f.rule, f.line) for f in found] == [("raw-einsum-in-plan", 14)]
    elsewhere = os.path.join(SRC_PKG, "core", "other.py")
    assert lint_source(src, path=elsewhere, all_paths=False) == []


def test_env_dtype_blesses_device_py_only_for_turning_tf32_off():
    off = ("import torch\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "torch.backends.cudnn.allow_tf32 = False\n")
    on = "import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n"
    high = "import torch\ntorch.set_float32_matmul_precision('medium')\n"
    device_py = os.path.join(SRC_PKG, "device.py")
    plan_py = os.path.join(SRC_PKG, "engine", "plan.py")
    assert lint_source(off, path=device_py, all_paths=False) == []
    assert [f.line for f in lint_source(off, path=plan_py,
                                        all_paths=False)] == [2, 3]
    for src in (on, high):
        (f,) = lint_source(src, path=device_py, all_paths=False)
        assert f.rule == "env-dependent-dtype" and "TF32" in f.message


def test_untiled_gram_recognises_the_budget_route_only():
    src = ("from repro_torch.kernels import ops\n"
           "def gram_and_lipschitz(Z, a, budget=None):\n"
           "    return ops.weighted_gram(Z, a)\n"
           "def elsewhere(Z, a):\n"
           "    return ops.weighted_gram(Z, a)\n")
    route = os.path.join(SRC_PKG, "engine", "invariants.py")
    other = os.path.join(SRC_PKG, "engine", "plan.py")
    assert [f.line for f in lint_source(src, path=route,
                                        all_paths=False)] == [5]
    assert [f.line for f in lint_source(src, path=other,
                                        all_paths=False)] == [3, 5]
    with open(route, encoding="utf-8") as fh:
        real = lint_source(fh.read(), path=route, all_paths=False)
    assert not [f for f in real if f.rule == "untiled-gram-call"]


# ----------------------------------------------------------------------
# suppression mechanics
# ----------------------------------------------------------------------


def test_suppression_mechanics():
    findings = lint_fixture("suppression.py")
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)

    ein = {f.line: f for f in by_rule["raw-einsum-in-plan"]}
    assert sorted(ein) == [9, 10, 11, 12, 17]
    # line-above directive with a reason suppresses (and keeps it)
    assert ein[9].suppressed
    assert ein[9].reason.startswith("fixture attestation")
    # bare / unknown / malformed directives do NOT suppress ...
    assert not ein[10].suppressed
    assert not ein[11].suppressed
    assert not ein[12].suppressed
    # ... and are findings themselves, at the directive's line
    assert [f.line for f in by_rule["bare-noqa"]] == [10]
    assert [f.line for f in by_rule["unknown-noqa"]] == [11]
    assert [f.line for f in by_rule["malformed-noqa"]] == [12]
    # the wildcard form suppresses every rule on its line
    assert ein[17].suppressed


def test_directive_findings_match_the_reference_linter():
    """The port's noqa grammar reads the reference's own suppression
    fixture as the reference does: the same rules at the same lines,
    suppressed alike."""
    path = os.path.join(HERE, "analysis_fixtures", "suppression.py")
    ours = [(f.rule, f.line, f.suppressed) for f in
            lint_paths([path], all_paths=True)]
    theirs = [(f.rule, f.line, f.suppressed) for f in
              jlinter.lint_paths([path], all_paths=True)]
    assert ours == theirs


def test_same_line_suppression():
    src = ("import torch\n"
           "def plan_step(z, g):\n"
           "    return torch.einsum('nd,d->n', z, g)"
           "  # repro: noqa[raw-einsum-in-plan] - test: same-line\n")
    (f,) = [f for f in lint_source(src) if f.rule == "raw-einsum-in-plan"]
    assert f.suppressed and f.reason == "test: same-line"


def test_directives_inside_docstrings_are_ignored():
    src = ('"""Example::\n\n'
           '    x = 1  # repro: noqa[not-a-rule]\n"""\n')
    assert lint_source(src) == []


def test_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    findings = lint_paths([str(bad)])
    assert [f.rule for f in findings] == ["syntax-error"]


# ----------------------------------------------------------------------
# path scoping
# ----------------------------------------------------------------------


@pytest.mark.parametrize("path,want", [
    (os.path.join(SRC_PKG, "engine", "plan.py"), "engine/plan.py"),
    ("src/repro_torch/engine/plan.py", "engine/plan.py"),
    (os.path.join(SRC_PKG, "device.py"), "device.py"),
    # the reference package is not the port's: basename only
    (os.path.join(SRC_DIR, "repro", "engine", "plan.py"), "plan.py"),
    (os.path.join(FIXTURES, "raw_einsum_bad.py"), "raw_einsum_bad.py"),
])
def test_package_relpath_anchors_on_repro_torch(path, want):
    assert linter.package_relpath(path) == want


def test_rule_path_scoping():
    sync = rules.get_rule("host-sync-in-hot-path")
    assert sync.applies("engine/plan.py")
    assert sync.applies("dist/sample.py")            # the rank backends
    assert not sync.applies("models/transformer.py")  # substrate
    assert not sync.applies("analysis/rules.py")      # tooling
    env = rules.get_rule("env-dependent-dtype")
    assert env.applies("serve/model.py")
    assert env.applies("device.py")                   # checked, blessed
    down = rules.get_rule("silent-downcast")
    assert down.applies("store/session_store.py")
    gram = rules.get_rule("untiled-gram-call")
    assert gram.applies("dist/sample.py")
    assert not gram.applies("core/dtsvm.py")
    tel = rules.get_rule("telemetry-read-in-kernel")
    assert tel.applies("kernels/ops.py")
    assert not tel.applies("engine/plan.py")          # the step MAY collect


@pytest.mark.parametrize("rel,src", [
    ("train/steps.py",
     "def make_train_step():\n"
     "    def train_step(state, batch):\n"
     "        return float(batch['loss'])\n"
     "    return train_step\n"),
    ("optim/adamw.py",
     "def adamw():\n"
     "    def update(grads, state, params):\n"
     "        return grads.item()\n"
     "    return update\n"),
])
def test_the_train_step_and_the_update_are_hot_roots(tmp_path, rel, src):
    """A host sync inside the train step or an optimizer's update is a
    finding (``PATH_ROOTS``): both run once per training iteration.  The
    same code elsewhere in the package is not a root."""
    path = tmp_path / "repro_torch" / rel
    path.parent.mkdir(parents=True)
    path.write_text(src)
    found = [f for f in lint_paths([str(path)])
             if f.rule == "host-sync-in-hot-path"]
    assert [f.line for f in found] == [3]
    other = tmp_path / "repro_torch" / "launch" / "train.py"
    other.parent.mkdir(parents=True)
    other.write_text(src)
    assert lint_paths([str(other)]) == []


def test_src_tree_has_no_unsuppressed_findings():
    """The acceptance gate: the linter runs clean over src/repro_torch,
    every suppression carries an attested reason, and the deliberate
    sites are among them."""
    findings = lint_paths([SRC_PKG])
    assert [f for f in findings if not f.suppressed] == []
    suppressed = [f for f in findings if f.suppressed]
    assert suppressed, "the attested noqa sites should be reported"
    assert all(f.reason for f in suppressed)
    sites = {(linter.package_relpath(f.path), f.rule) for f in suppressed}
    for site in [("engine/plan.py", "raw-einsum-in-plan"),
                 ("core/dtsvm.py", "raw-einsum-in-plan"),
                 ("core/dtsvm_dist.py", "raw-einsum-in-plan"),
                 ("net/fabric.py", "raw-einsum-in-plan"),
                 ("dist/sample.py", "raw-einsum-in-plan"),
                 ("kernels/ref.py", "raw-einsum-in-plan"),
                 ("dist/collectives.py", "host-sync-in-hot-path")]:
        assert site in sites, site


# ----------------------------------------------------------------------
# dispatch audit and the call counter
# ----------------------------------------------------------------------


def test_audit_fn_flags_denied_dtypes_and_ops():
    x = torch.ones(4)

    def to_f64(x):
        return (x.double() * 2).float()

    fs = audit_fn(to_f64, x)
    assert any(f.rule == "dispatch-denied-dtype" and "float64" in f.message
               for f in fs)

    def to_bf16(x):
        return (x.to(torch.bfloat16) * 2).float()

    fs = audit_fn(to_bf16, x)
    assert any(f.rule == "dispatch-denied-dtype" and "bfloat16" in f.message
               for f in fs)
    assert audit_fn(to_bf16, x, allow_bf16=True) == []

    def index_add(x):
        return x.clone().index_add_(0, torch.tensor([0, 0]),
                                    torch.ones(2))

    fs = audit_fn(index_add, x)
    assert any(f.rule == "dispatch-denied-op" and "index_add" in f.message
               for f in fs)

    def put_accumulate(x):
        return x.clone().index_put_((torch.tensor([1, 1]),), torch.ones(2),
                                    accumulate=True)

    fs = audit_fn(put_accumulate, x)
    assert any("accumulate=True" in f.message for f in fs)
    assert audit_fn(lambda x: x.clone().index_put_(
        (torch.tensor([1]),), torch.ones(1)), x) == []

    fs = audit_fn(lambda x: x + torch.rand(4), x)
    assert any("random" in f.message for f in fs)
    assert audit_fn(lambda x: (x * 2).sum(), x) == []


def test_entry_points_are_clean():
    from repro_torch.analysis.dispatch_audit import audit_entry_points
    assert audit_entry_points("cpu") == []


def test_bf16_plan_needs_its_allowance():
    """The bf16 plan's step holds bf16 (allowed only there), the f32 plan
    none."""
    from repro_torch.analysis.dispatch_audit import _tiny_problem
    from repro_torch.engine.plan import compile_problem

    prob = _tiny_problem("cpu")
    plan16 = compile_problem(prob, qp_iters=2, qp_solver="pallas_fused_multi",
                             qp_precision="bf16")
    fs = audit_fn(plan16.step, plan16.init_state())
    assert fs and all("bfloat16" in f.message for f in fs)
    assert audit_fn(plan16.step, plan16.init_state(), allow_bf16=True) == []


def test_call_counter_counts_and_restores():
    from repro_torch.kernels import ops

    orig = ops.weighted_gram
    Z = torch.ones((2, 2, 4, 3))
    a = torch.ones((2, 2, 3))
    with call_counter("repro_torch.kernels.ops:weighted_gram") as c:
        ops.weighted_gram(Z, a)
        ops.weighted_gram(Z, a)
        assert c["weighted_gram"] == 2
        snap = c.snapshot()
    assert ops.weighted_gram is orig       # restored on exit
    assert snap == {"repro_torch.kernels.ops:weighted_gram": 2}


def test_launch_guard_is_clean_on_the_cpu():
    from repro_torch.analysis.dispatch_audit import launch_guard
    assert launch_guard("cpu") == []


# ----------------------------------------------------------------------
# launch audit
# ----------------------------------------------------------------------


def test_launch_audit_runs_clean():
    assert launch_audit.audit_kernels() == []
    findings, n = launch_audit.audit_launch_geometry()
    assert findings == [] and n > 100


def test_source_constants_match_launch_py():
    """The ``constexpr`` constants parsed out of the .cu files equal
    kernels/launch.py's, so a change on either side shows on the CPU."""
    csrc = launch_audit._csrc()
    for fname, want in L.CUDA_CONSTANTS.items():
        assert launch_audit.source_constants(
            os.path.join(csrc, fname)) == want, fname
    assert launch_audit.audit_constants() == []


def test_constant_drift_is_flagged(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(launch_audit._csrc(), csrc)
    path = csrc / "qp_multi.cu"
    path.write_text(path.read_text().replace(
        "constexpr int kStageBytes = 100 * 1024;",
        "constexpr int kStageBytes = 96 * 1024;"))
    (f,) = launch_audit.audit_constants(str(csrc))
    assert f.rule == "launch-constant-drift" and "kStageBytes" in f.message


def test_every_launch_site_is_registered():
    csrc = launch_audit._csrc()
    sites = {fname: launch_audit.launch_sites(os.path.join(csrc, fname))
             for fname in ("gram.cu", "qp_step.cu", "qp_multi.cu",
                           "rows.cu")}
    assert {k for s in sites.values() for k, _ in s} == \
        set(launch_audit.KERNELS)
    # the alias `auto kernel = qp_multi_block_kernel<...>` resolves
    assert [k for k, _ in sites["qp_multi.cu"]] == [
        "qp_multi_block_kernel", "qp_multi_grid_kernel"]


def test_unregistered_site_and_missing_twin_are_flagged(tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(launch_audit._csrc(), csrc)
    with open(csrc / "rows.cu", "a") as fh:
        fh.write("\nvoid extra() { stray_kernel<<<1, 32>>>(); }\n")
    fs = launch_audit.audit_call_sites(str(csrc), tests_dir=HERE)
    assert [f.rule for f in fs] == ["launch-unaudited-site"]
    assert "stray_kernel" in fs[0].message

    twins = dict(launch_audit.PLAIN_TWINS)
    del twins["gemm_rows"]
    monkeypatch.setattr(launch_audit, "PLAIN_TWINS", twins)
    fs = launch_audit.audit_call_sites(tests_dir=HERE)
    assert [(f.rule, "gemm_rows" in f.message) for f in fs] == [
        ("launch-missing-twin", True)]


def _rules(launch, resident=None):
    return {f.rule for f in launch_audit.check_launch(launch, "bad",
                                                      resident)}


def test_launch_audit_flags_bad_geometry():
    # grid z 65536: one problem past the batch guard
    assert _rules(L.gram_launch(65536, 60, 11)) == {"launch-grid"}
    # the square build past repro_gram_max_rows overflows grid x
    assert _rules(L.gram_launch(1, L.gram_max_rows() + L.GRAM_TILE, 1)) \
        == {"launch-grid"}
    with pytest.raises(ValueError):
        n = L.gram_max_rows() + L.GRAM_TILE
        L.gram_tiled_launch(1, n, 1, 0, n)
    # 1025 threads
    assert _rules(L.Launch("qp_step_kernel", (1, 1, 1), 1025)) == \
        {"launch-threads"}
    # a block path of 512 threads under a 256-thread kernel's bound
    assert _rules(L.Launch("qp_step_kernel", (1, 1, 1), 512)) == \
        {"launch-threads"}
    # 228 KB of dynamic shared memory, above the 227 KB opt-in
    assert _rules(L.Launch("qp_multi_block_kernel<f32>", (1, 1, 1), 512,
                           dynamic_smem=228 * 1024, opt_in=True)) == \
        {"launch-dynamic-smem"}
    # above 48 KB without raising the limit
    assert _rules(L.Launch("rows_group_kernel<vec>", (1, 1, 1), 256,
                           dynamic_smem=48 * 1024 + 4)) == \
        {"launch-dynamic-smem"}
    # static shared memory above 48 KB
    assert _rules(L.Launch("gram_kernel", (1, 1, 1), 256,
                           static_smem=48 * 1024 + 4)) == \
        {"launch-static-smem"}
    # a cooperative grid above the resident CTAs
    grid = L.qp_multi_launch(2, 20000)
    assert grid.cooperative and grid.grid == (264, 1, 1)
    assert _rules(grid, 264) == set()
    assert _rules(grid._replace(grid=(265, 1, 1)), 264) == \
        {"launch-cooperative"}


def test_the_guards_edges_stay_within_the_limits():
    """At the largest sizes the bindings admit (B = 65535, N =
    repro_gram_max_rows()), every launch is within Hopper's limits."""
    n = L.gram_max_rows()
    for launch in (L.gram_prescale_launch(65535, n, 65535 * 32),
                   L.gram_launch(65535, n, 257),
                   L.gram_tiled_launch(65535, n, 257, 0, n),
                   L.qp_step_launch(65535, n)):
        assert launch_audit.check_launch(launch, "edge") == []
    assert L.gram_launch(1, n, 1).grid[0] <= launch_audit.MAX_GRID_X


@pytest.mark.parametrize("precision,B,N,path", [
    ("f32", 20, 60, "block"), ("f32", 2, 232, "block"),
    ("f32", 2, 233, "grid"), ("f32", 2, 1025, "grid"),
    ("f32", 300, 329, "grid"), ("bf16", 20, 60, "block"),
    ("bf16", 2, 328, "block"), ("bf16", 2, 329, "grid"),
    ("bf16", 300, 515, "grid")])
def test_multi_shape_paths_match_the_card_tests(precision, B, N, path):
    """kernels/launch.py picks the path tests/test_torch_gpu.py's
    MULTI_PATHS pins on the card (232 f32 / 328 bf16 rows fit a CTA)."""
    shape = L.qp_multi_shape(B, N, bf16=precision == "bf16")
    assert shape["path"] == path
    if path == "grid":
        assert shape["blocks"] <= L.H100_SMS * L.MULTI_GRID_CTAS_PER_SM
        assert shape["smem"] <= L.MULTI_STAGE_BYTES
    else:
        assert shape["blocks"] == B
        assert shape["smem"] <= L.HOPPER_SMEM_OPTIN


def test_rows_staging_holds_48kb_without_the_opt_in():
    """rows.cu stages nothing in shared memory (the hyperplanes are read
    through the L1), so K(p+1) floats at 48 KB and past it, up to the
    tested (16, 60, 784), launch with no dynamic shared bytes and without
    raising the limit."""
    K = 12
    p = 48 * 1024 // 4 // K - 1
    for M, k, q in ((1024, K, p), (1024, K, p + 1), (16, 60, 784),
                    (1024, 20, 784)):
        launch = L.rows_launch(M, k, q)
        assert launch.kernel in L.STATIC_SMEM
        assert launch.kernel.startswith("rows_group_kernel<")
        assert launch.dynamic_smem == 0 and launch.static_smem == 0
        assert not launch.opt_in
        assert launch_audit.check_launch(launch, "rows") == []


@pytest.mark.parametrize("label,M,K,p", launch_audit.ROWS_SHAPES)
def test_rows_launch_at_every_audited_shape_is_within_the_limits(label, M,
                                                                 K, p):
    """``rows_launch`` at every ``ROWS_SHAPES`` entry, the MNIST width and
    the M*K guard's edge included, passes the launch check, and its CTAs
    cover every row's lane group."""
    launch = L.rows_launch(M, K, p)
    assert launch_audit.check_launch(launch, label) == []
    g = L.rows_lanes(p)
    assert launch.grid[0] * launch.threads >= M * g
    assert (launch.grid[0] - 1) * launch.threads < M * g


@pytest.mark.parametrize("p,lanes", [(0, 1), (1, 1), (4, 1), (5, 2),
                                     (10, 4), (16, 4), (17, 8), (128, 32),
                                     (256, 32), (257, 32), (784, 32),
                                     (4096, 32)])
def test_rows_lane_group_is_a_function_of_p(p, lanes):
    """A row's lane group (and so the order of its sum) is min(32, the
    power of two at or above ceil(p / 4)), whatever M or K."""
    assert L.rows_lanes(p) == lanes


@pytest.mark.parametrize("p,vec,kernel", [
    (1, None, "rows_group_kernel<scalar>"),
    (10, None, "rows_group_kernel<scalar>"),
    (12, None, "rows_group_kernel<vec>"),
    (256, None, "rows_group_kernel<vec>"),
    (256, False, "rows_group_kernel<scalar>"),
    (257, None, "rows_group_kernel<scalar>"),
    (512, None, "rows_group_kernel<vec>"),
    (784, None, "rows_group_kernel<vec>"),
    (1027, None, "rows_group_kernel<scalar>"),
    (4096, None, "rows_group_kernel<vec>")])
def test_rows_instance_is_picked_by_p_and_alignment(p, vec, kernel):
    """The load width alone picks one of the two instances that
    ``kernel_info`` reports (float4 where p % 4 == 0 and the operands lie
    on 16 bytes, else scalar, the same for rows past the held 1024
    features); it does not change the order of the sum."""
    launch = L.rows_launch(64, 20, p, vec=vec)
    assert launch.kernel == kernel
    assert launch.kernel in L.STATIC_SMEM and launch.kernel in L.LAUNCH_BOUNDS


@pytest.mark.parametrize("M,K,p,grid,threads", [
    (8, 2, 256, (1, 1), 256), (8, 20, 784, (1, 5), 256),
    (8, 20, 10, (1, 5), 32), (1, 1, 1, (1, 1), 32),
    (1024, 2, 256, (256, 1), 128), (1024, 20, 784, (256, 1), 128),
    (1000, 2, 256, (250, 1), 128), (1024, 20, 10, (128, 5), 32),
    (64, 2, 256, (64, 1), 32), (4096, 2, 256, (512, 1), 256),
    (256, 20, 784, (256, 4), 32), (16, 60, 784, (16, 15), 32)])
def test_rows_grid_is_one_cta_at_the_smallest_bucket_and_fills_the_card(
        M, K, p, grid, threads):
    """The smallest bucket is one CTA along x; 1024 rows at p = 256 or 784
    are at least an H100's 132 SMs of CTAs; the passes of 4 hyperplanes
    are dealt out along y only while the grid stays within one wave of
    132 x 8 warps, at most one CTA a pass; K moves only y."""
    launch = L.rows_launch(M, K, p)
    assert (launch.grid[:2], launch.threads) == (grid, threads)
    assert launch.grid[1] <= -(-K // L.ROWS_K_TILE)
    wide = L.rows_launch(M, 4 * K, p)
    assert (wide.grid[0], wide.threads) == (grid[0], threads)


# ----------------------------------------------------------------------
# substrate reachability
# ----------------------------------------------------------------------


def _reference_substrate_ported() -> list:
    """The reference's substrate list, mapped ``repro.`` ->
    ``repro_torch.`` and restricted to the modules the port has."""
    from repro.analysis.substrate import substrate_report as ref_report
    from repro_torch.analysis.substrate import import_graph
    ported = set(import_graph())
    return sorted(m for m in ("repro_torch" + r[len("repro"):]
                              for r in ref_report()["substrate"])
                  if m in ported)


def test_substrate_report_is_empty():
    """Named when the port had no substrate; now its substrate is the
    reference's, mapped and restricted to the modules ported (the dense
    decoder's serving path: configs, models, train, launch)."""
    from repro_torch.analysis.substrate import substrate_report
    rep = substrate_report()
    want = _reference_substrate_ported()
    assert rep["substrate"] == want
    for mod in ("repro_torch.configs.gemma2_2b", "repro_torch.models",
                "repro_torch.models.transformer", "repro_torch.train.steps",
                "repro_torch.launch.serve"):
        assert mod in want, mod
    assert "repro_torch.convert" in rep["tooling"]
    for live in ("repro_torch.engine.plan", "repro_torch.core.dtsvm",
                 "repro_torch.net.fabric", "repro_torch.kernels.gram",
                 "repro_torch.kernels.launch", "repro_torch.obs.__main__",
                 "repro_torch.figures.golden", "repro_torch.quickstart"):
        assert live in rep["reachable"], live
    assert rep["tooling"]
    assert all(m.startswith(("repro_torch.analysis", "repro_torch.convert"))
               for m in rep["tooling"])


def test_reference_roots_alone_would_misreport_the_port():
    """With only the reference's roots (api, store, serve, data), the
    port's own entry points would come out as substrate."""
    from repro_torch.analysis.substrate import substrate_report
    rep = substrate_report(roots=("repro_torch.api", "repro_torch.store",
                                  "repro_torch.serve", "repro_torch.data"))
    assert "repro_torch.quickstart" in rep["substrate"]
    assert "repro_torch.figures.golden" in rep["substrate"]


# ----------------------------------------------------------------------
# the CLI gate
# ----------------------------------------------------------------------


def _run_cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC_DIR + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_json_gate_is_clean(tmp_path):
    out = tmp_path / "report.json"
    proc = _run_cli(SRC_PKG, "--device", "cpu", "--format", "json",
                    "--out", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["summary"]["unsuppressed"] == 0
    assert report["summary"]["suppressed"] >= 1
    assert all(d["reason"] for d in report["suppressed"])
    assert report["substrate"]["substrate"] == _reference_substrate_ported()
    assert report["dispatch"] == report["guard"] == report["launch"] == []
    assert json.loads(proc.stdout)["summary"] == report["summary"]


def test_cli_fails_on_unsuppressed_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\n\n"
                   "def _decode(obj):\n"
                   "    return torch.as_tensor(obj)\n")
    proc = _run_cli(str(bad), "--no-dispatch", "--no-guard", "--no-launch")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "silent-downcast" in proc.stdout


def test_cli_list_rules():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rule in rules.all_rules():
        assert rule.id in proc.stdout
    assert "scalar-closure-in-scan (no twin in the port)" in proc.stdout
    assert len(rules.all_rules()) == 6


def test_cli_program_sections_need_the_card_or_cpu():
    """Without ``--device cpu`` the sections that run the program resolve
    the default device, the card; with none present they raise the
    device error, and nothing falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    proc = _run_cli(SRC_PKG, "--no-launch")
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr and "device='cpu'" in proc.stderr


class _FakeExtension:
    """The two queries of the built extension, answered from
    kernels/launch.py at a given occupancy (the card's run is
    chip_smoke.py phase 2)."""

    def __init__(self, sms, per_sm, smem_skew=0):
        self.sms, self.per_sm, self.smem_skew = sms, per_sm, smem_skew

    def qp_multi_shape(self, bf16, fold, B, N):
        s = L.qp_multi_shape(B, N, bf16=bf16, sms=self.sms,
                             ctas_per_sm=self.per_sm)
        return (L.MULTI_PATHS.index(s["path"]), s["blocks"], s["slots"],
                s["smem"] + (self.smem_skew if s["path"] == "grid" else 0))

    def kernel_info(self):
        return [(name, 64, static, 0, L.LAUNCH_BOUNDS[name])
                for name, static in L.STATIC_SMEM.items()]


@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_audit_extension_against_a_matching_extension(monkeypatch, per_sm):
    props = type("Props", (), {"multi_processor_count": 132,
                               "shared_memory_per_block_optin": 232448})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    findings, rec = launch_audit.audit_extension(
        _FakeExtension(132, per_sm), "cuda")
    assert findings == []
    assert rec["grid_ctas_per_sm"] == [per_sm]
    assert rec["multi_shapes_compared"] == 4 * len(launch_audit.QP_SHAPES)
    assert rec["kernel_info_compared"] == len(L.STATIC_SMEM)

    findings, _ = launch_audit.audit_extension(
        _FakeExtension(132, per_sm, smem_skew=16), "cuda")
    assert findings and {f.rule for f in findings} == {"launch-ext-mismatch"}
