"""The port's API against the reference, its device rule, and its
independence from JAX.

The whole quickstart through ``repro_torch.quickstart.main(device="cpu")``
must give the JAX run's target and source risks of DTSVM and DSVM within
the golden ``ATOL = 0.015`` (tests/test_golden_figures.py); the observed
gap is printed (on this tree it is below 1e-6).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import backends as jbackends
from repro.api import solvers as jsolvers
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro.engine.invariants import PlanBudget as JPlanBudget
from repro.net import NetConfig as JNetConfig
from repro_torch import quickstart
from repro_torch.api import (DSVM, DTSVM, LinkPolicy, NetConfig,
                             PlanBudget, SolverConfig)
from repro_torch.api import backends
from repro_torch.engine import invariants

ATOL = 0.015
_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once, and these tests
    make many tiny torch ops: intra-op threads would only oversubscribe
    the cores (a quickstart fit took 190 s under the full suite with the
    default thread count, ~1 s alone with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_quickstart(**overrides):
    """examples/quickstart.py's experiment through the JAX package
    (``overrides`` replace config fields)."""
    V, T = 10, 2
    n_train = np.zeros((V, T), int)
    n_train[:, 0] = jsynthetic.split_counts(40, V)
    n_train[:, 1] = jsynthetic.split_counts(600, V)
    data = jsynthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=1800,
        relatedness=0.92, noise=1.0, seed=0)
    adj = jgraph.make_graph("random", V, degree=0.8, seed=0)
    cfg = jsolvers.SolverConfig(C=0.01, eps1=1.0, eps2=1.0, iters=60,
                                qp_iters=100, **overrides)
    dtsvm = jsolvers.DTSVM(cfg).fit(data["X"], data["y"], mask=data["mask"],
                                    adj=adj)
    dsvm = jsolvers.DSVM(cfg).fit(data["X"], data["y"], mask=data["mask"],
                                  adj=adj)
    return {"dtsvm": dtsvm.global_risks(data["X_test"], data["y_test"]),
            "dsvm": dsvm.global_risks(data["X_test"], data["y_test"])}


def test_quickstart_risks_match_the_jax_run(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")
    want = _reference_quickstart()
    got = quickstart.main(device="cpu")
    gap = max(float(np.abs(np.asarray(got[k]) - want[k]).max())
              for k in ("dtsvm", "dsvm"))
    print(f"quickstart risk gap port vs JAX: {gap:.3e}")
    for k in ("dtsvm", "dsvm"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
    assert got["dtsvm"][0] < got["dsvm"][0]          # the transfer gain
    assert all(np.isfinite(got["residuals"]))


def test_solver_config_dicts_mean_the_same():
    assert [f.name for f in SolverConfig.__dataclass_fields__.values()] == \
        [f.name for f in jsolvers.SolverConfig.__dataclass_fields__.values()]
    for kw in ({}, dict(C=0.1, iters=7, qp_solver="pallas_fused_multi",
                        qp_precision="bf16", box_scale=3.0,
                        backend_options={"topology": "ring"})):
        assert SolverConfig(**kw).to_dict() == \
            jsolvers.SolverConfig(**kw).to_dict()
    d = jsolvers.SolverConfig(
        budget=JPlanBudget(max_elems=4096, tile=(8, 128))).to_dict()
    cfg = SolverConfig.from_dict(d)
    assert cfg.budget == PlanBudget(max_elems=4096, tile=(8, 128))
    assert cfg.to_dict() == d
    assert SolverConfig.from_dict(cfg.to_dict()) == cfg


def _roadmap_modules() -> dict:
    """ROADMAP.md's queue of modules to port: {item number: its title}."""
    path = os.path.join(os.path.dirname(_SRC), "ROADMAP.md")
    with open(path) as f:
        text = f.read()
    queue = text[text.index("### 1. Modules to port"):
                 text.index("### 2. ")]
    return {int(m.group(1)): m.group(2) for m in
            re.finditer(r"^(\d+)\. \*\*(.+?)\*\*", queue, re.M)}


@pytest.mark.parametrize("solver", ["DTSVM", "DSVM"])
@pytest.mark.parametrize("backend", ["vmap", "async"])
def test_telemetry_fits_return_the_reference_streams(solver, backend):
    """``SolverConfig(telemetry=True)`` (ROADMAP.md item 5,
    observability, done) fits and sets ``telemetry_`` with the reference
    fit's keys, shapes and float32; the state is bitwise the
    telemetry-off fit's."""
    assert "observability" in _roadmap_modules()[5].lower()
    data = _tiny_data()
    A = np.ones((2, 2), bool) & ~np.eye(2, dtype=bool)
    kw = dict(iters=3, qp_iters=10, backend=backend)
    port = {"DTSVM": DTSVM, "DSVM": DSVM}[solver]
    on = port(SolverConfig(telemetry=True, **kw), device="cpu").fit(
        data["X"], data["y"], adj=A)
    off = port(SolverConfig(**kw), device="cpu").fit(data["X"], data["y"],
                                                      adj=A)
    want = getattr(jsolvers, solver)(jsolvers.SolverConfig(
        telemetry=True, **kw)).fit(data["X"], data["y"], adj=A).telemetry_
    assert off.telemetry_ is None
    assert all(torch.equal(a, b) for a, b in zip(on.state_, off.state_))
    assert {k: (v.shape, v.dtype) for k, v in on.telemetry_.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}


@pytest.mark.parametrize("field", [
    dict(budget=PlanBudget(max_elems=2 * 1 * 8 * 20)),
    dict(qp_operator="factored"),
    dict(qp_operator="factored", budget=PlanBudget(tile=(8, 128))),
])
def test_budget_and_factored_options_fit(field):
    """The large-n options fit through the API: a budget (8-row panels of
    N=20) leaves the dense fit's state exactly as it is, the factored
    operator comes within rtol 1e-4 / atol 1e-6 of it."""
    data = _tiny_data(N=20)
    cfg = SolverConfig(iters=3, qp_iters=10, qp_solver="pallas_fused_multi")
    dense = DTSVM(cfg, device="cpu").fit(data["X"], data["y"]).state_
    got = DTSVM(cfg.replace(**field), device="cpu").fit(
        data["X"], data["y"]).state_
    for name, g, d in zip(dense._fields, got, dense):
        if "qp_operator" in field:
            torch.testing.assert_close(g, d, rtol=1e-4, atol=1e-6,
                                       msg=name)
        else:
            assert torch.equal(g, d), name


@pytest.mark.parametrize("field", [
    dict(qp_solver="fista", qp_operator="factored"),
    dict(qp_solver="pallas_fused_multi", qp_precision="bf16",
         qp_operator="factored"),
])
def test_factored_validation_matches_reference(field):
    """The reference's rule: the factored operator needs the fused multi
    engine and f32; both packages refuse the rest with ValueError."""
    data = _tiny_data()
    with pytest.raises(ValueError, match="factored"):
        DTSVM(SolverConfig(iters=1, **field), device="cpu").fit(
            data["X"], data["y"])
    with pytest.raises(ValueError, match="factored"):
        jsolvers.DTSVM(jsolvers.SolverConfig(iters=1, **field)).fit(
            data["X"], data["y"])


def test_budget_in_backend_options_fits_like_the_reference(monkeypatch):
    """``backend_options={"budget": ...}`` goes into the one options dict
    that ``cfg.budget`` only fills in where it names no budget (the
    reference's ``setdefault``).  The quickstart streamed in 8-row panels
    that way gives the JAX run's risks within the golden ATOL, and both of
    its fits stream."""
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")
    want = _reference_quickstart(
        backend_options={"budget": JPlanBudget(tile=(8, 128))})
    streamed = []
    panel = invariants.streamed_gram_panel
    monkeypatch.setattr(invariants, "streamed_gram_panel",
                        lambda *a, **k: streamed.append(1) or panel(*a, **k))
    got = quickstart.main(device="cpu", backend_options={
        "budget": PlanBudget(tile=(8, 128))})
    assert len(streamed) == 2                        # DTSVM and DSVM
    for k in ("dtsvm", "dsvm"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_backend_options_budget_wins_over_the_config_budget(monkeypatch):
    """With a budget in both places the backend_options one is used, as in
    the reference: here the 8-row panels, not the non-binding tile."""
    data = _tiny_data(N=20)
    streamed = []
    panel = invariants.streamed_gram_panel
    monkeypatch.setattr(invariants, "streamed_gram_panel",
                        lambda *a, **k: streamed.append(1) or panel(*a, **k))
    cfg = SolverConfig(iters=2, qp_iters=5, budget=PlanBudget(tile=(64, 128)),
                       backend_options={"budget": PlanBudget(tile=(8, 128))})
    DTSVM(cfg, device="cpu").fit(data["X"], data["y"])
    assert len(streamed) == 1
    DTSVM(cfg.replace(backend_options={}), device="cpu").fit(data["X"],
                                                              data["y"])
    assert len(streamed) == 1                        # (64, 128) does not bind


_PLAN_KW = dict(qp_iters=5, qp_solver="pg", qp_precision="f32",
                qp_operator="materialized")


def _plans():
    """One tiny problem and its compiled plan in each package."""
    from repro.engine import plan as jplan
    from repro_torch.engine import plan as tplan

    data = _tiny_data(N=10)
    jprob = jsolvers.DTSVM().make_problem(data["X"], data["y"])
    tprob = DTSVM().make_problem(data["X"], data["y"], device="cpu")
    return ((jbackends, jprob, jplan.compile_problem(jprob, **_PLAN_KW)),
            (backends, tprob, tplan.compile_problem(tprob, **_PLAN_KW)))


def test_vmap_runner_uses_a_matching_prebuilt_plan(monkeypatch):
    """``plan=`` that agrees with the call is run as it is, in both
    packages: nothing is compiled, the state is the plan's own run, and
    the two packages agree."""
    states = []
    for mod, prob, plan in _plans():
        def compile_again(*args, **kwargs):
            raise AssertionError("the runner compiled a new plan")

        monkeypatch.setattr(mod.engine_plan, "compile_problem",
                            compile_again)
        got, _ = mod.run(prob, 3, plan=plan, **_PLAN_KW)
        want, _ = plan.run(iters=3)
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)
        states.append(got)
    for name, j, t in zip(states[0]._fields, *states):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mismatch", [
    dict(qp_iters=6), dict(qp_solver="fista"), dict(qp_precision="bf16"),
    dict(qp_operator="factored"), dict(prob=None)])
def test_vmap_runner_refuses_a_mismatched_plan(mismatch):
    """``plan=`` that disagrees with the call's problem or QP settings
    raises the reference's ValueError in both packages."""
    for mod, prob, plan in _plans():
        kw = dict(_PLAN_KW, **mismatch)
        if kw.pop("prob", prob) is None:
            prob = prob._replace(C=prob.C * 2)       # another problem
        with pytest.raises(ValueError, match="prebuilt plan= disagrees"):
            mod.run(prob, 1, plan=plan, **kw)


@pytest.mark.parametrize("field", [
    dict(net=NetConfig()), dict(backend="async"),
    dict(backend="async", net=NetConfig(policy=LinkPolicy(quant="int8"))),
    dict(net=NetConfig(policy=LinkPolicy(drop=0.2, delay=1),
                       schedule="partial:0.8", seed=3)),
])
def test_fabric_options_fit_as_the_reference(field):
    """``net`` and ``backend="async"`` (the fabric, ROADMAP.md item 2)
    fit through the API: an identity fabric bitwise the vmap fit, any
    fabric within 1e-4 of each state leaf's largest magnitude of the
    same JAX fit, its byte report the reference's."""
    data = _tiny_data(N=8)
    adj = np.array([[0, 1], [1, 0]], bool)
    cfg = SolverConfig(iters=4, qp_iters=20, **field)
    got = DTSVM(cfg, device="cpu").fit(data["X"], data["y"], adj=adj)
    jfield = dict(field)
    if "net" in field:
        jfield["net"] = JNetConfig.from_dict(field["net"].to_dict())
    want = jsolvers.DTSVM(jsolvers.SolverConfig(
        iters=4, qp_iters=20, **jfield)).fit(data["X"], data["y"], adj=adj)
    if cfg.net is None or cfg.net.is_identity:
        vmap = DTSVM(cfg.replace(net=None, backend="vmap"),
                     device="cpu").fit(data["X"], data["y"], adj=adj)
        for name, a, b in zip(got.state_._fields, got.state_, vmap.state_):
            assert torch.equal(a, b), name
    for name, g, w in zip(got.state_._fields, got.state_, want.state_):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            1e-4 * float(np.abs(w).max()), name
    for k, v in want.net_report_.items():
        if k != "bytes_round_series":
            assert got.net_report_[k] == v, k


def test_net_dicts_are_the_references():
    """A net config's dict is key for key the reference's, and each
    package's loads into the other."""
    kw = dict(policy=dict(quant="int16", drop=0.1),
              edge_policies={(1, 0): dict(delay=2)}, schedule="gossip",
              seed=4, stale_limit=3)
    net = NetConfig(policy=LinkPolicy(**kw["policy"]),
                    edge_policies={(1, 0): LinkPolicy(delay=2)},
                    **{k: kw[k] for k in ("schedule", "seed",
                                          "stale_limit")})
    d = SolverConfig(net=net, iters=3).to_dict()
    jd = jsolvers.SolverConfig(net=JNetConfig.from_dict(net.to_dict()),
                               iters=3).to_dict()
    assert d == jd
    assert SolverConfig.from_dict(jd) == SolverConfig(net=net, iters=3)
    assert jsolvers.SolverConfig.from_dict(d).net.to_dict() == \
        net.to_dict()


def _tiny_data(N=6):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 1, N, 3)).astype(np.float32)
    y = np.where(X[..., 0] > 0, 1.0, -1.0).astype(np.float32)
    return {"X": X, "y": y}


def test_fit_without_a_device_needs_cuda(monkeypatch):
    """device=None means "cuda": where no card is present the fit raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _tiny_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DTSVM(SolverConfig(iters=1)).fit(data["X"], data["y"])
    with pytest.raises(RuntimeError):
        DSVM(SolverConfig(iters=1)).fit(data["X"], data["y"])
    with pytest.raises(RuntimeError):
        quickstart.main()


def test_fit_device_argument_overrides_the_constructor():
    data = _tiny_data()
    fit = DSVM(SolverConfig(iters=2, qp_iters=5), device="meta")
    with pytest.raises(ValueError):
        fit.fit(data["X"], data["y"])
    fit.fit(data["X"], data["y"], device="cpu")
    assert fit.state_.r.device.type == "cpu"
    assert tuple(fit.predict(data["X"][0]).shape) == (2, 1, 6)
    assert set(np.unique(fit.predict(data["X"][0]).numpy())) <= {-1.0, 0.0,
                                                                1.0}


def test_predict_and_risks_need_a_fit():
    with pytest.raises(RuntimeError):
        DTSVM(SolverConfig()).risks(np.zeros((1, 2, 3)), np.zeros((1, 2)))


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports with no JAX and nothing of the
    reference package in the process."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
