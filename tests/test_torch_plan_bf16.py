"""The bf16 plan: K converted to bf16 once per ``Plan``, not in every solve.

A plan with ``qp_precision="bf16"`` hands every dual solve the bf16 K it
made when it was built (``Plan.solve_K``); its invariants keep the f32 K.
On the CPU the plain solve rounds K to bf16 itself, so a plan that hands
it the f32 K (the per-solve conversion the reference makes) must give
the same bits.  Against the JAX package (its Pallas kernel in interpret
mode): within 1e-2 of each state leaf's largest magnitude, the bf16
tolerance of ``test_torch_engine.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import dtsvm as jcore
from repro.engine import plan as jplan
from repro_torch import convert
from repro_torch.engine import plan, qp_engines

from test_torch_engine import _problems, _shared_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_plan(tprob, **kw):
    return plan.compile_problem(tprob, qp_iters=10,
                                qp_solver="pallas_fused_multi",
                                qp_precision="bf16", **kw)


def test_bf16_plan_converts_k_once(monkeypatch):
    """One f32 -> bf16 conversion of a K-sized tensor, when the plan is
    built; every step hands the engine that same bf16 K."""
    _, tprob = _problems()
    V, T, N = tprob.X.shape[:3]
    conversions = []
    to = torch.Tensor.to

    def counting_to(self, *args, **kwargs):
        out = to(self, *args, **kwargs)
        if (self.dtype == torch.float32 and out.dtype == torch.bfloat16
                and tuple(self.shape) == (V, T, N, N)):
            conversions.append(tuple(self.shape))
        return out

    monkeypatch.setattr(torch.Tensor, "to", counting_to)
    pl = _bf16_plan(tprob)
    assert len(conversions) == 1
    assert pl.inv.K.dtype == torch.float32
    assert pl.solve_K.dtype == torch.bfloat16
    assert torch.equal(pl.solve_K, pl.inv.K.to(torch.bfloat16))

    engine = qp_engines.get("pallas_fused_multi")
    seen = []

    def recording(K, *args, **kwargs):
        seen.append(K)
        return engine(K, *args, **kwargs)

    recording.supports_precision = recording.supports_fold = True
    monkeypatch.setitem(qp_engines._REGISTRY, "pallas_fused_multi",
                        recording)
    pl.run(iters=3)
    assert len(seen) == 3 and all(K is pl.solve_K for K in seen)
    assert len(conversions) == 2        # the check above converted once


def test_f32_and_factored_plans_solve_with_their_own_k():
    _, tprob = _problems()
    dense = plan.compile_problem(tprob, qp_solver="pallas_fused_multi")
    assert dense.solve_K is dense.inv.K
    factored = plan.compile_problem(tprob, qp_solver="pallas_fused_multi",
                                    qp_operator="factored")
    assert factored.solve_K is None and factored.inv.K is None


def test_bf16_plan_fit_equals_the_per_solve_conversion():
    """Five ADMM iterations on the plan's bf16 K are torch.equal to the
    same iterations with the f32 K converted in every solve."""
    _, tprob = _problems()
    once = _bf16_plan(tprob)
    per_solve = _bf16_plan(tprob)
    per_solve.solve_K = per_solve.inv.K
    want, _ = per_solve.run(iters=5)
    got, _ = once.run(iters=5)
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g, w), name


def test_bf16_plan_step_matches_the_pallas_kernel(monkeypatch):
    """One step of the bf16 plan against the JAX package's plan_step
    through its fused Pallas kernel, interpreted on the CPU."""
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    jprob, tprob = _problems()
    jst = _shared_state(jprob)
    want = jplan.compile_problem(jprob, qp_iters=10,
                                 qp_solver="pallas_fused_multi",
                                 qp_precision="bf16").step(jst)
    got = convert.to_numpy(_bf16_plan(tprob).step(
        convert.to_torch(jst, device="cpu")))
    for name in jcore.DTSVMState._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-2 * scale, name


def test_replan_converts_the_new_k_and_leaves_the_old_plan():
    _, tprob = _problems()
    old = _bf16_plan(tprob)
    old_K, old_solve_K = old.inv.K.clone(), old.solve_K.clone()
    active = torch.ones_like(tprob.active)
    active[0, 1] = 0.0
    new = old.replan(active=active)
    assert new.stats["replans"] == 1
    assert new.solve_K.dtype == torch.bfloat16
    assert torch.equal(new.solve_K, new.inv.K.to(torch.bfloat16))
    assert not torch.equal(new.inv.K, old.inv.K)
    assert torch.equal(old.inv.K, old_K)
    assert torch.equal(old.solve_K, old_solve_K)
