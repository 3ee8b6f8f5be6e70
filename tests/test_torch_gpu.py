"""The hand CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one.  The file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch; from the root of the repository:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py releases JAX's caches and so needs
JAX.)  Tolerance: the largest error at most 3e-5 (f32) or 1e-2 (bf16)
times the largest magnitude of the plain result.  The shapes
cover the one-problem edge, the paper regime (20 problems of 60 x 11),
odd sizes that exercise the masked edges, and N > 1024, where the
multi-iteration kernel takes its cooperative grid path.  The tiled Gram
kernel is also held bitwise to the square kernel's rows (the two share
one FMA loop), and a budgeted fit to the dense fit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

REL = {"f32": 3e-5, "bf16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only there")
    return torch.device("cuda")


def _close(got, want, rel):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


def _gram_inputs(rng, batch, n, d):
    Z = rng.normal(size=batch + (n, d)).astype(np.float32)
    a = rng.uniform(0.1, 2.0, size=batch + (d,)).astype(np.float32)
    return Z, a


def _qp_inputs(rng, batch, n):
    Z, a = _gram_inputs(rng, batch, n, 5)
    K = np.einsum("...nd,...d,...md->...nm", Z, a, Z).astype(np.float32)
    q = (1.0 + 0.3 * rng.normal(size=batch + (n,))).astype(np.float32)
    hi = np.full(batch + (n,), 0.2, np.float32)
    hi[..., n - n // 4:] = 0.0
    lam0 = rng.uniform(-0.1, 0.3, size=batch + (n,)).astype(np.float32)
    L = np.abs(K).sum(-1).max(-1)
    gamma = np.asarray(1.0 / np.maximum(L, 1e-12), np.float32)
    return K, q, hi, lam0, gamma


def _on(dev, *arrays):
    return [None if x is None else torch.from_numpy(x).to(dev)
            for x in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,d", [((), 1, 1), ((20,), 60, 11),
                                       ((2, 3), 130, 20), ((2,), 1500, 257)])
def test_gram_kernel_matches_plain(cuda, batch, n, d):
    Zc, ac = _on(cuda, *_gram_inputs(np.random.default_rng(n), batch, n, d))
    before = ops.launch_counts()["weighted_gram"]
    got = ops.weighted_gram(Zc, ac)
    torch.cuda.synchronize()
    assert ops.launch_counts()["weighted_gram"] == before + 1
    assert got.shape == batch + (n, n)
    _close(got, ref.weighted_gram(Zc, ac), REL["f32"])


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [((), 1), ((20,), 60), ((2, 3), 130),
                                     ((2,), 3000)])
def test_qp_step_kernel_matches_plain(cuda, batch, n):
    K, q, hi, lam0, gamma = _on(cuda, *_qp_inputs(np.random.default_rng(n),
                                                  batch, n))
    before = ops.launch_counts()["qp_pg_step"]
    got = ops.qp_pg_step(lam0, K, q, hi, gamma)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qp_pg_step"] == before + 1
    _close(got, ref.qp_pg_step(lam0, K, q, hi, gamma), REL["f32"])


@pytest.mark.gpu
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("batch,n,iters", [((20,), 60, 50), ((2,), 1025, 5),
                                           ((3,), 3000, 4), ((1,), 7, 0),
                                           ((2,), 2000, 0)])
def test_qp_multi_kernel_matches_plain(cuda, batch, n, iters, precision,
                                       fold):
    rng = np.random.default_rng(n + iters)
    K, q, hi, lam0, gamma = _qp_inputs(rng, batch, n)
    Z = rng.normal(size=batch + (n, 9)).astype(np.float32) if fold else None
    K, q, hi, lam0, gamma, Z = _on(cuda, K, q, hi, lam0, gamma, Z)
    before = ops.launch_counts()["qp_pg_multi"]
    got = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                          precision=precision)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qp_pg_multi"] == before + 1
    want = ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                           precision=precision)
    for g, w in (zip(got, want) if fold else [(got, want)]):
        _close(g, w, REL[precision])


@pytest.mark.gpu
def test_fit_on_the_card_matches_the_cpu(cuda):
    """A small DTSVM fit through the API, on the card and on the CPU."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, SolverConfig

    data, adj = quickstart.data_and_graph()
    for solver in ("pallas_fused", "pallas_fused_multi"):
        cfg = SolverConfig(iters=5, qp_iters=20, qp_solver=solver)
        risks = [DTSVM(cfg, device=dev).fit(
            data["X"], data["y"], mask=data["mask"], adj=adj).global_risks(
                data["X_test"], data["y_test"]) for dev in ("cuda", "cpu")]
        np.testing.assert_allclose(risks[0], risks[1], atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,N,d,start", [
    (1, 1, 1, 1, 0), (20, 24, 60, 11, 36), (2, 67, 131, 257, 5),
    (3, 130, 62, 1, 1), (2, 64, 256, 33, 64)])
def test_tiled_gram_kernel_matches_plain_into_an_offset_view(cuda, B, M, N,
                                                            d, start):
    """Rows [start, start + M) of a NaN-filled buffer take the panel; M and
    N not multiples of 64 or 4 exercise the masked edges, and an odd row
    stride or offset the scalar stores."""
    rng = np.random.default_rng(M * N + d)
    Zm, a = _gram_inputs(rng, (B,), M, d)
    Zn, _ = _gram_inputs(rng, (B,), N, d)
    Zm, a, Zn = _on(cuda, Zm, a, Zn)
    big = torch.full((B, start + M + 3, N), float("nan"), device=cuda)
    before = ops.launch_counts()["weighted_gram_tiled"]
    got = ops.weighted_gram_rows(Zm, a, Zn, out=big[:, start:start + M])
    torch.cuda.synchronize()
    assert ops.launch_counts()["weighted_gram_tiled"] == before + 1
    assert got.data_ptr() == big[:, start:].data_ptr()
    _close(big[:, start:start + M], ref.weighted_gram_rows(Zm, a, Zn),
           REL["f32"])
    assert torch.isnan(big[:, :start]).all()
    assert torch.isnan(big[:, start + M:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,d,chunk", [((20,), 60, 11, 8),
                                             ((2,), 300, 257, 72),
                                             ((3, 2), 129, 1, 24)])
def test_tiled_panels_are_the_square_kernels_rows(cuda, batch, n, d, chunk):
    from repro_torch.engine import invariants

    Z, a = _on(cuda, *_gram_inputs(np.random.default_rng(n), batch, n, d))
    K = ops.weighted_gram(Z, a)
    streamed, rs = invariants.streamed_gram_panel(Z, a, Z, chunk)
    assert torch.equal(streamed, K)
    torch.testing.assert_close(rs, K.abs().sum(-1), rtol=1e-6, atol=0)
    assert torch.equal(ops.weighted_gram(Z, a, tile=(8, 128)), K)


@pytest.mark.gpu
def test_tiled_wrapper_refuses_cpu_tensors(cuda):
    from repro_torch.kernels import gram as gram_kernel

    Z = torch.ones(1, 8, 3, device=cuda)
    a = torch.ones(1, 3, device=cuda)
    with pytest.raises(ValueError):
        gram_kernel.weighted_gram_tiled(Z.cpu(), a.cpu(), Z.cpu())
    with pytest.raises(ValueError):
        gram_kernel.weighted_gram_tiled(Z, a, Z, out=torch.empty(1, 8, 8))
    with pytest.raises(ValueError):
        ops.weighted_gram_rows(Z, a, Z.cpu())


@pytest.mark.gpu
def test_budgeted_fit_on_the_card_equals_the_dense_fit(cuda):
    """The quickstart's problem under an 8-row budget and under the
    factored operator, on the card: the budgeted K is the dense K
    bitwise, L and the states agree to rounding."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, PlanBudget, SolverConfig
    from repro_torch.engine import plan

    data, adj = quickstart.data_and_graph()
    cfg = SolverConfig(iters=5, qp_iters=20, qp_solver="pallas_fused_multi")
    prob = DTSVM(cfg).make_problem(data["X"], data["y"], data["mask"], adj,
                                   device=cuda)
    dense = plan.compile_problem(prob, cfg)
    budgeted = plan.compile_problem(prob, cfg,
                                    budget=PlanBudget(tile=(8, 128)))
    factored = plan.compile_problem(prob, cfg, qp_operator="factored")
    assert torch.equal(budgeted.inv.K, dense.inv.K)
    assert factored.inv.K is None
    for p in (budgeted, factored):
        torch.testing.assert_close(p.inv.L, dense.inv.L, rtol=1e-6, atol=0)
    want, _ = dense.run(iters=5)
    for p in (budgeted, factored):
        got, _ = p.run(iters=5)
        for name, g, w in zip(want._fields, got, want):
            _close(g, w, 1e-4)


@pytest.mark.gpu
def test_budgeted_replan_on_the_card_rebuilds_the_changed_slices(cuda):
    """A membership change under a budget rebuilds only the K slices whose
    ``a`` row changed, with the tiled kernel; the result is a fresh
    build's K, bitwise."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, PlanBudget, SolverConfig
    from repro_torch.engine import invariants, plan

    data, adj = quickstart.data_and_graph()
    cfg = SolverConfig(qp_solver="pallas_fused_multi",
                       budget=PlanBudget(tile=(8, 128)))
    prob = DTSVM(cfg).make_problem(data["X"], data["y"], data["mask"], adj,
                                   device=cuda)
    compiled = plan.compile_problem(prob, cfg)
    active = torch.ones_like(prob.active)
    active[0, 1] = 0.0
    before = ops.launch_counts()["weighted_gram_tiled"]
    replanned = compiled.replan(active=active)
    torch.cuda.synchronize()
    n = replanned.stats["gram_slices_computed"] - prob.active.numel()
    assert 0 < n < prob.active.numel()
    assert ops.launch_counts()["weighted_gram_tiled"] > before
    fresh = invariants.compute_invariants(replanned.prob)
    assert torch.equal(replanned.inv.K, fresh.K)
