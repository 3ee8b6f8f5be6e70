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
multi-iteration kernel takes its cooperative grid path.
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
