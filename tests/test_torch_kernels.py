"""The port's kernels against the JAX reference.

On the CPU the port runs each kernel's plain PyTorch version
(``repro_torch.kernels.ref``, reached through ``ops``); the JAX side runs
the Pallas kernel in interpret mode, as tests/test_kernels.py does.
Tolerances: rtol = atol = 3e-5 in f32 (the bound of tests/test_kernels.py);
bf16 mode 1e-2 relative to the largest magnitude (the rounding of the
iterate to bf16 differs where the two f32 sums differ in the last bit).

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
holds them against the plain versions there and skips without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gram as jgram
from repro.kernels import qp_step as jqp
from repro.kernels import ref as jref
from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import qp_step as qp_kernel
from repro_torch.kernels import rows as rows_kernel

TOL = dict(rtol=3e-5, atol=3e-5)
BF16_REL = 1e-2


def _close_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale


def _gram_inputs(rng, batch, n, d):
    Z = rng.normal(size=batch + (n, d)).astype(np.float32)
    a = rng.uniform(0.1, 2.0, size=batch + (d,)).astype(np.float32)
    return Z, a


def _qp_inputs(rng, batch, n):
    """A PSD K (a weighted Gram), q, a box with some zero (padding) rows,
    a warm start partly outside the box, and gamma = 1/L per problem."""
    Z, a = _gram_inputs(rng, batch, n, 5)
    K = np.einsum("...nd,...d,...md->...nm", Z, a, Z).astype(np.float32)
    q = (1.0 + 0.3 * rng.normal(size=batch + (n,))).astype(np.float32)
    hi = np.full(batch + (n,), 0.2, np.float32)
    hi[..., n - n // 4:] = 0.0
    lam0 = rng.uniform(-0.1, 0.3, size=batch + (n,)).astype(np.float32)
    L = np.abs(K).sum(-1).max(-1)
    gamma = np.asarray(1.0 / np.maximum(L, 1e-12), np.float32)
    return K, q, hi, lam0, gamma


T = torch.from_numpy


@pytest.mark.parametrize("n,d", [(1, 1), (5, 3), (37, 11), (60, 11),
                                 (130, 20)])
def test_gram_plain_matches_pallas_kernel(n, d):
    Z, a = _gram_inputs(np.random.default_rng(n * 100 + d), (), n, d)
    want = jgram.weighted_gram_2d(jnp.asarray(Z), jnp.asarray(a),
                                  interpret=True)
    got = ops.weighted_gram(T(Z), T(a))
    assert got.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gram_batched_matches_reference():
    Z, a = _gram_inputs(np.random.default_rng(1), (3, 2), 24, 11)
    got = ops.weighted_gram(T(Z), T(a))
    assert got.shape == (3, 2, 24, 24)
    want = jref.weighted_gram(jnp.asarray(Z), jnp.asarray(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gram_rows_matches_reference():
    rng = np.random.default_rng(2)
    Zm, a = _gram_inputs(rng, (2,), 9, 7)
    Zn, _ = _gram_inputs(rng, (2,), 30, 7)
    got = ref.weighted_gram_rows(T(Zm), T(a), T(Zn))
    want = jref.weighted_gram_rows(jnp.asarray(Zm), jnp.asarray(a),
                                   jnp.asarray(Zn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 37, 60, 130])
def test_qp_step_plain_matches_pallas_kernel(n):
    K, q, hi, lam0, gamma = _qp_inputs(np.random.default_rng(n), (), n)
    want = jqp.qp_pg_step_1d(jnp.asarray(lam0), jnp.asarray(K),
                             jnp.asarray(q), jnp.asarray(hi),
                             jnp.asarray(gamma), interpret=True)
    got = ops.qp_pg_step(T(lam0), T(K), T(q), T(hi), T(gamma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qp_step_per_problem_gamma_matches_reference():
    K, q, hi, lam0, gamma = _qp_inputs(np.random.default_rng(3), (3, 2), 20)
    got = ops.qp_pg_step(T(lam0), T(K), T(q), T(hi), T(gamma))
    want = jref.qp_pg_step(jnp.asarray(lam0), jnp.asarray(K), jnp.asarray(q),
                           jnp.asarray(hi), jnp.asarray(gamma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a prefix (per-node) gamma broadcasts over the task axis
    got_p = ops.qp_pg_step(T(lam0), T(K), T(q), T(hi), T(gamma[:, 0]))
    want_p = jref.qp_pg_step(jnp.asarray(lam0), jnp.asarray(K),
                             jnp.asarray(q), jnp.asarray(hi),
                             jnp.asarray(gamma[:, 0]))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_qp_multi_plain_matches_pallas_kernel(precision, fold):
    rng = np.random.default_rng(4)
    n, d, iters = 37, 11, 6
    K, q, hi, lam0, gamma = _qp_inputs(rng, (), n)
    Z = rng.normal(size=(n, d)).astype(np.float32) if fold else None
    want = jqp.qp_pg_multi_1d(
        jnp.asarray(lam0), jnp.asarray(K), jnp.asarray(q), jnp.asarray(hi),
        jnp.asarray(gamma), iters=iters,
        Z=None if Z is None else jnp.asarray(Z), precision=precision,
        interpret=True)
    got = ops.qp_pg_multi(T(lam0), T(K), T(q), T(hi), T(gamma), iters=iters,
                          Z=None if Z is None else T(Z), precision=precision)
    pairs = list(zip(got, want)) if fold else [(got, want)]
    for g, w in pairs:
        if precision == "f32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        else:
            _close_rel(g.numpy(), np.asarray(w), BF16_REL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_qp_multi_batched_matches_reference(precision):
    rng = np.random.default_rng(5)
    K, q, hi, lam0, gamma = _qp_inputs(rng, (2, 3), 16)
    Z = rng.normal(size=(2, 3, 16, 4)).astype(np.float32)
    lam, zl = ops.qp_pg_multi(T(lam0), T(K), T(q), T(hi), T(gamma),
                              iters=12, Z=T(Z), precision=precision)
    wlam, wzl = jref.qp_pg_multi(jnp.asarray(lam0), jnp.asarray(K),
                                 jnp.asarray(q), jnp.asarray(hi),
                                 jnp.asarray(gamma), iters=12,
                                 Z=jnp.asarray(Z), precision=precision)
    assert lam.shape == (2, 3, 16) and zl.shape == (2, 3, 4)
    for g, w in ((lam, wlam), (zl, wzl)):
        if precision == "f32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        else:
            _close_rel(g.numpy(), np.asarray(w), BF16_REL)


def test_qp_multi_f32_is_the_iterated_step():
    """The multi solve is clip + ``iters`` steps, on the plain path."""
    K, q, hi, lam0, gamma = (T(x) for x in
                             _qp_inputs(np.random.default_rng(6), (4,), 25))
    lam = torch.minimum(torch.clamp_min(lam0, 0.0), hi)
    for _ in range(9):
        lam = ops.qp_pg_step(lam, K, q, hi, gamma)
    multi = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=9)
    assert torch.equal(multi, lam)


def test_unknown_precision_raises():
    K, q, hi, lam0, gamma = (T(x) for x in
                             _qp_inputs(np.random.default_rng(7), (), 4))
    with pytest.raises(ValueError):
        ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=1, precision="fp8")


def test_dispatch_is_by_device_and_refuses_mixed_devices():
    Z = torch.zeros(2, 5, 3)
    a = torch.ones(2, 3, device="meta")
    with pytest.raises(ValueError):
        ops.weighted_gram(Z, a)


def test_kernel_wrappers_take_only_cuda_tensors():
    """The wrappers never run the plain version: a CPU tensor is refused
    before any build is attempted."""
    Z, a = torch.zeros(1, 4, 3), torch.ones(1, 3)
    with pytest.raises(ValueError):
        gram_kernel.weighted_gram(Z, a)
    with pytest.raises(ValueError):
        gram_kernel.prescale(Z, a)
    with pytest.raises(ValueError):
        gram_kernel.weighted_gram_tiled(torch.zeros(2, 1, 3, 4), 0,
                                        torch.zeros(1, 4, 4))
    lam, K, q, hi, g = (torch.zeros(1, 4), torch.zeros(1, 4, 4),
                        torch.zeros(1, 4), torch.zeros(1, 4), torch.ones(1))
    with pytest.raises(ValueError):
        qp_kernel.qp_pg_step(lam, K, q, hi, g)
    with pytest.raises(ValueError):
        qp_kernel.qp_pg_multi(lam, K, q, hi, g, iters=1)
    with pytest.raises(ValueError):
        rows_kernel.gemm_rows(torch.zeros(2, 3), torch.zeros(2),
                              torch.zeros(8, 3))


def test_launch_counts_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"weighted_gram": 0,
                                   "weighted_gram_tiled": 0,
                                   "gram_prescale": 0,
                                   "qp_pg_step": 0, "qp_pg_multi": 0,
                                   "gemm_rows": 0}
