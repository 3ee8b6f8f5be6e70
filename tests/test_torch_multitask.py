"""The multi-task decomposition w_t = w0 + wt (``repro_torch.core.
multitask``) against the reference's ``repro.core.multitask``.

Every function runs in both packages on the same numpy-made trees (a
nested mapping, fp32 and bf16 leaves, a 0-d leaf), and each leaf is held
within 1e-6 of its largest magnitude in fp32 and within one bf16 step
(2^-8) of it in bf16.  Then the twin of tests/test_substrates.py's
``test_multitask_combine_and_grads``, and the paper's trade-off (Section
II) at both of its limits: at the minimizer of sum_t 1/2 ||w0 + wt -
c_t||^2 + eps1/2 ||w0||^2 + eps2/2 sum_t ||wt||^2, ``split_grads`` of
the per-task gradients is zero, a large eps2 gives every task the shared
head (the mean of the c_t) and a large eps1 gives each task its own c_t.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import multitask as jmt
from repro_torch.core import multitask as mt

T = 3
EPS1, EPS2 = 0.3, 0.7
TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}


def _np_tree(rng, dtype, lead=()):
    """A nested tree of numpy leaves: a matrix, a vector and a 0-d leaf
    under ``head``, and one more leaf beside it."""
    shapes = {"head": {"w": (5, 4), "b": (4,), "scale": ()},
              "adapter": (6,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        x = rng.standard_normal(lead + s).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    return make(shapes)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _close(got, want, dtype):
    """Each leaf within TOL of the reference leaf's largest magnitude,
    same dtype and shape, over the same keys (the port keeps its
    mapping's order, jax sorts)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], dtype)
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    g = got.float().numpy().astype(np.float64)
    w = want.astype(np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= TOL[dtype] * scale


def _pair(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shared = _np_tree(rng, dtype)
    task = _np_tree(rng, dtype, lead=(T,))
    grads = _np_tree(rng, dtype, lead=(T,))
    return shared, task, grads


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_init(dtype):
    shared, _, _ = _pair(dtype)
    got = mt.init(_torch(shared), T)
    want = jmt.init(_jax(shared), T)
    assert isinstance(got, mt.MultiTaskParams)
    _close(got.shared, want.shared, dtype)
    _close(got.task, want.task, dtype)
    assert all(float(x.abs().max()) == 0 for x in mt._leaves(got.task))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_combine_and_combine_all(dtype):
    shared, task, _ = _pair(dtype)
    got = mt.MultiTaskParams(_torch(shared), _torch(task))
    want = jmt.MultiTaskParams(_jax(shared), _jax(task))
    for t in range(T):
        _close(mt.combine(got, t), jmt.combine(want, t), dtype)
    _close(mt.combine_all(got), jmt.combine_all(want), dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_regularizer(dtype):
    shared, task, _ = _pair(dtype)
    got = mt.regularizer(mt.MultiTaskParams(_torch(shared), _torch(task)),
                         EPS1, EPS2)
    want = jmt.regularizer(jmt.MultiTaskParams(_jax(shared), _jax(task)),
                           EPS1, EPS2)
    # the squares are summed in fp32 whatever the leaves' dtype
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_split_grads(dtype):
    shared, task, grads = _pair(dtype)
    got = mt.split_grads(_torch(grads),
                         mt.MultiTaskParams(_torch(shared), _torch(task)),
                         EPS1, EPS2)
    want = jmt.split_grads(_jax(grads),
                           jmt.MultiTaskParams(_jax(shared), _jax(task)),
                           EPS1, EPS2)
    _close(got.shared, want.shared, dtype)
    _close(got.task, want.task, dtype)


def test_split_grads_casts_to_the_gradients_dtype():
    """fp32 parameters, bf16 gradients: eps * w is cast to bf16 before
    the add, as the reference's ``s.astype(g.dtype)``."""
    shared, task, _ = _pair("float32")
    _, _, grads = _pair("bfloat16", seed=1)
    got = mt.split_grads(_torch(grads),
                         mt.MultiTaskParams(_torch(shared), _torch(task)),
                         EPS1, EPS2)
    want = jmt.split_grads(_jax(grads),
                           jmt.MultiTaskParams(_jax(shared), _jax(task)),
                           EPS1, EPS2)
    _close(got.shared, want.shared, "bfloat16")
    _close(got.task, want.task, "bfloat16")


def test_multitask_combine_and_grads():
    """tests/test_substrates.py's ``test_multitask_combine_and_grads``."""
    params = {"w": torch.ones((3,)), "b": torch.zeros(())}
    m = mt.init(params, num_tasks=2)
    eff = mt.combine(m, 0)
    np.testing.assert_allclose(eff["w"].numpy(), 1.0)
    g = {k: torch.ones_like(d) for k, d in m.task.items()}
    split = mt.split_grads(g, m, eps1=0.1, eps2=0.2)
    # dL/dw0 = sum_t g_t + eps1 * w0 = 2 + 0.1
    np.testing.assert_allclose(split.shared["w"].numpy(), 2.1, rtol=1e-6)
    # dL/dwt = g_t + eps2 * wt = 1 + 0
    np.testing.assert_allclose(split.task["w"].numpy(), 1.0, rtol=1e-6)
    reg = mt.regularizer(m, 1.0, 1.0)
    assert float(reg) == pytest.approx(0.5 * 3.0)


def _minimizer(c, eps1, eps2):
    """The closed-form minimizer of sum_t 1/2 ||w0 + wt - c_t||^2 +
    eps1/2 ||w0||^2 + eps2/2 sum_t ||wt||^2 (float64): wt = (c_t - w0) /
    (1 + eps2) and w0 = a sum_t c_t / (a T + eps1), a = eps2 / (1 +
    eps2)."""
    a = eps2 / (1.0 + eps2)
    w0 = a * c.sum(0) / (a * c.shape[0] + eps1)
    return w0, (c - w0) / (1.0 + eps2)


@pytest.mark.parametrize("limit,eps1,eps2", [
    ("shared", 0.0, 1e6),          # eps2 -> inf: one shared head
    ("independent", 1e6, 0.0),     # eps1 -> inf: independent heads
    ("between", EPS1, EPS2)])
def test_trade_off_limits(limit, eps1, eps2):
    rng = np.random.default_rng(4)
    c = rng.standard_normal((T, 8))
    w0, wt = _minimizer(c, eps1, eps2)
    ports = mt.MultiTaskParams({"w": torch.from_numpy(w0.astype(np.float32))},
                               {"w": torch.from_numpy(wt.astype(np.float32))})
    refs = jmt.MultiTaskParams({"w": jnp.asarray(w0, jnp.float32)},
                               {"w": jnp.asarray(wt, jnp.float32)})
    # the per-task loss gradients at the combined parameters
    g = {"w": mt.combine_all(ports)["w"] - torch.from_numpy(
        c.astype(np.float32))}
    split = mt.split_grads(g, ports, eps1, eps2)
    jsplit = jmt.split_grads({"w": jnp.asarray(g["w"].numpy())}, refs, eps1,
                             eps2)
    _close(split.shared, jsplit.shared, "float32")
    _close(split.task, jsplit.task, "float32")
    # stationary: both parts of the gradient vanish (fp32 rounding of
    # the eps-scaled terms aside)
    scale = max(1.0, eps1, eps2)
    assert float(split.shared["w"].abs().max()) <= 1e-6 * scale * T
    assert float(split.task["w"].abs().max()) <= 1e-6 * scale
    eff = mt.combine_all(ports)["w"].double().numpy()
    if limit == "shared":
        # every task takes the one shared head, the mean of the targets
        np.testing.assert_allclose(eff, np.broadcast_to(c.mean(0), c.shape),
                                   atol=1e-5)
        assert float(np.abs(wt).max()) <= 1e-5
    elif limit == "independent":
        # no shared part; each task its own target
        assert float(np.abs(w0).max()) <= 1e-5
        np.testing.assert_allclose(eff, c, atol=1e-5)
    else:
        spread = np.abs(eff - c.mean(0)).max()
        assert 1e-3 < spread < np.abs(c - c.mean(0)).max()
    reg = mt.regularizer(ports, eps1, eps2)
    _close(reg, jmt.regularizer(refs, eps1, eps2), "float32")
