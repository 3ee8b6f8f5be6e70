"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU, over several steps.

The same seeded numpy parameters and gradients (a fresh gradient each
step) go through both packages.  fp32 leaves: parameters and moments
within rtol = 1e-5 of each other with atol = 1e-6 of each leaf's largest
magnitude (the update divides two moments that each carry an fp32
rounding of their own; the step is 1e-3 of the parameters' scale).
bf16 leaves: parameters within one bf16 ulp (rtol 2 ** -7), the fp32
moments as above.  The schedule and the norms within 1e-6 (rtol).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim

# the modules (each package's ``adamw`` name is the function)
jadamw = importlib.import_module("repro.optim.adamw")
tadamw = importlib.import_module("repro_torch.optim.adamw")

SHAPES = {"embed": (40, 8), "ln": (8,), "bias": (12,), "w": (8, 12)}
STEPS = 5
LR = 1e-3
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 2.0 ** -7


def _tree(rng, scale=1.0):
    return {n: (scale * rng.normal(size=s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _both(tree, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ({n: jnp.asarray(a).astype(jdt) for n, a in tree.items()},
            {n: torch.from_numpy(a).to(tdt) for n, a in tree.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_tree(got, want, **tol):
    assert sorted(got) == sorted(want)
    for n in got:
        g, w = _np(got[n]), _np(want[n])
        atol = tol.get("atol", 0.0) * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=tol["rtol"], atol=atol,
                                   err_msg=n)


def _run(make, dtype, steps=STEPS, seed=0):
    """``steps`` updates by both packages' optimizer from ``make(pkg)``;
    yields (step, port params, port state, reference params, state)."""
    rng = np.random.default_rng(seed)
    jp, tp = _both(_tree(rng), dtype)
    jopt, topt = make(joptim), make(optim)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for k in range(steps):
        jg, tg = _both(_tree(rng, scale=0.1), dtype)
        jup, jstate = jopt.update(jg, jstate, jp)
        jp = joptim.apply_updates(jp, jup)
        tup, tstate = topt.update(tg, tstate, tp)
        tp = optim.apply_updates(tp, tup)
        yield k + 1, tp, tstate, jp, jstate


ADAMW = {
    "plain": lambda pkg: pkg.adamw(LR),
    "decay": lambda pkg: pkg.adamw(LR, weight_decay=0.01),
    "cosine+decay": lambda pkg: pkg.adamw(
        pkg.cosine_schedule(LR, warmup=2, total=4, floor=1e-4),
        weight_decay=0.1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(ADAMW))
def test_adamw_matches_the_reference(kind, dtype):
    """Parameters, both moments and the step after each of five steps;
    the cosine case runs through warm-up, decay and the floor."""
    for k, tp, ts, jp, js in _run(ADAMW[kind], dtype):
        assert int(ts.step) == int(js.step) == k
        assert ts.step.dtype == torch.int32
        if dtype == "float32":
            _close_tree(tp, jp, **FP32_TOL)
        else:
            _close_tree(tp, jp, rtol=BF16_RTOL)
        _close_tree(ts.mu, js.mu, **FP32_TOL)
        _close_tree(ts.nu, js.nu, **FP32_TOL)
        assert all(t.dtype == torch.float32 for t in ts.mu.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cosine", [False, True])
def test_sgd_matches_the_reference(dtype, cosine):
    def make(pkg):
        return pkg.sgd(pkg.cosine_schedule(LR, 2, 4) if cosine else LR)
    for k, tp, ts, jp, js in _run(make, dtype):
        assert int(ts.step) == int(js.step) == k
        tol = FP32_TOL if dtype == "float32" else dict(rtol=BF16_RTOL)
        _close_tree(tp, jp, **tol)


def test_weight_decay_reaches_every_leaf():
    """A zero gradient still moves every leaf, norms and biases included,
    by lr * weight_decay * p: the reference's rule."""
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    jp, tp = _both(tree, "float32")
    opt = optim.adamw(LR, weight_decay=0.5)
    zeros = {n: torch.zeros_like(p) for n, p in tp.items()}
    ups, _ = opt.update(zeros, opt.init(tp), tp)
    jups, _ = joptim.adamw(LR, weight_decay=0.5).update(
        {n: jnp.zeros_like(p) for n, p in jp.items()},
        joptim.adamw(LR).init(jp), jp)
    for n in SHAPES:
        np.testing.assert_allclose(_np(ups[n]), -LR * 0.5 * tree[n],
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(ups[n]), _np(jups[n]), rtol=1e-6)


def test_cosine_schedule_matches_the_reference():
    fn = optim.cosine_schedule(3e-4, warmup=10, total=50, floor=1e-5)
    jfn = joptim.cosine_schedule(3e-4, warmup=10, total=50, floor=1e-5)
    steps = np.arange(0, 60, dtype=np.int32)
    got = fn(torch.from_numpy(steps))
    want = jfn(jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [1e-2, 1e3])
def test_global_norm_and_clip_match_the_reference(max_norm):
    """Both sides of the clip: a norm above ``max_norm`` scales every
    leaf by max_norm / (norm + 1e-9), one below leaves them as they
    are; bf16 leaves keep their dtype."""
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    jg, tg = _both(tree, "float32")
    tg["w"] = tg["w"].to(torch.bfloat16)
    jg["w"] = jg["w"].astype(jnp.bfloat16)
    norm = optim.global_norm(tg)
    np.testing.assert_allclose(float(norm), float(joptim.global_norm(jg)),
                               rtol=1e-6)
    got, gn = optim.clip_by_global_norm(tg, max_norm)
    want, jn = joptim.clip_by_global_norm(jg, max_norm)
    assert float(gn) == float(norm)
    assert got["w"].dtype == torch.bfloat16
    _close_tree(got, want, rtol=BF16_RTOL)
    if max_norm > float(norm):
        assert all(torch.equal(got[n], tg[n]) for n in tg)


def test_update_consumes_the_state():
    """The moments are updated in place and carried into the returned
    state; the step is a new tensor, the old one left as it was
    (module doc)."""
    rng = np.random.default_rng(5)
    _, tp = _both(_tree(rng), "float32")
    _, tg = _both(_tree(rng), "float32")
    opt = optim.adamw(LR)
    s0 = opt.init(tp)
    mu0 = dict(s0.mu)
    _, s1 = opt.update(tg, s0, tp)
    assert all(s1.mu[n] is mu0[n] for n in mu0)
    assert int(s0.step) == 0 and int(s1.step) == 1
    assert isinstance(s1, tadamw.AdamWState)
    assert tadamw.AdamWState._fields == jadamw.AdamWState._fields
    assert tadamw.SGDState._fields == jadamw.SGDState._fields


def test_apply_updates_is_in_place_under_no_grad():
    p = {"w": torch.nn.Parameter(torch.ones(3))}
    out = optim.apply_updates(p, {"w": torch.full((3,), -0.5)})
    assert out is p and p["w"].requires_grad
    assert torch.equal(p["w"].detach(), torch.full((3,), 0.5))
    assert p["w"].grad_fn is None
