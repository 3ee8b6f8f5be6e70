"""The port's allreduce training path (``repro_torch.models.layers``'
losses, ``transformer.forward_train``, ``repro_torch.train.steps``'
train step) against the reference's on the CPU: the losses, qwen2's
steps, the remat, the chunked loss and the step's interface; ``test_torch_train_dense.py``, ``test_torch_train_moe.py``
and ``test_torch_train_ssm.py`` hold each family's stacks with this
file's helpers.

The same seeded numpy inputs and the same weights (carried across with
``repro_torch.convert.lm_params_to_torch``) go through both packages;
``jax.value_and_grad``'s tree and the port's gradients
(``lm_grads_to_numpy``) are compared leaf by leaf.  Tolerances, fp32
compute:

- the loss within rtol 1e-5 (the packages differ by ~1e-7);
- each gradient leaf within 1e-4 of that leaf's largest magnitude (the
  orders of autograd's and ``jax.grad``'s sums differ; the ten reduced
  stacks differ by at most 5e-6), the logits within 1e-4;
- ``grad_norm`` within rtol 1e-5, the optimizer's moments as the
  gradients;
- the parameters after a step within 2 lr a step.  Adam's first steps
  divide each gradient by its own magnitude, so an element whose
  gradient lies within the two frameworks' noise can step by about +lr
  or -lr in either: 2 lr is the most two correct steps can differ by.
  That bound alone would pass a wrong sign anywhere, so at most 1e-3 of
  the elements may differ by more than lr / 100 (the reduced stacks:
  about 2e-5 after three steps, none past 0.13 lr).

bf16 compute is held with the reference's own fp32 run as the
yardstick, as ``test_bf16_is_as_accurate_as_the_reference`` does for
prefill: per leaf, the port's distance from the fp32 gradient at most
1.5x the reference's plus 1e-3 of the leaf's largest magnitude.  An MoE
token whose K-th and (K+1)-th fp32 router probabilities lie within bf16
noise (under NEAR_TIE = 4e-3 apart: the layers below move a probability
near 0.1 by up to ~1.5e-3 in bf16, in either package) can take another
expert in bf16.  Where the port's bf16 run moves such a pick, and only
in the last layer (whose MoE output reaches no other token), that
token's cross entropy is left out of the compared loss in all four
runs (the aux loss stays in), and the test names it: on
``test_torch_train_moe.py``'s inputs, token (0, 21) of reduced
phi3.5-moe's layer 1, fp32 probabilities 0.10508 (expert 1) and 0.10421
(expert 3), which the port's bf16 picks 3 at 0.1062 against 0.1052 and
the reference's keeps 1 at 0.1066 against 0.1051.  Any other flip fails.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import jax.tree_util as tu
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtrans
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.configs.base import InputShape
from repro_torch.convert import (lm_grads_to_numpy, lm_params_to_numpy,
                                 lm_params_to_torch)
from repro_torch.models import layers, moe, transformer
from repro_torch.train import steps
from test_torch_models import _batch, _np, _reference_params

LR = 3e-4
NEAR_TIE = 4e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FLIP = 2 * LR          # the most one step of either package can differ by
NEAR = LR / 100
FAR_FRACTION = 1e-3
BATCH, SEQ = 2, 32


# ---------------------------------------------------------------------------
# helpers (also imported by the other families' files)
# ---------------------------------------------------------------------------
def train_models(arch, dtype="float32", seed=0, **over):
    """Both packages' reduced configs at ``dtype`` (with ``over``) and the
    reference's weights: its tree and a fresh port model holding them."""
    over = dict(over, compute_dtype=dtype)
    jcfg = jconfigs.get_reduced_config(arch).replace(**over)
    cfg = configs.get_reduced_config(arch).replace(**over)
    params, tree = _reference_params(arch, seed)
    return jcfg, cfg, params, lm_params_to_torch(tree, cfg, device="cpu")


def train_batch(cfg, B=BATCH, S=SEQ, seed=1):
    """``_batch``'s inputs (text length S less any vision prefix) and
    seeded targets, as reference arrays and port tensors."""
    St = S - (cfg.num_prefix_tokens if cfg.frontend == "vision" else 0)
    jb, tb = _batch(cfg, B, St, seed)
    tg = np.random.default_rng(seed + 100).integers(
        0, cfg.vocab_size, (B, St)).astype(np.int32)
    jb["targets"], tb["targets"] = jnp.asarray(tg), torch.from_numpy(tg)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jgrad(jcfg):
    """The reference's (loss, logits) and the loss's gradient, compiled
    once per config."""
    def loss(p, b):
        logits, total = jtrans.forward_train(p, b, jcfg)
        return total, logits
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def jstep(jcfg, microbatch=0):
    """The reference's train step, compiled once per config."""
    return jax.jit(jsteps.make_train_step(jcfg, lr=LR,
                                          microbatch=microbatch))


def grads_of(net, cfg, tb):
    """The port's loss and gradient tree (``forward_train`` then
    ``backward``)."""
    net.zero_grad(set_to_none=True)
    logits, loss = transformer.forward_train(net, tb, cfg)
    loss.backward()
    return logits.detach(), loss.detach(), lm_grads_to_numpy(net)


def leaves(tree):
    return tu.tree_leaves(jax.tree.map(_np, tree))


def leaf_errors(got, want):
    """Per leaf: the largest difference over the leaf's largest
    magnitude."""
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    out = []
    for a, b in zip(g, w, strict=True):
        assert a.shape == b.shape
        out.append(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
    return out


def close_grads(got, want, tol=GRAD_TOL):
    errs = leaf_errors(got, want)
    assert max(errs) <= tol, max(errs)


def close_params(got_tree, want_tree, steps_taken):
    """Parameters after ``steps_taken`` steps in units of lr (module doc)."""
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        leaves(got_tree), leaves(want_tree), strict=True)])
    assert d.max() <= FLIP * steps_taken, d.max() / LR
    assert (d > NEAR).mean() <= FAR_FRACTION, (d > NEAR).mean()


def port_state(net):
    return {"params": net,
            "opt": steps.make_optimizer(LR).init(
                transformer.named_leaves(net))}


def check_forward_train(arch):
    """fp32 loss, logits and every gradient leaf against the reference."""
    jcfg, cfg, params, net = train_models(arch)
    jb, tb = train_batch(cfg)
    (jl, jlogits), jg = _jgrad(jcfg)(params, jb)
    logits, loss, g = grads_of(net, cfg, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    close_grads(g, jg)


def check_train_steps(arch, n_steps=1, microbatch=0, B=BATCH):
    """``n_steps`` of ``make_train_step`` (fp32) in both packages: the
    loss and grad_norm of each, then the parameters and moments."""
    jcfg, cfg, params, net = train_models(arch)
    jb, tb = train_batch(cfg, B=B)
    js = {"params": params, "opt": jsteps.make_optimizer(LR).init(params)}
    ts = port_state(net)
    step = steps.make_train_step(cfg, lr=LR, microbatch=microbatch)
    for _ in range(n_steps):
        js, jm = jstep(jcfg, microbatch)(js, jb)
        ts, tm = step(ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=LOSS_RTOL)
    assert int(ts["opt"].step) == int(js["opt"].step) == n_steps
    close_params(lm_params_to_numpy(net), js["params"], n_steps)
    close_grads(lm_grads_to_numpy(net, ts["opt"].mu), js["opt"].mu)
    close_grads(lm_grads_to_numpy(net, ts["opt"].nu), js["opt"].nu)


def _routing(net, cfg, tb):
    """Each MoE layer's fp32 router probabilities and top-k picks over
    the tokens of the port's forward, in layer order."""
    out = []
    real = moe.route

    def route(p, xt, c):
        probs, w, i = real(p, xt, c)
        out.append((probs.detach().float().numpy(), i.numpy()))
        return probs, w, i
    with mock.patch.object(moe, "route", route), torch.no_grad():
        transformer.forward_train(net, tb, cfg)
    return out


def near_tie_flips(arch):
    """The tokens (flat over B x S) whose top-k picks the port's bf16 run
    moves from its fp32 run's, each with its fp32 margin (the K-th less
    the (K+1)-th probability); only in the last layer, whose MoE output
    reaches no other token, and only at a near tie (module doc)."""
    runs = []
    for dtype in ("float32", "bfloat16"):
        _, cfg, _, net = train_models(arch, dtype)
        runs.append(_routing(net, cfg, train_batch(cfg)[1]))
    K = configs.get_reduced_config(arch).moe_top_k
    flips = {}
    for layer, ((probs, a), (_, b)) in enumerate(zip(*runs, strict=True)):
        top = -np.sort(-probs, axis=-1)
        for t in np.nonzero((np.sort(a, -1) != np.sort(b, -1)).any(-1))[0]:
            flips[(layer, int(t))] = float(top[t, K - 1] - top[t, K])
    n_moe = len(runs[0])
    assert all(layer == n_moe - 1 and margin < NEAR_TIE
               for (layer, _), margin in flips.items()), flips
    return flips


@functools.lru_cache(maxsize=None)
def _jmasked(jcfg):
    """The reference's loss over the tokens ``keep`` marks (the mean
    token CE over them plus the aux loss) and its gradient."""
    def loss(p, b, keep):
        logits, total = jtrans.forward_train(p, b, jcfg)
        aux = total - jlayers.cross_entropy(logits, b["targets"])
        gold = jnp.take_along_axis(logits, b["targets"][..., None], -1)
        tok = jax.nn.logsumexp(logits, -1) - gold[..., 0]
        return jnp.sum(tok * keep) / jnp.sum(keep) + aux
    return jax.jit(jax.value_and_grad(loss))


def check_bf16_grads(arch):
    """Each package's bf16 loss and gradients against the reference's fp32
    ones: the port's distance per leaf at most 1.5x the reference's
    plus 1e-3, over the tokens no near tie flips (module doc)."""
    flips = near_tie_flips(arch)
    keep = np.ones((BATCH, SEQ), np.float32)
    for _, t in flips:
        keep.reshape(-1)[t] = 0.0
    jcfg32, _, params, _ = train_models(arch)
    jb, _ = train_batch(jcfg32)
    truth_l, truth = _jmasked(jcfg32)(params, jb, keep)
    jcfg, cfg, params, net = train_models(arch, "bfloat16")
    jb, tb = train_batch(cfg)
    jl, jg = _jmasked(jcfg)(params, jb, keep)
    logits, total = transformer.forward_train(net, tb, cfg)
    tg = tb["targets"].long()
    aux = total - layers.cross_entropy(logits, tg)
    gold = logits.gather(-1, tg[..., None])[..., 0]
    tok = torch.logsumexp(logits, -1) - gold
    tkeep = torch.from_numpy(keep)
    loss = (tok * tkeep).sum() / tkeep.sum() + aux
    loss.backward()
    g = lm_grads_to_numpy(net)
    ref_errs, port_errs = leaf_errors(jg, truth), leaf_errors(g, truth)
    for port, ref in zip(port_errs, ref_errs, strict=True):
        assert port <= 1.5 * ref + 1e-3, (port, ref, flips)
    assert abs(float(loss.detach()) - float(truth_l)) <= \
        1.5 * abs(float(jl) - float(truth_l)) + 1e-3
    return flips


def check_remat(arch):
    """``remat=True`` (each stacked layer checkpointed) gives the loss and
    gradients of ``remat=False`` bitwise: the recompute runs the same
    ops on the same inputs."""
    out = []
    for remat in (False, True):
        _, cfg, _, net = train_models(arch, remat=remat)
        _, tb = train_batch(cfg)
        out.append(grads_of(net, cfg, tb))
    (_, l0, g0), (_, l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(np.array_equal(a, b)
               for a, b in zip(leaves(g0), leaves(g1), strict=True))


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------
def _ce_inputs(B, S, d, V, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    head = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    tg = rng.integers(0, V, (B, S)).astype(np.int32)
    return x, head, tg


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_cross_entropy_matches_the_reference(cap):
    """Value and gradient with respect to the logits, with and without
    gemma's final softcap in front of it."""
    x, head, tg = _ce_inputs(2, 12, 16, 50)

    def jloss(x, head):
        return jlayers.cross_entropy(jlayers.lm_head(x, head, cap),
                                     jnp.asarray(tg))
    jl, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    loss = layers.cross_entropy(layers.lm_head(tx, th, cap),
                                torch.from_numpy(tg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    close_grads([tx.grad.numpy(), th.grad.numpy()], [jgx, jgh])


# (S, seq_chunk): a chunk that divides S; halved twice (48 % 32, then 16);
# halved to 2 (6 % 4); and down to 1, where the full loss is taken
CHUNKS = [(64, 16), (48, 32), (6, 4), (7, 4)]


@pytest.mark.parametrize("S,chunk", CHUNKS)
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunked_cross_entropy_matches_the_reference(S, chunk, cap):
    """Value and gradients (x and the head) against the reference's
    chunked form, and equal to the port's own full loss within
    rounding."""
    x, head, tg = _ce_inputs(2, S, 16, 50, seed=S)

    def jloss(x, head):
        return jlayers.chunked_cross_entropy(x, head, jnp.asarray(tg), cap,
                                             seq_chunk=chunk)
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    got = []
    for chunked in (True, False):
        tx = torch.from_numpy(x).requires_grad_()
        th = torch.from_numpy(head).requires_grad_()
        t = torch.from_numpy(tg)
        loss = (layers.chunked_cross_entropy(tx, th, t, cap, seq_chunk=chunk)
                if chunked else
                layers.cross_entropy(layers.lm_head(tx, th, cap), t))
        loss.backward()
        got.append((float(loss.detach()), [tx.grad.numpy(),
                                           th.grad.numpy()]))
    (cl, cg), (fl, fg) = got
    np.testing.assert_allclose(cl, float(jl), rtol=LOSS_RTOL)
    close_grads(cg, list(jg))
    np.testing.assert_allclose(cl, fl, rtol=LOSS_RTOL)
    close_grads(cg, fg)


def test_chunked_cross_entropy_recomputes_each_chunk(monkeypatch):
    """Each chunk's logits are computed once in the forward and again in
    the backward (the checkpoint keeps none of them): 2 x 4 head calls
    for 4 chunks."""
    calls = []
    real = layers.lm_head

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(layers, "lm_head", counted)
    x, head, tg = _ce_inputs(2, 32, 8, 64)
    tx = torch.from_numpy(x).requires_grad_()
    loss = layers.chunked_cross_entropy(tx, torch.from_numpy(head),
                                        torch.from_numpy(tg), 0.0,
                                        seq_chunk=8)
    assert len(calls) == 4
    loss.backward()
    assert calls == [(2, 8, 8)] * 8


# ---------------------------------------------------------------------------
# qwen2's step (the dense family's parity: test_torch_train_dense.py)
# ---------------------------------------------------------------------------
def test_two_train_steps_match_the_reference():
    """qwen2: the tied head (two gradient contributions to ``embed``) and
    the QKV biases (gradients and weight decay) over two steps."""
    check_train_steps("qwen2-0.5b", n_steps=2)


def test_microbatch_matches_the_reference():
    """microbatch=2 over a batch of 4 against the reference's own
    microbatch=2: fp32 accumulation, then the sum and the loss halved."""
    check_train_steps("qwen2-0.5b", microbatch=2, B=4)


def test_microbatch_must_divide_the_batch():
    _, cfg, _, net = train_models("qwen2-0.5b")
    _, tb = train_batch(cfg, B=3)
    with pytest.raises(AssertionError):
        steps.make_train_step(cfg, microbatch=2)(port_state(net), tb)


def test_bf16_gradients_are_as_accurate_as_the_reference():
    assert check_bf16_grads("qwen2-0.5b") == {}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-2b"])
def test_remat_gives_the_same_gradients(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-2b"])
def test_chunked_forward_train_matches_the_full_loss(arch):
    """``chunked_ce``: the same loss and gradients as the full loss
    (within rounding), only the last position's logits, and the
    reference's chunked loss; internvl2 drops its vision prefix first."""
    out = []
    for chunked in (False, True):
        jcfg, cfg, params, net = train_models(arch, chunked_ce=chunked)
        jb, tb = train_batch(cfg, S=40)
        out.append(grads_of(net, cfg, tb))
    (logits, l0, g0), (last, l1, g1) = out
    St = tb["tokens"].shape[1]
    assert logits.shape == (BATCH, St, cfg.vocab_size)
    assert last.shape == (BATCH, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(last), _np(logits[:, -1:]), atol=1e-6)
    np.testing.assert_allclose(float(l1), float(l0), rtol=LOSS_RTOL)
    close_grads(g1, g0, tol=1e-5)
    (jl, _), jg = _jgrad(jcfg)(params, jb)
    np.testing.assert_allclose(float(l1), float(jl), rtol=LOSS_RTOL)
    close_grads(g1, jg)


# ---------------------------------------------------------------------------
# the step's interface
# ---------------------------------------------------------------------------
def test_grad_specs_has_no_meaning_on_one_card():
    cfg = configs.get_reduced_config("qwen2-0.5b")
    with pytest.raises(ValueError, match="one card"):
        steps.make_train_step(cfg, grad_specs={"embed": None})


def test_make_step_returns_the_train_step():
    """train_4k's step kind gives the allreduce step; it takes a step."""
    _, cfg, _, net = train_models("qwen2-0.5b")
    _, tb = train_batch(cfg)
    step = steps.make_step(cfg, SHAPES["train_4k"])
    state, metrics = step(port_state(net), tb)
    assert state["params"] is net and int(state["opt"].step) == 1
    assert bool(torch.isfinite(metrics["loss"]))


def _path_key(path):
    return tuple(k.key if isinstance(k, tu.DictKey) else k.idx for k in path)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_state_specs_follow_the_reference_leaves(arch):
    """At full size, on the meta device: every moment fp32 with its
    parameter's shape, keyed by name in the reference's leaf order (a
    stacked leaf's layers in a row), and the reference's shapes."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape = InputShape("t", 64, 2, "train")
    spec = steps.train_state_specs(cfg, shape)
    jspec = jsteps.train_state_specs(jcfg, shape)
    opt = spec["opt"]
    assert opt.step.dtype == torch.int32 and opt.step.device.type == "meta"
    named = dict(spec["params"].named_parameters())
    assert list(opt.mu) == list(opt.nu) == list(
        transformer.named_leaves(spec["params"]))
    assert sorted(opt.mu) == sorted(named)
    order = []
    for name, m in opt.mu.items():
        assert m.dtype == torch.float32 and m.shape == named[name].shape
        path, _ = transformer.reference_path(name)
        if not order or order[-1] != path:
            order.append(path)
    jleaves = tu.tree_flatten_with_path(jspec["opt"].mu)[0]
    assert order == [_path_key(p) for p, _ in jleaves]
    for name, m in opt.mu.items():
        path, row = transformer.reference_path(name)
        leaf = dict((_path_key(p), s) for p, s in jleaves)[path]
        want = leaf.shape if row is None else leaf.shape[1:]
        assert tuple(m.shape) == tuple(want)
