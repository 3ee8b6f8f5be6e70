"""The port's mixture-of-experts serving path (``repro_torch.models.moe``,
the MoE branch of ``repro_torch.models.transformer``) against the
reference's (``repro.models.moe``, ``repro.models.transformer``) on the
CPU.

The same seeded numpy inputs and the same weights (numpy for
``moe_apply`` alone, ``repro_torch.convert.lm_params_to_torch`` for the
stack) go through both packages.  Tolerances are tests/test_torch_models
.py's: 1e-4 in fp32, 3e-2 in bf16 (a stack's bf16 logits as there).  In
fp32 the routing must be the reference's exactly: the top-k picks, the
slots and the kept mask.  Cases: reduced Phi-3.5-MoE (16 -> 4 experts,
top-2) and the MoE layer of reduced DeepSeek-V2 (a shared expert; its
latent attention is tests/test_torch_mla.py's), dropless (capacity factor 8.0) and at 1.0, at 64
tokens (32 groups), 12 (4), 21 (1 group: capacity round(10.5) = 10 by
Python's half-to-even rule, where round-half-up would give 11) and 1;
exact router ties.  The stack: reduced Phi-3.5-MoE runs in the shared
parity tests of tests/test_torch_models.py and tests/test_torch_launch_
serve.py (``SERVED``); here its variant with a dense leading layer
(``first_k_dense=1``, set in both packages, the reference's
``dense_layers`` list), in the port-only decode check; its convert round
trip is a case of tests/test_torch_models.py's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch import serve
from repro_torch.models import moe, transformer
from repro_torch.train import steps
from test_torch_models import (DTYPES, TDT, TOL, _batch, _close,
                               _close_cache, _close_logits, _jdecode,
                               _jprefill, _np, _pair)

PHI = "phi3.5-moe-42b-a6.6b"
DSV2 = "deepseek-v2-236b"
# (B, S) per token count: 64 tokens make 32 groups, 12 make 4, 21 one
TOKENS = {64: (2, 32), 12: (3, 4), 21: (3, 7), 1: (1, 1)}
# the stack: reduced Phi-3.5-MoE as published, and with its first layer
# a dense-MLP one (the reference's ``dense_layers`` list)
VARIANTS = {"phi": {}, "phi-dense1": {"first_k_dense": 1}}
DENSE1 = "phi-dense1"

_jmoe_apply = jax.jit(jmoe.moe_apply,
                      static_argnames=("cfg", "capacity_factor"))


@functools.partial(jax.jit, static_argnames=("cfg", "G", "cap"))
def _jrouting(p, xt, cfg, G, cap):
    """The reference's routing of xt (T, d) by its own ops and its own
    ``_dispatch_group``: probs, picks, slots (clamped) and kept mask."""
    logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_i = jax.lax.top_k(probs, cfg.moe_top_k)
    T, d = xt.shape
    _, flat_e, pos, keep = jax.vmap(
        lambda a, b: jmoe._dispatch_group(a, b, None, cfg.num_experts, cap))(
        xt.reshape(G, T // G, d), gate_i.reshape(G, T // G, -1))
    return probs, gate_i, flat_e, pos, keep


def _cfgs(arch, dtype, **over):
    over["compute_dtype"] = dtype
    return (jconfigs.get_reduced_config(arch).replace(**over),
            configs.get_reduced_config(arch).replace(**over))


@functools.lru_cache(maxsize=None)
def _moe_params(arch, seed=0):
    """The reference's init of one MoE layer, as numpy."""
    jcfg = jconfigs.get_reduced_config(arch)
    return jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(seed),
                                                  jcfg))


def _as(tree, fn):
    return jax.tree.map(fn, tree)


def _margins(probs, picks_a, picks_b, K):
    """For tokens whose picks differ, the gap between their K-th and
    (K+1)-th largest fp32 router probabilities."""
    differ = np.nonzero((picks_a != picks_b).any(axis=-1))[0]
    top = -np.sort(-probs, axis=-1)
    return {int(t): float(top[t, K - 1] - top[t, K]) for t in differ}


def _port_routing(p, x, cfg, cf):
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, -1)
    G = moe.groups(T)
    cap = moe.capacity(T // G, cfg, cf)
    probs, _, gate_i = moe.route(p, xt, cfg)
    _, flat_e, pos, keep = moe._dispatch_group(
        xt.reshape(G, T // G, -1), gate_i.reshape(G, T // G, -1),
        cfg.num_experts, cap)
    return xt, G, cap, probs, gate_i, flat_e, pos, keep


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_moe_init_matches_the_reference_tree(arch):
    """``moe_shapes`` is the reference's tree, and ``moe_init`` draws each
    leaf at the reference's scale, reproducibly from a seeded generator."""
    cfg = configs.get_reduced_config(arch)
    want = _as(_moe_params(arch), lambda a: a.shape)
    shapes = moe.moe_shapes(cfg)
    got = jax.tree.map(lambda s: s[0], shapes,
                       is_leaf=lambda s: isinstance(s, tuple))
    assert got == want
    assert ("shared" in shapes) == bool(cfg.num_shared_experts)

    def draw(seed):
        p = jax.tree.map(lambda s: torch.empty(s[0]), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
        return moe.moe_init(p, cfg, torch.Generator().manual_seed(seed))

    a, b = draw(3), draw(3)
    jax.tree.map(lambda x, y: torch.testing.assert_close(x, y, rtol=0,
                                                         atol=0), a, b)
    fans = jax.tree.map(lambda s: s[1], shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    for t, fan, ref in zip(jax.tree.leaves(a), jax.tree.leaves(fans),
                           jax.tree.leaves(_moe_params(arch))):
        assert abs(float(t.std()) * fan ** 0.5 - 1) < 0.1
        assert abs(float(ref.std()) * fan ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("tokens", sorted(TOKENS))
@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_moe_apply_matches_the_reference(arch, dtype, cf, tokens):
    """``moe_apply``'s output and aux loss; in fp32 also the routing (picks,
    slots, kept mask) equal to the reference's."""
    jcfg, cfg = _cfgs(arch, dtype)
    p = _moe_params(arch)
    B, S = TOKENS[tokens]
    x = np.random.default_rng(tokens).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tp = _as(p, lambda a: torch.from_numpy(np.array(a)))
    y, aux = moe.moe_apply(tp, tx, cfg, cf)
    jy, jaux = _jmoe_apply(_as(p, jnp.asarray), jx, jcfg, cf)
    assert y.shape == (B, S, cfg.d_model) and y.dtype == TDT[dtype]
    assert aux.dtype == torch.float32 and aux.shape == ()

    xt, G, cap, probs, gate_i, flat_e, pos, keep = _port_routing(
        tp, tx, cfg, cf)
    jprobs, jgate_i, jflat_e, jpos, jkeep = (
        np.asarray(a) for a in _jrouting(_as(p, jnp.asarray),
                                         jx.reshape(B * S, -1), jcfg, G,
                                         cap))
    if tokens == 21:
        assert (G, cap) == (1, 10 if cf == 1.0 else 21)
    if (tokens, cf) == (21, 1.0):
        assert int((~keep).sum()) > 0, "the case must drop assignments"
    same_routing = (np.array_equal(gate_i.numpy(), jgate_i)
                    and np.array_equal(keep.numpy(), jkeep))
    margins = _margins(jprobs, gate_i.numpy(), jgate_i, cfg.moe_top_k)
    msg = (f"routing equal: {same_routing}; tokens whose picks differ and "
           f"their top-k margin: {margins}")
    if dtype == "float32":
        assert same_routing, msg
        np.testing.assert_array_equal(flat_e.numpy(), jflat_e)
        np.testing.assert_array_equal(pos.numpy(), jpos)
        _close(probs, jprobs)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype], err_msg=msg)
    _close(aux, jaux, dtype)


def test_dispatch_keeps_the_first_assignments_of_each_expert():
    """The exclusive cumsum over the token-major, k-minor flattening: of
    the assignments to an expert in a group, the first ``cap`` are kept,
    each in its own slot, and the buffer holds their tokens."""
    cfg = configs.get_reduced_config(PHI)
    rng = np.random.default_rng(0)
    G, Tg, K, E, cap = 2, 9, cfg.moe_top_k, cfg.num_experts, 3
    x = torch.from_numpy(rng.normal(size=(G, Tg, 8)).astype(np.float32))
    ig = torch.from_numpy(np.stack([np.stack(
        [rng.choice(E, K, replace=False) for _ in range(Tg)])
        for _ in range(G)]))
    buf, flat_e, pos, keep = moe._dispatch_group(x, ig, E, cap)
    assert buf.shape == (G, E, cap, 8)
    for g in range(G):
        seen = np.zeros(E, int)
        want = torch.zeros((E, cap, 8))
        for n, e in enumerate(ig[g].reshape(-1).tolist()):
            assert bool(keep[g, n]) == (seen[e] < cap)
            assert int(pos[g, n]) == min(seen[e], cap - 1)
            if seen[e] < cap:
                want[e, seen[e]] = x[g, n // K]
            seen[e] += 1
        assert torch.equal(buf[g], want)


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_bf16_router_logits_are_not_rounded(arch):
    """In bf16 the router's logits are the fp32 sum of the bf16 operands'
    products, never rounded to bf16: XLA folds the reference's
    ``.astype(float32)`` into the dot.  The port's probabilities equal
    the compiled reference's within fp32 summation order (1e-6); logits
    rounded to bf16 first would sit ~1e-3 away, enough to move a
    near-tied pick."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    p = _moe_params(arch)
    B, S = TOKENS[64]
    x = np.random.default_rng(7).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, "bfloat16")
    tp = _as(p, lambda a: torch.from_numpy(np.array(a)))
    _, G, cap, probs, *_ = _port_routing(tp, tx, cfg, 8.0)
    jprobs = np.asarray(_jrouting(_as(p, jnp.asarray),
                                  jx.reshape(B * S, -1), jcfg, G, cap)[0])
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=0, atol=1e-6)
    rounded = torch.softmax(
        (tx.reshape(B * S, -1) @ tp["router"].to(torch.bfloat16)).float(),
        dim=-1)
    assert np.abs(rounded.numpy() - jprobs).max() > 1e-4


def test_top_k_breaks_ties_by_the_lower_index():
    """Exact ties among the router's probabilities go to the lower expert
    index, as ``jax.lax.top_k`` breaks them (``[0.1, 0.3, 0.3, 0.3, 0.01]``
    picks experts 1 and 2)."""
    cfg = configs.get_reduced_config(PHI)
    rows = np.array([[0.1, 0.3, 0.3, 0.3, 0.01],
                     [0.2, 0.2, 0.2, 0.2, 0.2],
                     [0.05, 0.4, 0.1, 0.4, 0.05]], np.float32)
    logits = np.log(rows)
    _, w, i = moe.route({"router": torch.eye(5)}, torch.from_numpy(logits),
                        cfg)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jw, ji = jax.lax.top_k(probs, cfg.moe_top_k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), [[1, 2], [0, 1], [1, 3]])
    _close(w, jw / jnp.sum(jw, axis=-1, keepdims=True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_router_ties_route_as_the_reference(dtype):
    """A router with two equal columns: the logits of experts 1 and 2 tie
    exactly in both packages, and the picks, the kept mask (21 tokens,
    capacity 10, so the drop order matters), the output and the aux loss
    are the reference's."""
    jcfg, cfg = _cfgs(PHI, dtype)
    p = dict(_moe_params(PHI))
    router = p["router"].copy()
    router[:, 2] = router[:, 1]
    p["router"] = router
    B, S = TOKENS[21]
    x = np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tp = _as(p, lambda a: torch.from_numpy(np.array(a)))
    xt, G, cap, probs, gate_i, _, _, keep = _port_routing(tp, tx, cfg, 1.0)
    jprobs, jgate_i, _, _, jkeep = (
        np.asarray(a) for a in _jrouting(_as(p, jnp.asarray),
                                         jx.reshape(B * S, -1), jcfg, G,
                                         cap))
    assert torch.equal(probs[:, 1], probs[:, 2])
    np.testing.assert_array_equal(jprobs[:, 1], jprobs[:, 2])
    picked_tie = (gate_i == 1).any(-1) & (gate_i == 2).any(-1)
    assert bool(picked_tie.any())
    np.testing.assert_array_equal(gate_i.numpy(), jgate_i)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert int((~keep).sum()) > 0
    y, aux = moe.moe_apply(tp, tx, cfg, 1.0)
    jy, jaux = _jmoe_apply(_as(p, jnp.asarray), jx, jcfg, 1.0)
    _close(y, jy, dtype)
    _close(aux, jaux, dtype)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_stack(variant, seed=0):
    jcfg, _ = _cfgs(PHI, "float32", **VARIANTS[variant])
    params = jmodel.init_params(jcfg, jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def _stack(variant, dtype, seed=0):
    jcfg, cfg = _cfgs(PHI, dtype, **VARIANTS[variant])
    params, tree = _reference_stack(variant, seed)
    return jcfg, cfg, params, lm_params_to_torch(tree, cfg, device="cpu")


def _close_dense(cache, jcache, dtype):
    assert len(cache.get("dense", ())) == len(jcache.get("dense", ()))
    for c, jc in zip(cache.get("dense", ()), jcache.get("dense", ())):
        _close_cache({"layers": {k: v[None] for k, v in c.items()}},
                     {"layers": {k: v[None] for k, v in jc.items()}}, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_leading_layer_prefill_and_decode_match_the_reference(dtype):
    """Prefill's logits and caches (the dense layers' list too), then two
    decode steps."""
    jcfg, cfg, params, net = _stack(DENSE1, dtype)
    assert len(net.dense_layers) == 1 and "mlp" in net.dense_layers[0]
    assert len(net.layers) == 1 and "moe" in net.layers[0]
    jb, tb = _batch(cfg, 2, 14)
    got, cache = transformer.prefill(net, tb, cfg, min_cache_len=40)
    want, jcache = _jprefill(params, jb, jcfg, min_cache_len=40)
    _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)
    _close_dense(cache, jcache, dtype)
    rng = np.random.default_rng(9)
    for t in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        got, cache = transformer.decode(net, {"tokens": torch.from_numpy(tok)},
                                        cache, 14 + t, cfg)
        want, jcache = _jdecode(params, {"tokens": jnp.asarray(tok)},
                                jcache, jnp.int32(14 + t), jcfg)
        _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)
    _close_dense(cache, jcache, dtype)


def test_dense_leading_layer_generate_fp32_tokens_equal_the_reference():
    jcfg, cfg, params, net = _stack(DENSE1, "float32")
    jb, tb = _batch(cfg, 2, 12)
    want = jserve.generate(jcfg, params, jb["tokens"], 8)
    got = serve.generate(cfg, net, tb["tokens"], 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_leading_layer_generate_bf16_logits_match_the_reference():
    """Prefill, the caches re-seated for generation (the dense layers'
    too), then 7 decode steps fed the reference's greedy tokens."""
    jcfg, cfg, params, net = _stack(DENSE1, "bfloat16")
    B, S, n = 2, 12, 8
    jb, tb = _batch(cfg, B, S)
    jl, jcache = jax.jit(jsteps.make_prefill_step(jcfg))(params, jb)
    jcache = jserve._grow_cache(jcfg, jcache, B, S + n, False)
    tl, cache = steps.make_prefill_step(cfg)(net, tb)
    cache = serve._grow_cache(cfg, cache, B, S + n, False)
    assert cache["layers"]["k"].shape[2] == S + n
    assert cache["dense"][0]["k"].shape[1] == S + n
    _close_logits(tl, jl, "bfloat16")
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    dec = steps.make_decode_step(cfg)
    idx = S
    for _ in range(n - 1):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jcache, _ = jdec(params, jnp.asarray(tok), jcache,
                             jnp.int32(idx))
        tl, cache, idx = dec(net, torch.from_numpy(tok), cache, idx)
        _close_logits(tl, jl, "bfloat16")
    _close_cache(cache, jcache, "bfloat16")
    _close_dense(cache, jcache, "bfloat16")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dropless_decode_equals_prefill(variant):
    """Port only: at a dropless capacity (the reduced config's 8.0 >= E/K)
    in fp32, decode after S tokens equals a prefill over S + 1, to 1e-4."""
    _, cfg, _, net = _stack(variant, "float32")
    assert cfg.moe_capacity_factor >= cfg.num_experts / cfg.moe_top_k
    _, tb = _batch(cfg, 2, 17, seed=4)
    toks = tb["tokens"]
    _, cache = transformer.prefill(net, {"tokens": toks[:, :13]}, cfg,
                                   min_cache_len=17)
    for t in range(13, 17):
        dl, cache = transformer.decode(net, {"tokens": toks[:, t:t + 1]},
                                       cache, t, cfg)
        full, _ = transformer.prefill(net, {"tokens": toks[:, :t + 1]}, cfg)
        assert float((dl - full).abs().max()) <= 1e-4
