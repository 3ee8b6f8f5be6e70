"""The port's Mamba2 block (``repro_torch.models.ssm``, the stack's mamba
branch) against the reference's (``repro.models.ssm``,
``repro.models.transformer``) on the CPU, on reduced mamba2 (2 layers,
d_model 256, d_inner 512, 16 SSM heads of 32, d_state 32, 1 group, conv
width 4, chunk 32).

The same seeded numpy inputs and the same weights (numpy for the block,
``repro_torch.convert.lm_params_to_torch`` for the stack) go through
both packages.  Tolerances are tests/test_torch_models.py's: 1e-4 in
fp32, 3e-2 in bf16.  The chunked prefill and the recurrent decode are
equal in exact arithmetic only (the reference's own decode is 1e-2 off
its prefill in bf16): in bf16 each form is held to the reference's same
form, and decode is held to prefill only in fp32, port only.  The op
orders of ``_silu``, ``_causal_conv``, ``_conv_step`` and
``_gated_norm``, which the block calls, are held to what XLA compiles
the reference's lines to, against an order they rule out.  The stack's
parity (prefill, decode, bf16 accuracy, ``generate``) is a case of
tests/test_torch_models.py's and tests/test_torch_launch_serve.py's
stack tests (mamba2 is in ``SERVED``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import layers, model, ssm, transformer
from test_torch_models import (DTYPES, TDT, _batch, _close, _models,
                               _normal, _pair)

ARCH = "mamba2-130m"

_japply = jax.jit(jssm.mamba_apply, static_argnames=("cfg", "return_cache"))
_jdecode = jax.jit(jssm.mamba_decode, static_argnames=("cfg",))
_jssd = jax.jit(jssm.ssd_chunked, static_argnames=("chunk",))
_jconv = jax.jit(jssm._causal_conv)


def _cfgs(dtype="float32"):
    return (jconfigs.get_reduced_config(ARCH).replace(compute_dtype=dtype),
            configs.get_reduced_config(ARCH).replace(compute_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _block_params(seed=0):
    """The reference's init of one mamba block as numpy; ``conv_b``,
    ``norm`` and ``D`` (zeros, zeros, ones at init) given a spread so
    that they enter the comparison."""
    jcfg, _ = _cfgs()
    p = jax.tree.map(np.asarray, jssm.mamba_init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return dict(p, conv_b=_normal(rng, *p["conv_b"].shape, scale=0.1),
                norm=_normal(rng, *p["norm"].shape, scale=0.1),
                D=1.0 + _normal(rng, *p["D"].shape, scale=0.1))


def _params_pair(seed=0):
    p = _block_params(seed)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _x(S, d, seed, B=2):
    return _normal(np.random.default_rng(seed), B, S, d)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's values as fp32 numpy (exact)."""
    return t.float().numpy()


def _jbf16_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False])
def test_mamba_shapes_match_the_reference(reduced):
    """``mamba_shapes`` is the reference's ``mamba_init`` tree (at full
    size by ``jax.eval_shape``), its deterministic leaves are the fan-0
    ones, and it holds the config's count plus ``conv_b`` and the H that
    the count books as d_inner wide (``D``)."""
    get, jget = ((configs.get_reduced_config, jconfigs.get_reduced_config)
                 if reduced else (configs.get_config, jconfigs.get_config))
    cfg, jcfg = get(ARCH), jget(ARCH)
    ref = jax.eval_shape(lambda k: jssm.mamba_init(k, jcfg),
                         jax.random.key(0))
    shapes = ssm.mamba_shapes(cfg)
    assert {k: s for k, (s, _) in shapes.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert {k for k, (_, fan) in shapes.items() if not fan} == \
        {"conv_b", "A_log", "D", "dt_bias", "norm"}
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    n = sum(math.prod(s) for s, _ in shapes.values())
    assert n == cfg._mamba_params() + conv_ch + cfg.ssm_nheads


def test_init_draws_the_reference_scheme():
    """Every mamba leaf of a seeded ``init_params`` has the reference's
    shape and scheme, reproducibly: 1/sqrt(fan) for ``in_proj`` (d),
    ``conv_w`` (w) and ``out_proj`` (d_inner); ``conv_b`` and ``norm``
    zeros, ``D`` ones; ``A_log`` within one fp32 ulp (2.4e-7) of the
    reference's ``log(linspace(1, 16, H))``; ``dt_bias`` the inverse
    softplus of a draw in [1e-3, 1e-1]."""
    jcfg, cfg = _cfgs()
    ref = jax.tree.map(np.asarray, jssm.mamba_init(jax.random.key(0), jcfg))
    a = model.init_params(cfg, 3, device="cpu")
    b = model.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    assert len(a.layers) == cfg.num_layers == 2
    for la, lb in zip(a.layers, b.layers):
        assert {n for n, _ in la.named_children()} == {"mamba"}
        assert {n for n, _ in la.named_parameters(recurse=False)} == {"ln1"}
        assert not la.ln1.any()
        for name, (shape, fan) in ssm.mamba_shapes(cfg).items():
            t = la.mamba[name].detach()
            assert tuple(t.shape) == shape == ref[name].shape
            assert torch.equal(t, lb.mamba[name])
            if fan:
                assert abs(float(t.std()) * fan ** 0.5 - 1) < 0.1
                assert abs(float(ref[name].std()) * fan ** 0.5 - 1) < 0.1
        m = {k: v.detach() for k, v in la.mamba.named_parameters()}
        assert not m["conv_b"].any() and not m["norm"].any()
        assert (m["D"] == 1).all()
        np.testing.assert_allclose(m["A_log"].numpy(), ref["A_log"],
                                   rtol=0, atol=2.4e-7)
        dt = F.softplus(m["dt_bias"].double())
        assert ((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5))).all()
    assert not torch.equal(a.layers[0].mamba["dt_bias"],
                           a.layers[1].mamba["dt_bias"])


def test_cache_spec_and_init_match_the_reference():
    """The block's cache (``h`` fp32, ``conv`` in the compute dtype) as
    the reference's, and the stacked one at full size: ``h`` (24, 4, 24,
    64, 128) fp32 and ``conv`` (24, 4, 3, 1792) bf16 at every length."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    spec = ssm.mamba_cache_spec(cfg, 2, torch.bfloat16)
    jspec = jssm.mamba_cache_spec(jcfg, 2, jnp.bfloat16)
    assert set(spec) == set(jspec) == {"h", "conv"}
    for name, s in spec.items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == jspec[name].shape
        assert str(s.dtype).split(".")[-1] == str(jspec[name].dtype)
    init = ssm.mamba_cache_init(cfg, 2, torch.float32, device="cpu")
    jinit = jssm.mamba_cache_init(jcfg, 2, jnp.float32)
    for name, t in init.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jinit[name]))
    for S in (1, 512, 32768):
        stacked = transformer.cache_spec(cfg, 4, S, torch.bfloat16, False)
        assert set(stacked) == {"layers"}
        assert tuple(stacked["layers"]["h"].shape) == (24, 4, 24, 64, 128)
        assert stacked["layers"]["h"].dtype == torch.float32
        assert tuple(stacked["layers"]["conv"].shape) == (24, 4, 3, 1792)
        assert stacked["layers"]["conv"].dtype == torch.bfloat16
        assert transformer.required_cache_len(cfg, S, False) == 0


# ---------------------------------------------------------------------------
# the op orders (module doc)
# ---------------------------------------------------------------------------
def test_silu_takes_xla_s_op_order():
    """``jax.nn.silu`` on bf16, compiled by XLA, is x * (1 / (1 +
    exp(-x))) with each op rounded to bf16: ``_silu`` gives its bits,
    where ``F.silu`` (one rounding) differs in many elements."""
    x = _normal(np.random.default_rng(0), 4096, scale=3.0)
    jx, tx = _pair(x, "bfloat16")
    want = _jbf16_np(jax.jit(jax.nn.silu)(jx))
    got = _bf16_np(ssm._silu(tx))
    assert np.mean(got != want) < 1e-3
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    assert np.mean(_bf16_np(F.silu(tx)) != want) > 0.05
    # in fp32 the same formula, within fp32 rounding of F.silu
    jx, tx = _pair(x, "float32")
    np.testing.assert_allclose(ssm._silu(tx).numpy(),
                               np.asarray(jax.jit(jax.nn.silu)(jx)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ssm._silu(tx).numpy(), F.silu(tx).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("S", [1, 2, 5, 40])
def test_causal_conv_takes_xla_s_op_order(S):
    """Prefill's conv in bf16: each of the four products and each add
    rounded (XLA's order), bitwise the reference's; the products summed
    in fp32 and rounded once (decode's order) differs.  fp32 within
    1e-4."""
    _, cfg = _cfgs()
    p = _block_params()
    C = p["conv_w"].shape[1]
    xbc = _x(S, C, S, B=2)
    for dtype in DTYPES:
        jx, tx = _pair(xbc, dtype)
        want = _jconv(jx, jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]))
        got = ssm._causal_conv(tx, torch.from_numpy(np.array(p["conv_w"])),
                               torch.from_numpy(np.array(p["conv_b"])))
        assert got.dtype == TDT[dtype] and got.shape == (2, S, C)
        if dtype == "float32":
            _close(got, want)
            continue
        np.testing.assert_array_equal(_bf16_np(got), _jbf16_np(want))
    if S >= 5:
        pad = F.pad(tx, (0, 0, 3, 0))
        windows = torch.stack([pad[:, i:i + 4] for i in range(S)], dim=1)
        once = ssm._silu(ssm._conv_step(
            windows.reshape(2 * S, 4, C), torch.from_numpy(np.array(p["conv_w"])),
            torch.from_numpy(np.array(p["conv_b"])))).reshape(2, S, C)
        assert (_bf16_np(once) != _jbf16_np(want)).mean() > 0.01


def test_conv_step_takes_xla_s_op_order():
    """Decode's conv in bf16 (the reference's ``einsum`` over the window,
    then the bias): the four products summed in fp32 and rounded once,
    then the bias added in bf16, bitwise the reference's; prefill's
    order (each product and add rounded) differs."""
    p = _block_params()
    C = p["conv_w"].shape[1]
    win = _normal(np.random.default_rng(3), 64, 4, C)

    @jax.jit
    def ref(conv_in, w, b):
        return (jnp.einsum("bwc,wc->bc", conv_in, w.astype(conv_in.dtype))
                + b.astype(conv_in.dtype))

    jw, tw = _pair(win, "bfloat16")
    want = _jbf16_np(ref(jw, jnp.asarray(p["conv_w"]),
                         jnp.asarray(p["conv_b"])))
    got = ssm._conv_step(tw, torch.from_numpy(np.array(p["conv_w"])),
                         torch.from_numpy(np.array(p["conv_b"])))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_np(got), want)
    wb = torch.from_numpy(np.array(p["conv_w"])).bfloat16()
    each = tw[:, 0] * wb[0]
    for i in range(1, 4):
        each = each + tw[:, i] * wb[i]
    each = each + torch.from_numpy(np.array(p["conv_b"])).bfloat16()
    assert (_bf16_np(each) != want).mean() > 0.01


def test_gated_norm_takes_xla_s_op_order():
    """``rms_norm(y * silu(z), norm)`` in bf16: XLA takes the gate
    product in fp32 and never rounds it before the fp32 norm.
    ``_gated_norm`` gives the reference's bits (to one bf16 ulp in a few
    elements, from the mean's summation order); rounding the product to
    bf16 first differs in many elements."""
    rng = np.random.default_rng(4)
    y, z = _normal(rng, 8, 512, scale=2.0), _normal(rng, 8, 512, scale=2.0)
    scale = _normal(rng, 512, scale=0.1)
    (jy, ty), (jz, tz) = _pair(y, "bfloat16"), _pair(z, "bfloat16")

    @jax.jit
    def ref(y, z, s):
        return jlayers.rms_norm(y * jax.nn.silu(z), s, 1e-5)

    want = _jbf16_np(ref(jy, jz, jnp.asarray(scale)))
    got = ssm._gated_norm(ty, tz, torch.from_numpy(scale), 1e-5)
    assert got.dtype == torch.bfloat16
    assert np.mean(_bf16_np(got) != want) < 0.01
    np.testing.assert_allclose(_bf16_np(got), want, rtol=2 ** -7, atol=0)
    rounded = layers.rms_norm(ty * ssm._silu(tz), torch.from_numpy(scale),
                              1e-5)
    assert np.mean(_bf16_np(rounded) != want) > 0.05


def test_segsum_is_the_reference_s():
    x = _normal(np.random.default_rng(5), 2, 3, 33, scale=0.3)
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jssm._segsum)(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4,
                               atol=1e-5)
    assert (got[~finite] < 0).all()


def test_softplus_is_the_reference_s():
    x = np.concatenate([_normal(np.random.default_rng(6), 256, scale=8.0),
                        np.array([-100, -30, -1e-3, 0, 1e-3, 19, 21, 40,
                                  100], np.float32)])
    np.testing.assert_allclose(
        ssm._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x))),
        rtol=2e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
def _ssd_inputs(dtype, S=96, seed=7):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, 1
    x = _normal(rng, 2, S, H, P)
    dt = np.log1p(np.exp(_normal(rng, 2, S, H) - 3.0)).astype(np.float32)
    A = -np.exp(_block_params()["A_log"])
    Bm, Cm = _normal(rng, 2, S, G, N), _normal(rng, 2, S, G, N)
    h0 = _normal(rng, 2, H, P, N, scale=0.5)
    jx, tx = _pair(x, dtype)
    jB, tB = _pair(Bm, dtype)
    jC, tC = _pair(Cm, dtype)
    j = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(h0))
    t = (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
         torch.from_numpy(h0))
    return j, t, cfg.ssm_chunk


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_the_reference(dtype, with_h0):
    """Three chunks of 32 (the quadratic blocks, the chunk states, the
    recurrence across chunks), from zero and from a given state: y and
    the final state."""
    j, t, chunk = _ssd_inputs(dtype)
    jh0 = j[5] if with_h0 else None
    th0 = t[5] if with_h0 else None
    want_y, want_h = _jssd(*j[:5], chunk=chunk, h0=jh0)
    got_y, got_h = ssm.ssd_chunked(*t[:5], chunk, h0=th0)
    assert got_y.dtype == TDT[dtype] and got_h.dtype == torch.float32
    assert got_h.shape == (2, 16, 32, 32)
    _close(got_y, want_y, dtype)
    _close(got_h, want_h, dtype)


def test_ssd_chunked_refuses_a_partial_chunk():
    _, t, chunk = _ssd_inputs("float32", S=40)
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        ssm.ssd_chunked(*t[:5], chunk)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [2, 32, 40, 96])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_apply_matches_the_reference(dtype, S):
    """The block's output and cache (``h``, the state after S tokens;
    ``conv``, the last three raw inputs, left-padded with zeros at S = 2)
    at one chunk of 2, one whole chunk, a padded tail (40 = 32 + 8) and
    three chunks."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params_pair()
    jx, tx = _pair(_x(S, cfg.d_model, S), dtype)
    got = ssm.mamba_apply(tp, tx, cfg)
    got_c, cache = ssm.mamba_apply(tp, tx, cfg, return_cache=True)
    want, jcache = _japply(jp, jx, cfg=jcfg, return_cache=True)
    assert got.shape == (2, S, cfg.d_model) and got.dtype == TDT[dtype]
    assert torch.equal(got, got_c)
    _close(got, want, dtype)
    assert set(cache) == set(jcache) == {"h", "conv"}
    for name, t in cache.items():
        assert t.shape == jcache[name].shape
        assert str(t.dtype).split(".")[-1] == str(jcache[name].dtype)
        _close(t, jcache[name], dtype)
    if S < cfg.ssm_conv - 1:
        assert not cache["conv"][:, :cfg.ssm_conv - 1 - S].any()


@pytest.mark.parametrize("S", [2, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_the_reference(dtype, S):
    """Four recurrent steps after a prefill of S tokens: each output,
    then the cache the steps wrote in place."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params_pair()
    n = 4
    jx, tx = _pair(_x(S + n, cfg.d_model, S + 1), dtype)
    _, cache = ssm.mamba_apply(tp, tx[:, :S], cfg, return_cache=True)
    _, jcache = _japply(jp, jx[:, :S], cfg=jcfg, return_cache=True)
    h, conv = cache["h"], cache["conv"]
    for t in range(S, S + n):
        got, cache = ssm.mamba_decode(tp, tx[:, t:t + 1], cache, cfg)
        want, jcache = _jdecode(jp, jx[:, t:t + 1], jcache, cfg=jcfg)
        assert got.shape == (2, 1, cfg.d_model) and got.dtype == TDT[dtype]
        _close(got, want, dtype)
    assert cache["h"] is h and cache["conv"] is conv      # in place
    for name in ("h", "conv"):
        _close(cache[name], jcache[name], dtype)


def _recurrence(tp, tx, cfg):
    """The state after every token by the plain per-token recurrence
    h <- h * exp(dt A) + dt x B^T, from the port's own projection and
    conv (fp32)."""
    B, S, _ = tx.shape
    H, P = cfg.ssm_nheads, cfg.ssm_head_dim
    proj = tx @ tp["in_proj"]
    _, xbc, dt_raw = ssm._split_proj(cfg, proj)
    x, Bm, _ = ssm._split_xbc(cfg, ssm._causal_conv(xbc, tp["conv_w"],
                                                    tp["conv_b"]))
    dt = ssm._softplus(dt_raw + tp["dt_bias"])
    A = -torch.exp(tp["A_log"])
    h = torch.zeros((B, H, P, cfg.ssm_state))
    for t in range(S):
        xt = x[:, t].reshape(B, H, P)
        Bt = Bm[:, t].repeat_interleave(H // cfg.ssm_ngroups, dim=1)
        h = (h * torch.exp(dt[:, t] * A)[..., None, None]
             + dt[:, t, :, None, None] * xt[..., None] * Bt[:, :, None, :])
    return h


def test_padded_tail_leaves_the_state_after_s_tokens():
    """Port only, fp32: at S = 40 (a chunk of 32 and 8 tokens padded to
    a second chunk) ``mamba_apply``'s state is the plain recurrence's
    after the 40 tokens, within 1e-5: the padding comes after the
    softplus, so its 24 steps carry dt = 0.  Padding the raw dt before
    the softplus would decay the state by exp(24 dt A)."""
    _, cfg = _cfgs()
    _, tp = _params_pair()
    tx = torch.from_numpy(_x(40, cfg.d_model, 11))
    _, cache = ssm.mamba_apply(tp, tx, cfg, return_cache=True)
    want = _recurrence(tp, tx, cfg)
    assert float((cache["h"] - want).abs().max()) <= 1e-5
    assert float(want.abs().max()) > 1e-2
    # the trap: the raw dt padded, then the softplus over the padding
    dt_pad = ssm._softplus(tp["dt_bias"])                      # (H,)
    decayed = want * torch.exp(24 * dt_pad * -torch.exp(
        tp["A_log"]))[None, :, None, None]
    assert float((decayed - want).abs().max()) > 1e-3


@settings(max_examples=12, deadline=None, database=None)
@given(S=st.integers(1, 70), seed=st.integers(0, 2 ** 16))
def test_decode_equals_prefill(S, seed):
    """Port only, fp32: one recurrent step after a prefill of S tokens
    equals the last row of the block over S + 1 tokens, within 1e-4
    (whole chunks, padded tails and S < w - 1 alike)."""
    _, cfg = _cfgs()
    _, tp = _params_pair(1)
    tx = torch.from_numpy(_x(S + 1, cfg.d_model, seed, B=1))
    _, cache = ssm.mamba_apply(tp, tx[:, :S], cfg, return_cache=True)
    got, _ = ssm.mamba_decode(tp, tx[:, S:], cache, cfg)
    full = ssm.mamba_apply(tp, tx, cfg)
    assert float((got - full[:, -1:]).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
def test_stack_decode_equals_prefill():
    """Port only, fp32: the two-layer stack's decode after 14 tokens, four
    steps, each equal to a prefill over the tokens so far within 1e-4; the
    cache the same tensors throughout (written in place)."""
    _, cfg, _, net = _models(ARCH, "float32")
    _, tb = _batch(cfg, 2, 18, seed=4)
    toks = tb["tokens"]
    _, cache = transformer.prefill(net, {"tokens": toks[:, :14]}, cfg)
    h = cache["layers"]["h"]
    for t in range(14, 18):
        dl, cache = transformer.decode(net, {"tokens": toks[:, t:t + 1]},
                                       cache, t, cfg)
        full, _ = transformer.prefill(net, {"tokens": toks[:, :t + 1]}, cfg)
        assert float((dl - full).abs().max()) <= 1e-4
    assert cache["layers"]["h"] is h


def test_grow_cache_takes_the_device_from_any_leaf():
    """A mamba cache has no ``pos``: ``_grow_cache`` keeps it as it is
    for any generation length (its size does not grow), and re-seating it
    (here into a larger batch) reads the device from a leaf, copying the
    rows it has and leaving the rest zeros."""
    _, cfg, _, net = _models(ARCH, "float32")
    _, tb = _batch(cfg, 2, 10)
    _, cache = transformer.prefill(net, tb, cfg)
    assert "pos" not in cache["layers"]
    assert serve._grow_cache(cfg, cache, 2, 64, False) is cache
    grown = serve._grow_cache(cfg, cache, 3, 64, False)
    for name, t in grown["layers"].items():
        assert t.device == cache["layers"][name].device
        assert t.shape[1] == 3
        assert torch.equal(t[:, :2], cache["layers"][name])
        assert not t[:, 2:].any()
