"""The port's decoder family (``repro_torch.configs``,
``repro_torch.models``) against the reference's (``repro.configs``,
``repro.models``) on the CPU: dense, MoE, MLA, mamba2's stack,
zamba2's hybrid one and whisper's encoder-decoder.

The same seeded numpy inputs and the same weights (carried across with
``repro_torch.convert.lm_params_to_torch``) go through both packages.
Tolerances: fp32 compute within atol = rtol = 1e-4; bf16 compute within
atol = rtol = 3e-2 (one bf16 ulp of a logit near 4 is 0.031, so a last-bit
difference in one product stays inside rtol).  A whole stack's bf16 logits
carry bf16's noise at the logits' own scale: each package's bf16 logits
sit up to ~0.075 sigma from its fp32 logits (sigma, their spread: 0.011-
0.016 at sigma 0.2 for the tied-embedding configs, 0.042-0.055 at sigma
0.6 for the untied heads of qwen2.5-32b and internvl2-2b).  So a stack's
bf16 logits are held within atol = max(3e-2, 0.15 sigma), rtol = 3e-2
(3e-2 itself for the tied configs), and the port's bf16 must be about as
accurate as the reference's own (within 1.5x its distance from the fp32
logits).  Caches are compared after sorting each layer's slots by
position: the port seats each key at slot ``pos mod cache_len`` (the
reference's layout, rolled); a mamba layer's state ``h`` and conv
window ``conv`` are compared as they are, beside the KV slot in a hybrid
stack, and so are whisper's cross ``xk``/``xv``.  A bf16 cache entry
carries the noise of every layer below it: the caches of a layer with two or more below it
(the 3-layer deepseek-v2 case's third layer; whisper's cross ``xk``/``xv``
and its layers past the first, which have the whole encoder, two layers
in the reduced config, below them) are held within atol = 6e-2, rtol =
3e-2.  On ``test_generate_bf16_logits_match_the_reference``'s
inputs that layer's ``ckv``/``kr`` differ between the packages by up to
0.035 / 0.031, where each package is 0.055-0.058 / 0.036-0.047 from its
fp32 run (the layers below: 0.031 / 0.023 between the packages, 0.036-
0.043 from fp32), so one element in 2432 misses a flat 3e-2.  There
whisper's second layer's ``v`` differs between the packages by up to
0.036, where the port is 0.037 and the reference 0.034 from its fp32
run, so one element in 10240 misses a flat 3e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtrans
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import lm_params_to_numpy, lm_params_to_torch
from repro_torch.models import attention, layers, model, ssm, transformer

# the reference's functions compiled once per shape (their op-by-op
# dispatch would compile every primitive at every test's shapes)
_jprefill = jax.jit(jtrans.prefill,
                    static_argnames=("cfg", "long_mode", "min_cache_len"))
_jdecode = jax.jit(jtrans.decode, static_argnames=("cfg", "long_mode"))
_jgqa_prefill = jax.jit(jattn.gqa_prefill,
                        static_argnames=("cfg", "cache_len", "use_rope"))
_jgqa_decode = jax.jit(jattn.gqa_decode, static_argnames=("cfg", "use_rope"))
_jflash = jax.jit(jattn._flash_sdpa, static_argnames=(
    "cap", "scale", "causal", "q_chunk", "kv_chunk"))

DENSE = ("qwen2-0.5b", "qwen2.5-32b", "gemma2-2b", "gemma3-12b",
         "internvl2-2b")
# the mixture-of-experts archs the stack runs (deepseek-v2 with its latent
# attention and a dense leading layer)
MOE = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")
# the attention-free state-space stack
SSM = ("mamba2-130m",)
# the mamba stack with the weight-tied shared attention block
HYBRID = ("zamba2-1.2b",)
# the encoder-decoder over stub frames, with cross attention
ENCDEC = ("whisper-small",)
ATTENTION = DENSE + MOE + ENCDEC
SERVED = ATTENTION + SSM + HYBRID
# a served arch at another depth: deepseek-v2 with 3 layers, so that the
# stacked latent cache holds two layers (name -> (arch, config changes))
DSV2_3L = "deepseek-v2-236b:3-layers"
VARIANTS = {DSV2_3L: ("deepseek-v2-236b", {"num_layers": 3})}
# the cases of the stack's parity tests
STACKS = SERVED + tuple(VARIANTS)
# phi3.5 with a dense leading layer, so that an MoE stack's tree without
# MLA holds ``dense_layers`` (a case of the converter's round trip only)
PHI_DENSE1 = "phi3.5-moe-42b-a6.6b:1-dense"
# a shared_attn_period without mamba+shared_attn kinds, which adds no
# shared block (test_a_shared_attention_period_alone_still_raises)
PERIOD_ONLY = {f"{arch}:period-2": (arch, {"shared_attn_period": 2})
               for arch in ("qwen2-0.5b", "mamba2-130m")}
_NAMED = dict(VARIANTS, **PERIOD_ONLY, **{
    PHI_DENSE1: ("phi3.5-moe-42b-a6.6b", {"first_k_dense": 1})})
DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a bf16 cache entry with two or more layers below it (module doc)
DEEP_CACHE_TOL = dict(atol=6e-2, rtol=3e-2)
# the layers below each cross entry of the reduced whisper, and below
# every entry of its layers past the first: its whole encoder
ENCODER_BELOW = jconfigs.get_reduced_config("whisper-small").num_encoder_layers


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _close_logits(got, want, dtype):
    """A whole stack's logits: bf16's atol grows with their spread (see
    the module doc)."""
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] = max(tol["atol"], 0.15 * float(np.std(_np(want))))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _pair(x, dtype):
    """The same numpy array as a reference array and a port tensor, each
    cast to ``dtype``."""
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


@functools.lru_cache(maxsize=None)
def _reference_params(name, seed):
    """The reference's init (the compute dtype does not enter it)."""
    arch, over = _NAMED.get(name, (name, {}))
    params = jmodel.init_params(
        jconfigs.get_reduced_config(arch).replace(**over),
        jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def _models(name, dtype, seed=0):
    """Both packages' reduced configs at ``dtype`` and the same weights:
    the reference's tree and a fresh port model holding it.  ``name`` is
    an arch or a key of ``VARIANTS`` or ``_NAMED``."""
    arch, over = _NAMED.get(name, (name, {}))
    over = dict(over, compute_dtype=dtype)
    jcfg = jconfigs.get_reduced_config(arch).replace(**over)
    cfg = configs.get_reduced_config(arch).replace(**over)
    params, tree = _reference_params(name, seed)
    return jcfg, cfg, params, lm_params_to_torch(tree, cfg, device="cpu")


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        vis = _normal(rng, B, cfg.num_prefix_tokens, cfg.d_model)
        jb["vision_embeds"], tb["vision_embeds"] = _pair(vis, cfg.compute_dtype)
    if cfg.frontend == "audio":
        frames = _normal(rng, B, cfg.encoder_seq, cfg.d_model)
        jb["frames"], tb["frames"] = _pair(frames, cfg.compute_dtype)
    return jb, tb


# the cache entries laid out over slots, one position each (``pos``)
SLOTTED = ("k", "v", "ckv", "kr")


def _close_cache(got, want, dtype):
    """Each layer's cache (each dense leading layer's, then the stacked
    layers'): the slotted entries (k/v, or MLA's ckv/kr) with their
    slots sorted by position, equal positions and values within
    tolerance; every other entry (mamba's ``h`` and ``conv``, also beside
    a hybrid layer's KV slot, and whisper's ``xk``/``xv``) as it is
    (module doc)."""
    dense = got.get("dense", ())
    assert len(dense) == len(want.get("dense", ()))
    pairs = [({k: v[None] for k, v in g.items()},
              {k: v[None] for k, v in w.items()})
             for g, w in zip(dense, want.get("dense", ()))]
    pairs.append((got["layers"], want["layers"]))
    depth = 0
    for gl, wl in pairs:
        assert set(gl) == set(wl)
        assert ("pos" in gl) == any(name in gl for name in SLOTTED)
        encoder = ENCODER_BELOW if "xk" in gl else 0
        for i in range(next(iter(gl.values())).shape[0]):
            below = depth + (encoder if depth else 0)
            tol, cross_tol = (
                DEEP_CACHE_TOL if dtype == "bfloat16" and n >= 2
                else TOL[dtype] for n in (below, encoder))
            depth += 1
            for name in sorted(set(gl) - {"pos", *SLOTTED}):
                assert gl[name][i].shape == wl[name][i].shape
                np.testing.assert_allclose(
                    _np(gl[name][i]), _np(wl[name][i]),
                    **(cross_tol if name in ("xk", "xv") else tol))
            if "pos" not in gl:
                continue
            gpos, wpos = gl["pos"][i].numpy(), np.asarray(wl["pos"][i])
            assert gpos.shape == wpos.shape
            go, wo = np.argsort(gpos), np.argsort(wpos)
            np.testing.assert_array_equal(gpos[go], wpos[wo])
            valid = wpos[wo] >= 0
            for name in sorted(set(gl) & set(SLOTTED)):
                np.testing.assert_allclose(
                    _np(gl[name][i])[:, go][:, valid],
                    _np(wl[name][i])[:, wo][:, valid], **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_the_reference(arch):
    assert configs.ARCHS == jconfigs.ARCHS
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_reduced_config,
                       jconfigs.get_reduced_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        for name, shape in base.SHAPES.items():
            assert base.shape_applicable(cfg, shape) == \
                jbase.shape_applicable(jcfg, jbase.SHAPES[name])


def test_config_constants_and_dtsvm_config():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert dataclasses.asdict(base.DTSVMConfig()) == \
        dataclasses.asdict(jbase.DTSVMConfig())
    assert (base.ATTN_GLOBAL, base.ATTN_LOCAL, base.MAMBA,
            base.MAMBA_SHARED_ATTN) == (jbase.ATTN_GLOBAL, jbase.ATTN_LOCAL,
                                        jbase.MAMBA, jbase.MAMBA_SHARED_ATTN)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(_normal(rng, 2, 5, 48, scale=3.0), dtype)
    scale = _normal(rng, 48, scale=0.1)
    got = layers.rms_norm(tx, torch.from_numpy(scale), 1e-6)
    assert got.dtype == TDT[dtype]
    _close(got, jlayers.rms_norm(jx, jnp.asarray(scale), 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(dtype, theta):
    rng = np.random.default_rng(1)
    jx, tx = _pair(_normal(rng, 2, 7, 3, 16), dtype)
    pos = np.array([0, 1, 2, 5, 64, 300, 4099], np.int32)
    got = layers.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(got, jlayers.apply_rope(jx, jnp.asarray(pos), theta), dtype)
    _close(layers.rope_freqs(16, theta), jlayers.rope_freqs(16, theta))


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    x = _normal(np.random.default_rng(2), 64, scale=60.0)
    _close(layers.softcap(torch.from_numpy(x), cap),
           jlayers.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("silu", False)])
def test_mlp_apply(dtype, act, gated):
    rng = np.random.default_rng(3)
    d, f = 32, 64
    p = {"up": _normal(rng, d, f, scale=d ** -0.5),
         "down": _normal(rng, f, d, scale=f ** -0.5)}
    if gated:
        p["gate"] = _normal(rng, d, f, scale=d ** -0.5)
    jx, tx = _pair(_normal(rng, 2, 5, d), dtype)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           tx, act, gated)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jx,
                             act, gated)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [False, True])
def test_embed_tokens_and_lm_head(dtype, scale):
    rng = np.random.default_rng(4)
    table = _normal(rng, 50, 48, scale=0.5)
    toks = rng.integers(0, 50, (2, 6)).astype(np.int32)
    got = layers.embed_tokens(torch.from_numpy(table), torch.from_numpy(toks),
                              scale, TDT[dtype])
    want = jlayers.embed_tokens(jnp.asarray(table), jnp.asarray(toks), scale,
                                JDT[dtype])
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)
    for cap in (0.0, 30.0):
        head = layers.lm_head(got, torch.from_numpy(table).T, cap)
        assert head.dtype == torch.float32
        _close(head, jlayers.lm_head(want, jnp.asarray(table).T, cap), dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(rng, B, Sq, Sk, H, K, D, dtype):
    q = _pair(_normal(rng, B, Sq, H, D), dtype)
    k = _pair(_normal(rng, B, Sk, K, D), dtype)
    v = _pair(_normal(rng, B, Sk, K, D), dtype)
    return q, k, v


SDPA_CASES = [  # (window, cap, causal, with k_valid)
    (0, 0.0, True, False), (5, 0.0, True, False), (0, 50.0, True, False),
    (7, 50.0, True, True), (0, 0.0, False, True), (3, 30.0, False, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,cap,causal,valid", SDPA_CASES)
def test_sdpa(dtype, window, cap, causal, valid):
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 6, 11, 4, 2, 8, dtype)
    q_pos = np.arange(5, 11, dtype=np.int32)
    k_pos = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, -1], np.int32)
    k_valid = k_pos >= 0 if valid else None
    kw = dict(cap=cap, scale=8 ** -0.5, causal=causal)
    got = attention._sdpa(
        tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        window=window, k_valid=None if k_valid is None
        else torch.from_numpy(k_valid), **kw)
    want = jattn._sdpa(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
                       window=jnp.int32(window), k_valid=None
                       if k_valid is None else jnp.asarray(k_valid), **kw)
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,cap,causal,valid", SDPA_CASES)
@pytest.mark.parametrize("q_chunk,kv_chunk", [(4, 8), (16, 16)])
def test_flash_sdpa(dtype, window, cap, causal, valid, q_chunk, kv_chunk):
    """``_flash_sdpa`` called directly with small blocks: the online
    softmax over several query and KV blocks, fully masked blocks among
    them (the isinf guards)."""
    rng = np.random.default_rng(6)
    S = 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, S, S, 4, 2, 8, dtype)
    pos = np.arange(S, dtype=np.int32)
    k_valid = (pos % 5 != 3) if valid else None
    kw = dict(cap=cap, scale=8 ** -0.5, causal=causal, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    got = attention._flash_sdpa(
        tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos),
        window=window, k_valid=None if k_valid is None
        else torch.from_numpy(k_valid), **kw)
    want = _jflash(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                             window=jnp.int32(window), k_valid=None
                             if k_valid is None else jnp.asarray(k_valid),
                             **kw)
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)
    # and the plain schedule agrees with the flash one inside the port
    plain = attention._sdpa(
        tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos),
        window=window, cap=cap, scale=8 ** -0.5, causal=causal,
        k_valid=None if k_valid is None else torch.from_numpy(k_valid))
    _close(got, plain, dtype)


def _gqa_params(cfg, rng):
    return {name: (_normal(rng, *shape, scale=fan ** -0.5) if fan else
                   _normal(rng, *shape, scale=0.1))
            for name, (shape, fan) in attention.gqa_shapes(cfg).items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-2b"])
@pytest.mark.parametrize("S,cache_len,window", [
    (12, 16, 0), (12, 12, 5), (16, 8, 8), (20, 8, 8), (20, 6, 6)])
def test_gqa_prefill_and_decode(dtype, arch, S, cache_len, window):
    """Prefill's output and cache (sorted by position), then two decode
    steps against that cache.  Where the cache is shorter than the prompt
    the reference's ring write corrupts the window unless S is a multiple
    of the cache (16 = 2 x 8 is; 20 = 2.5 x 8 and 20 = 3.33 x 6 are not): there the port's decode is
    held to its own full-sequence attention instead."""
    jcfg = jconfigs.get_reduced_config(arch)
    cfg = configs.get_reduced_config(arch)
    rng = np.random.default_rng(7)
    p = _gqa_params(cfg, rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = _normal(rng, 2, S + 2, cfg.d_model)
    jx, tx = _pair(x, dtype)
    pos = np.arange(S, dtype=np.int32)
    got, cache = attention.gqa_prefill(
        tp, tx[:, :S], positions=torch.from_numpy(pos), window=window,
        cfg=cfg, cache_len=cache_len)
    want, jcache = _jgqa_prefill(
        jp, jx[:, :S], positions=jnp.asarray(pos), window=jnp.int32(window),
        cfg=jcfg, cache_len=cache_len)
    _close(got, want, dtype)
    _close_cache({"layers": {k: v[None] for k, v in cache.items()}},
                 {"layers": {k: v[None] for k, v in jcache.items()}}, dtype)
    exact_ref = cache_len >= S or S % cache_len == 0
    for t in (S, S + 1):
        got, cache = attention.gqa_decode(tp, tx[:, t:t + 1], cache, t,
                                          window=window, cfg=cfg)
        if exact_ref:
            want, jcache = _jgqa_decode(jp, jx[:, t:t + 1], jcache,
                                            jnp.int32(t),
                                            window=jnp.int32(window),
                                            cfg=jcfg)
            _close(got, want, dtype)
        full = attention.gqa_apply(tp, tx[:, :t + 1],
                                   positions=torch.arange(t + 1),
                                   window=window or cache_len, cfg=cfg)
        if window or cache_len >= t + 1:
            _close(got, full[:, -1:], dtype)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("long_mode", [False, True])
def test_layer_windows_and_cache_len(arch, long_mode):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert transformer.layer_windows(cfg, long_mode) == \
        tuple(int(w) for w in jtrans.layer_windows(jcfg, long_mode))
    for S in (1, 64, 4096, 4608, 524_288):
        assert transformer.required_cache_len(cfg, S, long_mode) == \
            jtrans.required_cache_len(jcfg, S, long_mode)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", STACKS)
def test_prefill_and_decode_match_the_reference(dtype, arch):
    """Prefill's logits and its caches sorted by position, then two
    decode steps' logits and caches."""
    jcfg, cfg, params, net = _models(arch, dtype)
    jb, tb = _batch(cfg, 2, 14)
    got, cache = transformer.prefill(net, tb, cfg, min_cache_len=40)
    want, jcache = _jprefill(params, jb, jcfg, min_cache_len=40)
    assert got.shape == (2, 1, cfg.vocab_size) and got.dtype == torch.float32
    _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)
    idx = 14 + (cfg.num_prefix_tokens if cfg.frontend == "vision" else 0)
    rng = np.random.default_rng(9)
    for t in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        got, cache = transformer.decode(net, {"tokens": torch.from_numpy(tok)},
                                        cache, idx + t, cfg)
        want, jcache = _jdecode(params, {"tokens": jnp.asarray(tok)},
                                     jcache, jnp.int32(idx + t), jcfg)
        _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)


@pytest.mark.parametrize("arch", STACKS)
def test_bf16_is_as_accurate_as_the_reference(arch):
    """Each package's bf16 prefill logits against the reference's fp32
    ones: the port's distance at most 1.5x the reference's own."""
    jcfg, _, params, _ = _models(arch, "float32")
    jb, _ = _batch(jcfg, 2, 14)
    truth = _np(_jprefill(params, jb, jcfg)[0])
    jcfg, cfg, params, net = _models(arch, "bfloat16")
    jb, tb = _batch(cfg, 2, 14)
    port = np.abs(_np(transformer.prefill(net, tb, cfg)[0]) - truth).max()
    ref = np.abs(_np(_jprefill(params, jb, jcfg)[0]) - truth).max()
    assert port <= 1.5 * ref + 1e-3, (port, ref)


@pytest.mark.parametrize("arch", ATTENTION)
def test_prefill_takes_the_flash_schedule(arch):
    """A prompt over the chunk threshold (2560 > 2048, a multiple of the
    512-query block) prefills through ``_flash_sdpa`` in both packages;
    one stacked layer, fp32, batch 1."""
    jcfg, cfg, params, net = _models(arch, "float32")
    # one stacked layer (after the dense leading one, where there is one)
    one = dict(num_layers=1 + len(getattr(net, "dense_layers", ())))
    jcfg, cfg = jcfg.replace(**one), cfg.replace(**one)
    params = dict(params, layers=jax.tree.map(lambda a: a[:1],
                                              params["layers"]))
    net.layers = net.layers[:1]
    S = 2560 - (cfg.num_prefix_tokens if cfg.frontend == "vision" else 0)
    jb, tb = _batch(cfg, 1, S)
    got, cache = transformer.prefill(net, tb, cfg)
    want, jcache = _jprefill(params, jb, jcfg)
    _close(got, want)
    _close_cache(cache, jcache, "float32")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("long_mode", [False, True])
def test_cache_and_input_specs_match_the_reference(arch, long_mode):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    spec = transformer.cache_spec(cfg, 2, 64, torch.bfloat16, long_mode)
    jspec = jtrans.cache_spec(jcfg, 2, 64, jnp.bfloat16, long_mode)
    for name, s in spec["layers"].items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == jspec["layers"][name].shape
        assert str(s.dtype).split(".")[-1] == str(jspec["layers"][name].dtype)
    init = transformer.cache_init(cfg, 2, 64, "float32", long_mode,
                                  device="cpu")
    assert _empty_cache(init)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape, jshape = base.SHAPES[name], jbase.SHAPES[name]
        assert model.use_long_mode(cfg, shape) == \
            jmodel.use_long_mode(jcfg, jshape)
        small = dataclasses.replace(shape, seq_len=512, global_batch=2)
        jsmall = dataclasses.replace(jshape, seq_len=512, global_batch=2)
        specs = model.input_specs(cfg, small)
        jspecs = jmodel.input_specs(jcfg, jsmall)
        assert set(specs) == set(jspecs)
        for key in ("tokens", "targets", "vision_embeds", "frames"):
            if key in specs:
                assert tuple(specs[key].shape) == jspecs[key].shape


@pytest.mark.parametrize("arch", SERVED)
def test_param_specs_and_init_match_the_reference_tree(arch):
    """The meta model's tree is the reference's (shapes, fp32), and a
    seeded init is reproducible, finite and at the reference's scales."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    spec = _tree_shapes(model.param_specs(cfg))
    jspec = jax.tree.map(lambda s: tuple(s.shape), jmodel.param_specs(jcfg))
    assert spec == jspec
    red = configs.get_reduced_config(arch)
    a = model.init_params(red, 3, device="cpu")
    b = model.init_params(red, torch.Generator().manual_seed(3),
                          device="cpu")
    ta, tb = lm_params_to_numpy(a), lm_params_to_numpy(b)
    jax.tree.map(np.testing.assert_array_equal, ta, tb)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(ta))
    assert abs(ta["embed"].std() - 0.02) < 0.002
    # the query's (MLA's query down-, mamba's input) projection, fan-in
    # d_model
    if "mamba" in ta["layers"]:
        wq = ta["layers"]["mamba"]["in_proj"]
    else:
        wq = ta["layers"]["attn"]["wdq" if red.use_mla else "wq"]
    assert abs(wq.std() - red.d_model ** -0.5) < 0.1 * red.d_model ** -0.5
    assert (ta["final_norm"] == 0).all() and (ta["layers"]["ln1"] == 0).all()


def _empty_cache(cache) -> bool:
    """Every slot empty (pos -1) and every other entry (k/v, mamba's
    state and window) zeros."""
    layers = cache["layers"]
    if "pos" in layers and not bool((layers["pos"] == -1).all()):
        return False
    return not any(t.any() for k, t in layers.items() if k != "pos")


def _tree_shapes(net) -> dict:
    """The reference-layout tree of a (meta) model, shapes only: ``layers``
    (and whisper's ``encoder.layers``) stacked over L, ``dense_layers`` a
    list of per-layer trees, every other subtree (``shared_attn``,
    ``encoder``) nested as it is."""
    out: dict = {}
    for name, t in net.named_parameters():
        parts = name.split(".")
        shape = tuple(t.shape)
        n = 2 if parts[:2] == ["encoder", "layers"] else \
            1 if parts[0] == "layers" else 0
        if n:
            if parts[n] != "0":
                continue
            stacked = net.encoder.layers if n == 2 else net.layers
            node = out
            for key in parts[:n]:
                node = node.setdefault(key, {})
            path, shape = parts[n + 1:], (len(stacked),) + shape
        elif parts[0] == "dense_layers":
            dense = out.setdefault("dense_layers", [])
            i = int(parts[1])
            dense.extend({} for _ in range(i + 1 - len(dense)))
            node, path = dense[i], parts[2:]
        else:
            node, path = out, parts
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = shape
    return out


@pytest.mark.parametrize("arch", SERVED)
def test_make_inputs(arch):
    cfg = configs.get_reduced_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = base.InputShape("s", 24, 2, kind)
        a = model.make_inputs(cfg, shape, 5, device="cpu")
        b = model.make_inputs(cfg, shape, torch.Generator().manual_seed(5),
                              device="cpu")
        specs = model.input_specs(cfg, shape)
        assert set(a) == set(specs)
        for k, v in a.items():
            if k == "cache":
                assert _empty_cache(v)
            elif k == "cache_index":
                assert v == 0
            else:
                assert v.shape == specs[k].shape and v.dtype == specs[k].dtype
                assert torch.equal(v, b[k])
        if kind != "decode":
            assert int(a["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_family_is_served(arch, reduced):
    """The stack runs all ten archs, reduced and at full size: nothing is
    refused, and each model builds (on meta)."""
    cfg = (configs.get_reduced_config if reduced else configs.get_config)(arch)
    assert arch in SERVED
    assert transformer.unsupported(cfg) is None
    assert transformer.Transformer(cfg, "meta").cfg is cfg


def test_a_shared_attention_period_alone_still_raises():
    """A ``shared_attn_period`` without ``mamba+shared_attn`` kinds adds
    no shared block, as in the reference (its ``has_shared`` reads the
    kinds): a dense and a mamba stack with period 2 run plain, their
    trees, prefill logits and caches and two decode steps the
    reference's, the period touching only ``required_cache_len``.  What
    still raises is a stack whose layers mix mamba and attention kinds,
    which the reference's uniform scan cannot hold."""
    for name in PERIOD_ONLY:
        jcfg, cfg, params, net = _models(name, "float32")
        assert cfg.shared_attn_period == 2 and "shared_attn" not in net
        assert "shared_attn" not in params
        assert transformer.shared_attn_layers(cfg) == ()
        for long_mode in (False, True):
            for S in (14, 4608):
                assert transformer.required_cache_len(cfg, S, long_mode) \
                    == jtrans.required_cache_len(jcfg, S, long_mode)
        jb, tb = _batch(cfg, 2, 14)
        got, cache = transformer.prefill(net, tb, cfg, min_cache_len=20)
        want, jcache = _jprefill(params, jb, jcfg, min_cache_len=20)
        _close(got, want)
        _close_cache(cache, jcache, "float32")
        for t in range(2):
            tok = np.full((2, 1), 7 + t, np.int32)
            got, cache = transformer.decode(
                net, {"tokens": torch.from_numpy(tok)}, cache, 14 + t, cfg)
            want, jcache = _jdecode(params, {"tokens": jnp.asarray(tok)},
                                    jcache, jnp.int32(14 + t), jcfg)
            _close(got, want)
        _close_cache(cache, jcache, "float32")
    mixed = configs.get_reduced_config("qwen2-0.5b").replace(
        layer_pattern=(base.MAMBA, base.ATTN_GLOBAL), shared_attn_period=2)
    with pytest.raises(NotImplementedError, match="mixes mamba and "
                       "attention"):
        transformer.Transformer(mixed, "meta")


def _dense_leaves(cfg, tree, net):
    assert ("head" in net) == (not cfg.tie_embeddings)


def _moe_leaves(cfg, tree, net):
    assert isinstance(tree["layers"]["moe"]["gate"], np.ndarray)
    assert ("dense_layers" in tree) == bool(cfg.first_k_dense)


def _mla_leaves(cfg, tree, net):
    names = set(attention.mla_shapes(cfg))
    assert set(tree["layers"]["attn"]) == names
    assert set(tree["dense_layers"][0]["attn"]) == names
    assert tree["layers"]["attn"]["wuk"].shape[0] == len(net.layers)


def _mamba_leaves(cfg, tree, net):
    assert set(tree["layers"]) == {"ln1", "mamba"}
    assert set(tree["layers"]["mamba"]) == set(ssm.mamba_shapes(cfg))
    assert "head" not in tree and "head" not in net


def _encdec_leaves(cfg, tree, net):
    _dense_leaves(cfg, tree, net)
    assert set(tree["encoder"]) == {"layers", "final_norm"}
    assert set(tree["encoder"]["layers"]) == {"ln1", "attn", "ln2", "mlp"}
    assert tree["encoder"]["layers"]["ln1"].shape[0] == \
        cfg.num_encoder_layers
    assert {"ln_x", "cross"} <= set(tree["layers"])
    assert tree["pos_dec"].shape == (len(net.pos_dec), cfg.d_model)
    assert tree["pos_enc"].shape == (cfg.encoder_seq, cfg.d_model)


def _hybrid_leaves(cfg, tree, net):
    _mamba_leaves(cfg, tree, net)
    shared = tree["shared_attn"]
    assert set(shared) == {"ln1", "attn", "ln2", "mlp"}
    assert set(shared["attn"]) == set(attention.gqa_shapes(cfg))
    # one layer's tree, not stacked over the layers
    assert shared["attn"]["wq"].shape == attention.gqa_shapes(cfg)["wq"][0]


# the converter's round trip: case -> (the leaf cut short, which the
# error must name; the family's leaf-name check)
ROUND_TRIP = {
    "gemma2-2b": (("embed",), _dense_leaves),
    "internvl2-2b": (("embed",), _dense_leaves),
    "qwen2-0.5b": (("embed",), _dense_leaves),
    "phi3.5-moe-42b-a6.6b": (("layers", "moe", "router"), _moe_leaves),
    PHI_DENSE1: (("layers", "moe", "router"), _moe_leaves),
    "deepseek-v2-236b": (("layers", "attn", "wuk"), _mla_leaves),
    DSV2_3L: (("layers", "attn", "wuk"), _mla_leaves),
    "mamba2-130m": (("layers", "mamba", "conv_w"), _mamba_leaves),
    "zamba2-1.2b": (("shared_attn", "attn", "wq"), _hybrid_leaves),
    "whisper-small": (("encoder", "layers", "attn", "wq"), _encdec_leaves),
}


@pytest.mark.parametrize("case", ROUND_TRIP)
def test_convert_round_trip_is_bitwise(case):
    """The reference's tree crosses to the port and back bitwise, each
    family's leaves where its stack keeps them (dense, MoE with and
    without ``dense_layers``, MLA, mamba, the hybrid's shared block, the
    encoder-decoder's encoder and position tables); a wrong shape names
    its leaf."""
    path, leaves = ROUND_TRIP[case]
    jcfg, cfg, params, net = _models(case, "float32", seed=11)
    tree = lm_params_to_numpy(net)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    leaves(cfg, tree, net)
    bad = jax.tree.map(lambda a: a, want)
    node = bad
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]][..., :-1]
    with pytest.raises(ValueError, match=".".join(path[-2:])):
        lm_params_to_torch(bad, cfg, device="cpu")
