"""The port's multi-head latent attention (``repro_torch.models.attention``'s
MLA half, the stack's MLA branch) against the reference's
(``repro.models.attention``, ``repro.models.transformer``) on the CPU, on
reduced DeepSeek-V2 (d_model 256, 4 heads, q_lora 96, kv_lora 64, nope
32, rope 16, v 32; a dense leading layer, MoE layers at the dropless
capacity factor 8.0).

The same seeded numpy inputs and the same weights (numpy for the
attention alone, ``repro_torch.convert.lm_params_to_torch`` for the
stack) go through both packages.  Tolerances are tests/test_torch_models
.py's: 1e-4 in fp32, 3e-2 in bf16.  The whole stack's parity with the
reference (prefill, decode, ``generate``, bf16 accuracy), with 2 layers
and with 3, is a case of tests/test_torch_models.py's and
tests/test_torch_launch_serve.py's stack tests; this file holds the
blocks, the op order, the cache's bounds and what only MLA has.

The absorbed decode and the expanded prefill are equal only in exact
arithmetic: in bf16 the port's decode is held to the reference's decode
and its prefill to the reference's prefill, never one form to the other;
in fp32 (port only) decode after S tokens equals an expanded prefill over
S + 1.  The op order of the absorbed scores is the one XLA compiles the
reference's to (each product rounded to bf16, their sum in fp32; see
``repro_torch.models.attention``'s doc); ``test_absorbed_scores_take_
xla_s_op_order`` holds it bitwise.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention, model, transformer
from test_torch_models import (DSV2_3L, DTYPES, TDT, _batch, _close,
                               _close_cache, _jflash, _models, _normal, _pair)

DSV2 = "deepseek-v2-236b"
_jmla_apply = jax.jit(jattn.mla_apply, static_argnames=("cfg",))
_jmla_prefill = jax.jit(jattn.mla_prefill,
                        static_argnames=("cfg", "cache_len"))
_jmla_decode = jax.jit(jattn.mla_decode, static_argnames=("cfg",))


def _cfgs(dtype, **over):
    over["compute_dtype"] = dtype
    return (jconfigs.get_reduced_config(DSV2).replace(**over),
            configs.get_reduced_config(DSV2).replace(**over))


@functools.lru_cache(maxsize=None)
def _mla_params(seed=0):
    """The reference's init of one MLA block as numpy, its latent norms
    (zero at init) given a spread so that they enter the comparison."""
    jcfg = jconfigs.get_reduced_config(DSV2)
    p = jax.tree.map(np.asarray, jattn.mla_init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return dict(p, q_ln=_normal(rng, *p["q_ln"].shape, scale=0.1),
                kv_ln=_normal(rng, *p["kv_ln"].shape, scale=0.1))


def _params_pair(seed=0):
    p = _mla_params(seed)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _x(S, d, seed, B=2):
    return _normal(np.random.default_rng(seed), B, S, d)


def _close_block_cache(cache, jcache, dtype):
    """One block's cache as a one-layer stacked cache, sorted by pos."""
    _close_cache({"layers": {k: v[None] for k, v in cache.items()}},
                 {"layers": {k: v[None] for k, v in jcache.items()}}, dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False])
def test_mla_shapes_match_the_reference(reduced):
    """``mla_shapes`` is the reference's ``mla_init`` tree (at full width
    by ``jax.eval_shape``), and it holds the config's attention count plus
    the two latent norms."""
    get, jget = ((configs.get_reduced_config, jconfigs.get_reduced_config)
                 if reduced else (configs.get_config, jconfigs.get_config))
    cfg, jcfg = get(DSV2), jget(DSV2)
    ref = jax.eval_shape(lambda k: jattn.mla_init(k, jcfg),
                         jax.random.key(0))
    shapes = attention.mla_shapes(cfg)
    assert {k: s for k, (s, _) in shapes.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert {k for k, (_, fan) in shapes.items() if not fan} == \
        {"q_ln", "kv_ln"}
    n = sum(math.prod(s) for s, _ in shapes.values())
    assert n == cfg._attn_params() + cfg.q_lora_rank + cfg.kv_lora_rank


def test_init_draws_the_reference_scales():
    """Every MLA leaf of a seeded ``init_params`` (the dense leading layer
    and the stacked one) has the reference's shape and scale: 1/sqrt(fan)
    for the projections, zero for the latent norms; reproducibly."""
    cfg = configs.get_reduced_config(DSV2)
    ref = jax.tree.map(np.asarray, jattn.mla_init(
        jax.random.key(0), jconfigs.get_reduced_config(DSV2)))
    a = model.init_params(cfg, 3, device="cpu")
    b = model.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    layers = (*a.dense_layers, *a.layers)
    assert len(layers) == cfg.num_layers == 2
    for i, layer in enumerate(layers):
        assert set(layer.attn.keys()) == set(ref)
        for name, (shape, fan) in attention.mla_shapes(cfg).items():
            t = layer.attn[name].detach()
            assert tuple(t.shape) == shape == ref[name].shape
            twin = (b.dense_layers[0] if i == 0 else b.layers[0]).attn[name]
            assert torch.equal(t, twin)
            if fan:
                assert abs(float(t.std()) * fan ** 0.5 - 1) < 0.1
                assert abs(float(ref[name].std()) * fan ** 0.5 - 1) < 0.1
            else:
                assert not t.any() and not ref[name].any()


def test_cache_spec_and_init_match_the_reference():
    cfg, jcfg = configs.get_config(DSV2), jconfigs.get_config(DSV2)
    spec = attention.mla_cache_spec(cfg, 2, 40, torch.bfloat16)
    jspec = jattn.mla_cache_spec(jcfg, 2, 40, jnp.bfloat16)
    assert set(spec) == set(jspec) == {"ckv", "kr", "pos"}
    for name, s in spec.items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == jspec[name].shape
        assert str(s.dtype).split(".")[-1] == str(jspec[name].dtype)
    init = attention.mla_cache_init(cfg, 2, 40, torch.float32, device="cpu")
    jinit = jattn.mla_cache_init(jcfg, 2, 40, jnp.float32)
    for name, t in init.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jinit[name]))
    # the stacked spec: the dense leading layer's own, then (L, ...)
    stacked = transformer.cache_spec(cfg, 2, 40, torch.bfloat16, False)
    L = cfg.num_layers - cfg.first_k_dense
    assert tuple(stacked["layers"]["ckv"].shape) == (L, 2, 40, 512)
    assert tuple(stacked["layers"]["kr"].shape) == (L, 2, 40, 64)
    assert [tuple(c["ckv"].shape) for c in stacked["dense"]] == [(2, 40, 512)]


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [12, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_apply_and_prefill_match_the_reference(dtype, S):
    """The expanded form's output and latents, and prefill's output and
    cache (``ckv``, ``kr``, ``pos``, with the empty slots past S)."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params_pair()
    jx, tx = _pair(_x(S, cfg.d_model, S), dtype)
    got, lat = attention.mla_apply(tp, tx, positions=torch.arange(S),
                                   cfg=cfg)
    want, jlat = _jmla_apply(jp, jx, positions=jnp.arange(S), cfg=jcfg)
    assert got.shape == (2, S, cfg.d_model) and got.dtype == TDT[dtype]
    assert lat["ckv"].shape == (2, S, cfg.kv_lora_rank)
    assert lat["kr"].shape == (2, S, cfg.qk_rope_head_dim)
    _close(got, want, dtype)
    _close(lat["ckv"], jlat["ckv"], dtype)
    _close(lat["kr"], jlat["kr"], dtype)
    cache_len = S + 5
    got, cache = attention.mla_prefill(tp, tx, positions=torch.arange(S),
                                       cfg=cfg, cache_len=cache_len)
    want, jcache = _jmla_prefill(jp, jx, positions=jnp.arange(S), cfg=jcfg,
                                 cache_len=cache_len)
    _close(got, want, dtype)
    assert set(cache) == set(jcache)
    for name, t in cache.items():
        assert t.shape == jcache[name].shape
        assert str(t.dtype).split(".")[-1] == str(jcache[name].dtype)
        _close(t, jcache[name], dtype)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("S", [12, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_the_reference(dtype, S):
    """Four absorbed decode steps after a prefill of S tokens: each
    output, then the cache the steps wrote in place."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params_pair()
    n = 4
    jx, tx = _pair(_x(S + n, cfg.d_model, S + 1), dtype)
    _, cache = attention.mla_prefill(tp, tx[:, :S], positions=torch.arange(S),
                                     cfg=cfg, cache_len=S + n)
    _, jcache = _jmla_prefill(jp, jx[:, :S], positions=jnp.arange(S),
                              cfg=jcfg, cache_len=S + n)
    ckv = cache["ckv"]
    for t in range(S, S + n):
        got, cache = attention.mla_decode(tp, tx[:, t:t + 1], cache, t,
                                          cfg=cfg)
        want, jcache = _jmla_decode(jp, jx[:, t:t + 1], jcache, jnp.int32(t),
                                    cfg=jcfg)
        assert got.shape == (2, 1, cfg.d_model) and got.dtype == TDT[dtype]
        _close(got, want, dtype)
    assert cache["ckv"] is ckv          # written in place
    assert (cache["pos"] >= 0).all()
    _close_block_cache(cache, jcache, dtype)


def test_absorbed_scores_take_xla_s_op_order():
    """The reference's score lines, compiled by XLA in bf16, are bitwise
    each product rounded to bf16 and their sum taken in fp32 (not rounded),
    then divided by sqrt(nope + rope): ``_absorbed_scores``, which
    ``mla_decode`` calls, computes them so, where fp32 products summed in
    fp32, or the sum rounded to bf16, differ by ~1e-2."""
    rng = np.random.default_rng(0)
    B, H, r, e, S = 2, 4, 64, 16, 20
    arrs = [_normal(rng, *s) for s in ((B, H, r), (B, S, r), (B, H, e),
                                       (B, S, e))]

    @jax.jit
    def ref(q_lat, ckv, q_rope, kr):
        s = jnp.einsum("bhr,bsr->bhs", q_lat, ckv)
        s = s + jnp.einsum("bhe,bse->bhs", q_rope, kr)
        return s.astype(jnp.float32) / math.sqrt(48)

    want = np.asarray(ref(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in arrs)))
    q_lat, ckv, q_rope, kr = (torch.from_numpy(a).bfloat16() for a in arrs)
    port = attention._absorbed_scores(q_lat, ckv, q_rope, kr, math.sqrt(48))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), want, rtol=2e-7, atol=0)
    fp32 = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
            + torch.einsum("bhe,bse->bhs", q_rope.float(), kr.float()))
    assert np.abs(fp32.numpy() / math.sqrt(48) - want).max() > 1e-3
    bf16 = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
            + torch.einsum("bhe,bse->bhs", q_rope, kr)).float()
    assert np.abs(bf16.numpy() / math.sqrt(48) - want).max() > 1e-3


def test_decode_takes_the_absorbed_scores(monkeypatch):
    """``mla_decode``'s scores are ``_absorbed_scores``' (the op order
    held above): one call a step, at the compute dtype and the
    reference's denominator."""
    _, cfg = _cfgs("bfloat16")
    _, tp = _params_pair()
    tx = torch.from_numpy(_x(6, cfg.d_model, 3)).bfloat16()
    _, cache = attention.mla_prefill(tp, tx[:, :5], positions=torch.arange(5),
                                     cfg=cfg, cache_len=6)
    calls, real = [], attention._absorbed_scores

    def spy(*args):
        calls.append(tuple(a.dtype for a in args[:4]) + args[4:])
        return real(*args)

    monkeypatch.setattr(attention, "_absorbed_scores", spy)
    attention.mla_decode(tp, tx[:, 5:], cache, 5, cfg=cfg)
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert calls == [(torch.bfloat16,) * 4 + (math.sqrt(qk),)]


@pytest.mark.parametrize("S", [1, 12, 64])
def test_absorbed_decode_equals_expanded_prefill(S):
    """Port only, fp32: each of three decode steps after a prefill of S
    tokens equals the last row of ``mla_apply`` over the tokens so far."""
    _, cfg = _cfgs("float32")
    _, tp = _params_pair(1)
    tx = torch.from_numpy(_x(S + 3, cfg.d_model, 7))
    _, cache = attention.mla_prefill(tp, tx[:, :S], positions=torch.arange(S),
                                     cfg=cfg, cache_len=S + 3)
    for t in range(S, S + 3):
        got, cache = attention.mla_decode(tp, tx[:, t:t + 1], cache, t,
                                          cfg=cfg)
        full, _ = attention.mla_apply(tp, tx[:, :t + 1],
                                      positions=torch.arange(t + 1), cfg=cfg)
        assert float((got - full[:, -1:]).abs().max()) <= 1e-4


@settings(max_examples=12, deadline=None, database=None)
@given(S=st.integers(1, 40), spare=st.integers(1, 9),
       seed=st.integers(0, 2 ** 16))
def test_absorbed_decode_masks_the_empty_slots(S, spare, seed):
    """Port only, fp32: a cache with ``spare`` slots beyond the next token
    (zeros at pos -1) changes nothing; decode still equals the expanded
    form within 1e-4."""
    _, cfg = _cfgs("float32")
    _, tp = _params_pair()
    tx = torch.from_numpy(_x(S + 1, cfg.d_model, seed, B=1))
    _, cache = attention.mla_prefill(tp, tx[:, :S], positions=torch.arange(S),
                                     cfg=cfg, cache_len=S + spare)
    got, _ = attention.mla_decode(tp, tx[:, S:], cache, S, cfg=cfg)
    full, _ = attention.mla_apply(tp, tx, positions=torch.arange(S + 1),
                                  cfg=cfg)
    assert float((got - full[:, -1:]).abs().max()) <= 1e-4


def test_prefill_raises_on_a_short_cache():
    _, cfg = _cfgs("float32")
    _, tp = _params_pair()
    tx = torch.from_numpy(_x(12, cfg.d_model, 0))
    with pytest.raises(ValueError, match="holds 8 slots, the prompt 12"):
        attention.mla_prefill(tp, tx, positions=torch.arange(12), cfg=cfg,
                              cache_len=8)


def test_decode_raises_past_the_cache():
    """A decode at a position the cache has no slot for raises, in the
    block and through the stack, and leaves the cache as it was (MLA has
    no window: a wrapped write would drop position 0 from attention)."""
    _, cfg = _cfgs("float32")
    _, tp = _params_pair()
    tx = torch.from_numpy(_x(9, cfg.d_model, 0))
    _, cache = attention.mla_prefill(tp, tx[:, :8], positions=torch.arange(8),
                                     cfg=cfg, cache_len=8)
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(ValueError, match="position 8 does not fit the "
                                         "cache's 8 slots"):
        attention.mla_decode(tp, tx[:, 8:], cache, 8, cfg=cfg)
    assert all(torch.equal(cache[k], before[k]) for k in before)
    _, cfg, _, net = _models(DSV2, "float32")
    _, tb = _batch(cfg, 2, 9)
    _, cache = transformer.prefill(net, {"tokens": tb["tokens"][:, :8]}, cfg)
    assert cache["layers"]["pos"].shape[-1] == 8
    with pytest.raises(ValueError, match="position 8 does not fit"):
        transformer.decode(net, {"tokens": tb["tokens"][:, 8:]}, cache, 8,
                           cfg)


# ---------------------------------------------------------------------------
# the flash schedule with v narrower than q and k
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,causal,valid", [(4, True, False),
                                            (4, True, True),
                                            (2, False, False)])
def test_flash_sdpa_with_a_narrower_v(dtype, K, causal, valid):
    """``_flash_sdpa`` with Dv = 8 < D = 12 over several query and KV
    blocks, against the reference's and the port's plain schedule."""
    rng = np.random.default_rng(11)
    S, H, D, Dv = 32, 4, 12, 8
    jq, tq = _pair(_normal(rng, 1, S, H, D), dtype)
    jk, tk = _pair(_normal(rng, 1, S, K, D), dtype)
    jv, tv = _pair(_normal(rng, 1, S, K, Dv), dtype)
    pos = np.arange(S, dtype=np.int32)
    k_valid = (pos % 5 != 3) if valid else None
    kw = dict(cap=0.0, scale=D ** -0.5, causal=causal)
    tvalid = None if k_valid is None else torch.from_numpy(k_valid)
    got = attention._flash_sdpa(tq, tk, tv, torch.from_numpy(pos),
                                torch.from_numpy(pos), window=0,
                                k_valid=tvalid, q_chunk=8, kv_chunk=16, **kw)
    want = _jflash(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                   window=jnp.int32(0), k_valid=None if k_valid is None
                   else jnp.asarray(k_valid), q_chunk=8, kv_chunk=16, **kw)
    assert got.shape == (1, S, H * Dv) and got.dtype == TDT[dtype]
    _close(got, want, dtype)
    plain = attention._sdpa(tq, tk, tv, torch.from_numpy(pos),
                            torch.from_numpy(pos), window=0, k_valid=tvalid,
                            **kw)
    _close(got, plain, dtype)


def test_long_prefill_takes_the_flash_schedule(monkeypatch):
    """A 2560-token MLA prefill (fp32, batch 1) goes through
    ``_flash_sdpa`` with v's head dim (32) below q's and k's (48), and
    matches the reference's, cache included."""
    jcfg, cfg = _cfgs("float32")
    jp, tp = _params_pair()
    S = 2560
    jx, tx = _pair(_x(S, cfg.d_model, 3, B=1), "float32")
    calls = []
    real = attention._flash_sdpa

    def counting(q, k, v, *a, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(attention, "_flash_sdpa", counting)
    got, cache = attention.mla_prefill(tp, tx, positions=torch.arange(S),
                                       cfg=cfg, cache_len=S)
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert calls == [(qk, qk, cfg.v_head_dim)]
    want, jcache = _jmla_prefill(jp, jx, positions=jnp.arange(S), cfg=jcfg,
                                 cache_len=S)
    _close(got, want)
    _close_block_cache(cache, jcache, "float32")


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
def test_only_the_latent_families_join_the_stack():
    """DeepSeek-V2 runs, and so does every other arch since whisper's
    encoder-decoder joined: ``unsupported`` is None for all ten, reduced
    and at full size."""
    assert DSV2 in configs.ARCHS
    for arch in configs.ARCHS:
        assert transformer.unsupported(configs.get_reduced_config(arch)) \
            is None
        assert transformer.unsupported(configs.get_config(arch)) is None


def test_grow_cache_reseats_the_latent_cache():
    """``_grow_cache`` re-seats every latent (the stacked layers' and the
    dense layer's) into a longer buffer: the prefix copied, the rest zeros
    at pos -1; a cache already of the size is kept as it is."""
    _, cfg, _, net = _models(DSV2_3L, "float32")
    _, tb = _batch(cfg, 2, 10)
    _, cache = transformer.prefill(net, tb, cfg)
    grown = serve._grow_cache(cfg, cache, 2, 16, False)
    assert serve._grow_cache(cfg, grown, 2, 16, False) is grown
    for have, got in ((cache["layers"], grown["layers"]),
                      (cache["dense"][0], grown["dense"][0])):
        assert set(got) == {"ckv", "kr", "pos"}
        for name in ("ckv", "kr"):
            assert got[name].shape[-2] == 16
            assert torch.equal(got[name][..., :10, :], have[name])
            assert not got[name][..., 10:, :].any()
        assert torch.equal(got["pos"][..., :10], have["pos"])
        assert (got["pos"][..., 10:] == -1).all()


def test_dropless_decode_equals_prefill():
    """Port only, fp32, at the dropless capacity (8.0 >= E/K): the three-
    layer stack's absorbed decode after S tokens equals an expanded prefill
    over S + 1, to 1e-4."""
    _, cfg, _, net = _models(DSV2_3L, "float32")
    assert cfg.moe_capacity_factor >= cfg.num_experts / cfg.moe_top_k
    _, tb = _batch(cfg, 2, 18, seed=4)
    toks = tb["tokens"]
    _, cache = transformer.prefill(net, {"tokens": toks[:, :14]}, cfg,
                                   min_cache_len=18)
    for t in range(14, 18):
        dl, cache = transformer.decode(net, {"tokens": toks[:, t:t + 1]},
                                       cache, t, cfg)
        full, _ = transformer.prefill(net, {"tokens": toks[:, :t + 1]}, cfg)
        assert float((dl - full).abs().max()) <= 1e-4
