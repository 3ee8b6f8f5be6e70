"""Zamba2's hybrid stack in the port (``repro_torch.models.transformer``'s
hybrid branch: the mamba layers with one weight-tied shared attention
block, and the uniform cache) against the reference's
(``repro.models.transformer``) on the CPU.

The reduced zamba2: 4 mamba layers (d_model 256, d_inner 512, 16 SSM
heads of 32, d_state 16, chunk 32), the shared block (4 heads over 4 KV
heads of 64, d_ff 512) after layers 1 and 3, long-mode window 64, vocab
512 with a tied head.  The weights are the reference's, carried across
with ``repro_torch.convert.lm_params_to_torch``.  Tolerances are
tests/test_torch_models.py's: fp32 within atol = rtol = 1e-4, bf16
within 3e-2 (the stack's logits with its spread-scaled atol); a decode
step held to the port's own prefill over the same tokens within 1e-4 in
fp32.  In long mode past the window the reference's decode is off (its
ring after a long prompt, ROADMAP queue 3); there the port's decode is
held to its own prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import transformer as jtrans
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import attention, transformer
from test_torch_models import (DTYPES, _batch, _close, _close_cache,
                               _close_logits, _jdecode, _jprefill, _models,
                               _np)

ARCH = "zamba2-1.2b"
KV = ("k", "v", "pos")


def _leaf_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def _decode_steps(net, cfg, cache, tokens, start, long_mode=False):
    """Decode ``tokens`` (B, n) one at a time from position ``start``;
    returns each step's logits and the cache."""
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = transformer.decode(
            net, {"tokens": tokens[:, t:t + 1]}, cache, start + t, cfg,
            long_mode=long_mode)
        out.append(logits)
    return out, cache


def test_the_shared_block_is_one_tied_set():
    """Exactly one ``shared_attn`` module (ln1, attn, ln2, mlp), after the
    reference's flagged layers; the port's parameter count equal to the
    reference's leaf count, reduced and at full size (on meta: 1,104,937,
    856), which six copies of the block would exceed."""
    for get, jget in ((configs.get_reduced_config,
                       jconfigs.get_reduced_config),
                      (configs.get_config, jconfigs.get_config)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        net = transformer.init_params(cfg, None, device="meta")
        shared = [n for n, m in net.named_modules()
                  if n.split(".")[-1] == "shared_attn"]
        assert shared == ["shared_attn"]
        assert set(dict(net.shared_attn.named_children())) == {"attn",
                                                               "mlp"}
        assert "ln1" in net.shared_attn and "ln2" in net.shared_attn
        assert transformer.shared_attn_layers(cfg) == \
            jtrans.shared_attn_layers(jcfg)
        want = _leaf_count(jmodel.param_specs(jcfg))
        assert sum(p.numel() for p in net.parameters()) == want
    assert want == 1_104_937_856
    assert transformer.shared_attn_layers(cfg) == (5, 11, 17, 23, 29, 35)
    assert transformer.shared_attn_layers(
        configs.get_reduced_config(ARCH)) == (1, 3)
    # the block's own size: a dense layer at the config's widths
    block = sum(p.numel() for p in net.shared_attn.parameters())
    d = cfg.d_model
    assert block == 4 * d * d + 3 * d * cfg.d_ff + 2 * d


def test_the_round_trip_carries_the_shared_tree():
    """The reference's tree to the port and back, leaf for leaf, with
    ``shared_attn`` nested as the reference nests it; prefill runs that
    one module at each flagged layer."""
    jcfg, cfg, params, net = _models(ARCH, "float32", seed=5)
    tree = lm_params_to_numpy(net)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert set(tree["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    _, tb = _batch(cfg, 1, 6)
    calls = []
    real = transformer._attn_block_prefill

    def counting(lp, *args, **kw):
        calls.append(lp is net.shared_attn)
        return real(lp, *args, **kw)

    transformer._attn_block_prefill = counting
    try:
        transformer.prefill(net, tb, cfg)
    finally:
        transformer._attn_block_prefill = real
    assert calls == [True, True]


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_uniform_cache_after_prefill_and_two_steps(dtype):
    """Every stacked layer carries ``h``/``conv`` and a KV slot; after a
    14-token prefill and two decode steps the unflagged layers' ``k``/``v``
    are zeros and their ``pos`` -1, as the reference's, and the flagged
    layers' slots (sorted by position) and every layer's state and window
    are the reference's."""
    jcfg, cfg, params, net = _models(ARCH, dtype)
    jb, tb = _batch(cfg, 2, 14)
    got, cache = transformer.prefill(net, tb, cfg, min_cache_len=24)
    want, jcache = _jprefill(params, jb, jcfg, min_cache_len=24)
    _close_logits(got, want, dtype)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    steps, cache = _decode_steps(net, cfg, cache, torch.from_numpy(toks), 14)
    for t, logits in enumerate(steps):
        want, jcache = _jdecode(params,
                                {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                jcache, jnp.int32(14 + t), jcfg)
        _close_logits(logits, want, dtype)
    layers, jlayers = cache["layers"], jcache["layers"]
    L = cfg.num_layers
    assert set(layers) == {"h", "conv", *KV} == set(jlayers)
    assert tuple(layers["k"].shape) == (L, 2, 24, cfg.num_kv_heads,
                                        cfg.head_dim)
    assert layers["h"].dtype == torch.float32
    flagged = set(transformer.shared_attn_layers(cfg))
    assert flagged == {1, 3}
    for i in range(L):
        if i in flagged:
            assert int((layers["pos"][i] >= 0).sum()) == 16
            continue
        for name in ("k", "v"):
            assert not layers[name][i].any()
            assert not np.asarray(jlayers[name][i]).any()
        assert bool((layers["pos"][i] == -1).all())
        np.testing.assert_array_equal(layers["pos"][i].numpy(),
                                      np.asarray(jlayers["pos"][i]))
    _close_cache(cache, jcache, dtype)


def test_long_mode_past_the_window_decodes_as_its_prefill():
    """fp32, long mode (window and cache 64): a 70-token prompt (over the
    window and not a multiple of it; two chunks of 32 and a 6-token
    tail) prefills as the reference's, its cache (sorted by position) the
    reference's, and 4 decode steps within 1e-4 of the port's own prefill
    over the tokens so far."""
    jcfg, cfg, params, net = _models(ARCH, "float32")
    S, n = 70, 4
    jb, tb = _batch(cfg, 1, S + n, seed=3)
    toks = tb["tokens"]
    got, cache = transformer.prefill(net, {"tokens": toks[:, :S]}, cfg,
                                     long_mode=True)
    want, jcache = _jprefill(params, {"tokens": jb["tokens"][:, :S]}, jcfg,
                             long_mode=True)
    _close(got, want)
    _close_cache(cache, jcache, "float32")
    assert cache["layers"]["k"].shape[2] == cfg.long_context_window == 64
    cache = serve._grow_cache(cfg, cache, 1, S + n, True)
    for t in range(S, S + n):
        dl, cache = transformer.decode(net, {"tokens": toks[:, t:t + 1]},
                                       cache, t, cfg, long_mode=True)
        full, _ = transformer.prefill(net, {"tokens": toks[:, :t + 1]}, cfg,
                                      long_mode=True)
        assert float((dl - full).abs().max()) <= 1e-4


def test_long_mode_at_the_window_matches_the_reference():
    """fp32, long mode, a 64-token prompt (a whole window, where the
    reference's ring is exact): 4 decode steps as the reference's, their
    positions wrapping onto slots 0-3."""
    jcfg, cfg, params, net = _models(ARCH, "float32")
    S, n = 64, 4
    jb, tb = _batch(cfg, 1, S + n, seed=8)
    got, cache = transformer.prefill(net, {"tokens": tb["tokens"][:, :S]},
                                     cfg, long_mode=True)
    want, jcache = _jprefill(params, {"tokens": jb["tokens"][:, :S]}, jcfg,
                             long_mode=True)
    _close(got, want)
    steps, cache = _decode_steps(net, cfg, cache, tb["tokens"][:, S:], S,
                                 long_mode=True)
    jdec = jax.jit(jtrans.decode, static_argnames=("cfg", "long_mode"))
    for t, logits in enumerate(steps):
        want, jcache = jdec(params,
                            {"tokens": jb["tokens"][:, S + t:S + t + 1]},
                            jcache, jnp.int32(S + t), jcfg, long_mode=True)
        _close(logits, want)
    _close_cache(cache, jcache, "float32")
    assert cache["layers"]["pos"][1, :n].tolist() == [64, 65, 66, 67]


def test_the_shared_block_prefills_through_the_flash_schedule():
    """fp32, two layers (the shared block after the second), batch 1: a
    2560-token prompt (over the 2048 threshold, a multiple of the
    512-query block) takes ``_flash_sdpa`` in the shared block; logits
    and cache as the reference's, which takes the same schedule."""
    jcfg, cfg, params, net = _models(ARCH, "float32")
    jcfg, cfg = jcfg.replace(num_layers=2), cfg.replace(num_layers=2)
    params = dict(params, layers=jax.tree.map(lambda a: a[:2],
                                              params["layers"]))
    net.layers = net.layers[:2]
    jb, tb = _batch(cfg, 1, 2560, seed=2)
    calls = []
    real = attention._flash_sdpa

    def counting(q, *args, **kw):
        calls.append(q.shape[1])
        return real(q, *args, **kw)

    attention._flash_sdpa = counting
    try:
        got, cache = transformer.prefill(net, tb, cfg)
    finally:
        attention._flash_sdpa = real
    assert calls == [2560]
    want, jcache = _jprefill(params, jb, jcfg)
    _close(got, want)
    _close_cache(cache, jcache, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_prompt_shorter_than_the_conv_window(dtype):
    """A 2-token prompt (the conv window holds 3): prefill, its cache and
    three decode steps as the reference's."""
    jcfg, cfg, params, net = _models(ARCH, dtype)
    jb, tb = _batch(cfg, 2, 5, seed=6)
    got, cache = transformer.prefill(net, {"tokens": tb["tokens"][:, :2]},
                                     cfg, min_cache_len=5)
    want, jcache = _jprefill(params, {"tokens": jb["tokens"][:, :2]}, jcfg,
                             min_cache_len=5)
    _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)
    steps, cache = _decode_steps(net, cfg, cache, tb["tokens"][:, 2:], 2)
    for t, logits in enumerate(steps):
        want, jcache = _jdecode(params,
                                {"tokens": jb["tokens"][:, 2 + t:3 + t]},
                                jcache, jnp.int32(2 + t), jcfg)
        _close_logits(logits, want, dtype)
    _close_cache(cache, jcache, dtype)


@pytest.mark.parametrize("S", [31, 40])
def test_bf16_prefill_and_decode_match_the_reference(S):
    """bf16 prefill (one partial chunk at 31, a padded second chunk at
    40) and four decode steps, each package fed the same tokens, as the
    stack tests hold mamba2."""
    jcfg, cfg, params, net = _models(ARCH, "bfloat16")
    jb, tb = _batch(cfg, 2, S + 4, seed=S)
    got, cache = transformer.prefill(net, {"tokens": tb["tokens"][:, :S]},
                                     cfg, min_cache_len=S + 4)
    want, jcache = _jprefill(params, {"tokens": jb["tokens"][:, :S]}, jcfg,
                             min_cache_len=S + 4)
    _close_logits(got, want, "bfloat16")
    steps, cache = _decode_steps(net, cfg, cache, tb["tokens"][:, S:], S)
    for t, logits in enumerate(steps):
        want, jcache = _jdecode(params,
                                {"tokens": jb["tokens"][:, S + t:S + t + 1]},
                                jcache, jnp.int32(S + t), jcfg)
        _close_logits(logits, want, "bfloat16")
    _close_cache(cache, jcache, "bfloat16")


def test_grow_cache_reseats_the_kv_half_and_carries_the_state():
    """``serve._grow_cache`` on the uniform cache: the KV slots copied
    into a longer buffer (the rest zeros at pos -1), ``h`` and ``conv``
    carried whole; in long mode past the window the 64-slot ring kept as
    it is."""
    _, cfg, _, net = _models(ARCH, "float32")
    _, tb = _batch(cfg, 2, 14)
    _, cache = transformer.prefill(net, tb, cfg)
    grown = serve._grow_cache(cfg, cache, 2, 30, False)
    layers, old = grown["layers"], cache["layers"]
    assert layers["k"].shape[2] == 30 and old["k"].shape[2] == 14
    for name in ("h", "conv"):
        assert torch.equal(layers[name], old[name])
    for name in ("k", "v"):
        assert torch.equal(layers[name][:, :, :14], old[name])
        assert not layers[name][:, :, 14:].any()
    assert torch.equal(layers["pos"][:, :14], old["pos"])
    assert bool((layers["pos"][:, 14:] == -1).all())
    _, long_cache = transformer.prefill(net, {"tokens": torch.zeros(
        (1, 70), dtype=torch.int32)}, cfg, long_mode=True)
    assert serve._grow_cache(cfg, long_cache, 1, 80, True) is long_cache


def test_unsupported_lets_the_hybrid_through_and_refuses_a_mixed_stack():
    """zamba2 runs at both sizes; a stack whose layers mix mamba and
    attention kinds raises, with or without the shared block's kind."""
    for cfg in (configs.get_config(ARCH), configs.get_reduced_config(ARCH)):
        assert transformer.unsupported(cfg) is None
    red = configs.get_reduced_config(ARCH)
    for pattern in ((base.MAMBA, base.ATTN_GLOBAL),
                    (base.MAMBA_SHARED_ATTN, base.ATTN_LOCAL)):
        cfg = red.replace(layer_pattern=pattern)
        assert "mixes mamba and attention" in transformer.unsupported(cfg)
        with pytest.raises(NotImplementedError):
            transformer.cache_spec(cfg, 1, 8, torch.float32, False)


def test_cache_spec_matches_the_reference_at_full_size():
    """The full model's stacked cache at batch 4 and 544 positions, on
    meta: ``h`` (38, 4, 64, 64, 64) fp32, ``conv`` (38, 4, 3, 4224),
    ``k``/``v`` (38, 4, 544, 32, 64), ``pos`` (38, 544) int32, as the
    reference's spec; in long mode past the window, 4096 slots."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    spec = transformer.cache_spec(cfg, 4, 544, torch.bfloat16, False)
    jspec = jtrans.cache_spec(jcfg, 4, 544, jnp.bfloat16, False)
    want = {"h": ((38, 4, 64, 64, 64), "float32"),
            "conv": ((38, 4, 3, 4224), "bfloat16"),
            "k": ((38, 4, 544, 32, 64), "bfloat16"),
            "v": ((38, 4, 544, 32, 64), "bfloat16"),
            "pos": ((38, 544), "int32")}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in spec["layers"].items()} == want
    assert {k: (v.shape, str(v.dtype)) for k, v in
            jspec["layers"].items()} == want
    long = transformer.cache_spec(cfg, 1, 4626, torch.bfloat16, True)
    assert long["layers"]["k"].shape[2] == 4096


@settings(max_examples=10, deadline=None, database=None)
@given(S=st.integers(1, 70), long_mode=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_decode_equals_prefill(S, long_mode, seed):
    """fp32: after an S-token prompt (a partial chunk, a padded tail, and
    in long mode a ring past the window), two decode steps within 1e-4
    of the port's own prefill over the tokens so far."""
    _, cfg, _, net = _models(ARCH, "float32")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S + 2)).astype(np.int32))
    _, cache = transformer.prefill(net, {"tokens": toks[:, :S]}, cfg,
                                   long_mode=long_mode)
    cache = serve._grow_cache(cfg, cache, 1, S + 2, long_mode)
    steps, _ = _decode_steps(net, cfg, cache, toks[:, S:], S, long_mode)
    for t, logits in enumerate(steps):
        full, _ = transformer.prefill(net, {"tokens": toks[:, :S + t + 1]},
                                      cfg, long_mode=long_mode)
        assert float(np.abs(_np(logits - full)).max()) <= 1e-4, (S, t)


def test_decode_writes_only_the_flagged_layers_slots():
    """A decode step writes its key into the flagged layers' KV slots
    alone and moves every layer's state; the shared block's weights are
    read, never written."""
    _, cfg, _, net = _models(ARCH, "float32")
    _, tb = _batch(cfg, 2, 10)
    _, cache = transformer.prefill(net, tb, cfg, min_cache_len=12)
    before = {k: v.clone() for k, v in cache["layers"].items()}
    weights = {k: v.clone() for k, v in net.shared_attn.state_dict().items()}
    transformer.decode(net, {"tokens": tb["tokens"][:, :1]}, cache, 10, cfg)
    after = cache["layers"]
    for i in range(cfg.num_layers):
        wrote = not torch.equal(after["k"][i], before["k"][i])
        assert wrote == (i in (1, 3))
        assert int(after["pos"][i, 10]) == (10 if i in (1, 3) else -1)
        assert not torch.equal(after["h"][i], before["h"][i])
    for k, v in net.shared_attn.state_dict().items():
        assert torch.equal(v, weights[k])
