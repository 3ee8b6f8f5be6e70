"""Whisper's encoder-decoder in the port (``repro_torch.models.transformer``:
the bidirectional encoder over stub frames, the learned position tables,
cross attention and its ``xk``/``xv`` cache) against the reference's
(``repro.models.transformer``) on the CPU.

The reduced whisper: 2 encoder and 2 decoder layers, d_model 256, 4
heads of 64 (MHA), d_ff 512 with an ungated tanh-GELU, 32 stub frames,
vocab 512 with a tied head.  The weights are the reference's, carried
across with ``repro_torch.convert.lm_params_to_torch``.  Tolerances are
tests/test_torch_models.py's: fp32 within atol = rtol = 1e-4, bf16 within
3e-2 (the stack's logits with its spread-scaled atol, and its rule for a
cache entry with two or more layers below it); a decode step held to the
port's own prefill over the same tokens within 1e-4 in fp32.

Two reference behaviours the port refuses (ROADMAP queue 3), each shown
here on the reference too: frames shorter than ``encoder_seq`` leave a
cross cache that ``_grow_cache`` pads with zero keys, so the reference's
decode is off its own prefill; and a one-row ``pos_dec`` broadcasts over
every token of a longer prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import transformer as jtrans
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import lm_params_to_numpy, lm_params_to_torch
from repro_torch.launch import serve
from repro_torch.models import model, transformer
from test_torch_models import (DTYPES, TDT, _batch, _close,
                               _close_cache, _close_logits, _jdecode,
                               _jprefill, _models, _normal, _pair)

ARCH = "whisper-small"
_jencode = jax.jit(jtrans._encode, static_argnames=("cfg",))


def _leaf_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def _table_models(rows: int, dtype: str = "float32"):
    """Both packages' reduced whisper with a ``rows``-row ``pos_dec``: the
    reference's init at ``max_seq=rows`` and the port holding it."""
    jcfg = jconfigs.get_reduced_config(ARCH).replace(compute_dtype=dtype)
    cfg = configs.get_reduced_config(ARCH).replace(compute_dtype=dtype)
    params = jtrans.init_params(jcfg, jax.random.key(4), max_seq=rows)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, lm_params_to_torch(tree, cfg, device="cpu")


def _decode_steps(net, cfg, cache, tokens, start):
    """Decode ``tokens`` (B, n) one at a time from position ``start``;
    returns each step's logits and the cache."""
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = transformer.decode(
            net, {"tokens": tokens[:, t:t + 1]}, cache, start + t, cfg)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("rows", [1, 8, 4096])
def test_convert_round_trip_keeps_the_encoder_and_both_tables(rows):
    """The reference's tree crosses to the port and back leaf for leaf:
    ``encoder.layers`` stacked over the encoder's layers, its
    ``final_norm``, the decoder layers' ``ln_x`` and ``cross``, and both
    position tables, ``pos_dec`` with the tree's row count."""
    jcfg, cfg, params, net = _table_models(rows)
    want = jax.tree.map(np.asarray, params)
    tree = lm_params_to_numpy(net)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert tree["pos_dec"].shape == (rows, cfg.d_model)
    assert tree["pos_enc"].shape == (cfg.encoder_seq, cfg.d_model)
    assert tree["encoder"]["layers"]["attn"]["wq"].shape[0] == \
        cfg.num_encoder_layers
    assert set(tree["layers"]) == {"ln1", "attn", "ln_x", "cross", "ln2",
                                   "mlp"}
    assert "cross" not in tree["encoder"]["layers"]
    assert sum(p.numel() for p in net.parameters()) == _leaf_count(want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_the_reference(dtype):
    """The bidirectional, RoPE-free encoder over the frames and
    ``pos_enc``, then its final norm."""
    jcfg, cfg, params, net = _models(ARCH, dtype)
    rng = np.random.default_rng(2)
    jf, tf = _pair(_normal(rng, 2, cfg.encoder_seq, cfg.d_model), dtype)
    got = transformer._encode(net, tf, cfg)
    assert got.shape == tf.shape and got.dtype == TDT[dtype]
    _close(got, _jencode(params, jf, jcfg), dtype)
    # bidirectional: the last frame reaches the first position's output
    moved = tf.clone()
    moved[:, -1] += 1.0
    assert not torch.allclose(transformer._encode(net, moved, cfg)[:, 0],
                              got[:, 0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_four_decode_steps_match_the_reference(dtype):
    """Prefill's logits and caches (``k``/``v``/``pos`` sorted by position,
    ``xk``/``xv`` as they are), then four decode steps' logits and the
    caches after them."""
    jcfg, cfg, params, net = _models(ARCH, dtype)
    jb, tb = _batch(cfg, 2, 10, seed=3)
    got, cache = transformer.prefill(net, tb, cfg, min_cache_len=16)
    want, jcache = _jprefill(params, jb, jcfg, min_cache_len=16)
    _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)
    assert cache["layers"]["xk"].shape == (cfg.num_layers, 2,
                                           cfg.encoder_seq,
                                           cfg.num_kv_heads, cfg.head_dim)
    assert cache["layers"]["xk"].dtype == TDT[dtype]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 4)).astype(np.int32)
    outs, cache = _decode_steps(net, cfg, cache, torch.from_numpy(toks), 10)
    for t, got in enumerate(outs):
        want, jcache = _jdecode(params, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, jcache, jnp.int32(10 + t), jcfg)
        _close_logits(got, want, dtype)
    _close_cache(cache, jcache, dtype)


def test_decode_at_and_past_the_last_table_row():
    """An 8-row ``pos_dec``: decode at position 7 reads the last row, at 8
    and 9 the reference's clamp reads it again; each step's logits and
    the caches as the reference's."""
    jcfg, cfg, params, net = _table_models(8)
    jb, tb = _batch(cfg, 2, 6, seed=5)
    _, cache = transformer.prefill(net, tb, cfg, min_cache_len=12)
    _, jcache = _jprefill(params, jb, jcfg, min_cache_len=12)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (2, 4)).astype(np.int32)
    outs, cache = _decode_steps(net, cfg, cache, torch.from_numpy(toks), 6)
    for t, got in enumerate(outs):
        want, jcache = _jdecode(params, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, jcache, jnp.int32(6 + t), jcfg)
        _close(got, want)
    _close_cache(cache, jcache, "float32")


def test_frames_of_another_length_raise():
    """The port's prefill takes only (B, encoder_seq, d_model) frames.  The
    reference's takes 16 of 32, and its decode after ``_grow_cache`` pads
    the cross cache with zero keys is then off its own prefill (within
    1e-4 with 32 frames)."""
    jcfg, cfg, params, net = _models(ARCH, "float32")
    for n in (16, 40):
        _, tb = _batch(cfg.replace(encoder_seq=n), 2, 6)
        with pytest.raises(ValueError, match="frames of shape"):
            transformer.prefill(net, tb, cfg)
    _, tb = _batch(cfg, 2, 6)
    bad = dict(tb, frames=tb["frames"][:1])
    with pytest.raises(ValueError, match="frames of shape"):
        transformer.prefill(net, bad, cfg)

    gaps = {}
    for n in (16, cfg.encoder_seq):
        jb, _ = _batch(jcfg.replace(encoder_seq=n), 2, 7, seed=7)
        pre = {"tokens": jb["tokens"][:, :6], "frames": jb["frames"]}
        _, jcache = _jprefill(params, pre, jcfg)
        assert jcache["layers"]["xk"].shape[2] == n
        jcache = jserve._grow_cache(jcfg, jcache, 2, 7, False)
        assert jcache["layers"]["xk"].shape[2] == cfg.encoder_seq
        got, _ = _jdecode(params, {"tokens": jb["tokens"][:, 6:]}, jcache,
                          jnp.int32(6), jcfg)
        full, _ = _jprefill(params, jb, jcfg)
        gaps[n] = float(jnp.abs(got - full).max())
    assert gaps[cfg.encoder_seq] <= 1e-4 and gaps[16] > 1e-2, gaps


def test_a_prompt_longer_than_the_table_raises():
    """A 6-token prompt over a 1-row and a 3-row ``pos_dec``: the port's
    prefill raises for both; the reference's broadcasts the one row over
    every token (and raises only for 3 rows)."""
    for rows in (1, 3):
        jcfg, cfg, params, net = _table_models(rows)
        jb, tb = _batch(cfg, 2, 6)
        with pytest.raises(ValueError, match="position table holds"):
            transformer.prefill(net, tb, cfg)
        if rows == 1:
            logits, _ = jtrans.prefill(params, jb, jcfg)
            assert bool(jnp.isfinite(logits).all())
        else:
            with pytest.raises(ValueError):
                jtrans.prefill(params, jb, jcfg)
    # a prompt that fills the table exactly runs
    jcfg, cfg, params, net = _table_models(6)
    jb, tb = _batch(cfg, 2, 6)
    _close(transformer.prefill(net, tb, cfg)[0],
           _jprefill(params, jb, jcfg)[0])


def test_cache_spec_at_full_size():
    """whisper-small's decode cache on meta against the reference's spec:
    ``k``/``v`` (12, 4, 448, 12, 64), ``xk``/``xv`` (12, 4, 1500, 12, 64),
    ``pos`` (12, 448); nothing allocated."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    spec = transformer.cache_spec(cfg, 4, 448, torch.bfloat16, False)
    jspec = jtrans.cache_spec(jcfg, 4, 448, jnp.bfloat16, False)
    assert set(spec) == set(jspec) == {"layers"}
    assert set(spec["layers"]) == set(jspec["layers"]) == {
        "k", "v", "pos", "xk", "xv"}
    for name, s in spec["layers"].items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == jspec["layers"][name].shape
        assert str(s.dtype).split(".")[-1] == str(jspec["layers"][name].dtype)
    assert tuple(spec["layers"]["xk"].shape) == (12, 4, 1500, 12, 64)
    assert tuple(spec["layers"]["k"].shape) == (12, 4, 448, 12, 64)


def test_pos_dec_rows_follow_the_shape():
    """``model.init_params`` sizes ``pos_dec`` as the reference's does:
    ``max_positions(cfg, shape)`` rows, or 4096 without a shape; at
    whisper-small's 448 the model holds 239,562,240 parameters, the
    reference's leaf count."""
    red = configs.get_reduced_config(ARCH)
    shape = base.InputShape("serve", 24, 2, "prefill")
    assert model.init_params(red, 0, shape, device="cpu").pos_dec.shape == \
        (24, red.d_model)
    assert model.init_params(red, 0, device="cpu").pos_dec.shape == \
        (4096, red.d_model)
    assert model.param_specs(red).pos_dec.shape == (4096, red.d_model)
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    full = base.InputShape("serve", 448, 4, "prefill")
    jfull = jbase.InputShape("serve", 448, 4, "prefill")
    net = model.param_specs(cfg, full)
    assert net.pos_dec.shape == (448, cfg.d_model)
    n = sum(p.numel() for p in net.parameters())
    assert n == _leaf_count(jmodel.param_specs(jcfg, jfull)) == 239_562_240
    # the config's count, plus both tables, the 12 ln_x and the two
    # final norms
    assert n == cfg.param_count() + (448 + 1500) * 768 + 12 * 768 + 2 * 768


def test_grow_cache_carries_the_cross_cache_whole():
    """``_grow_cache`` grows the KV slots and carries ``xk``/``xv`` as they
    are; four decode steps then equal a prefill over the tokens so far
    (fp32, within 1e-4), and no step writes ``xk``/``xv``."""
    _, cfg, _, net = _models(ARCH, "float32")
    _, tb = _batch(cfg, 2, 12, seed=8)
    toks, frames = tb["tokens"], tb["frames"]
    _, cache = transformer.prefill(net, {"tokens": toks[:, :8],
                                         "frames": frames}, cfg)
    grown = serve._grow_cache(cfg, cache, 2, 12, False)
    assert grown["layers"]["k"].shape[2] == 12
    for name in ("xk", "xv"):
        assert torch.equal(grown["layers"][name], cache["layers"][name])
    before = {n: grown["layers"][n].clone() for n in ("xk", "xv")}
    outs, grown = _decode_steps(net, cfg, grown, toks[:, 8:], 8)
    for t, got in enumerate(outs):
        full, _ = transformer.prefill(
            net, {"tokens": toks[:, :9 + t], "frames": frames}, cfg)
        assert float((got - full).abs().max()) <= 1e-4
    for name, t in before.items():
        assert torch.equal(grown["layers"][name], t)


def test_generate_with_frames_equals_the_reference():
    """``generate`` over the reduced whisper with a 448-row table: the
    greedy tokens of the reference's, fp32."""
    jcfg, cfg, params, net = _table_models(448)
    jb, tb = _batch(cfg, 2, 12, seed=9)
    want = jserve.generate(jcfg, params, jb["tokens"], 6,
                           extra={"frames": jb["frames"]})
    got = serve.generate(cfg, net, tb["tokens"], 6,
                         extra={"frames": tb["frames"]})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
