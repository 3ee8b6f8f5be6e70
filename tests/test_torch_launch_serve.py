"""The port's serving path (``repro_torch.launch.serve``,
``repro_torch.train.steps``) against the reference's (``repro.launch.
serve``, ``repro.train.steps``) on the CPU, with the same weights carried
across by ``repro_torch.convert.lm_params_to_torch``.

fp32 compute: logits within atol = rtol = 1e-4 and greedy tokens equal.
bf16 compute: only logits are compared (a last-bit difference may flip a
near-tie), teacher-forced with the reference's tokens, within the bounds
of tests/test_torch_models.py.  Long mode (the windowed variant of gemma2
and gemma3, and zamba2's shared block, window and cache 64 in the reduced
configs) at prompts of 64, 96 and 128: the reference's decode after a prompt longer than the cache
is off unless the prompt is a multiple of it (its prefill keeps the last
keys in slots 0..63, its decode writes position p at slot p mod 64); the
port seats keys at ``pos mod cache_len`` and is held to its own prefill
there.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.configs.base import SHAPES, InputShape
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch import serve
from repro_torch.models import model, transformer
from repro_torch.train import steps
from test_torch_models import (STACKS, _batch, _close, _close_cache,
                               _close_logits, _models, _np)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
LONG = ("gemma2-2b", "gemma3-12b", "zamba2-1.2b")


def _extra(jb, tb):
    return ({k: v for k, v in jb.items() if k != "tokens"},
            {k: v for k, v in tb.items() if k != "tokens"})


@pytest.mark.parametrize("arch", STACKS)
def test_generate_fp32_tokens_equal_the_reference(arch):
    jcfg, cfg, params, net = _models(arch, "float32")
    jb, tb = _batch(cfg, 2, 12)
    jx, tx = _extra(jb, tb)
    want = jserve.generate(jcfg, params, jb["tokens"], 8, extra=jx)
    got = serve.generate(cfg, net, tb["tokens"], 8, extra=tx)
    assert got.shape == (2, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", STACKS)
def test_generate_bf16_logits_match_the_reference(arch):
    """Prefill, the cache re-seated for generation, then 7 decode steps,
    each package fed the reference's greedy tokens."""
    jcfg, cfg, params, net = _models(arch, "bfloat16")
    B, S, n = 2, 12, 8
    jb, tb = _batch(cfg, B, S)
    total = S + n + (cfg.num_prefix_tokens if cfg.frontend == "vision"
                     else 0)
    jl, jcache = jax.jit(jsteps.make_prefill_step(jcfg))(params, jb)
    jcache = jserve._grow_cache(jcfg, jcache, B, total, False)
    tl, cache = steps.make_prefill_step(cfg)(net, tb)
    cache = serve._grow_cache(cfg, cache, B, total, False)
    _close_logits(tl, jl, "bfloat16")
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    dec = steps.make_decode_step(cfg)
    idx = total - n
    for _ in range(n - 1):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jcache, _ = jdec(params, jnp.asarray(tok), jcache,
                             jnp.int32(idx))
        tl, cache, idx = dec(net, torch.from_numpy(tok), cache, idx)
        _close_logits(tl, jl, "bfloat16")
    _close_cache(cache, jcache, "bfloat16")


@pytest.mark.parametrize("arch", LONG)
@pytest.mark.parametrize("S", [64, 96, 128])
def test_long_mode_matches_the_reference(arch, S):
    """Long mode, fp32, batch 1: prefill's logits and cache (sorted by
    position) as the reference's; the next token's decode as a prefill
    over S + 1 tokens; and, where the reference's ring is exact (S a
    multiple of the 64-slot cache), its decode and 8 greedy tokens."""
    jcfg, cfg, params, net = _models(arch, "float32")
    jb, tb = _batch(cfg, 1, S + 1, seed=S)
    jpre, tpre = {"tokens": jb["tokens"][:, :S]}, {"tokens": tb["tokens"][:, :S]}
    jl, jcache = jax.jit(jsteps.make_prefill_step(jcfg, True))(params, jpre)
    tl, cache = steps.make_prefill_step(cfg, True)(net, tpre)
    _close(tl, jl)
    _close_cache(cache, jcache, "float32")
    assert cache["layers"]["k"].shape[2] == 64
    tok = tb["tokens"][:, S:]
    dl, cache, _ = steps.make_decode_step(cfg, True)(net, tok, cache, S)
    full, _ = steps.make_prefill_step(cfg, True)(net, tb)
    _close(dl, full)
    if S % 64 == 0:
        jdl, _, _ = jax.jit(jsteps.make_decode_step(jcfg, True))(
            params, jb["tokens"][:, S:], jcache, jnp.int32(S))
        _close(dl, jdl)
        want = jserve.generate(jcfg, params, jpre["tokens"], 8,
                               long_mode=True)
        got = serve.generate(cfg, net, tpre["tokens"], 8, long_mode=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", LONG)
def test_decode_after_a_long_prompt_equals_prefill(arch):
    """The repaired ring: after a 96-token long-mode prompt (1.5 windows)
    each of 4 decode steps equals a prefill over the tokens so far within
    1e-4, where the reference's own decode is off (by 2.6e-2 on gemma2 at
    the first step, in fp32)."""
    jcfg, cfg, params, net = _models(arch, "float32")
    S, n = 96, 4
    jb, tb = _batch(cfg, 1, S + n, seed=7)
    toks = tb["tokens"]
    _, cache = transformer.prefill(net, {"tokens": toks[:, :S]}, cfg,
                                   long_mode=True)
    cache = serve._grow_cache(cfg, cache, 1, S + n, True)
    for t in range(S, S + n):
        dl, cache = transformer.decode(net, {"tokens": toks[:, t:t + 1]},
                                       cache, t, cfg, long_mode=True)
        full, _ = transformer.prefill(net, {"tokens": toks[:, :t + 1]}, cfg,
                                      long_mode=True)
        assert float((dl - full).abs().max()) <= 1e-4
    # the reference's decode of the first token after the prompt
    _, jcache = jax.jit(jsteps.make_prefill_step(jcfg, True))(
        params, {"tokens": jb["tokens"][:, :S]})
    jdl, _, _ = jax.jit(jsteps.make_decode_step(jcfg, True))(
        params, jb["tokens"][:, S:S + 1], jcache, jnp.int32(S))
    full, _ = transformer.prefill(net, {"tokens": toks[:, :S + 1]}, cfg,
                                  long_mode=True)
    assert float(np.abs(_np(jdl) - _np(full)).max()) > 1e-3


def test_make_step_kinds():
    cfg = configs.get_reduced_config("gemma2-2b")
    net = model.init_params(cfg, 0, device="cpu")
    # train_4k's kind gives the allreduce train step; it takes a step
    train = steps.make_step(cfg, SHAPES["train_4k"])
    state = steps.make_train_state(cfg, 0, device="cpu")
    tb = model.make_inputs(cfg, InputShape("t", 16, 2, "train"), 0,
                           device="cpu")
    state, metrics = train(state, tb)
    assert int(state["opt"].step) == 1
    assert bool(torch.isfinite(metrics["loss"]))
    pre = steps.make_step(cfg, InputShape("p", 16, 2, "prefill"))
    batch = model.make_inputs(cfg, InputShape("p", 16, 2, "prefill"), 0,
                              device="cpu")
    logits, cache = pre(net, batch)
    assert logits.shape == (2, 1, cfg.vocab_size)
    dec = steps.make_step(cfg, InputShape("d", 32, 2, "decode"))
    cache = serve._grow_cache(cfg, cache, 2, 32, False)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    logits, cache, idx = dec(net, tok, cache, 16)
    assert idx == 17 and int(cache["layers"]["pos"][0, 16]) == 16
    assert bool(torch.isfinite(logits).all())
    # long_500k decodes gemma2 in its windowed long-context variant
    inputs = model.make_inputs(cfg, InputShape("long_500k", 512, 1,
                                               "decode"), 0, device="cpu")
    assert inputs["cache"]["layers"]["k"].shape[2] == cfg.long_context_window


def test_generate_sampling_is_seeded_and_vlm_uses_its_prefix():
    cfg = configs.get_reduced_config("internvl2-2b")
    net = model.init_params(cfg, 1, device="cpu")
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                            dtype=torch.int32)
    vis = torch.randn((2, cfg.num_prefix_tokens, cfg.d_model), generator=gen)
    sample = lambda seed: serve.generate(
        cfg, net, prompts, 6, extra={"vision_embeds": vis}, temperature=0.8,
        rng=torch.Generator().manual_seed(seed))
    assert torch.equal(sample(5), sample(5))
    greedy = lambda v: serve.generate(cfg, net, prompts, 4,
                                      extra={"vision_embeds": v})
    a = greedy(vis)
    assert a.shape == (2, 4) and torch.equal(a, greedy(vis))
    assert not torch.equal(a, greedy(vis + 1.0))


def test_device_defaults_to_cuda_and_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = configs.get_reduced_config("gemma2-2b")
    tree = {"embed": np.zeros((cfg.vocab_size, cfg.d_model), np.float32)}
    for call in (lambda: serve.main(["--arch", "gemma2-2b", "--reduced"]),
                 lambda: model.init_params(cfg, 0),
                 lambda: model.make_inputs(cfg, SHAPES["train_4k"], 0),
                 lambda: transformer.cache_init(cfg, 1, 8, "float32", False),
                 lambda: lm_params_to_torch(tree, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    toks = serve.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert toks.shape == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out


# the module's CLI in a fresh interpreter: (arch, prompt length, tokens
# generated) for the vision-prefix, MLA, mamba, hybrid and encoder-decoder
# stacks
CLI = (("internvl2-2b", 8, 3), ("deepseek-v2-236b", 16, 4),
       ("mamba2-130m", 40, 4), ("zamba2-1.2b", 40, 4),
       ("whisper-small", 12, 4))


@pytest.mark.parametrize("arch,prompt_len,gen", CLI,
                         ids=[c[0] for c in CLI])
def test_module_cli_runs_on_the_cpu_without_jax(arch, prompt_len, gen):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu`` in a fresh interpreter, which must not import jax or
    the reference."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import runpy, sys\n"
            f"sys.argv = ['serve', '--arch', '{arch}', '--reduced', "
            f"'--device', 'cpu', '--batch', '2', '--prompt-len', "
            f"'{prompt_len}', '--gen', '{gen}']\n"
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"generated (2, {gen}) on cpu" in proc.stdout
