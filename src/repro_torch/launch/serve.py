"""Serving entry point: batched prefill + decode loop with the ring KV cache
(twin of ``repro/launch/serve.py``).

Greedy-decodes synthetic prompts for a selectable architecture of the
decoder family, dense or mixture-of-experts, with grouped-query or
latent attention, Mamba2's attention-free stack, whose recurrent state
and conv window are the same size at every length, Zamba2's hybrid
stack, which adds a KV slot to every layer for its shared attention
block, or Whisper's encoder-decoder over random stub frames, whose
cross K/V the prefill caches (reduced configs run on the CPU).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --batch 4 --prompt-len 64 --gen 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small

``--device`` defaults to the card (``cuda``) and raises without one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype
from repro_torch.train import steps as steps_lib


def _next_token(logits, temperature: float, rng):
    if temperature > 0 and rng is not None:
        probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng).to(torch.int32)
    # torch.argmax picks the first maximum, as jnp.argmax does
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


@torch.no_grad()
def generate(cfg, params, prompts, gen_len: int, extra=None,
             long_mode: bool = False, temperature: float = 0.0, rng=None):
    """prompts: (B, S) int32 on the parameters' device -> (B, gen_len)
    greedy (or, with ``temperature > 0`` and a ``torch.Generator``,
    sampled) continuation.  The reference also decodes the last token,
    whose logits it drops; the port stops after the last token it keeps."""
    B, S = prompts.shape
    n_prefix = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    total = S + gen_len + n_prefix
    prefill = steps_lib.make_prefill_step(cfg, long_mode)
    decode = steps_lib.make_decode_step(cfg, long_mode)

    batch = {"tokens": prompts}
    if extra:
        batch.update(extra)
    logits, cache = prefill(params, batch)
    # grow the cache to cover generation
    cache = _grow_cache(cfg, cache, B, total, long_mode)
    idx = S + n_prefix

    out = []
    tok = _next_token(logits, temperature, rng)
    for i in range(gen_len):
        out.append(tok)
        if i + 1 < gen_len:
            logits, cache, idx = decode(params, tok, cache, idx)
            tok = _next_token(logits, temperature, rng)
    return torch.cat(out, dim=1)


def _grow_cache(cfg, cache, batch, total_len, long_mode):
    """Re-seat a prefill cache into a buffer sized for prefill+generation
    (kept as it is where the sizes already agree, as a mamba stack's
    always do): the stacked layers' and, in an MoE config with dense
    leading layers, each of theirs.  A hybrid stack's KV slots grow, its
    mamba state and window are carried whole, as are an encoder-decoder's
    cross ``xk``/``xv``, which prefill fills to the spec's shape."""
    dtype = torch_dtype(cfg.compute_dtype)
    spec = transformer.cache_spec(cfg, batch, total_len, dtype, long_mode)
    layer_caches = lambda c: [c["layers"], *c.get("dense", ())]
    if all(want[k].shape == got.shape
           for want, have in zip(layer_caches(spec), layer_caches(cache))
           for k, got in have.items()):
        return cache
    device = next(iter(cache["layers"].values())).device
    target = transformer.cache_init(cfg, batch, total_len, dtype, long_mode,
                                    device=device)
    for dst_layer, src_layer in zip(layer_caches(target),
                                    layer_caches(cache), strict=True):
        for name, src in src_layer.items():
            # KV caches grow along the slot axis; copy the prefix
            dst_layer[name][tuple(slice(0, s) for s in src.shape)] = src
    return target


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shape = InputShape("serve", args.prompt_len + args.gen, args.batch,
                       "prefill")
    params = model_lib.init_params(cfg, gen, shape, device=dev)

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32, device=dev)
    extra = {}
    if cfg.frontend == "vision":
        extra["vision_embeds"] = torch.randn(
            (args.batch, cfg.num_prefix_tokens, cfg.d_model), generator=gen,
            dtype=torch_dtype(cfg.compute_dtype), device=dev)
    if cfg.frontend == "audio":
        extra["frames"] = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            dtype=torch_dtype(cfg.compute_dtype), device=dev)

    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen, extra=extra,
                    temperature=args.temperature, rng=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} on {dev.type} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
