"""Step functions: the allreduce train step, prefill and decode (twin of
``repro/train/steps.py`` less its ADMM-consensus step, which comes with
ROADMAP queue 1, item 9's training slice (b)).

The steps are plain functions: eager PyTorch has no ``jit`` to wrap them
in.  A train state is ``{"params": Transformer, "opt": AdamWState}``, the
optimizer's moments keyed by parameter name in the reference's leaf
order (``transformer.named_leaves``).  One card holds the whole batch, so
the reference's implicit data-parallel gradient mean is the gradient of
the mean loss itself, and ``grad_specs`` (a sharding constraint) has no
meaning here: only ``None`` is accepted.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm


# ===========================================================================
# standard (allreduce) training
# ===========================================================================
def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01):
    return adamw(lr, weight_decay=weight_decay)


def make_train_state(cfg: ModelConfig, rng, shape: InputShape = None,
                     lr: float = 3e-4, device=None) -> Dict:
    """Fresh parameters (``model.init_params`` on ``device``, ``None``
    meaning ``"cuda"``) and the optimizer's state over them."""
    params = model_lib.init_params(cfg, rng, shape, device=device)
    opt = make_optimizer(lr)
    return {"params": params,
            "opt": opt.init(transformer.named_leaves(params))}


def train_state_specs(cfg: ModelConfig, shape: InputShape = None) -> Dict:
    """The train state on the meta device: shapes and dtypes only."""
    params = model_lib.param_specs(cfg, shape)
    return {"params": params,
            "opt": make_optimizer().init(transformer.named_leaves(params))}


def _value_and_grad(loss_fn, params, leaves, batch):
    """The loss and its gradient per leaf (zeros for a leaf the loss does
    not reach, as ``jax.value_and_grad`` gives)."""
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {
        name: torch.zeros_like(p) if g is None else g
        for (name, p), g in zip(leaves.items(), grads, strict=True)}


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    long_mode: bool = False, clip: float = 1.0,
                    microbatch: int = 0, grad_specs=None):
    """A step over (state, batch) -> (state, {"loss", "grad_norm"}).

    ``microbatch > 1`` splits the batch into that many chunks and
    accumulates their gradients in fp32 (the reference's lax.scan), then
    divides the sum and the loss by ``microbatch``: the activations of
    one chunk at a time.  The state passed in is consumed: its
    parameters and moments are updated in place and belong to the state
    returned."""
    if grad_specs is not None:
        raise ValueError("grad_specs constrains the gradients' sharding over "
                         "a mesh; one card has none")
    opt = make_optimizer(lr)

    def loss_fn(params, batch):
        _, loss = transformer.forward_train(params, batch, cfg,
                                            long_mode=long_mode)
        return loss

    def train_step(state, batch):
        params = state["params"]
        leaves = transformer.named_leaves(params)
        if microbatch > 1:
            B = batch["tokens"].shape[0]
            assert B % microbatch == 0, (B, microbatch)
            chunks = {k: v.reshape((microbatch, B // microbatch)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in leaves.items()}
            for i in range(microbatch):
                mb = {k: v[i] for k, v in chunks.items()}
                loss_i, g = _value_and_grad(loss_fn, params, leaves, mb)
                for n, acc in grads.items():
                    acc.add_(g[n].float())
                loss = loss + loss_i
            loss = loss / microbatch
            for g in grads.values():
                g.div_(microbatch)
        else:
            loss, grads = _value_and_grad(loss_fn, params, leaves, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        updates, opt_state = opt.update(grads, state["opt"], leaves)
        apply_updates(leaves, updates)
        return ({"params": params, "opt": opt_state},
                {"loss": loss, "grad_norm": gnorm})

    return train_step


# ===========================================================================
# serving steps
# ===========================================================================
def make_prefill_step(cfg: ModelConfig, long_mode: bool = False):
    def prefill_step(params, batch):
        return transformer.prefill(params, batch, cfg, long_mode=long_mode)
    return prefill_step


def make_decode_step(cfg: ModelConfig, long_mode: bool = False):
    def decode_step(params, tokens, cache, cache_index):
        logits, new_cache = transformer.decode(
            params, {"tokens": tokens}, cache, cache_index, cfg,
            long_mode=long_mode)
        return logits, new_cache, cache_index + 1
    return decode_step


def make_step(cfg: ModelConfig, shape: InputShape, **kw):
    """Step factory keyed on the workload's step kind."""
    long_mode = model_lib.use_long_mode(cfg, shape)
    if shape.step_kind == "train":
        return make_train_step(cfg, long_mode=long_mode, **kw)
    if shape.step_kind == "prefill":
        return make_prefill_step(cfg, long_mode=long_mode)
    if shape.step_kind == "decode":
        return make_decode_step(cfg, long_mode=long_mode)
    raise ValueError(shape.step_kind)
