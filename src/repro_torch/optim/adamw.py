"""Minimal optimizer library: AdamW, SGD and a cosine schedule (twin of
``repro/optim/adamw.py``).

The reference's functional API: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``.  ``params``, ``grads`` and ``updates`` are mappings
from parameter name to tensor; a state's ``mu``/``nu`` are dicts keyed
the same, in the order of ``params`` (``transformer.named_leaves``
gives the reference's leaf order, by which a checkpoint re-seats the
state).  ``step`` is an int32 tensor on the parameters' device, so an
update enqueues device work only.

Kept exactly as the reference has them (``torch.optim.AdamW`` differs
in each): ``b2 = 0.95``; the moments in fp32 whatever the leaf's dtype;
the bias corrections in fp32 from the int32 step; weight decay added to
the update of every leaf, norms and biases included; each update cast
to its leaf's dtype before it is applied.

Unlike the reference's, ``update`` consumes the state it is given: its
``mu``/``nu`` tensors are updated in place and become the returned
state's (its ``step`` is left as it was).  ``apply_updates`` adds in
place, under ``torch.no_grad``, and returns the same mapping.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _step0(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> AdamWState:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in params.items()}
        return AdamWState(step=_step0(params), mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        step = state.step + 1
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        updates = {}
        for name, p in params.items():
            g = grads[name].float()
            m = state.mu[name].mul_(b1).add_(g, alpha=1 - b1)
            v = state.nu[name].mul_(b2).add_(g.square(), alpha=1 - b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            updates[name] = (-lr_t * u).to(p.dtype)
        return updates, AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update)


class SGDState(NamedTuple):
    step: torch.Tensor


def sgd(lr) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> SGDState:
        return SGDState(step=_step0(params))

    @torch.no_grad()
    def update(grads: Tree, state: SGDState, params: Tree
               ) -> Tuple[Dict[str, torch.Tensor], SGDState]:
        step = state.step + 1
        lr_t = lr_fn(step)
        updates = {n: (-lr_t * grads[n]).to(p.dtype)
                   for n, p in params.items()}
        return updates, SGDState(step=step)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p += u`` for every leaf, in place (the module doc)."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))
    return params


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def global_norm(tree: Tree) -> torch.Tensor:
    """The fp32 norm over every leaf, the leaves' sums added in order."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The leaves scaled by min(1, max_norm / (norm + 1e-9)), new tensors,
    and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm
