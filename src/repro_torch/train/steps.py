"""Step functions: train (allreduce | ADMM-consensus), prefill and decode
(twin of ``repro/train/steps.py``).

The steps are plain functions: eager PyTorch has no ``jit`` to wrap them
in.  A train state is ``{"params": Transformer, "opt": AdamWState}``, the
optimizer's moments keyed by parameter name in the reference's leaf
order (``transformer.named_leaves``).  One card holds the whole batch, so
the reference's implicit data-parallel gradient mean is the gradient of
the mean loss itself, and ``grad_specs`` (a sharding constraint) has no
meaning here: only ``None`` is accepted.

The ADMM-consensus step (the paper's technique, ``repro_torch.core.
consensus``) keeps R replicas on the one card.  The reference shards a
leading replica axis over the ``data`` mesh axis; here that axis stays
on the card: ``ConsensusTrainState.params`` and ``.dual`` map each
parameter name (``named_leaves`` order) to an (R, ...) stack, the
optimizer's moments are stacked the same way and its ``step`` is (R,).
Replica r reads rows [r B/R, (r+1) B/R) of the batch, as ``P("data")``
gives its shard, and its forward and backward run on a ``Transformer``
whose parameters alias row r of the stacks.  The ring's exchange is two
rolls of the replica axis.  ``ConsensusTrainState.step`` is a 0-d int32
tensor on the CPU, so the ``every > 1`` branch reads it without waiting
for the card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import consensus as consensus_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               clip_by_global_norm_)
from repro_torch.optim.adamw import AdamWState


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
# ADMM-consensus training (the paper's technique, generalized)
# ===========================================================================
class ConsensusTrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # name -> (R, ...) replicas
    opt: AdamWState                   # step (R,), mu / nu stacked
    dual: Dict[str, torch.Tensor]     # beta_v, fp32, stacked
    step: torch.Tensor                # 0-d int32 on the CPU


def _consensus_state(model, replicas: int) -> ConsensusTrainState:
    """R identical copies of ``model``'s parameters, on its device, and
    zero moments and duals beside them."""
    params = {n: p.detach().unsqueeze(0).expand(
        (replicas,) + tuple(p.shape)).clone()
        for n, p in transformer.named_leaves(model).items()}
    opt = make_optimizer().init(params)
    dev = next(iter(params.values())).device
    return ConsensusTrainState(
        params=params,
        opt=opt._replace(step=torch.zeros((replicas,), dtype=torch.int32,
                                          device=dev)),
        dual=consensus_lib.init_state(params).dual,
        step=torch.zeros((), dtype=torch.int32))


def make_consensus_train_state(cfg: ModelConfig, rng, replicas: int,
                               shape: InputShape = None, lr: float = 3e-4,
                               device=None) -> ConsensusTrainState:
    """``replicas`` identical copies of ``model.init_params(cfg, rng,
    shape)`` on ``device`` (``None`` meaning ``"cuda"``), the reference's
    state with its ``data`` mesh axis as the leading replica axis (``lr``
    is the reference's argument; the fresh state does not depend on
    it)."""
    return _consensus_state(
        model_lib.init_params(cfg, rng, shape, device=device), replicas)


def consensus_state_specs(cfg: ModelConfig, replicas: int,
                          shape: InputShape = None) -> ConsensusTrainState:
    """The consensus state on the meta device: shapes and dtypes only (its
    ``step`` a 0-d CPU tensor, as the live state's)."""
    return _consensus_state(model_lib.param_specs(cfg, shape), replicas)


def _replica(cfg: ModelConfig, params, r: int) -> transformer.Transformer:
    """A ``Transformer`` whose parameters alias row r of the stacks: its
    gradients are replica r's, and an in-place update of a stack is the
    replica's."""
    rows = params["pos_dec"].shape[1] if "pos_dec" in params else 0
    net = transformer.Transformer(cfg, "meta", max_seq=rows)
    names = set(dict(net.named_parameters()))
    if names != set(params):
        raise ValueError(f"the stacks do not hold {cfg.name}'s parameters: "
                         f"{sorted(names ^ set(params))[:4]}")
    for name, stacked in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(net.get_submodule(owner), leaf, nn.Parameter(stacked[r]))
    return net


def consensus_exchange(grads: Dict[str, torch.Tensor], params,
                       dual: Dict[str, torch.Tensor], step: torch.Tensor,
                       ccfg: consensus_lib.ConsensusConfig) -> None:
    """The consensus round over every replica, one leaf at a time, inside
    a ``consensus_round`` profiler range: each entry of ``grads`` and
    ``dual`` is replaced by its augmented gradient and its new dual, both
    read from ``params`` as given (none of whose replicas may have
    stepped yet); ``params`` is left as it is."""
    with torch.profiler.record_function("consensus_round"):
        for n in grads:
            g, cs = consensus_lib.consensus_round(
                {n: grads[n]}, {n: params[n]},
                consensus_lib.ConsensusState({n: dual[n]}, step), ccfg)
            grads[n], dual[n] = g[n], cs.dual[n]


def make_consensus_train_step(cfg: ModelConfig, replicas: int,
                              ccfg: consensus_lib.ConsensusConfig = None,
                              lr: float = 3e-4, long_mode: bool = False,
                              clip: float = 1.0, batch_spec=None):
    """A step over (ConsensusTrainState, batch) -> (state, {"loss",
    "grad_norm", "consensus_gap"}).

    Per replica, as the reference's shard does: the forward and backward
    on its rows, its gradients clipped by their own global norm, then
    the consensus round (ring sums, augmented gradients, dual), AdamW
    and the update.  Every replica's neighbour sums, augmented gradients
    and dual, and AdamW's weight decay, read the pre-step parameters:
    the round runs over all R replicas, one leaf at a time, before any
    replica's update.  The gradients accumulate in place into one fp32
    stack, and the clip and the round rewrite it leaf by leaf, so no
    second stacked copy exists.

    ``loss`` is the replicas' mean (the reference's ``pmean``).
    ``grad_norm`` and ``consensus_gap`` are replica 0's: the reference
    returns each shard's own value under ``out_specs=P()`` and a caller
    reads device 0's.  The state passed in is consumed (its stacks are
    updated in place).  ``batch_spec`` other than None raises
    ``ValueError``: one card has no mesh to shard the batch over.
    """
    if batch_spec is not None:
        raise ValueError("batch_spec shards the batch over a mesh; one card "
                         "has none (replica r takes rows [r B/R, (r+1) B/R))")
    ccfg = ccfg or consensus_lib.ConsensusConfig()
    opt = make_optimizer(lr)
    R = replicas

    def consensus_step(state: ConsensusTrainState, batch):
        B = batch["tokens"].shape[0]
        if B % R:
            raise ValueError(f"the batch's {B} rows do not split over "
                             f"{R} replicas")
        rows = B // R
        params = state.params
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, norms = [], []
        for r in range(R):
            net = _replica(cfg, params, r)
            for name, p in net.named_parameters():
                p.grad = grads[name][r]      # backward adds in place
            _, loss = transformer.forward_train(
                net, {k: v[r * rows:(r + 1) * rows]
                      for k, v in batch.items()}, cfg, long_mode=long_mode)
            loss.backward()
            losses.append(loss.detach())
            norms.append(clip_by_global_norm_(
                {n: g[r] for n, g in grads.items()}, clip))
        del net

        dual = dict(state.dual)
        # repro: noqa[host-sync-in-hot-path] — state.step is a 0-d CPU tensor (module doc): reading it waits for no card
        if ccfg.every <= 1 or int(state.step) % ccfg.every == 0:
            consensus_exchange(grads, params, dual, state.step, ccfg)

        steps = []
        for r in range(R):
            row = {n: p[r] for n, p in params.items()}
            updates, rs = opt.update(
                {n: g[r] for n, g in grads.items()},
                AdamWState(state.opt.step[r],
                           {n: m[r] for n, m in state.opt.mu.items()},
                           {n: v[r] for n, v in state.opt.nu.items()}), row)
            apply_updates(row, updates)
            del updates
            steps.append(rs.step)
        gap = consensus_lib.consensus_gap(params)
        new_state = ConsensusTrainState(
            params=params,
            opt=AdamWState(torch.stack(steps), state.opt.mu, state.opt.nu),
            dual=dual, step=state.step + 1)
        return new_state, {"loss": torch.stack(losses).mean(),
                           "grad_norm": norms[0], "consensus_gap": gap[0]}

    return consensus_step


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
