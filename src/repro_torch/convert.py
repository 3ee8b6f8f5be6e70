"""Carry problems, states and invariants between the two packages.

The reference's ``DTSVMProblem`` / ``DTSVMState`` / ``PlanInvariants``
are NamedTuples of arrays; so are the port's, with the same field names.
``to_torch`` takes any such tuple whose leaves convert to numpy (numpy
arrays, or anything ``np.asarray`` accepts) and returns the port's twin
with tensors on a chosen device, each leaf keeping its dtype.
``to_numpy`` turns a port tuple back into the same tuple of numpy arrays.
Nothing here imports the reference: the twin is found by the class name.

``lm_params_to_torch`` / ``lm_params_to_numpy`` do the same for the
decoder's weights: the reference's parameter pytree (numpy leaves,
``layers`` stacked along a leading L axis, an MoE config's
``dense_layers`` a list, a hybrid config's ``shared_attn`` one layer's
tree, an encoder-decoder's ``encoder.layers`` stacked too) to the port's
``Transformer`` and back, each leaf bitwise; ``lm_grads_to_numpy`` lays
the gradients of a port model out in the same tree, to compare with
``jax.grad``'s leaf by leaf.  ``consensus_state_to_torch`` /
``consensus_state_to_numpy`` carry the consensus trainer's state (every
leaf with a leading replica axis R, a stacked layer's leaf (R, L, ...)
in the reference's tree), so both packages start from the same one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dtsvm as core
from repro_torch.engine import invariants as inv_lib
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.steps import ConsensusTrainState

_TWINS = {cls.__name__: cls for cls in (core.DTSVMProblem, core.DTSVMState,
                                        inv_lib.PlanInvariants)}


def to_torch(tree, device=None):
    """The port's twin of a reference problem, state or invariants tuple,
    on ``device`` (``None`` means ``"cuda"``)."""
    name = type(tree).__name__
    if name not in _TWINS:
        raise TypeError(f"no port twin for {name}; expected one of "
                        f"{sorted(_TWINS)}")
    dev = device_lib.resolve(device)
    cls = _TWINS[name]
    leaf = lambda x: None if x is None else torch.as_tensor(
        np.array(x), device=dev)
    return cls(**{f: leaf(getattr(tree, f)) for f in cls._fields})


def to_numpy(tree):
    """The same tuple with every tensor leaf as a numpy array."""
    leaf = lambda x: None if x is None else x.detach().cpu().numpy()
    return type(tree)(*(leaf(x) for x in tree))


def _put(node: dict, path, leaf) -> None:
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _lists(node):
    """Each dict keyed 0..n-1 (a list index of ``reference_path``) as a
    list, recursively."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def _leaf(params, name: str, axis: int = 0) -> np.ndarray:
    """The reference tree's array for the port's parameter ``name``
    (``transformer.reference_path``); a stacked leaf's layers lie along
    ``axis`` (1 behind a replica axis)."""
    path, row = transformer.reference_path(name)
    src = params
    for key in path:
        src = src[key]
    src = np.asarray(src)
    return src if row is None else np.take(src, row, axis=axis)


def _tree(named, axis: int = 0) -> dict:
    """The reference's tree of ``(parameter name, tensor)`` pairs in the
    model's order: numpy leaves, the stacked ones stacked along L at
    ``axis``."""
    tree: dict = {}
    per_layer: dict = {}
    for name, t in named:
        path, row = transformer.reference_path(name)
        leaf = t.detach().cpu().numpy()
        if row is None:
            _put(tree, path, leaf)
        else:
            per_layer.setdefault(path, []).append(leaf)
    for path, leaves in per_layer.items():
        _put(tree, path, np.stack(leaves, axis=axis))
    return _lists(tree)


def lm_params_to_torch(params, cfg, device=None) -> "transformer.Transformer":
    """The port's ``Transformer`` for ``cfg`` holding the reference's
    parameter pytree ``params`` (``embed``, ``final_norm``, ``head`` where
    the embeddings are untied, ``dense_layers`` (a list) where an MoE
    config has dense leading layers, and ``layers`` stacked over L, MoE
    layers with their ``moe`` and ``moe.shared`` subtrees, an MLA config's
    ``attn`` with ``wdq``, ``q_ln``, ``wuq``, ``wdkv``, ``kv_ln``, ``wuk``,
    ``wuv``, ``wkr`` and ``wo``, a mamba2 layer's ``ln1`` and ``mamba``
    with ``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
    ``dt_bias``, ``norm`` and ``out_proj``, and a hybrid stack's
    ``shared_attn``, one unstacked layer tree, and an encoder-decoder's
    ``encoder`` (``layers`` stacked, ``final_norm``), ``pos_enc`` and
    ``pos_dec``, whose rows the model takes), on ``device`` (``None``
    means ``"cuda"``).  The walk is by parameter name, so every family's
    leaves (``layers.<i>.mamba.in_proj``, ...) cross without a case of
    their own."""
    dev = device_lib.resolve(device)
    rows = np.shape(params["pos_dec"])[0] if cfg.is_encoder_decoder else 0
    model = transformer.Transformer(cfg, dev, max_seq=rows)
    with torch.no_grad():
        for name, t in model.named_parameters():
            src = _leaf(params, name)
            if src.shape != tuple(t.shape):
                raise ValueError(f"{name}: the tree holds {src.shape}, the "
                                 f"model wants {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(src)))
    return model


def lm_params_to_numpy(model) -> dict:
    """The reference's parameter pytree of a port ``Transformer``: numpy
    leaves, ``layers`` (and ``encoder.layers``) stacked along a leading L
    axis, ``dense_layers`` a list of per-layer trees, and every other
    subtree (a hybrid stack's ``shared_attn``) nested as it is."""
    return _tree(model.named_parameters())


def lm_grads_to_numpy(model, grads=None) -> dict:
    """The same tree of one tensor per parameter of ``model``:
    ``grads[name]`` where a mapping by parameter name is given (the
    gradients a train step takes, an optimizer state's ``mu`` or
    ``nu``), else each parameter's ``.grad``; a parameter without one
    gets zeros, as ``jax.grad`` gives an unused leaf."""
    def grad(name, p):
        g = p.grad if grads is None else grads.get(name)
        return torch.zeros_like(p) if g is None else g
    return _tree((n, grad(n, p)) for n, p in model.named_parameters())


def consensus_state_to_torch(ref_state, cfg, device=None):
    """The port's ``ConsensusTrainState`` of a reference one (its
    ``params``, ``opt`` (an AdamWState: ``step`` (R,), ``mu``, ``nu``),
    ``dual`` and ``step``, numpy or anything ``np.asarray`` takes) for
    ``cfg``, on ``device`` (``None`` means ``"cuda"``): each stacked
    mapping keyed in ``transformer.named_leaves`` order, every leaf
    bitwise; ``step`` a 0-d int32 CPU tensor, as the port keeps it."""
    dev = device_lib.resolve(device)
    rows = np.shape(ref_state.params["pos_dec"])[1] \
        if cfg.is_encoder_decoder else 0
    names = list(transformer.named_leaves(
        transformer.Transformer(cfg, "meta", max_seq=rows)))

    def stacked(tree):
        return {n: torch.from_numpy(np.array(_leaf(tree, n, axis=1))).to(dev)
                for n in names}
    opt = ref_state.opt
    return ConsensusTrainState(
        params=stacked(ref_state.params),
        opt=AdamWState(step=torch.from_numpy(np.array(opt.step)).to(dev),
                       mu=stacked(opt.mu), nu=stacked(opt.nu)),
        dual=stacked(ref_state.dual),
        step=torch.from_numpy(np.array(ref_state.step)))


def consensus_state_to_numpy(state):
    """The same ``ConsensusTrainState`` with each stacked mapping as the
    reference's tree (numpy leaves (R, ...), a stacked layer's leaves
    (R, L, ...)), the optimizer an ``AdamWState`` of numpy leaves and
    trees, ``step`` numpy: the reference's ``ConsensusTrainState(*out)``
    with ``AdamWState(*out.opt)`` takes it."""
    tree = lambda m: _tree(m.items(), axis=1)
    opt = state.opt
    return type(state)(
        params=tree(state.params),
        opt=type(opt)(step=opt.step.detach().cpu().numpy(),
                      mu=tree(opt.mu), nu=tree(opt.nu)),
        dual=tree(state.dual),
        step=state.step.detach().cpu().numpy())
