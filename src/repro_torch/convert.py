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
``jax.grad``'s leaf by leaf.  ``train_state_to_numpy`` lays either
trainer's state out as the reference's tree: the allreduce state's
(``mu`` and ``nu`` in the parameters' tree) and the consensus one's
(every leaf with a leading replica axis R, a stacked layer's leaf
(R, L, ...)).  ``train_state_to_torch`` and ``consensus_state_to_torch``
carry the reference's states back, so both packages start from the
same one.
``restore_train_state_`` re-seats a checkpoint of either state into a
live one by the reference's leaf order, as ``launch/train.py`` resumes.
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


class _Slot:
    """The port tensors behind one leaf of the reference's tree: one, or
    a stacked leaf's layers in order along ``axis``."""

    def __init__(self, tensors, axis=None):
        self.tensors, self.axis = list(tensors), axis

    def numpy(self) -> np.ndarray:
        """The leaf as one numpy array: a stacked leaf's layers stacked
        where they live, then copied to the host once."""
        if self.axis is None:
            return self.tensors[0].detach().cpu().numpy()
        with torch.no_grad():
            return torch.stack(self.tensors, self.axis).cpu().numpy()


def _slots(named, axis: int = 0) -> dict:
    """The reference's tree over ``(parameter name, tensor)`` pairs in
    the model's order, a ``_Slot`` at each leaf (a stacked leaf's layers
    along ``axis``)."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in named:
        path, row = transformer.reference_path(name)
        if row is None:
            _put(tree, path, _Slot([t]))
        elif path in stacked:
            stacked[path].tensors.append(t)
        else:
            stacked[path] = _Slot([t], axis)
            _put(tree, path, stacked[path])
    return _lists(tree)


def _map(fn, tree):
    """``fn`` over a tree's leaves, keeping its dicts, lists and tuples
    (NamedTuples keep their class)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def _flatten(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, list and
    tuple entries in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _tree(named, axis: int = 0) -> dict:
    """The reference's tree of ``(parameter name, tensor)`` pairs in the
    model's order: numpy leaves, the stacked ones stacked along L at
    ``axis``."""
    return _map(_Slot.numpy, _slots(named, axis))


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


def _state_slots(state):
    """A train state's tree in the reference's layout with a ``_Slot`` at
    each leaf: ``{"params", "opt": AdamWState}`` for the allreduce state,
    ``ConsensusTrainState(params, opt, dual, step)`` (every stacked leaf
    (R, L, ...)) for the consensus one."""
    opt = state.opt if isinstance(state, ConsensusTrainState) \
        else state["opt"]
    axis = 1 if isinstance(state, ConsensusTrainState) else 0
    tree = lambda m: _slots(m.items(), axis)
    slots_opt = type(opt)(step=_Slot([opt.step]), mu=tree(opt.mu),
                          nu=tree(opt.nu))
    if isinstance(state, ConsensusTrainState):
        return type(state)(params=tree(state.params), opt=slots_opt,
                           dual=tree(state.dual), step=_Slot([state.step]))
    return {"params": _slots(state["params"].named_parameters()),
            "opt": slots_opt}


def train_state_to_numpy(state):
    """A train state as the reference's tree, what a checkpoint holds:
    the allreduce state ``{"params": Transformer, "opt": AdamWState(step,
    mu, nu)}`` with ``params`` as ``lm_params_to_numpy`` lays it out,
    ``mu`` and ``nu`` in the same shape and ``step`` a 0-d numpy array
    (the optimizer stays an ``AdamWState``); a ``ConsensusTrainState``
    the same ``ConsensusTrainState`` with each stacked mapping as the
    reference's tree (numpy leaves (R, ...), a stacked layer's leaves
    (R, L, ...)), the optimizer an ``AdamWState`` of numpy leaves and
    trees, ``step`` numpy: the reference's ``ConsensusTrainState(*out)``
    with ``AdamWState(*out.opt)`` takes it."""
    return _map(_Slot.numpy, _state_slots(state))


def train_state_to_torch(ref_state, cfg, device=None) -> dict:
    """The port's allreduce train state of a reference one (``params``
    and ``opt``, an AdamWState or the plain ``(step, mu, nu)`` tuple a
    checkpoint decodes to, numpy or anything ``np.asarray`` takes) for
    ``cfg``, on ``device`` (``None`` means ``"cuda"``): the moments keyed
    in ``transformer.named_leaves`` order, every leaf bitwise."""
    dev = device_lib.resolve(device)
    model = lm_params_to_torch(ref_state["params"], cfg, device=dev)
    step, mu, nu = ref_state["opt"]
    names = transformer.named_leaves(model)
    tree = lambda t: {n: torch.from_numpy(np.array(_leaf(t, n))).to(dev)
                      for n in names}
    return {"params": model,
            "opt": AdamWState(step=torch.from_numpy(np.array(step)).to(dev),
                              mu=tree(mu), nu=tree(nu))}


@torch.no_grad()
def restore_train_state_(state, tree):
    """Re-seat a restored checkpoint ``tree`` (``checkpoint.
    restore_latest``'s: dicts, lists, tuples for the NamedTuples, numpy
    or bf16 tensor leaves) into the live train state ``state``, allreduce
    or consensus, in place, and return it.  The leaves pair up by the
    reference's leaf order (``jax.tree.leaves``), and each is cast to the
    live leaf's dtype, as the reference's ``launch/train.py`` re-seats
    (``jnp.asarray(b, a.dtype)``); a count or shape that differs raises
    ``ValueError``."""
    slots, leaves = _flatten(_state_slots(state)), _flatten(tree)
    if len(slots) != len(leaves):
        raise ValueError(f"the checkpoint holds {len(leaves)} leaves, the "
                         f"train state {len(slots)}")
    for i, (slot, src) in enumerate(zip(slots, leaves)):
        want = tuple(slot.tensors[0].shape)
        if slot.axis is not None:
            want = want[:slot.axis] + (len(slot.tensors),) + \
                want[slot.axis:]
        if tuple(src.shape) != want:
            raise ValueError(f"leaf {i}: the checkpoint holds "
                             f"{tuple(src.shape)}, the train state {want}")
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))
        # the whole leaf to the live leaf's device and dtype once; a
        # stacked leaf's layers are then rows of it there
        src = src.to(slot.tensors[0].device).to(slot.tensors[0].dtype)
        for r, t in enumerate(slot.tensors):
            t.copy_(src if slot.axis is None else src.select(slot.axis, r))
    return state
