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
``Transformer`` and back, each leaf bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dtsvm as core
from repro_torch.engine import invariants as inv_lib
from repro_torch.models import transformer

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


# the reference's stacked subtrees, by path: the layers each leaf of which
# holds every layer's array along a leading axis
_STACKED = (("layers",), ("encoder", "layers"))


def _stack_of(parts):
    """The stacked subtree a parameter name's ``parts`` lie in, or None."""
    for stack in _STACKED:
        if tuple(parts[:len(stack)]) == stack:
            return stack
    return None


def _leaf(params, name: str) -> np.ndarray:
    """The reference tree's array for the port's parameter ``name``:
    ``layers.<i>.<path>`` (and ``encoder.layers.<i>.<path>``) is row i of
    a leaf stacked over L, and ``dense_layers.<i>.<path>`` a leaf of the
    i-th entry of a list."""
    parts = name.split(".")
    row = None
    stack = _stack_of(parts)
    if stack:
        n = len(stack)
        row, parts = int(parts[n]), list(stack) + parts[n + 1:]
    src = params
    for key in parts:
        src = src[int(key)] if isinstance(src, (list, tuple)) else src[key]
    src = np.asarray(src)
    return src if row is None else src[row]


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
    tree: dict = {}
    per_layer: dict = {}
    for name, t in model.named_parameters():
        parts = name.split(".")
        leaf = t.detach().cpu().numpy()
        stack = _stack_of(parts)
        if stack:
            path = stack + tuple(parts[len(stack) + 1:])
            per_layer.setdefault(path, []).append(leaf)
        elif parts[0] == "dense_layers":
            dense = tree.setdefault("dense_layers", [])
            i = int(parts[1])
            dense.extend({} for _ in range(i + 1 - len(dense)))
            _put(dense[i], parts[2:], leaf)
        else:
            _put(tree, parts, leaf)
    for path, leaves in per_layer.items():
        _put(tree, path, np.stack(leaves))
    return tree
