"""Carry problems, states and invariants between the two packages.

The reference's ``DTSVMProblem`` / ``DTSVMState`` / ``PlanInvariants``
are NamedTuples of arrays; so are the port's, with the same field names.
``to_torch`` takes any such tuple whose leaves convert to numpy (numpy
arrays, or anything ``np.asarray`` accepts) and returns the port's twin
with tensors on a chosen device, each leaf keeping its dtype.
``to_numpy`` turns a port tuple back into the same tuple of numpy arrays.
Nothing here imports the reference: the twin is found by the class name.

``lm_params_to_torch`` / ``lm_params_to_numpy`` do the same for the dense
decoder's weights: the reference's parameter pytree (numpy leaves,
``layers`` stacked along a leading L axis) to the port's ``Transformer``
and back, each leaf bitwise.
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


def lm_params_to_torch(params, cfg, device=None) -> "transformer.Transformer":
    """The port's ``Transformer`` for ``cfg`` holding the reference's
    parameter pytree ``params`` (``embed``, ``final_norm``, ``head`` where
    the embeddings are untied, and ``layers`` stacked over L), on
    ``device`` (``None`` means ``"cuda"``)."""
    dev = device_lib.resolve(device)
    model = transformer.Transformer(cfg, dev)
    with torch.no_grad():
        for name, t in model.named_parameters():
            src = params
            parts = name.split(".")
            if parts[0] == "layers":      # layers.<i>.<leaf path>
                i, parts = int(parts[1]), parts[2:]
                src = src["layers"]
                for key in parts:
                    src = src[key]
                src = np.asarray(src)[i]
            else:
                for key in parts:
                    src = src[key]
                src = np.asarray(src)
            if src.shape != tuple(t.shape):
                raise ValueError(f"{name}: the tree holds {src.shape}, the "
                                 f"model wants {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(src)))
    return model


def lm_params_to_numpy(model) -> dict:
    """The reference's parameter pytree of a port ``Transformer``: numpy
    leaves, ``layers`` stacked along a leading L axis."""
    tree: dict = {}
    per_layer: dict = {}
    for name, t in model.named_parameters():
        parts = name.split(".")
        leaf = t.detach().cpu().numpy()
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), []).append(leaf)
            continue
        tree[parts[0]] = leaf
    layers: dict = {}
    for path, leaves in per_layer.items():
        node = layers
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(leaves)
    tree["layers"] = layers
    return tree
