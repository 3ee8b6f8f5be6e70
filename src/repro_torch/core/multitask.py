"""Multi-task parameter decomposition  w_t = w0 + wt  (paper eq. (2)),
lifted to parameter trees (twin of ``repro/core/multitask.py``), for
task-specific heads or adapters on the assigned architectures.

A tree is the port's parameter idiom: a mapping from name to tensor,
whose nested mappings are walked the same way.  The regularizer
eps1/2 ||w0||^2 + eps2/2 sum_t ||wt||^2 interpolates between one shared
head (eps2 -> inf) and independent heads (eps1 -> inf), the paper's
Section II trade-off; tests/test_torch_multitask.py holds both limits.

The dtype rules are the reference's: the task axis leads, the task
parts take their leaf's dtype, ``regularizer`` sums squares in fp32 and
``split_grads`` casts ``eps * w`` to the gradient's dtype.  A Python
``eps`` is a weakly typed scalar in JAX, so it is rounded to the
gradient's dtype before the product (``_weak``): with bf16 gradients
the split is then the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping, NamedTuple

import torch


class MultiTaskParams(NamedTuple):
    shared: Any            # w0 tree
    task: Any              # wt tree with a leading task axis (T, ...)


# Not convert's walkers: these take any Mapping in its own key order and
# zip several trees by key; convert's walk the reference's dicts, lists
# and NamedTuples in jax's sorted-key leaf order.
def _map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of
    ``rest``'s trees, as a tree of ``tree``'s keys and nesting."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _weak(eps: float, dtype: torch.dtype) -> float:
    """``eps`` as JAX's weak typing leaves it beside a ``dtype`` array:
    rounded to that dtype."""
    return float(torch.tensor(eps, dtype=dtype))


def init(params, num_tasks: int) -> MultiTaskParams:
    """Start from a trained or initialized head: shared = params, tasks
    = 0."""
    zeros = _map(lambda p: torch.zeros((num_tasks,) + tuple(p.shape),
                                       dtype=p.dtype, device=p.device),
                 params)
    return MultiTaskParams(shared=params, task=zeros)


def combine(mt: MultiTaskParams, t: int):
    """Effective parameters for task t:  w0 + wt."""
    return _map(lambda s, d: s + d[t], mt.shared, mt.task)


def combine_all(mt: MultiTaskParams):
    """(T, ...) stacked effective parameters (for batches over tasks)."""
    return _map(lambda s, d: s.unsqueeze(0) + d, mt.shared, mt.task)


def regularizer(mt: MultiTaskParams, eps1: float,
                eps2: float) -> torch.Tensor:
    sq = lambda tree: sum(x.float().square().sum() for x in _leaves(tree))
    return 0.5 * eps1 * sq(mt.shared) + 0.5 * eps2 * sq(mt.task)


def split_grads(grads_combined, mt: MultiTaskParams, eps1: float,
                eps2: float) -> MultiTaskParams:
    """Map per-task gradients g_t (T, ...) of the combined parameters onto
    the decomposition: dL/dw0 = sum_t g_t + eps1*w0; dL/dwt = g_t +
    eps2*wt."""
    g_shared = _map(
        lambda g, s: g.sum(dim=0) + _weak(eps1, g.dtype) * s.to(g.dtype),
        grads_combined, mt.shared)
    g_task = _map(lambda g, d: g + _weak(eps2, g.dtype) * d.to(g.dtype),
                  grads_combined, mt.task)
    return MultiTaskParams(shared=g_shared, task=g_task)
