"""The one benchmark-timing helper: warmup, ``perf_counter``, blocking
(twin of ``repro/obs/timing.py``).

CUDA launches are asynchronous: a host clock around an unsynchronized
call times the *enqueue*, not the work.  ``timeit`` keeps the whole
discipline in one place:

- explicit warmup calls first (the kernel build and first-touch costs
  are not the measurement),
- ``time.perf_counter`` (monotonic, high-resolution) around each call,
- ``torch.cuda.synchronize`` of every CUDA device among the result's
  tensors before the clock stops (NamedTuples, tuples, lists and dicts
  are walked; other leaves are ignored).
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Set, Tuple

import torch


class Timing(NamedTuple):
    """One ``timeit`` measurement."""
    #: fastest single call, seconds (the number to report: min-of-N is
    #: the standard noise-robust statistic for hot-loop timings)
    best_s: float
    #: arithmetic mean over the timed calls, seconds
    mean_s: float
    #: every timed call, seconds, in order
    times_s: Tuple[float, ...]
    #: the last call's return value (already waited for)
    result: Any


def _cuda_devices(obj: Any, found: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor leaf of ``obj``."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):       # NamedTuples too
        for v in obj:
            _cuda_devices(v, found)
    return found


def _block_until_ready(result: Any) -> Any:
    """Wait for the work behind ``result``: synchronize each CUDA device
    that holds one of its tensors.  Returns ``result``."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1,
           block: bool = True, **kwargs) -> Timing:
    """Time ``fn(*args, **kwargs)`` with warmup and blocking discipline.

    Runs ``warmup`` untimed calls (each waited for), then ``repeats``
    timed calls; each timed call is bracketed by ``perf_counter`` and —
    when ``block`` — waits for the result's devices
    (:func:`_block_until_ready`) before the clock stops.  Returns a
    :class:`Timing`.

    ``block=False`` is for host-only callables (file IO, pure numpy)
    where there is nothing to wait on.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        if block:
            _block_until_ready(result)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if block:
            _block_until_ready(result)
        times.append(time.perf_counter() - t0)
    return Timing(best_s=min(times), mean_s=sum(times) / len(times),
                  times_s=tuple(times), result=result)
