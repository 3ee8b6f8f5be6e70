"""The collectives a rank of a ``World`` makes (the role of
``jax.lax.all_gather`` / ``psum`` / ``pmax`` inside the reference's
``shard_map`` bodies).

A world is gloo on the card too (NCCL refuses two ranks on one device),
and gloo moves host tensors.  :class:`Staging` is the one place that
bridges the two: on the card an operand goes down into a pinned host
buffer, the collective runs there, and the result comes back up (each
copy counted); on the CPU the tensors are used as they are.  Every
backend of ``repro_torch.dist`` goes through it:

- :func:`all_gather` — every member's tensor, concatenated along ``dim``
  in the group's rank order (``lax.all_gather(..., tiled=True)``);
- :func:`all_reduce` — the elementwise sum or max over the members
  (``psum`` / ``pmax``);
- ``core.dtsvm_dist`` builds its neighbor sums on :class:`Staging` too.

``group`` is ``(ranks, process group)`` as ``RankContext.groups`` holds
it, or None for the whole world.  A rank counts what it makes in
:func:`exchange_counts`, which :func:`world_stats` reads (and resets),
and the host seconds its collectives take, staging included
(``collective_s``; on the card the clock starts after the rank's own
queued work is done, which the copy down would wait for anyway).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional, Tuple

import torch

from repro_torch.dist import world as world_lib

#: what a rank counts: neighbor sums, all-gathers, all-reduces, the host
#: copies the staging made on the card, and the seconds all of it took
COUNTERS = ("nbr_sums", "all_gathers", "all_reduces", "host_copies",
            "collective_s")


def exchange_counts(ctx: Optional[world_lib.RankContext] = None) -> dict:
    """The calling rank's counters (``COUNTERS``), kept in its store."""
    ctx = world_lib.context() if ctx is None else ctx
    return ctx.store.setdefault("exchange", dict.fromkeys(COUNTERS, 0))


class Staging:
    """Operands to and from the host tensors gloo reads, for a rank on
    ``device``: through pinned host buffers on the card, each copy counted
    in ``counts["host_copies"]``; as they are on the CPU."""

    def __init__(self, device: torch.device, counts: dict):
        self.device = device
        self.staged = device.type != "cpu"
        self.counts = counts

    def host(self, shape, dtype=torch.float32) -> torch.Tensor:
        """An empty host buffer (pinned on the card)."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged)

    def down(self, arr: torch.Tensor, *, copy: bool = False) -> torch.Tensor:
        """``arr`` as a contiguous host tensor; ``copy=True`` never hands
        back ``arr``'s own storage (an in-place collective writes it)."""
        if not self.staged:
            return arr.clone(memory_format=torch.contiguous_format) \
                if copy else arr.contiguous()
        buf = self.host(arr.shape, arr.dtype)
        buf.copy_(arr)
        self.counts["host_copies"] += 1
        return buf

    def up(self, t: torch.Tensor) -> torch.Tensor:
        """A host result on the rank's device."""
        if not self.staged:
            return t
        self.counts["host_copies"] += 1
        return t.to(self.device)

    @contextlib.contextmanager
    def timed(self):
        """Add the block's seconds to ``counts["collective_s"]``; on the
        card the rank's queued work is waited for first."""
        if self.staged:
            # repro: noqa[host-sync-in-hot-path] — deliberate: the staged gloo path copies through pinned host buffers, so the rank's queued work is waited for before the host copy and the collective's seconds are its own (ROADMAP hazard 7: NCCL refuses two ranks on one device)
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.counts["collective_s"] += time.perf_counter() - t0


def members(group=None) -> Tuple[tuple, object]:
    """``(ranks, process group)`` of ``group``, the whole world for None."""
    if group is not None:
        return group
    return tuple(range(world_lib.context().size)), None


def all_gather(t: torch.Tensor, dim: int, *, group=None) -> torch.Tensor:
    """Every member's ``t`` (one shape for all), concatenated along
    ``dim`` in the group's rank order, on the rank's device."""
    import torch.distributed as dist

    ranks, pg = members(group)
    counts = exchange_counts()
    counts["all_gathers"] += 1
    st = Staging(t.device, counts)
    with st.timed():
        send = st.down(t)
        full = st.host((len(ranks),) + tuple(t.shape), t.dtype)
        dist.all_gather(list(full.unbind(0)), send, group=pg)
        return torch.cat(st.up(full).unbind(0), dim)


def all_reduce(t: torch.Tensor, op: str = "sum", *,
               group=None) -> torch.Tensor:
    """The elementwise ``"sum"`` or ``"max"`` of every member's ``t``, on
    the rank's device (``t`` itself is left as it was)."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}; expected 'sum' or "
                         f"'max'")
    _, pg = members(group)
    counts = exchange_counts()
    counts["all_reduces"] += 1
    st = Staging(t.device, counts)
    with st.timed():
        buf = st.down(t, copy=True)
        dist.all_reduce(buf, op=ops[op], group=pg)
        return st.up(buf)


def _rank_stats(reset: bool) -> dict:
    from repro_torch.kernels import ops

    ctx = world_lib.context()
    cuda = ctx.device.type == "cuda"
    out = {"rank": ctx.rank, "device": str(ctx.device),
           "launches": ops.launch_counts(),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                              if cuda else None),
           **exchange_counts(ctx),
           "received": ctx.store.get("received")}
    if reset:
        ops.reset_launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
        ctx.store["exchange"] = dict.fromkeys(COUNTERS, 0)
    return out


def world_stats(world: world_lib.World, reset: bool = False) -> list:
    """Per rank: its device, its hand-kernel launches, its peak device
    memory (None on the CPU), its neighbor sums, all-gathers, all-reduces,
    host copies and collective seconds since the last reset, and the
    shapes of the payload it last received.  ``reset=True`` sets the
    counters and the peak to 0 after reading."""
    return world.run_all(_rank_stats, reset)
