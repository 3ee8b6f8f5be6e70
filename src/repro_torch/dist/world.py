"""The rank world of one multi-process fit (the role of
``repro/core/dtsvm_dist.py:make_node_mesh`` and ``repro/dist/compat.py``).

A :class:`World` is ``size`` worker processes, one rank each, joined in
one ``torch.distributed`` process group:

- the processes come from ``torch.multiprocessing``'s *spawn* context, so
  a rank starts from a fresh interpreter and inherits nothing of the
  parent's CUDA state; the world itself touches no CUDA in the parent;
- they meet through a ``file://`` rendezvous in a fresh temporary
  directory, never a TCP port: two worlds at once (test workers side by
  side) would collide on a fixed port;
- the backend is gloo, with ``timeout`` on ``init_process_group``.  NCCL
  refuses two ranks on one device, and every rank of a world runs on the
  same device, the caller's: ``cuda:0`` on the card, or ``cpu``;
- each rank runs ``torch.set_num_threads(1)``: V ranks on few cores
  oversubscribe them otherwise;
- on the card the parent builds the kernels' extension before it spawns,
  and each rank only loads the built module (``kernels.build.load_built``):
  V concurrent builds into one directory would race.

As with any spawn start method, every rank imports the parent's main
module again (as ``__mp_main__``): a script that starts a world guards
its entry under ``if __name__ == "__main__":``.

The parent drives the ranks with :meth:`World.run`: ``fn(*args)`` runs in
every rank (``fn`` a module-level function, pickled by name; ``args`` one
tuple per rank), and the results come back in rank order.  Inside a rank
:func:`context` is the rank's :class:`RankContext`: its rank, the world's
size, its device, the sub-groups it belongs to, and a dict that keeps
objects between calls (a node's compiled plan).

A world may carry sub-groups (``groups=``: lists of ranks, e.g. the node
rows of a 2-D sweep): every rank calls ``dist.new_group`` for every group,
in the order given, once, right after it joins, as gloo requires of a
group's creation; a rank that hangs there ends in the world's timeout.

Only numpy arrays and plain Python values should cross the pipes: a
tensor would travel by shared memory (a CUDA tensor by IPC, and the rank
would then map the parent's allocation).

Failure never hangs the parent: every wait has ``timeout``.  If a rank
raises, the parent kills every rank and raises :class:`RankError` with
that rank's traceback; if a rank dies, the same with its exit code; if
no answer comes in time, ``TimeoutError``.  A failed world is closed and
refuses further calls.  :meth:`World.close` (also run at garbage
collection and at exit) stops the ranks, kills any that do not stop, and
removes the rendezvous directory.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
import weakref
from multiprocessing import connection
from typing import Any, Callable, List, Optional, Sequence

import torch

#: seconds any one wait of a world may take (start, a call, a collective)
DEFAULT_TIMEOUT_S = 300.0
#: seconds ``close`` waits for a rank to stop before it kills it
_STOP_S = 10.0


class RankError(RuntimeError):
    """A rank of a world raised or died; the message carries its
    traceback or exit code."""


class RankContext:
    """What a rank knows about itself (see :func:`context`)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 groups: tuple = ()):
        self.rank = rank
        self.size = size
        self.device = device
        #: ``(ranks, process group)`` of every sub-group the rank is in
        self.groups = groups
        #: objects a rank keeps between calls
        self.store: dict = {}

    def group(self):
        """``(ranks, process group)`` of the rank's first sub-group, or
        ``(all ranks, None)`` (the whole world) in a world without one."""
        if self.groups:
            return self.groups[0]
        return tuple(range(self.size)), None


_CONTEXT: Optional[RankContext] = None


def context() -> RankContext:
    """The calling rank's context; raises outside a rank."""
    if _CONTEXT is None:
        raise RuntimeError("not inside a rank of a repro_torch.dist.World")
    return _CONTEXT


def _rank_main(rank: int, size: int, init_file: str, device: str,
               timeout_s: float, groups: tuple, conn) -> None:
    """A rank's process: join the group, then run what the parent sends
    until it sends None (or goes away)."""
    global _CONTEXT
    import torch.distributed as dist

    from repro_torch import device as device_lib
    from repro_torch.kernels import build

    try:
        torch.set_num_threads(1)
        dev = device_lib.resolve(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            build.load_built()
        dist.init_process_group(
            "gloo", init_method="file://" + init_file, rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        mine = []
        for ranks in groups:             # every rank, every group, in order
            pg = dist.new_group(list(ranks))
            if rank in ranks:
                mine.append((tuple(ranks), pg))
        _CONTEXT = RankContext(rank, size, dev, tuple(mine))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    conn.send(("ok", str(dev)))
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:                  # the parent went away
                break
            if msg is None:
                break
            fn, args = msg
            try:
                out = fn(*args)
            except Exception:
                conn.send(("err", traceback.format_exc()))
            else:
                conn.send(("ok", out))
    finally:
        dist.destroy_process_group()


def _stop(procs, conns, tmpdir: str) -> None:
    """Stop the ranks (kill those that do not stop within _STOP_S), close
    the pipes, remove the rendezvous directory."""
    for proc, conn in zip(procs, conns):
        if proc.is_alive():
            try:
                conn.send(None)
            except OSError:
                pass
    deadline = time.monotonic() + _STOP_S
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 0.0))
        if proc.is_alive():
            proc.kill()
            proc.join()
    for conn in conns:
        conn.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


class World:
    """``size`` spawned ranks in one gloo process group, every rank on
    ``device`` (None means ``"cuda"``, i.e. ``cuda:0``), with the
    sub-groups ``groups`` (lists of ranks).  See the module doc.  Usable
    as a context manager; ``start_seconds`` is how long the ranks took to
    start and join."""

    def __init__(self, size: int, *, device=None,
                 timeout: float = DEFAULT_TIMEOUT_S,
                 groups: Sequence[Sequence[int]] = ()):
        if int(size) < 1:
            raise ValueError(f"a world needs at least one rank, got {size}")
        groups = tuple(tuple(int(r) for r in g) for g in groups)
        for g in groups:
            if not g or len(set(g)) != len(g) or \
                    not all(0 <= r < int(size) for r in g):
                raise ValueError(f"group {list(g)} is not a set of ranks of "
                                 f"a world of {size}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"a world runs on 'cuda' or 'cpu'; got {dev}")
        self.size = int(size)
        self.device = dev
        self.timeout = float(timeout)
        #: the sub-groups, as given
        self.groups = groups
        self._closed = False
        t0 = time.perf_counter()
        if dev.type == "cuda":
            from repro_torch.kernels import build
            build.extension()
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        tmpdir = tempfile.mkdtemp(prefix="repro_torch_world_")
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns, tmpdir)
        spawn = torch.multiprocessing.get_context("spawn")
        try:
            for rank in range(self.size):
                mine, theirs = spawn.Pipe()
                proc = spawn.Process(
                    target=_rank_main, daemon=True,
                    args=(rank, self.size,
                          os.path.join(tmpdir, "rendezvous"), str(dev),
                          self.timeout, groups, theirs))
                proc.start()
                theirs.close()
                self._procs.append(proc)
                self._conns.append(mine)
            #: each rank's device, as the rank resolved it
            self.devices = self._gather()
        except BaseException:
            self.close()
            raise
        self.start_seconds = time.perf_counter() - t0

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop every rank; idempotent."""
        self._closed = True
        self._finalizer()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _fail(self, exc: BaseException):
        self.close()
        raise exc

    def _gather(self) -> list:
        """One answer from every rank, in rank order, within the timeout."""
        results: List[Any] = [None] * self.size
        pending = set(range(self.size))
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(TimeoutError(
                    f"ranks {sorted(pending)} gave no answer within "
                    f"{self.timeout} s"))
            waits = [self._conns[r] for r in pending] + \
                [self._procs[r].sentinel for r in pending]
            connection.wait(waits, timeout=left)
            for r in sorted(pending):
                conn, proc = self._conns[r], self._procs[r]
                if conn.poll():
                    try:
                        status, value = conn.recv()
                    except EOFError:
                        status, value = "dead", None
                elif not proc.is_alive():
                    status, value = "dead", None
                else:
                    continue
                if status == "err":
                    self._fail(RankError(f"rank {r} of {self.size} "
                                         f"raised:\n{value}"))
                if status == "dead":
                    proc.join(_STOP_S)
                    self._fail(RankError(
                        f"rank {r} of {self.size} died (exit code "
                        f"{proc.exitcode})"))
                results[r] = value
                pending.discard(r)
        return results

    def run(self, fn: Callable, args: Sequence[tuple]) -> list:
        """``fn(*args[r])`` in every rank r; the results in rank order."""
        if self._closed:
            raise RuntimeError("this world is closed")
        if len(args) != self.size:
            raise ValueError(f"{len(args)} argument tuples for a world of "
                             f"{self.size} ranks")
        for r, (conn, a) in enumerate(zip(self._conns, args)):
            try:
                conn.send((fn, tuple(a)))
            except OSError:
                self._fail(RankError(f"rank {r} of {self.size} is gone "
                                     f"(exit code "
                                     f"{self._procs[r].exitcode})"))
        return self._gather()

    def run_all(self, fn: Callable, *args) -> list:
        """``fn(*args)`` in every rank, the same arguments for each."""
        return self.run(fn, [args] * self.size)

    def __repr__(self):
        state = "closed" if self._closed else "open"
        groups = f", groups={len(self.groups)}" if self.groups else ""
        return (f"World(size={self.size}, device={self.device}{groups}, "
                f"{state})")
