"""A batched, hot-swappable predict server over a ``PredictModel`` (twin
of ``repro/serve/server.py``).

The serving problem for this model family is the classic
small-request/large-throughput one: a single predict is a (n, p) x
(p, V*T) GEMM with tiny n — latency-bound, wasteful alone — but rows
of a GEMM are independent, so many concurrent requests can share one
kernel launch.  ``PredictServer`` does exactly that:

- requests (``submit``) land in a queue; a dispatcher thread coalesces
  everything that arrives within a ``window_ms`` batching window (or up
  to ``max_batch`` rows) into ONE batch;
- the batch is zero-padded up to a power-of-two row bucket, so every
  product runs at one of a few shapes (``model.gemm_rows``: on the card
  one launch of the hand kernel ``kernels/csrc/rows.cu`` per batch);
- batches round-robin across the configured devices (weights are
  placed on every device at ``publish`` time), one product per batch;
- each request's rows are sliced back out and its future resolved.

Batching is invisible in the VALUES: ``gemm_rows`` sums every element
in a fixed order, so a row's values depend only on that row, and a
request's answers are bitwise identical whatever it was batched and
padded with (asserted in tests/test_torch_serve.py).

``publish`` hot-swaps the model between batches — the online-session
story: a live network runs stages (``repro_torch.store`` keeps it durable),
and after each stage the refreshed hyperplanes are published while the
server keeps answering.  In-flight batches finish on the model they
started with; there is never a torn read.

``stats()`` reports p50/p99 request latency, requests/sec and batching
counters; the reference's ``benchmarks/bench_serve.py`` sweeps
``window_ms`` with it, and ``chip_smoke.py`` does the same on the card.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.obs import spans as obs_spans
from repro_torch.serve.model import PredictModel, gemm_rows, row_bucket


class _Request:
    __slots__ = ("rows", "vt", "scalar", "future", "t0")

    def __init__(self, rows: np.ndarray, vt: int, scalar: bool):
        self.rows = rows
        self.vt = vt
        self.scalar = scalar
        self.future: Future = Future()
        self.t0 = time.perf_counter()


class PredictServer:
    """Queue + window batching + padded-bucket product + hot swap.

    Parameters
    ----------
    model : PredictModel
        The initial hyperplanes; replace any time with ``publish``.
    window_ms : float
        Batching window: after the first queued request, the dispatcher
        waits this long for co-travelers before launching (0 = greedy —
        take whatever is queued right now, never wait).
    max_batch : int
        Row cap per batch; overflow waits for the next batch.
    devices : sequence of torch devices (or their names), optional
        Product devices, round-robined per batch (default: the one
        ``repro_torch.device.resolve(None)`` gives, the card).  Weights
        are placed on each at ``publish``.
    """

    def __init__(self, model: PredictModel, *, window_ms: float = 2.0,
                 max_batch: int = 1024,
                 devices: Optional[Sequence] = None):
        self.window_s = float(window_ms) / 1e3
        self.max_batch = int(max_batch)
        self._devices = ([device_lib.resolve(d) for d in devices]
                         if devices else [device_lib.resolve(None)])
        self._cond = threading.Condition()
        self._queue: List[_Request] = []
        self._closed = False
        self._rr = 0
        # stats (guarded by _cond)
        self._lat: List[float] = []
        self._rows = 0
        self._padded_rows = 0
        self._batches = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self.publish(model)
        self._thread = threading.Thread(target=self._dispatch,
                                        name="repro-serve", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def publish(self, model: PredictModel) -> None:
        """Hot-swap the served model (atomic between batches).

        Places the flat weights on every serving device now, so the
        swap costs the publisher — not the next request — the copies.
        """
        Wf, bf = model.flat()
        placed = [(Wf.to(d), bf.to(d)) for d in self._devices]
        with self._cond:
            self._model = model
            self._placed = placed
            self.V, self.T, self.p = model.shape

    def publish_session(self, sess) -> None:
        """Publish a session's current stage
        (``PredictModel.from_session``)."""
        self.publish(PredictModel.from_session(sess))

    def submit(self, x, *, node: int, task: int) -> Future:
        """Enqueue rows ``x`` ((n, p) or a single (p,) vector) for the
        (node, task) hyperplane; resolves to the decision values
        ((n,) or a scalar) — ``sign`` of it is the label."""
        x = np.asarray(x, np.float32)
        scalar = x.ndim == 1
        rows = x[None] if scalar else x
        if rows.ndim != 2 or rows.shape[1] != self.p:
            raise ValueError(f"x must be (n, {self.p}) or ({self.p},); "
                             f"got shape {x.shape}")
        if not (0 <= node < self.V and 0 <= task < self.T):
            raise ValueError(f"(node={node}, task={task}) out of range "
                             f"for a ({self.V}, {self.T}) network")
        if rows.shape[0] > self.max_batch:
            raise ValueError(f"request of {rows.shape[0]} rows exceeds "
                             f"max_batch={self.max_batch}; split it")
        req = _Request(rows, node * self.T + task, scalar)
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._t_first is None:
                self._t_first = req.t0
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def predict(self, x, *, node: int, task: int,
                timeout: Optional[float] = 30.0):
        """Blocking ``submit`` — decision values for one request."""
        return self.submit(x, node=node, task=task).result(timeout)

    def stats(self) -> dict:
        """Latency/throughput counters so far: p50/p99 request latency
        (ms), requests/sec over the active span, batch size, and
        ``pad_ratio`` — the fraction of product rows that were padding
        (wasted compute bought for shape stability)."""
        with self._cond:
            lat = np.asarray(self._lat, np.float64)
            n = len(lat)
            span = ((self._t_last - self._t_first)
                    if n and self._t_last is not None else 0.0)
            return {
                "requests": n,
                "rows": self._rows,
                "batches": self._batches,
                "p50_ms": float(np.percentile(lat, 50)) if n else None,
                "p99_ms": float(np.percentile(lat, 99)) if n else None,
                "rps": (n / span) if span > 0 else None,
                "rows_per_batch": (self._rows / self._batches
                                   if self._batches else None),
                "pad_ratio": (self._padded_rows
                              / (self._rows + self._padded_rows)
                              if self._rows else None),
                "devices": len(self._devices),
            }

    def close(self) -> None:
        """Drain the queue, stop the dispatcher, reject new submits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self) -> "PredictServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------
    def _take_batch(self) -> Optional[List[_Request]]:
        """Block for the first request, then collect co-travelers until
        the window closes or the row cap is hit.  None = shut down."""
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait(0.05)
            if not self._queue:
                return None                        # closed and drained
            deadline = time.perf_counter() + self.window_s
            batch: List[_Request] = []
            rows = 0
            while True:
                while (self._queue
                       and rows + self._queue[0].rows.shape[0]
                       <= self.max_batch):
                    req = self._queue.pop(0)
                    batch.append(req)
                    rows += req.rows.shape[0]
                left = deadline - time.perf_counter()
                if (left <= 0 or rows >= self.max_batch or self._closed
                        or (self._queue and rows
                            + self._queue[0].rows.shape[0]
                            > self.max_batch)):
                    return batch
                self._cond.wait(left)

    def _dispatch(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except Exception as e:                 # pragma: no cover
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _run_batch(self, batch: List[_Request]) -> None:
        """One padded-bucket product for the whole batch, on the next
        device in the rotation; slice every request back out."""
        with obs_spans.span("serve_batch", requests=len(batch)):
            with self._cond:
                placed = self._placed
            X = np.concatenate([r.rows for r in batch], axis=0)
            n = X.shape[0]
            bucket = row_bucket(n)
            Xp = np.zeros((bucket, X.shape[1]), np.float32)
            Xp[:n] = X
            idx = self._rr % len(self._devices)
            self._rr += 1
            dev = self._devices[idx]
            Wf, bf = placed[idx]
            G = gemm_rows(Wf, bf, torch.from_numpy(Xp).to(dev)).cpu().numpy()
            now = time.perf_counter()
            off = 0
            for req in batch:
                k = req.rows.shape[0]
                out = G[off: off + k, req.vt]
                off += k
                req.future.set_result(out[0] if req.scalar else out)
            with self._cond:
                self._lat.extend((now - r.t0) * 1e3 for r in batch)
                self._rows += n
                self._padded_rows += bucket - n
                self._batches += 1
                self._t_last = now


def serve_model(model: PredictModel, **kw) -> PredictServer:
    """Start a server over ``model`` (keywords as in ``PredictServer``)."""
    return PredictServer(model, **kw)
