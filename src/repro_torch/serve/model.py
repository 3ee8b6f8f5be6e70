"""The serving-side view of a fitted linear SVM network (twin of
``repro/serve/model.py``).

Training carries the stacked primal vector r = [w0; b0; w; b] per (node,
task); inference needs only the effective hyperplanes

    w_vt = w0 + w_vt,   b_vt = b0 + b_vt

V*T small (p+1)-vectors.  ``PredictModel`` freezes exactly that: a
(V, T, p) weight block and a (V, T) bias block on one device, extracted
once from a state, solver or session and immutable afterwards (a
NamedTuple of tensors), so hot-swapping a server's model is one reference
assignment.

The decision values are computed as ONE product against all V*T
hyperplanes, ``G = X @ W_flat.T + b_flat``, by ``gemm_rows``, and gathered
per request.  The reference's contract is that a row's values are
bitwise the same whatever bucket it was padded to and whatever rows
shared its batch; the padded-bucket batching of the server relies on it
(tests/test_torch_serve.py).  A library matrix product does not promise
that (its sum may be split another way for another number of rows), so
``gemm_rows`` sums each element in a fixed order: on the card the hand
kernel ``kernels/csrc/rows.cu``, on the CPU its plain version.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops as kops


class PredictModel(NamedTuple):
    """Frozen per-(node, task) hyperplanes of a fitted network.

    ``W`` (V, T, p) and ``b`` (V, T), float32 tensors on one device, are
    the effective parameters w0 + w_vt / b0 + b_vt: everything inference
    needs, nothing ADMM carries."""
    W: torch.Tensor
    b: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(V, T, p)."""
        return tuple(self.W.shape)

    @property
    def device(self) -> torch.device:
        return self.W.device

    @classmethod
    def from_r(cls, r, device=None) -> "PredictModel":
        """The hyperplanes of a stacked primal block r (..., V, T, 2p+2),
        sliced as ``core.dtsvm.decision_values`` does.  ``device=None``
        keeps a tensor's own device and puts anything else (a numpy
        array) on ``"cuda"``."""
        if isinstance(r, torch.Tensor):
            dev = r.device if device is None else device_lib.resolve(device)
            r = r.to(device=dev, dtype=torch.float32)
        else:
            r = torch.as_tensor(np.array(r, np.float32), dtype=torch.float32,
                                device=device_lib.resolve(device))
        p =(r.shape[-1] - 2) // 2
        W = r[..., :p] + r[..., p + 1: 2 * p + 1]
        b = r[..., p] + r[..., 2 * p + 1]
        return cls(W=W.contiguous(), b=b.contiguous())

    @classmethod
    def from_state(cls, state) -> "PredictModel":
        """From a ``core.DTSVMState`` (its ``r``), on the state's device."""
        return cls.from_r(state.r)

    @classmethod
    def from_session(cls, sess) -> "PredictModel":
        """From a (run) ``OnlineSession``: the publish hook a serving
        deployment calls after every stage."""
        if sess.state is None:
            raise RuntimeError("run() the session before publishing")
        return cls.from_state(sess.state)

    @classmethod
    def from_solver(cls, solver) -> "PredictModel":
        """From a fitted solver (``DTSVM``/``DSVM``; its ``state_``)."""
        if getattr(solver, "state_", None) is None:
            raise RuntimeError("fit() the solver before publishing")
        return cls.from_state(solver.state_)

    # ------------------------------------------------------------------
    def flat(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(V*T, p) weights and (V*T,) biases, the product's layout; the
        hyperplane of (v, t) is row ``v * T + t``."""
        V, T, p = self.W.shape
        return self.W.reshape(V * T, p), self.b.reshape(V * T)

    def decision(self, X) -> torch.Tensor:
        """Decision values for X (T, n, p) shared or (V, T, n, p):
        (V, T, n), the offline-evaluation form, matching
        ``core.decision_values`` on the originating state."""
        V, T, p = self.W.shape
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        if X.ndim == 3:
            X = X[None].expand((V,) + tuple(X.shape))
        return (torch.einsum("vtnp,vtp->vtn", X, self.W)
                + self.b[..., None])

    def predict(self, X) -> torch.Tensor:
        """Labels in {-1, +1}, shape (V, T, n)."""
        return torch.sign(self.decision(X))

    def decide_rows(self, X) -> np.ndarray:
        """Decision values of rows X (n, p) against ALL V*T hyperplanes
        at once: (n, V*T) numpy, the exact computation the server runs on
        its batches (padded to the row bucket, as the server pads)."""
        X = np.asarray(X, np.float32)
        Wf, bf = self.flat()
        Xp = np.zeros((row_bucket(X.shape[0]), X.shape[1]), np.float32)
        Xp[:X.shape[0]] = X
        G = gemm_rows(Wf, bf, torch.from_numpy(Xp).to(self.device))
        return G.cpu().numpy()[:X.shape[0]]


def row_bucket(n: int) -> int:
    """Smallest power-of-two row count >= n (floor 8): the batch shapes
    every product of the server runs at."""
    b = 8
    while b < n:
        b *= 2
    return b


def gemm_rows(Wf: torch.Tensor, bf: torch.Tensor,
              X: torch.Tensor) -> torch.Tensor:
    """The server's product: X (B, p) against every hyperplane,
    (B, V*T), on the device of its operands (``kernels.ops.gemm_rows``:
    the hand kernel on the card, its plain version on the CPU)."""
    return kops.gemm_rows(Wf, bf, X)
