"""repro_torch.serve: low-latency batched inference for fitted networks
(twin of ``repro/serve/``).

Training produces V*T small hyperplanes; serving them is a batching
problem.  ``PredictModel`` freezes the effective (w, b) per (node, task)
out of a state, solver or session; ``PredictServer`` coalesces concurrent
predict requests into padded power-of-two batches (one product
``X @ W.T + b`` per batch, round-robined across devices) and hot-swaps
models between batches, the deployment story of an ``OnlineSession``
that keeps learning while it serves:

    from repro_torch.serve import PredictModel, PredictServer
    srv = PredictServer(PredictModel.from_session(sess), window_ms=2.0)
    fut = srv.submit(x, node=0, task=1)      # -> Future of decisions
    sess.run(30); srv.publish_session(sess)  # next stage goes live
    srv.stats()                              # p50/p99 latency, rps

Batching never changes a value: the product (``gemm_rows``, on the card
the hand kernel ``kernels/csrc/rows.cu``) sums each element in a fixed
order, so each request's answers are bitwise identical to an unbatched
call (tests/test_torch_serve.py).
"""
from repro_torch.serve.model import PredictModel, gemm_rows
from repro_torch.serve.server import PredictServer, serve_model

__all__ = [
    "PredictModel",
    "PredictServer",
    "gemm_rows",
    "serve_model",
]
