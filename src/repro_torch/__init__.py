"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``src/repro/`` module for module
(``repro_torch/engine/plan.py`` is the twin of ``repro/engine/plan.py``)
and imports nothing of the reference package or its framework.  Ported
so far: the paper's main path on the single-host ``vmap`` backend,

    make_problem -> compile_problem (Z, counts, U, box, L, K = Z diag(a) Z^T)
                 -> Plan.run (eqs. 6-9, pluggable dual QP engine) -> risks

through ``repro_torch.api.DTSVM`` / ``DSVM`` / ``CSVM``; the large-n
path (``PlanBudget``, the factored operator, ``Plan.replan``); the sweep
engine and ``sweep_fit`` (a grid of configs as one batched fit);
``OnlineSession`` (tasks entering and leaving a live network) with the
event log and its ``replay`` (``repro_torch.store``); the communication
fabric (``repro_torch.net``: lossy, delayed, quantized, metered links,
node churn, the ``"async"`` backend); the decentralized ``"shard_map"``
backend (``repro_torch.core.dtsvm_dist``: one process per network node
in a ``repro_torch.dist.World``, the neighbor sums as collectives); the runners of the paper's
Figs. 2-7 with Fig. 7's node-churn variant (``repro_torch.figures``);
durable sessions (``repro_torch.store`` on ``repro_torch.checkpoint``,
the reference's file format); the batching predict server
(``repro_torch.serve``); and observability (``repro_torch.obs``:
convergence telemetry, spans of the engine's phases, the metrics
registry, the timing helper).  The four TPU kernels (the square and the tiled
weighted Gram build, the fused QP step and the fused multi-iteration QP
solve) and the server's fixed-order product (``gemm_rows``) are CUDA C++
kernels for ``sm_90a`` under ``repro_torch/kernels/csrc/``, built at
first use.  A kernel or its plain PyTorch version is chosen by the
device of the tensors, and the caller chooses the device: entry points
take ``device=None``, which means ``"cuda"``; pass ``device="cpu"`` to
run the plain versions on the CPU.
"""
from repro_torch.net import (LinkPolicy, Membership, MembershipEvent,
                             NetConfig)

__all__ = ["LinkPolicy", "Membership", "MembershipEvent", "NetConfig"]
