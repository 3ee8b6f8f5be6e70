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
registry, the timing helper); and, of the seed substrate, the decoder
family's serving path (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.train.steps``, ``repro_torch.launch.serve``: prefill and
ring-KV decode of qwen2, qwen2.5, gemma2, gemma3 and internvl2, and of
the mixture-of-experts Phi-3.5-MoE (``repro_torch.models.moe``: top-k
routing, grouped static-capacity dispatch, shared experts and dense
leading layers), and of DeepSeek-V2 (its multi-head latent attention:
expanded prefill, absorbed decode, the latent cache), in plain PyTorch,
as the reference's attention and experts are plain ``jnp``).  ``python
-m repro_torch.launch.serve --arch gemma2-2b --reduced --device cpu``
runs it on the CPU, ``--arch phi3.5-moe-42b-a6.6b`` the MoE path and
``--arch deepseek-v2-236b`` the MLA path; ``pytest
tests/test_torch_moe.py tests/test_torch_mla.py`` holds them to the
reference, and ``python3 chip_smoke.py --only moe`` / ``--only mla``
runs Phi-3.5-MoE / DeepSeek-V2 at full width on the card.  The rest of
the seed substrate is ported too: the SSM, hybrid and encoder-decoder
stacks, both trainers and the training CLI (``repro_torch.launch.
train``), and the one-card dry run (``python -m repro_torch.launch.
dryrun``: each step on fake tensors, its peak bytes and FLOPs against
the card's memory, ``launch/costs.py``'s model beside them).
The four TPU kernels (the square and the tiled
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
