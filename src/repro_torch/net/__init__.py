"""repro_torch.net: the asynchronous, lossy, metered communication fabric
(twin of ``repro/net/``).

Nodes exchange only their decision vectors.  A ``Fabric`` owns the
per-edge ``LinkPolicy`` (delay in rounds, drop probability, int8 / int16
/ float16 wire formats, bandwidth caps) and per-node mailboxes of the
last-received neighbor variables; ``run_async`` runs Prop. 1 with every
node stepping against its mailbox under an activation/link
``Schedule``, and meters every byte that crosses an edge:

    from repro_torch.net import LinkPolicy, NetConfig, run_async
    net = NetConfig(policy=LinkPolicy(quant="int8", drop=0.1, delay=1),
                    schedule="partial:0.5", seed=0)
    res = run_async(prob, iters=60, net=net)
    res.report["bytes_per_round"], res.state

or, through the solvers, ``DTSVM(SolverConfig(net=net)).fit(...)``.  The
node set is elastic too (``Membership``: enter / leave / crash /
recover), ``NetConfig.stale_limit`` bounds how long a silent neighbor
keeps its seat in the consensus reduce, and ``error_feedback=True``
makes the integer wire formats residual-accumulating compressors.

The identity configuration (zero delay and drop, float32, the "full"
schedule, no membership events) is bitwise the ``vmap`` backend.  The
drop stream is the reference's jax threefry stream, reproduced bit for
bit in ``prng``, so a lossy run loses the messages the reference loses.
"""
from repro_torch.net.async_admm import AsyncResult, run_async
from repro_torch.net.elastic import Membership, MembershipEvent
from repro_torch.net.fabric import (Fabric, FabricState, build_fabric,
                                    restore_state, snapshot_state)
from repro_torch.net.policies import (LinkPolicy, NetConfig, apply_quant,
                                      bytes_per_message)
from repro_torch.net.schedule import Schedule, resolve as resolve_schedule
from repro_torch.net import elastic, meter, policies, prng, schedule

__all__ = [
    "AsyncResult",
    "Fabric",
    "FabricState",
    "LinkPolicy",
    "Membership",
    "MembershipEvent",
    "NetConfig",
    "Schedule",
    "apply_quant",
    "build_fabric",
    "bytes_per_message",
    "elastic",
    "meter",
    "policies",
    "resolve_schedule",
    "restore_state",
    "run_async",
    "schedule",
    "snapshot_state",
]
