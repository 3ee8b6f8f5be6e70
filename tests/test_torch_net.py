"""The port's communication fabric (``repro_torch.net``) against the
reference's ``repro.net``, mirroring tests/test_net.py.

Inside the port, the identity configuration (zero delay and drop, a
float32 wire, the "full" schedule) is bitwise the port's own ``vmap``
backend and ``Plan.run`` (one torch thread), as the reference holds its
own.  Across the packages, the same numpy inputs go to both on the CPU
(the reference on its plain path, ``REPRO_USE_PALLAS=0``):

- the drop stream is bitwise jax 0.9.0's threefry stream, so every
  counter of a lossy run (messages sent and delivered, bytes, warm-fill
  deliveries, staleness clocks) is equal exactly, as are the schedules
  and the membership masks (host numpy in both);
- the states are held to REL = 1e-4 of each leaf's largest magnitude
  (observed on this tree: at most 2.1e-5, int16; 1e-7 to 3e-6 for the
  other configurations).  A wire code of int8 or int16 rounds
  x / scale to an integer, so a last-bit difference of x can move one
  mailbox entry by a whole step (max|x| / 127 for int8); the seeds here
  hit no such flip, and the bound holds what they give.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DTSVM as JDTSVM
from repro.api import OnlineSession as JOnlineSession
from repro.api import SolverConfig as JSolverConfig
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic
from repro.net import LinkPolicy as JLinkPolicy
from repro.net import NetConfig as JNetConfig
from repro.net import policies as jpolicies
from repro.net import run_async as jrun_async
from repro.net import schedule as jschedule
from repro_torch.api import (CSVM, DTSVM, LinkPolicy, NetConfig,
                             OnlineSession, SolverConfig, backends,
                             sweep_fit)
from repro_torch.core import dtsvm as core
from repro_torch.core import graph
from repro_torch.engine import plan as engine_plan
from repro_torch.net import (Fabric, build_fabric, bytes_per_message, meter,
                             policies, prng, restore_state, run_async,
                             snapshot_state)
from repro_torch.net import schedule as schedule_lib
from repro_torch.obs import STREAMS, Telemetry

REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Bitwise comparisons inside the port need one reduction order; the
    suite's worker processes would oversubscribe the cores besides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_plain_path(monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "0")


def _data(V=5, T=2, p=6, n=8, seed=0, graph_kind="random", degree=0.7):
    n_train = np.full((V, T), n, int)
    data = synthetic.make_multitask_data(V=V, T=T, p=p, n_train=n_train,
                                         n_test=40, seed=seed)
    return data, jgraph.make_graph(graph_kind, V, degree=degree, seed=seed)


def _problem(V=5, T=2, p=6, n=8, seed=0, graph_kind="random", degree=0.7,
             active=None, couple=None):
    """tests/test_net.py's problem, in the port (on the CPU) and in the
    reference."""
    data, A = _data(V, T, p, n, seed, graph_kind, degree)
    args = (data["X"], data["y"], data["mask"], A)
    kw = dict(C=0.01, active=active, couple=couple)
    return (core.make_problem(*args, device="cpu", **kw),
            jcore.make_problem(*args, **kw), data)


def _eval_fns(data, V):
    Xte = np.broadcast_to(data["X_test"][None], (V,) + data["X_test"].shape)
    yte = np.broadcast_to(data["y_test"][None], (V,) + data["y_test"].shape)
    tX, ty = torch.from_numpy(Xte.copy()), torch.from_numpy(yte.copy())
    return (lambda st: core.risks(st.r, tX, ty),
            lambda st: jcore.risks(st.r, Xte, yte))


def _assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def _assert_near_reference(state, jstate, label=""):
    """Each leaf within REL of the reference leaf's largest magnitude."""
    gaps = {}
    for name, got, want in zip(state._fields, state, jstate):
        want = np.asarray(want, np.float64)
        err = float(np.abs(got.numpy().astype(np.float64) - want).max())
        scale = float(np.abs(want).max())
        gaps[name] = err / max(scale, 1e-30)
        assert err <= REL * scale, (label, name, err, scale)
    print(f"{label} port vs JAX, relative gap per leaf: "
          + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()))


def _nets(**kw):
    """The same NetConfig in both packages (``policy``/``edge_policies``
    given as LinkPolicy keyword dicts)."""
    pol = kw.pop("policy", {})
    edges = kw.pop("edge_policies", None)
    out = []
    for N, L in ((NetConfig, LinkPolicy), (JNetConfig, JLinkPolicy)):
        e = None if edges is None else {k: L(**v) for k, v in edges.items()}
        out.append(N(policy=L(**pol), edge_policies=e, **kw))
    return out


# ---------------------------------------------------------------------------
# the drop stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_drop_stream_is_jax_threefry_bitwise(seed):
    """``prng.uniform(fold_in(key(s), k), (V, V))`` has the bits of
    ``jax.random.uniform(fold_in(PRNGKey(s), k), (V, V))`` over a grid of
    rounds and sizes, and ``keep_masks`` is the reference fabric's
    ``uniform >= drop`` of each round."""
    for rnd in (0, 1, 5, 999, 2 ** 20):
        for V in (2, 6, 10):
            want = np.asarray(jax.random.uniform(jax.random.fold_in(
                jax.random.PRNGKey(seed), jnp.int32(rnd)), (V, V)))
            got = prng.uniform(prng.fold_in(prng.key(seed), rnd), (V, V))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
    drop = np.random.default_rng(seed).uniform(0, 1, (6, 6)).astype(
        np.float32)
    masks = prng.keep_masks(seed, 40, 5, drop)
    for i in range(5):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(
            jax.random.PRNGKey(seed), 40 + i), (6, 6))) >= drop
        np.testing.assert_array_equal(masks[i], want)


def test_keep_masks_without_drops_keep_everything():
    masks = prng.keep_masks(3, 0, 4, np.zeros((3, 3), np.float32))
    assert masks.shape == (4, 3, 3) and masks.all()


# ---------------------------------------------------------------------------
# the identity guarantee
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph_kind", ["ring", "full", "random"])
def test_identity_fabric_bitwise_vs_plan(graph_kind):
    tprob, jprob, data = _problem(graph_kind=graph_kind)
    ev, jev = _eval_fns(data, 5)
    plan = engine_plan.compile_problem(tprob, qp_iters=50)
    st_ref, hist_ref = plan.run(iters=6, eval_fn=ev)
    res = run_async(tprob, 6, net=NetConfig(), qp_iters=50, eval_fn=ev)
    assert res.fabric.mode == "buffer"
    _assert_equal(st_ref, res.state)
    assert torch.equal(hist_ref, res.history)
    # and the identity fabric still meters: every edge, every round
    E = int(np.asarray(jprob.adj).sum())
    T = tprob.X.shape[1]
    assert res.report["msgs_sent"] == pytest.approx(6 * E * T)
    assert res.report["bytes_per_round"] == pytest.approx(
        E * T * bytes_per_message("float32", res.fabric.D))
    assert res.report["delivery_rate"] == 1.0
    jres = jrun_async(jprob, 6, net=JNetConfig(), qp_iters=50, eval_fn=jev)
    _assert_near_reference(res.state, jres.state, f"identity {graph_kind}")
    for k in ("msgs_sent", "msgs_delivered", "bytes_sent", "warmfill_msgs",
              "bytes_per_edge", "edges", "payload_dim", "mode"):
        assert res.report[k] == jres.report[k], k


def test_identity_fabric_bitwise_vs_vmap_backend():
    """backend="async" with the identity NetConfig is the vmap backend's
    state and history, bit for bit, through ``backends.run``."""
    tprob, _, data = _problem(V=6)
    ev, _ = _eval_fns(data, 6)
    kw = dict(qp_iters=30, qp_solver="pallas_fused_multi", eval_fn=ev)
    st_v, h_v = backends.run(tprob, 5, backend="vmap", **kw)
    out = {}
    st_a, h_a = backends.run(tprob, 5, backend="async", net=NetConfig(),
                             meter_out=out, **kw)
    _assert_equal(st_v, st_a)
    assert torch.equal(h_v, h_a)
    assert out["fabric"].mode == "buffer" and out["report"]["rounds"] == 5


def test_identity_fabric_bitwise_masks_and_warm_start():
    V, T = 6, 3
    active = np.ones((V, T), np.float32)
    active[3:, 1] = 0.0                      # source-less nodes (Fig. 6)
    couple = np.zeros((V,), np.float32)
    couple[:3] = 1.0
    tprob, jprob, _ = _problem(V=V, T=T, active=active, couple=couple)
    plan = engine_plan.compile_problem(tprob, qp_iters=40)
    st_mid, _ = plan.run(iters=3)            # a nonzero warm start
    st_ref, _ = plan.run(state=st_mid, iters=4)
    res = run_async(tprob, 4, net=NetConfig(), qp_iters=40, state=st_mid)
    _assert_equal(st_ref, res.state)
    jres = jrun_async(jprob, 7, net=JNetConfig(), qp_iters=40)
    _assert_near_reference(res.state, jres.state, "masks + warm start")


def test_identity_fabric_bitwise_property():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None, database=None)
    @given(seed=st.integers(0, 10_000), V=st.integers(3, 6),
           degree=st.floats(0.3, 1.0), data=st.data())
    def prop(seed, V, degree, data):
        T = 2
        rng = np.random.default_rng(seed)
        active = data.draw(st.lists(
            st.lists(st.sampled_from([0.0, 1.0]), min_size=T, max_size=T),
            min_size=V, max_size=V).map(
                lambda x: np.asarray(x, np.float32)))
        if active.sum() == 0:
            active[0, 0] = 1.0               # keep at least one live task
        couple = (rng.random(V) < 0.5).astype(np.float32)
        tprob, _, _ = _problem(V=V, T=T, seed=seed, degree=degree,
                               active=active, couple=couple)
        plan = engine_plan.compile_problem(tprob, qp_iters=30)
        st_ref, _ = plan.run(iters=4)
        res = run_async(tprob, 4, net=NetConfig(), qp_iters=30)
        _assert_equal(st_ref, res.state)

    prop()


def test_mailbox_mode_identity_policy_matches_to_tolerance():
    """The per-edge mailbox path under an identity policy is the same
    math in another reduction order: close, not bitwise."""
    tprob, jprob, _ = _problem()
    fab = build_fabric(tprob, NetConfig(), force_mailbox=True)
    assert fab.mode == "mailbox"
    plan = engine_plan.compile_problem(tprob, qp_iters=50)
    st_ref, _ = plan.run(iters=6)
    res = run_async(tprob, 6, net=NetConfig(), qp_iters=50, fabric=fab)
    for name, a, b in zip(st_ref._fields, st_ref, res.state):
        torch.testing.assert_close(b, a, atol=2e-5, rtol=2e-5, msg=name)


# ---------------------------------------------------------------------------
# link semantics (the fabric driven directly)
# ---------------------------------------------------------------------------
def _two_node_fabric(policy, T=1, warm_fill=False, **net_kw):
    adj = np.array([[0, 1], [1, 0]], bool)
    net = NetConfig(policy=policy, warm_fill=warm_fill, **net_kw)
    fab = Fabric(adj, dim=3, net=net, force_mailbox=True, device="cpu")
    st = fab.init_state(torch.zeros((2, T, 3)))
    return fab, st


def _exchange(fab, st, payload, act, r, **kw):
    """One mailbox round ``r`` over the consensus graph, with the drop
    mask ``run_async`` would draw for it."""
    return fab.exchange(st, payload, act, None, rnd=r,
                        keep=fab.keep_masks(r, 1)[0], **kw)


def _round_payload(r):
    """A distinguishable payload per round: node v sends constant v+10r."""
    base = torch.tensor([[[1.0]], [[2.0]]])          # (V=2, T=1, D->bcast)
    return (base + 10.0 * r).expand(2, 1, 3).to(torch.float32)


def test_delay_delivers_older_payloads():
    d = 2
    fab, st = _two_node_fabric(LinkPolicy(delay=d))
    act = torch.ones(2)
    for r in range(5):
        st, _ = _exchange(fab, st, _round_payload(r), act, r)
        got = st.mailbox                              # (V, V, T, D)
        if r < d:                                     # nothing arrived yet
            assert float(got.max()) == 0.0
        else:                                         # round r-d's payload
            assert torch.equal(got[0, 1], _round_payload(r - d)[1])
            assert torch.equal(got[1, 0], _round_payload(r - d)[0])


def test_drop_one_blocks_all_delivery():
    fab, st = _two_node_fabric(LinkPolicy(drop=1.0))
    act = torch.ones(2)
    total_bytes = 0.0
    for r in range(4):
        st, b = _exchange(fab, st, _round_payload(r), act, r)
        total_bytes += float(b)
    assert float(st.mailbox.max()) == 0.0
    assert float(st.msgs_delivered.sum()) == 0.0
    # senders still paid for every in-transit loss
    assert float(st.msgs_sent.sum()) == 8.0
    assert total_bytes == pytest.approx(8 * bytes_per_message("float32", 3))


def test_drop_stream_is_seeded_split_invariant_and_the_references():
    """The same rounds split across calls deliver what one run delivers,
    another seed differs, and the reference fabric delivers exactly the
    same messages (its drop stream, bit for bit)."""
    from repro.net import Fabric as JFabric

    def run_rounds(splits, seed):
        fab, st = _two_node_fabric(LinkPolicy(drop=0.5), seed=seed)
        act = torch.ones(2)
        r = 0
        for n in splits:
            for _ in range(n):
                st, _ = _exchange(fab, st, _round_payload(r), act, r)
                r += 1
        return st.msgs_delivered, st.mailbox

    d1, m1 = run_rounds([8], seed=7)
    d2, m2 = run_rounds([3, 5], seed=7)     # same stream, split mid-way
    assert torch.equal(d1, d2) and torch.equal(m1, m2)
    d3, _ = run_rounds([8], seed=8)
    assert not torch.equal(d1, d3)          # a different seed differs
    jfab = JFabric(np.array([[0, 1], [1, 0]], bool), dim=3,
                   net=JNetConfig(policy=JLinkPolicy(drop=0.5),
                                  warm_fill=False, seed=7),
                   force_mailbox=True)
    jst = jfab.init_state(jnp.zeros((2, 1, 3), jnp.float32))
    for r in range(8):
        jst, _ = jfab.exchange(jst, jnp.asarray(_round_payload(r).numpy()),
                               jnp.ones(2), None)
    np.testing.assert_array_equal(d1.numpy(),
                                  np.asarray(jst.msgs_delivered))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jst.mailbox))


def test_bandwidth_token_bucket_halves_throughput():
    bpm = bytes_per_message("float32", 3)
    fab, st = _two_node_fabric(LinkPolicy(bandwidth=bpm / 2))
    act = torch.ones(2)
    for r in range(8):
        st, _ = _exchange(fab, st, _round_payload(r), act, r)
    # credit starts full (1 message), then refills half a message per
    # round: 8 rounds -> 1 + floor(7/2) = 4 sends per directed edge
    assert torch.equal(st.msgs_sent, torch.tensor([[0.0, 4.0], [4.0, 0.0]]))


def test_delayed_delivery_charged_at_send_round_task_count():
    """A message that sat in the delay ring across a membership change
    is charged at the task count it was sent with."""
    fab, st = _two_node_fabric(LinkPolicy(delay=1), T=2)
    act = torch.ones(2)
    payload = torch.ones((2, 2, 3))
    st, _ = _exchange(fab, st, payload, act, 0,
                      task_counts=torch.tensor([1.0, 1.0]))
    st, _ = _exchange(fab, st, payload, act, 1,
                      task_counts=torch.tensor([2.0, 2.0]))
    # round 1 delivers round 0's sends: 1 task-vector per directed edge
    assert float(st.msgs_delivered.sum()) == 2.0
    assert float(st.msgs_sent.sum()) == 6.0   # 2*1 + 2*2


def test_inactive_senders_keep_neighbors_stale():
    fab, st = _two_node_fabric(LinkPolicy())
    st, _ = _exchange(fab, st, _round_payload(0), torch.ones(2), 0)
    # node 1 goes silent; node 0 keeps its stale copy of round 0
    st, _ = _exchange(fab, st, _round_payload(1), torch.tensor([1.0, 0.0]),
                      1)
    assert torch.equal(st.mailbox[0, 1], _round_payload(0)[1])
    assert torch.equal(st.mailbox[1, 0], _round_payload(1)[0])


def test_exchange_leaves_its_input_state_as_it_was():
    """No fabric method changes a state in place: a caller's old state
    (a split run, a snapshot) stays valid."""
    fab, st = _two_node_fabric(LinkPolicy(delay=1, drop=0.3), seed=1)
    before = snapshot_state(st)
    st2, _ = _exchange(fab, st, _round_payload(0), torch.ones(2), 0)
    for k, v in snapshot_state(st).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert int(st2.round) == 1


def test_mailbox_exchange_needs_the_round_and_its_drop_mask():
    """One path draws drop masks: the caller's ``keep_masks``."""
    fab, st = _two_node_fabric(LinkPolicy(drop=0.3))
    with pytest.raises(ValueError, match="keep_masks"):
        fab.exchange(st, _round_payload(0), torch.ones(2), None,
                     rnd=None, keep=None)
    with pytest.raises(ValueError, match="keep_masks"):
        fab.exchange(st, _round_payload(0), torch.ones(2), None, rnd=0,
                     keep=None)


@pytest.mark.parametrize("quant,width", [("float32", 4), ("float16", 2),
                                         ("int16", 2), ("int8", 1)])
def test_quant_roundtrip_error_bound_bytes_and_the_references(quant, width):
    rng = np.random.default_rng(0)
    x = rng.normal(scale=3.0, size=(5, 4, 22)).astype(np.float32)
    code = policies.QUANT_CODES[quant]
    dq = policies.apply_quant(torch.from_numpy(x), code).numpy()
    bound = policies.quant_error_bound(x, quant)
    assert bound == jpolicies.quant_error_bound(x, quant)
    assert float(np.abs(dq - x).max()) <= bound
    got = bytes_per_message(quant, 22)
    assert got == width * 22 + (4 if quant.startswith("int") else 0)
    assert got == jpolicies.bytes_per_message(quant, 22)
    # the same operations on the same floats: bitwise the reference's
    np.testing.assert_array_equal(
        dq, np.asarray(jpolicies.apply_quant(jnp.asarray(x), code)))
    if quant == "float32":
        np.testing.assert_array_equal(dq, x)


def test_quant_zero_vectors_stay_zero_and_ties_round_to_even():
    z = torch.zeros((3, 7))
    for code in range(4):
        assert torch.equal(policies.apply_quant(z, code), z)
    # scale 127 / 127 = 1: 0.5 and 2.5 round half to even, as jnp.round
    x = torch.tensor([[0.5, 2.5, -1.5, 127.0]])
    assert policies.apply_quant(x, 3).tolist() == [[0.0, 2.0, -2.0, 127.0]]


def test_per_edge_policies_override_default():
    adj = np.ones((3, 3), bool)
    np.fill_diagonal(adj, False)
    net = NetConfig(policy=LinkPolicy(quant="int8"),
                    edge_policies={(0, 1): LinkPolicy(quant="float32",
                                                      delay=2)})
    fab = Fabric(adj, dim=4, net=net, device="cpu")
    assert fab.mode == "mailbox"
    m = fab.qcode_m
    assert m[1, 0] == policies.QUANT_CODES["float32"]    # edge 0 -> 1
    assert m[0, 1] == policies.QUANT_CODES["int8"]
    assert fab.delay_m[1, 0] == 2
    assert fab.hist_len == 3


def test_policy_validation_and_dicts_are_the_references():
    for kw in (dict(delay=-1), dict(drop=1.5), dict(quant="int4"),
               dict(bandwidth=0.0)):
        with pytest.raises(ValueError):
            LinkPolicy(**kw)
    with pytest.raises(ValueError, match="stale_limit"):
        NetConfig(stale_limit=-1)
    kw = dict(policy=dict(quant="int8", drop=0.1, delay=1, bandwidth=90.0),
              edge_policies={(0, 1): dict(quant="float16")},
              schedule="partial:0.5", seed=3, warm_fill=False,
              stale_limit=2)
    net, jnet = _nets(**kw)
    d = jnet.to_dict()
    assert net.to_dict() == d
    assert NetConfig.from_dict(d) == net
    assert net.is_identity == jnet.is_identity is False
    assert NetConfig().is_identity and NetConfig(
        schedule="partial:0.8").is_identity
    with pytest.raises(TypeError, match="string schedule"):
        NetConfig(schedule=schedule_lib.Schedule()).to_dict()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def test_schedule_resolve_specs():
    assert type(schedule_lib.resolve("full")) is schedule_lib.Schedule
    assert isinstance(schedule_lib.resolve("round_robin"),
                      schedule_lib.RoundRobin)
    assert schedule_lib.resolve("partial:0.25").frac == 0.25
    assert isinstance(schedule_lib.resolve("gossip"), schedule_lib.Gossip)
    tv = schedule_lib.resolve("links:ring:0.5")
    assert (tv.kind, tv.degree) == ("ring", 0.5)
    with pytest.raises(ValueError):
        schedule_lib.resolve("nope")
    sched = schedule_lib.resolve("partial:0.5", seed=3)
    assert sched.seed == 3                      # string specs inherit seed


@pytest.mark.parametrize("spec", ["round_robin", "partial:0.5", "gossip",
                                  "links:random:0.6"])
def test_schedule_continuation_is_prefix_consistent_and_the_references(spec):
    V = 5
    adj = graph.make_graph("random", V, degree=0.8, seed=0)
    s = schedule_lib.resolve(spec, seed=11)
    a_full, l_full = s.emit(V, 10, adj=adj)
    a1, l1 = s.emit(V, 4, adj=adj)
    a2, l2 = s.emit(V, 6, adj=adj, round0=4)
    np.testing.assert_array_equal(a_full, np.concatenate([a1, a2]))
    if l_full is not None:
        np.testing.assert_array_equal(l_full, np.concatenate([l1, l2]))
    ja, jl = jschedule.resolve(spec, seed=11).emit(V, 10, adj=adj)
    np.testing.assert_array_equal(a_full, ja)
    assert (l_full is None) == (jl is None)
    if jl is not None:
        np.testing.assert_array_equal(l_full, jl)


def test_round_robin_covers_every_node():
    acts, links = schedule_lib.RoundRobin().emit(4, 8)
    assert links is None
    np.testing.assert_array_equal(acts.sum(1), np.ones(8))
    np.testing.assert_array_equal(acts.sum(0), np.full(4, 2.0))


def test_gossip_one_edge_both_endpoints():
    V = 5
    adj = graph.ring(V)
    acts, links = schedule_lib.Gossip(seed=0).emit(V, 12, adj=adj)
    for r in range(12):
        assert acts[r].sum() == 2.0
        assert links[r].sum() == 2             # one edge, both directions
        u, v = np.nonzero(acts[r])[0]
        assert links[r][u, v] and links[r][v, u] and adj[u, v]


# ---------------------------------------------------------------------------
# graph satellites
# ---------------------------------------------------------------------------
def test_laplacian_and_metropolis_are_the_references():
    A = graph.make_graph("random", 6, degree=0.7, seed=1)
    L = graph.laplacian(A)
    np.testing.assert_array_equal(L, jgraph.laplacian(A))
    np.testing.assert_allclose(L.sum(1), 0.0, atol=1e-12)
    evals = np.linalg.eigvalsh(L)
    assert evals.min() >= -1e-9                # PSD
    assert np.sum(np.abs(evals) < 1e-9) == 1   # connected: one zero mode
    A = graph.make_graph("random", 7, degree=0.6, seed=2)
    W = graph.metropolis_weights(A)
    np.testing.assert_array_equal(W, jgraph.metropolis_weights(A))
    np.testing.assert_array_equal(W, W.T)
    np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-12)
    off = ~np.eye(7, dtype=bool)
    np.testing.assert_array_equal((W > 0) & off, A)   # off-diag support
    assert graph.network_degree(A) == jgraph.network_degree(A)


@pytest.mark.parametrize("kind", ["static", "random", "ring"])
def test_graph_schedule_emits_the_references_valid_adjacency(kind):
    seq = graph.schedule(kind, 6, 5, seed=3, degree=0.5, round0=2)
    np.testing.assert_array_equal(
        seq, jgraph.schedule(kind, 6, 5, seed=3, degree=0.5, round0=2))
    assert seq.shape == (5, 6, 6)
    for A in seq:
        np.testing.assert_array_equal(A, A.T)
        assert not A.diagonal().any()
        assert graph.is_connected(A)


# ---------------------------------------------------------------------------
# lossy runs against the reference
# ---------------------------------------------------------------------------
LOSSY = {
    "delay": dict(policy=dict(delay=1)),
    "drop": dict(policy=dict(drop=0.3), seed=5),
    "int8": dict(policy=dict(quant="int8")),
    "int16": dict(policy=dict(quant="int16")),
    "float16": dict(policy=dict(quant="float16")),
    "bandwidth": dict(policy=dict(bandwidth=60.0)),
    "partial": dict(schedule="partial:0.5", seed=1),
    "gossip": dict(schedule="gossip", seed=2),
    "links": dict(schedule="links:random:0.5"),
    "per_edge": dict(policy=dict(quant="int8"), edge_policies={
        (0, 1): dict(delay=2), (2, 3): dict(quant="float16", drop=0.5)},
        seed=4),
    "int8_drop_delay": dict(policy=dict(quant="int8", drop=0.3, delay=2),
                            seed=3),
}


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_lossy_run_matches_the_reference(name):
    """Each lossy configuration through both packages: the counters
    equal exactly, the states within REL (see the module doc)."""
    tprob, jprob, _ = _problem()
    net, jnet = _nets(**LOSSY[name])
    res = run_async(tprob, 10, net=net, qp_iters=40)
    jres = jrun_async(jprob, 10, net=jnet, qp_iters=40)
    assert res.fabric.mode == jres.fabric.mode
    _assert_near_reference(res.state, jres.state, name)
    for f in ("msgs_sent", "msgs_delivered", "ok_hist", "silence", "credit",
              "round", "warmfill_msgs", "tc_hist"):
        np.testing.assert_array_equal(
            getattr(res.fabric_state, f).numpy(),
            np.asarray(getattr(jres.fabric_state, f)), err_msg=f)
    for k, v in jres.report.items():
        if k != "bytes_round_series":
            assert res.report[k] == v, k
    np.testing.assert_allclose(res.report["bytes_round_series"],
                               jres.report["bytes_round_series"], rtol=0)


def test_snapshot_restores_and_continues_bitwise():
    """``restore_state(snapshot_state(st))`` continues a lossy run as the
    live state does, with every field's dtype pinned."""
    tprob, _, _ = _problem()
    net = NetConfig(policy=LinkPolicy(quant="int8", drop=0.3, delay=1),
                    seed=2)
    r1 = run_async(tprob, 4, net=net, qp_iters=30)
    tree = {k: v.astype(np.float64) if k == "round" else v
            for k, v in snapshot_state(r1.fabric_state).items()}
    fst = restore_state(tree, device="cpu")
    assert fst.round.dtype == torch.int32 and fst.ok_hist.dtype == torch.bool
    a = run_async(tprob, 4, net=net, qp_iters=30, state=r1.state,
                  fabric=r1.fabric, fabric_state=r1.fabric_state, round0=4)
    b = run_async(tprob, 4, net=net, qp_iters=30, state=r1.state,
                  fabric=r1.fabric, fabric_state=fst, round0=4)
    _assert_equal(a.state, b.state)
    with pytest.raises(ValueError, match="do not match"):
        restore_state({"mailbox": np.zeros(1)}, device="cpu")


def test_int16_quantization_stays_close_to_baseline():
    """A <=16-bit wire stays within 1e-3 of the float32 final risks at
    a fraction of the bytes."""
    tprob, _, data = _problem(V=6, T=2, n=12, seed=1)
    ev, _ = _eval_fns(data, 6)
    base = run_async(tprob, 15, net=NetConfig(), qp_iters=60, eval_fn=ev)
    q16 = run_async(tprob, 15,
                    net=NetConfig(policy=LinkPolicy(quant="int16")),
                    qp_iters=60, eval_fn=ev)
    assert float((base.history[-1] - q16.history[-1]).abs().max()) <= 1e-3
    assert q16.report["bytes_sent"] < 0.6 * base.report["bytes_sent"]


def test_partial_activation_still_learns():
    tprob, _, data = _problem(V=5, T=2, n=12, seed=2)
    ev, _ = _eval_fns(data, 5)
    res = run_async(tprob, 24, net=NetConfig(schedule="partial:0.5",
                                             seed=1), qp_iters=60,
                    eval_fn=ev)
    hist = res.history.numpy()
    assert hist[-1].mean() < hist[0].mean()      # risk still comes down
    E = int(tprob.adj.sum())
    assert res.report["msgs_sent"] < 24 * E * tprob.X.shape[1]


def test_time_varying_links_force_mailbox_mode():
    tprob, _, _ = _problem()
    res = run_async(tprob, 3, net=NetConfig(schedule="links:random:0.5"),
                    qp_iters=20)
    assert res.fabric.mode == "mailbox"
    with pytest.raises(ValueError, match="mailbox"):
        run_async(tprob, 3, net=NetConfig(schedule="links:random:0.5"),
                  qp_iters=20, fabric=build_fabric(tprob, NetConfig()))


def test_meter_report_consistency():
    tprob, _, _ = _problem()
    net = NetConfig(policy=LinkPolicy(quant="int8", drop=0.3), seed=5)
    rep = run_async(tprob, 10, net=net, qp_iters=20).report
    assert rep["bytes_sent"] == pytest.approx(
        rep["bytes_sent_series_total"], rel=1e-6)
    assert rep["bytes_sent"] == pytest.approx(
        np.asarray(rep["bytes_per_edge"]).sum(), rel=1e-6)
    assert len(rep["bytes_round_series"]) == 10
    assert 0.0 < rep["delivery_rate"] < 1.0      # drop=0.3 loses some
    assert rep["bytes_per_message_min"] == bytes_per_message("int8", 14)
    assert "KiB total" in meter.summarize(rep)


def test_meter_merge_reports():
    tprob, _, _ = _problem()
    net = NetConfig(policy=LinkPolicy(quant="int16"))
    r1 = run_async(tprob, 4, net=net, qp_iters=20)
    r2 = run_async(tprob, 6, net=net, qp_iters=20, state=r1.state,
                   fabric=r1.fabric, round0=4)
    merged = meter.merge_reports(r1.report, r2.report)
    assert merged["rounds"] == 10
    assert merged["bytes_sent"] == pytest.approx(
        r1.report["bytes_sent"] + r2.report["bytes_sent"])
    assert len(merged["bytes_round_series"]) == 10


# ---------------------------------------------------------------------------
# api wiring: backend registry, SolverConfig.net, the fabric-aware session
# ---------------------------------------------------------------------------
def test_async_backend_registered_and_plan_validated():
    assert "async" in backends.names()
    tprob, _, _ = _problem()
    other = engine_plan.compile_problem(tprob, qp_iters=99)
    with pytest.raises(ValueError, match="prebuilt plan= disagrees"):
        backends.run(tprob, 2, backend="async", qp_iters=50, plan=other)
    for mode in (dict(qp_precision="bf16"), dict(qp_operator="factored")):
        with pytest.raises(ValueError, match="vmap-backend features"):
            backends.run(tprob, 2, backend="async", qp_iters=5,
                         qp_solver="pallas_fused_multi", **mode)
    bf16 = engine_plan.compile_problem(tprob, qp_iters=5,
                                       qp_solver="pallas_fused_multi",
                                       qp_precision="bf16")
    with pytest.raises(ValueError, match="materialized f32"):
        run_async(tprob, 1, plan=bf16)
    # telemetry (ROADMAP.md item 5, done): the reference's stream keys
    res = run_async(tprob, 2, qp_iters=5, telemetry=Telemetry())
    assert set(res.telemetry) == set(STREAMS) | {"bytes_round",
                                                 "staleness"}
    assert res.telemetry["staleness"].shape == (2, tprob.X.shape[0])


def test_net_is_rejected_where_unsupported():
    data, A = _data(V=4, T=2)
    cfg = SolverConfig(net=NetConfig(), iters=2, qp_iters=10)
    args = (data["X"], data["y"])
    with pytest.raises(ValueError, match="single-fit"):   # sweeps are
        sweep_fit(*args, [dict(C=0.01)], mask=data["mask"], adj=A,
                  base=cfg, device="cpu")                 # synchronous
    with pytest.raises(ValueError, match="single-fit"):
        sweep_fit(*args, [cfg], mask=data["mask"], adj=A, device="cpu")
    with pytest.raises(ValueError, match="jit=True"):
        OnlineSession(*args, mask=data["mask"], adj=A, config=cfg,
                      jit=True, device="cpu")
    with pytest.raises(ValueError, match="centralized"):
        CSVM(cfg).fit(*args, device="cpu")
    with pytest.raises(ValueError, match="async-backend feature"):
        DTSVM(cfg.replace(backend="shard_map"), device="cpu").fit(
            *args, mask=data["mask"], adj=A)
    with pytest.raises(ValueError, match="membership="):
        DTSVM(SolverConfig(iters=1), device="cpu").fit(
            *args, adj=A, membership=object())


def test_solver_config_net_routes_to_async():
    """DTSVM with the identity net is the vmap fit bitwise, and its byte
    report is the reference's."""
    data, A = _data(V=4, T=2)
    args = (data["X"], data["y"])
    kw = dict(mask=data["mask"], adj=A)
    cfg = SolverConfig(C=0.01, iters=5, qp_iters=40)
    ref = DTSVM(cfg, device="cpu").fit(*args, **kw)
    asy = DTSVM(cfg.replace(net=NetConfig()), device="cpu").fit(*args, **kw)
    _assert_equal(ref.state_, asy.state_)
    assert ref.net_report_ is None
    jasy = JDTSVM(JSolverConfig(C=0.01, iters=5, qp_iters=40,
                                net=JNetConfig())).fit(*args, **kw)
    _assert_near_reference(asy.state_, jasy.state_, "DTSVM net")
    for k, v in jasy.net_report_.items():
        if k != "bytes_round_series":
            assert asy.net_report_[k] == v, k


def _run_session_stages(data, A, V, net, session_cls=OnlineSession,
                        config_cls=SolverConfig, **kw):
    cfg = config_cls(C=0.01, qp_iters=40, net=net)
    sess = session_cls(data["X"], data["y"], mask=data["mask"], adj=A,
                       config=cfg, couple=np.zeros(V, np.float32), **kw)
    sess.run(3, record=False)
    sess.drop_task(1)
    sess.set_coupling(True)
    sess.run(3, record=False)
    sess.add_task(1)
    sess.drop_task(0)
    sess.run(3, record=False)
    return sess


def test_session_async_identity_bitwise_across_stages():
    V, T = 5, 3
    n_train = np.full((V, T), 8, int)
    data = synthetic.make_multitask_data(V=V, T=T, p=6, n_train=n_train,
                                         n_test=40, seed=0)
    A = jgraph.make_graph("random", V, degree=0.7, seed=1)
    ref = _run_session_stages(data, A, V, None, device="cpu")
    asy = _run_session_stages(data, A, V, NetConfig(), device="cpu")
    _assert_equal(ref.state, asy.state)
    rep = asy.net_report_
    assert rep["rounds"] == 9
    assert len(rep["bytes_round_series"]) == 9     # series spans stages
    assert rep["bytes_sent"] == pytest.approx(
        rep["bytes_sent_series_total"], rel=1e-6)
    E = np.asarray(A).sum()
    # bootstrap (T tasks) + two membership events (1 + 2 changed tasks)
    assert rep["warmfill_msgs"] == E * (T + 1 + 2)
    jasy = _run_session_stages(data, A, V, JNetConfig(), JOnlineSession,
                               JSolverConfig)
    _assert_near_reference(asy.state, jasy.state, "async session")
    for k, v in jasy.net_report_.items():
        if k != "bytes_round_series":
            assert rep[k] == v, k


def test_session_lossy_fabric_persists_across_stages():
    V, T = 5, 2
    n_train = np.full((V, T), 8, int)
    data = synthetic.make_multitask_data(V=V, T=T, p=6, n_train=n_train,
                                         n_test=40, seed=0)
    A = jgraph.make_graph("random", V, degree=0.7, seed=1)
    pol = dict(quant="int8", drop=0.4, delay=1)
    sessions = []
    for S, C, N, L, kw in (
            (OnlineSession, SolverConfig, NetConfig, LinkPolicy,
             dict(device="cpu")),
            (JOnlineSession, JSolverConfig, JNetConfig, JLinkPolicy, {})):
        sess = S(data["X"], data["y"], mask=data["mask"], adj=A,
                 config=C(C=0.01, qp_iters=40,
                          net=N(policy=L(**pol), seed=9)), **kw)
        sess.run(4, record=False)
        rounds4 = int(np.asarray(sess._net_state.round))
        fabric = sess._net_fabric
        sess.drop_task(1)
        sess.run(4, record=False)
        assert int(np.asarray(sess._net_state.round)) == rounds4 + 4
        assert sess._net_fabric is fabric           # one fabric throughout
        assert sess.net_report_["rounds"] == 8
        assert 0.0 < sess.net_report_["delivery_rate"] < 1.0
        sessions.append(sess)
    sess, jsess = sessions
    _assert_near_reference(sess.state, jsess.state, "lossy session")
    for k in ("msgs_sent", "msgs_delivered", "bytes_sent", "warmfill_msgs"):
        assert sess.net_report_[k] == jsess.net_report_[k], k
