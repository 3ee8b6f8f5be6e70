"""The port's ``"shard_map"`` backend (``repro_torch.core.dtsvm_dist`` on
``repro_torch.dist.World``) against the reference's.

The reference runs in one subprocess with 8 forced host devices
(``helpers.run_with_devices``) on tests/test_api.py's data (V=8, T=2,
p=10, 8 samples a task, 10 ADMM x 50 QP iterations; a random graph of
degree 0.7 for ``graph``, ``graph.ring(8)`` for ``ring``).  The port runs
gloo worlds of CPU ranks and is held to the reference's own bar for this
backend (tests/test_api.py:137-141): state within 1e-5, risks within
1e-6; the telemetry streams within tests/test_torch_obs.py's bounds.
Whether the port's ``shard_map`` came out bitwise its own ``vmap`` is
printed (on this tree it does on the CPU).  Also: the hooks the backend
runs through, each against the reference's same hook in-process; the
collective neighbor sums; what a rank receives; a budgeted fit; the
refusals; a rank that raises or dies.  Every world has its own timeout.
"""
import os

import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro.engine import invariants as jinv
from repro.engine import plan as jplan
from repro_torch.api import DTSVM, OnlineSession, PlanBudget, SolverConfig
from repro_torch.core import dtsvm as core
from repro_torch.core import dtsvm_dist
from repro_torch.dist import RankError, World
from repro_torch.engine import invariants as inv_lib
from repro_torch.engine import plan as engine_plan
from test_torch_obs import _assert_streams_close

V, T, P = 8, 2, 10
STATE_TOL, RISK_TOL = 1e-5, 1e-6
#: seconds any wait of a test's world may take
WORLD_TIMEOUT = 120.0
CFG = dict(C=0.01, iters=10, qp_iters=50)
TOPOLOGIES = ("graph", "ring")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    return jsynthetic.make_multitask_data(
        V=V, T=T, p=P, n_train=np.full((V, T), 8, int), n_test=50, seed=1)


def _adj(topology: str) -> np.ndarray:
    return (jgraph.ring(V) if topology == "ring"
            else jgraph.make_graph("random", V, 0.7, seed=0))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's shard_map fits, 3-round histories and telemetry
    streams per topology, from one 8-device subprocess."""
    path = str(tmp_path_factory.mktemp("dist") / "reference.npz")
    run_with_devices(f"""
        import numpy as np
        from repro.api import DTSVM, SolverConfig
        from repro.core import graph
        from repro.data import synthetic
        V, T = {V}, {T}
        data = synthetic.make_multitask_data(
            V=V, T=T, p={P}, n_train=np.full((V, T), 8, int), n_test=50,
            seed=1)
        out = {{}}
        for topo in {TOPOLOGIES!r}:
            A = graph.ring(V) if topo == "ring" else \\
                graph.make_graph("random", V, 0.7, seed=0)
            cfg = SolverConfig(**{CFG!r}, backend="shard_map",
                               backend_options={{"topology": topo}})
            fit = lambda c, **kw: DTSVM(c).fit(
                data["X"], data["y"], mask=data["mask"], adj=A, **kw)
            m = fit(cfg)
            for k, v in zip(("r", "alpha", "beta", "lam"), m.state_):
                out[topo + "/" + k] = np.asarray(v)
            out[topo + "/risks"] = np.asarray(
                m.risks(data["X_test"], data["y_test"]))
            out[topo + "/hist"] = np.asarray(fit(
                cfg.replace(iters=3), X_test=data["X_test"],
                y_test=data["y_test"]).history_)
            for k, v in fit(cfg.replace(telemetry=True)).telemetry_.items():
                out[topo + "/tel/" + k] = np.asarray(v)
        np.savez({path!r}, **out)
        print("DONE")
    """, n_devices=V)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def world8():
    with dtsvm_dist.make_node_world(V, "cpu",
                                    timeout=WORLD_TIMEOUT) as world:
        yield world


def _fit(cfg, data, adj, **kw):
    return DTSVM(cfg, device="cpu").fit(data["X"], data["y"],
                                        mask=data["mask"], adj=adj, **kw)


def _shard_cfg(topology, world=None, **kw):
    options = {"topology": topology}
    if world is not None:
        options["world"] = world
    return SolverConfig(**CFG, backend="shard_map", backend_options=options,
                        **kw)


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the hooks, against the reference's, in-process
# ---------------------------------------------------------------------------
def _hook_problems(seed=0):
    """The same small problem in both packages, and a weighted adjacency
    W with its (V, T) counts: a neighbor sum other than the default."""
    data = jsynthetic.make_multitask_data(
        V=4, T=2, p=5, n_train=np.full((4, 2), 7, int), n_test=10,
        seed=seed)
    adj = jgraph.make_graph("random", 4, 0.7, seed=seed)
    jprob = jcore.make_problem(data["X"], data["y"], data["mask"], adj)
    tprob = core.make_problem(data["X"], data["y"], data["mask"], adj,
                              device="cpu")
    W = (np.random.default_rng(seed).uniform(0.5, 1.5, size=(4, 4))
         * adj).astype(np.float32)
    counts = W.sum(1, keepdims=True).repeat(2, 1).astype(np.float32)
    return jprob, tprob, W, counts


def _jax_hooks(W, counts):
    import jax.numpy as jnp
    Wj = jnp.asarray(W)
    return dict(nbr_reduce=lambda arr: jnp.einsum("vu,utd->vtd", Wj, arr),
                nbr_counts=jnp.asarray(counts))


def _torch_hooks(W, counts):
    Wt = torch.from_numpy(W)
    return dict(nbr_reduce=lambda arr: torch.einsum("vu,utd->vtd", Wt, arr),
                nbr_counts=torch.from_numpy(counts))


def _close_leaves(got, want, rel=3e-5):
    """Each leaf within ``rel`` of the reference leaf's largest magnitude
    (at least 1)."""
    for g, w in zip(got, want):
        if g is None:
            assert w is None
            continue
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g.numpy() - w).max()) <= rel * scale


def test_dtsvm_step_hooks_match_the_reference():
    jprob, tprob, W, counts = _hook_problems()
    jst = jcore.dtsvm_step(jcore.init_state(jprob), jprob, 30,
                           **_jax_hooks(W, counts))
    hooks = _torch_hooks(W, counts)
    tst = core.dtsvm_step(core.init_state(tprob), tprob, 30, **hooks)
    _close_leaves(tst, jst)
    # a second step reads the first's state through the hooks' sums
    _close_leaves(core.dtsvm_step(tst, tprob, 30, **hooks),
                  jcore.dtsvm_step(jst, jprob, 30, **_jax_hooks(W, counts)))
    plain = core.dtsvm_step(tst, tprob, 30)
    assert _max_err(plain, core.dtsvm_step(tst, tprob, 30, **hooks)) > 1e-4


def test_compute_invariants_nbr_counts_match_the_reference():
    jprob, tprob, W, counts = _hook_problems(1)
    got = inv_lib.compute_invariants(tprob,
                                     nbr_counts=torch.from_numpy(counts))
    _close_leaves(got, jinv.compute_invariants(jprob, nbr_counts=counts))
    assert not torch.equal(got.nbr, inv_lib.compute_invariants(tprob).nbr)


def test_compiled_plan_hooks_match_the_reference_and_survive_replan():
    jprob, tprob, W, counts = _hook_problems(2)
    jpl = jplan.compile_problem(jprob, qp_iters=30, **_jax_hooks(W, counts))
    hooks = _torch_hooks(W, counts)
    tpl = engine_plan.compile_problem(tprob, qp_iters=30, **hooks)
    assert tpl.nbr_reduce is hooks["nbr_reduce"]
    _close_leaves(tpl.inv, jpl.inv)
    jst, _ = jpl.run(iters=4)
    tst, _ = tpl.run(iters=4)
    _close_leaves(tst, jst)
    active = np.ones((4, 2), np.float32)
    active[1, 0] = 0.0
    assert tpl.replan(active=active).nbr_reduce is hooks["nbr_reduce"]


# ---------------------------------------------------------------------------
# the backend against the reference's shard_map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_shard_map_matches_the_reference(topology, reference, world8):
    """graph runs on the module's world (``backend_options["world"]``);
    ring starts and closes a world of its own for each fit."""
    data, adj = _data(), _adj(topology)
    world = world8 if topology == "graph" else None
    m = _fit(_shard_cfg(topology, world), data, adj)
    want = [reference[f"{topology}/{k}"] for k in core.DTSVMState._fields]
    errs = [float(np.abs(g.numpy() - w).max())
            for g, w in zip(m.state_, want)]
    assert max(errs) < STATE_TOL, errs
    np.testing.assert_allclose(m.risks(data["X_test"], data["y_test"]),
                               reference[f"{topology}/risks"],
                               atol=RISK_TOL)
    hist = _fit(_shard_cfg(topology, world).replace(iters=3), data, adj,
                X_test=data["X_test"], y_test=data["y_test"]).history_
    assert np.asarray(hist).shape == (3, V, T)
    np.testing.assert_allclose(np.asarray(hist), reference[f"{topology}/hist"],
                               atol=RISK_TOL)
    vmap = _fit(SolverConfig(**CFG), data, adj)
    print(f"{topology}: vs reference {max(errs):.2e}, vs the port's vmap "
          f"{_max_err(m.state_, vmap.state_):.2e}, bitwise "
          f"{all(torch.equal(a, b) for a, b in zip(m.state_, vmap.state_))}")
    assert _max_err(m.state_, vmap.state_) < STATE_TOL


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_telemetry_streams_match_the_reference(topology, reference, world8):
    data, adj = _data(), _adj(topology)
    cfg = _shard_cfg(topology, world8)
    on = _fit(cfg.replace(telemetry=True), data, adj)
    want = {k.split("/", 2)[2]: v for k, v in reference.items()
            if k.startswith(f"{topology}/tel/")}
    _assert_streams_close(on.telemetry_, want, float(data["mask"].sum()),
                          topology)
    assert on.telemetry_["primal_residual"].shape == (CFG["iters"],)
    # telemetry reads each round's state and writes nothing back
    off = _fit(cfg, data, adj)
    assert all(torch.equal(a, b) for a, b in zip(on.state_, off.state_))


# ---------------------------------------------------------------------------
# the collectives and what a rank holds
# ---------------------------------------------------------------------------
def test_neighbor_sums_are_the_adjacency_sums(world8):
    rng = np.random.default_rng(3)
    arr = torch.from_numpy(rng.normal(size=(V, T, 7)).astype(np.float32))
    adj = rng.uniform(size=(V, V)) < 0.4
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    want = torch.einsum("vu,utd->vtd", torch.from_numpy(adj).float(), arr)
    got = dtsvm_dist.neighbor_sum(world8, arr, adj, "graph")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    ring = dtsvm_dist.neighbor_sum(world8, arr, adj, "ring")
    assert torch.equal(ring, torch.roll(arr, 1, 0) + torch.roll(arr, -1, 0))


def test_a_rank_receives_only_its_node(world8):
    data, adj = _data(), _adj("graph")
    dtsvm_dist.world_stats(world8, reset=True)
    _fit(_shard_cfg("graph", world8).replace(iters=2), data, adj)
    N = data["X"].shape[2]
    stats = dtsvm_dist.world_stats(world8)
    for r, s in enumerate(stats):
        assert s["rank"] == r and s["device"] == "cpu"
        assert s["received"] == {
            "X": (1, T, N, P), "y": (1, T, N), "mask": (1, T, N),
            "adj_row": (1, V), "active": (1, T), "couple": (1,),
            "active_global": (V, T)}
        # two neighbor sums an ADMM iteration, no host copies on the CPU
        assert s["nbr_sums"] == 2 * 2 and s["host_copies"] == 0


def test_budgeted_fit_equals_the_dense_one(world8):
    data = jsynthetic.make_multitask_data(
        V=V, T=T, p=P, n_train=np.full((V, T), 20, int), n_test=10, seed=2)
    adj = _adj("graph")
    budget = PlanBudget(max_elems=2 * 8 * 20)
    assert budget.row_chunk(T, 20) == 8           # binds: 3 panels of K
    cfg = _shard_cfg("graph", world8)
    dense = _fit(cfg, data, adj)
    streamed = _fit(cfg.replace(budget=budget), data, adj)
    assert _max_err(dense.state_, streamed.state_) < STATE_TOL


# ---------------------------------------------------------------------------
# refusals and failures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(backend_options={"topology": "torus"}),
    dict(qp_solver="pallas_fused_multi", qp_precision="bf16"),
    dict(qp_solver="pallas_fused_multi", qp_operator="factored"),
])
def test_shard_map_refuses_what_the_reference_refuses(kw):
    """Each raises before any world starts."""
    data = _data()
    cfg = SolverConfig(**CFG, backend="shard_map").replace(**kw)
    with pytest.raises(ValueError, match="topology|vmap-backend"):
        _fit(cfg, data, _adj("graph"))


def test_a_world_of_the_wrong_size_is_refused(world8):
    data = jsynthetic.make_multitask_data(
        V=4, T=T, p=P, n_train=np.full((4, T), 5, int), n_test=5, seed=0)
    with pytest.raises(ValueError, match="one rank per node"):
        DTSVM(_shard_cfg("graph", world8), device="cpu").fit(
            data["X"], data["y"], adj=jgraph.ring(4))


def _gone(world: World) -> bool:
    return all(not p.is_alive() for p in world._procs)


def test_a_rank_that_raises_stops_the_world():
    """Rank 1 fails building its problem while rank 0 waits in the first
    all_gather: the parent raises rank 1's traceback and kills rank 0."""
    data = jsynthetic.make_multitask_data(
        V=2, T=T, p=P, n_train=np.full((2, T), 5, int), n_test=5, seed=0)
    prob = core.make_problem(data["X"], data["y"], adj=jgraph.ring(2),
                             device="cpu")
    nodes = dtsvm_dist._node_payloads(prob)
    del nodes[1]["X"]
    rows = dtsvm_dist._state_rows(core.init_state(prob))
    world = World(2, device="cpu", timeout=WORLD_TIMEOUT)
    with pytest.raises(RankError, match=r"(?s)rank 1 of 2 raised.*KeyError"):
        world.run(dtsvm_dist._rank_fit, [
            (1, node, "graph", dict(qp_iters=5), st, 2)
            for node, st in zip(nodes, rows)])
    assert world.closed and _gone(world)
    with pytest.raises(RuntimeError, match="closed"):
        world.run_all(os.getpid)


def test_a_rank_that_dies_stops_the_world():
    world = World(2, device="cpu", timeout=WORLD_TIMEOUT)
    assert len(set(world.run_all(os.getpid))) == 2
    with pytest.raises(RankError, match=r"died \(exit code 3\)"):
        world.run(os._exit, [(3,), (3,)])
    assert world.closed and _gone(world)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------
def test_session_keeps_its_world_and_matches_vmap():
    data = jsynthetic.make_multitask_data(
        V=4, T=T, p=P, n_train=np.full((4, T), 6, int), n_test=20, seed=4)
    adj = jgraph.make_graph("random", 4, 0.7, seed=1)
    kw = dict(mask=data["mask"], adj=adj, X_test=data["X_test"],
              y_test=data["y_test"], device="cpu")
    cfg = SolverConfig(iters=3, qp_iters=20)
    sess = OnlineSession(data["X"], data["y"], config=cfg.replace(
        backend="shard_map", budget=PlanBudget(max_elems=2 * 8 * 6)), **kw)
    ref = OnlineSession(data["X"], data["y"], config=cfg, **kw)
    try:
        for s in (sess, ref):
            s.run(3)
            s.drop_task(1)
            s.run(3)
        world = sess._world
        assert world is not None and not world.closed
        sess.add_task(1)
        sess.run(2)
        ref.add_task(1)
        ref.run(2)
        assert sess._world is world
        assert _max_err(sess.state, ref.state) < STATE_TOL
        np.testing.assert_allclose(np.concatenate(sess.history),
                                   np.concatenate(ref.history),
                                   atol=RISK_TOL)
        assert sess.plan_stats == {}
    finally:
        sess.close()
    assert world.closed and _gone(world)
