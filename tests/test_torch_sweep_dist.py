"""The port's device-tiled sweep (``SweepPlan.run_sharded`` on a
``repro_torch.dist.World``, ``sweep_fit(backend="shard_map")``) and
``compile_sweep(nbr_counts=)`` against the reference's.

The reference runs in one subprocess with 8 forced host devices
(``helpers.run_with_devices``) at tests/test_dist.py:118-150's regime
(V=4, T=2, p=6, 6 samples a task, 4 configs, 5 ADMM x 20 QP iterations;
a random graph of degree 0.7 for ``graph``, ``graph.ring(4)`` for
``ring``): 1-D over 4 devices and 2-D over a (2, 4) mesh.  The port runs
two module-scoped gloo worlds of CPU ranks, 4 ranks (1-D) and 2 rows of 4
(2-D, a node group a row), and is held to state within 1e-5 of the
reference and of its own single-host ``run``; whether it came out bitwise
``run`` is printed (on this tree it does, on the CPU).  Also: the
neighbor counts hook in-process, what a 2-D rank receives, a budgeted
sharded sweep, the refusals and a rank that dies.  Every world has its
own timeout.
"""
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro import engine as jengine
from repro.core import dtsvm as jcore
from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro_torch.api import PlanBudget, SolverConfig, backends, sweep_fit
from repro_torch.core import dtsvm as core
from repro_torch.dist import RankError, World, sharding
from repro_torch.dist.collectives import world_stats
from repro_torch.engine import compile_sweep, sweep

V, T, P = 4, 2, 6
ITERS, QP_ITERS = 5, 20
CFGS = [dict(C=0.02), dict(eps2=3.0), dict(eta2=0.7), dict(C=0.1)]
STATE_TOL = 1e-5
#: seconds any wait of a test's world may take
WORLD_TIMEOUT = 120.0
TOPOLOGIES = ("graph", "ring")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=6, v=V):
    return jsynthetic.make_multitask_data(
        V=v, T=T, p=P, n_train=np.full((v, T), n, int), n_test=20, seed=0)


def _adj(topology, v=V):
    return (jgraph.ring(v) if topology == "ring"
            else jgraph.make_graph("random", v, 0.7, seed=0))


def _plan(topology="graph", data=None, v=V, **kw):
    data = _data(v=v) if data is None else data
    prob = core.make_problem(data["X"], data["y"], data["mask"],
                             _adj(topology, v), device="cpu")
    return compile_sweep(prob, CFGS, qp_iters=QP_ITERS, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded sweeps (1-D and 2-D per topology) and its
    single-host run, from one 8-device subprocess."""
    path = str(tmp_path_factory.mktemp("sweep") / "reference.npz")
    run_with_devices(f"""
        import numpy as np
        from repro import engine
        from repro.core import dtsvm, graph
        from repro.data import synthetic
        V, T = {V}, {T}
        data = synthetic.make_multitask_data(
            V=V, T=T, p={P}, n_train=np.full((V, T), 6, int), n_test=20,
            seed=0)
        out = {{}}
        for topo in {TOPOLOGIES!r}:
            A = graph.ring(V) if topo == "ring" else \\
                graph.make_graph("random", V, 0.7, seed=0)
            prob = dtsvm.make_problem(data["X"], data["y"], data["mask"], A)
            splan = engine.compile_sweep(prob, {CFGS!r}, qp_iters={QP_ITERS})
            runs = {{
                "run": splan.run(iters={ITERS})[0],
                "1d": splan.run_sharded(
                    {ITERS}, mesh=engine.make_sweep_mesh({len(CFGS)})),
                "2d": splan.run_sharded(
                    {ITERS}, mesh=engine.make_sweep_mesh({len(CFGS)}, V),
                    node_axis="nodes", topology=topo)}}
            for name, st in runs.items():
                for k, v in zip(("r", "alpha", "beta", "lam"), st):
                    out[topo + "/" + name + "/" + k] = np.asarray(v)
        np.savez({path!r}, **out)
        print("DONE")
    """, n_devices=8)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def world1d():
    with sharding.make_sweep_world(len(CFGS), device="cpu",
                                   timeout=WORLD_TIMEOUT) as world:
        yield world


@pytest.fixture(scope="module")
def world2d():
    with sharding.make_sweep_world(len(CFGS), V, n_sweep=2, device="cpu",
                                   timeout=WORLD_TIMEOUT) as world:
        yield world


def _errs(got, want):
    return [float(np.abs(np.asarray(g) - np.asarray(w)).max())
            for g, w in zip(got, want)]


# ---------------------------------------------------------------------------
# the hook and the layouts
# ---------------------------------------------------------------------------
def _weighted_counts(seed=0):
    adj = _adj("graph")
    W = (np.random.default_rng(seed).uniform(0.5, 1.5, size=(V, V))
         * adj).astype(np.float32)
    return W.sum(1, keepdims=True).repeat(T, 1).astype(np.float32)


def test_compile_sweep_nbr_counts_match_the_reference():
    data, counts = _data(), _weighted_counts()
    jprob = jcore.make_problem(data["X"], data["y"], data["mask"],
                               _adj("graph"))
    want = jengine.compile_sweep(jprob, CFGS, qp_iters=QP_ITERS,
                                 nbr_counts=counts)
    got = _plan(nbr_counts=torch.from_numpy(counts))
    for name, g, w in zip(got.inv._fields, got.inv, want.inv):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g.numpy() - w).max()) <= 3e-5 * scale, name
    assert not torch.equal(got.inv.nbr, _plan().inv.nbr)
    jst, _ = want.run(iters=3)
    st, _ = got.run(iters=3)
    assert max(_errs(st, jst)) < STATE_TOL


def test_per_config_counts_are_the_stacked_counts():
    """(S, V, T) counts, each config's adjacency against its own
    ``active``, give the invariants of the counts the sweep computes
    itself, bitwise."""
    data = _data()
    active = np.ones((V, T), np.float32)
    active[2, 1] = 0.0
    cfgs = CFGS[:3] + [dict(C=0.1, active=active)]
    prob = core.make_problem(data["X"], data["y"], data["mask"],
                             _adj("graph"), device="cpu")
    own = compile_sweep(prob, cfgs, qp_iters=QP_ITERS)
    adjf = prob.adj.to(torch.float32)
    counts = torch.stack([adjf @ pc.active for pc in own.config_problems])
    given = compile_sweep(prob, cfgs, qp_iters=QP_ITERS, nbr_counts=counts)
    for name, a, b in zip(own.inv._fields, own.inv, given.inv):
        assert torch.equal(a, b), name


def test_the_default_layouts():
    assert sharding.DEFAULT_RANKS == 4
    assert [sharding.largest_divisor_leq(n, 4) for n in (16, 6, 7, 64, 1)] \
        == [4, 3, 1, 4, 1]
    assert sharding.sweep_groups(2, 3) == [[0, 1, 2], [3, 4, 5]]
    assert sharding.sample_shards(20000) == 4
    with pytest.raises(ValueError, match="16 configs do not tile evenly "
                                         "over 3 'sweep' devices"):
        sharding.make_sweep_world(16, n_sweep=3)


# ---------------------------------------------------------------------------
# the sharded sweep against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout,topology", [("1d", "graph"),
                                             ("2d", "graph"),
                                             ("2d", "ring")])
def test_run_sharded_matches_the_reference(layout, topology, reference,
                                           world1d, world2d):
    splan = _plan(topology)
    if layout == "1d":
        st = splan.run_sharded(ITERS, world=world1d)
    else:
        st = splan.run_sharded(ITERS, world=world2d, node_axis="nodes",
                               topology=topology)
    want = [reference[f"{topology}/{layout}/{k}"]
            for k in core.DTSVMState._fields]
    errs = _errs(st, want)
    assert max(errs) < STATE_TOL, errs
    ref_run = [reference[f"{topology}/run/{k}"]
               for k in core.DTSVMState._fields]
    assert max(_errs(want, ref_run)) == 0.0      # the reference's contract
    own, _ = splan.run(iters=ITERS)
    bitwise = all(torch.equal(a, b) for a, b in zip(st, own))
    print(f"{layout}/{topology}: vs reference {max(errs):.2e}, vs the "
          f"port's run {max(_errs(st, own)):.2e}, bitwise {bitwise}")
    assert max(_errs(st, own)) < STATE_TOL


def test_a_warm_start_continues_the_run(world1d, world2d):
    splan = _plan()
    half, _ = splan.run(iters=2)
    own, _ = splan.run(iters=ITERS)
    for kw in (dict(world=world1d), dict(world=world2d, node_axis="n")):
        st = splan.run_sharded(ITERS - 2, state=half, **kw)
        assert max(_errs(st, own)) < STATE_TOL


def test_sweep_fit_through_the_shard_map_backend(world1d, world2d):
    data = _data()
    base = SolverConfig(iters=ITERS, qp_iters=QP_ITERS)
    kw = dict(mask=data["mask"], adj=_adj("graph"), base=base, device="cpu")
    dense = sweep_fit(data["X"], data["y"], CFGS, **kw)
    for options in ({"world": world1d},
                    {"world": world2d, "node_axis": "nodes"}):
        res = sweep_fit(data["X"], data["y"], CFGS, backend="shard_map",
                        backend_options=options, **kw)
        assert res.history is None and len(res) == len(CFGS)
        assert max(_errs(res.states, dense.states)) < STATE_TOL
        np.testing.assert_allclose(
            res.global_risks(data["X_test"], data["y_test"]),
            dense.global_risks(data["X_test"], data["y_test"]),
            atol=1.0 / data["X_test"].shape[1])


def test_a_budgeted_sharded_sweep_equals_the_dense_one(world1d):
    data = _data(n=20)
    budget = PlanBudget(max_elems=8 * 20)
    dense = _plan(data=data)
    streamed = _plan(data=data, budget=budget)
    st = streamed.run_sharded(ITERS, world=world1d)
    own, _ = dense.run(iters=ITERS)
    assert max(_errs(st, own)) < STATE_TOL


def test_a_2d_rank_receives_only_its_node(world2d):
    world_stats(world2d, reset=True)
    splan = _plan()
    splan.run_sharded(2, world=world2d, node_axis="nodes")
    N, Sl = splan.base.X.shape[2], len(CFGS) // 2
    for r, s in enumerate(world_stats(world2d)):
        assert s["device"] == "cpu"
        assert s["received"] == {
            "X": (1, T, N, P), "y": (1, T, N), "mask": (1, T, N),
            "adj": (1, V), "active": (1, T), "couple": (1,),
            "active_global": (Sl, V, T)}
        # two neighbor sums an ADMM iteration, each an all-gather of V
        assert s["nbr_sums"] == 2 * 2 and s["host_copies"] == 0


# ---------------------------------------------------------------------------
# refusals and failures
# ---------------------------------------------------------------------------
def test_the_backend_refuses_chains_and_histories():
    splan = _plan()
    with pytest.raises(ValueError, match="chain=True"):
        backends.run_sweep(splan, 1, backend="shard_map", chain=True)
    with pytest.raises(ValueError, match="histories are a single-host"):
        backends.run_sweep(splan, 1, backend="shard_map",
                           eval_fn=lambda s: s.r)


@pytest.mark.parametrize("kw,match", [
    (dict(topology="torus"), "unknown topology"),
    (dict(n_sweep=3), "4 configs do not tile evenly over 3 'sweep'"),
    (dict(n_sweep=3, node_axis="nodes"), "do not tile evenly over 3"),
])
def test_run_sharded_refuses_before_a_world_starts(kw, match):
    with pytest.raises(ValueError, match=match):
        _plan().run_sharded(1, **kw)


def test_a_world_that_does_not_fit_is_refused(world1d, world2d):
    with pytest.raises(ValueError, match="a world of 4 sweep rows for "
                                         "n_sweep=2"):
        _plan().run_sharded(1, world=world1d, n_sweep=2)
    with pytest.raises(ValueError, match="no node groups"):
        _plan().run_sharded(1, world=world1d, node_axis="nodes")
    with pytest.raises(ValueError, match="3 nodes do not tile evenly over "
                                         "4 'nodes' devices"):
        _plan(v=3).run_sharded(1, world=world2d, node_axis="nodes")
    with pytest.raises(ValueError, match="one rank per node"):
        _plan(v=8).run_sharded(1, world=world2d, node_axis="nodes")


def test_a_rank_that_dies_makes_the_sweep_raise():
    world = World(2, device="cpu", timeout=WORLD_TIMEOUT)
    world._procs[0].kill()
    world._procs[0].join()
    with pytest.raises(RankError, match="rank 0 of 2"):
        _plan().run_sharded(1, world=world)
    assert world.closed and all(not p.is_alive() for p in world._procs)
    assert sweep.make_sweep_world is sharding.make_sweep_world
