"""The port's ``"sample_shard"`` backend (``repro_torch.dist.sample`` on a
``repro_torch.dist.World``) against the reference's.

The reference runs in one subprocess with 4 forced host devices
(``helpers.run_with_devices``) at tests/test_scale.py:236-278's regime
(V=3, T=2, N=64, p=10, a random graph of degree 0.8, 5 ADMM x 50 QP
iterations, 4 shards, ``REPRO_USE_PALLAS=0`` as there).  The port runs a
module-scoped gloo world of 4 CPU ranks and is held to the issue's bars:
``gather`` state within 1e-5 of the reference's and of the port's own
``vmap`` fit, risk histories within 1/n_test; ``psum`` within the
reference's own 2e-5 (tests/test_scale.py:270-275); telemetry on against
off ``torch.equal`` and its streams within tests/test_torch_obs.py's
bounds.  Whether a result came out bitwise the port's ``vmap`` is printed
(on this tree ``gather`` is, on the CPU).  Also in-process against the
reference: the row panels of K (``weighted_gram_rows``, the rectangular
``streamed_gram_panel``) within 3e-5 and the sample-sharded dual solve
against the reference's dense FISTA and PG; and the refusals, what a
rank receives, the session and its save -> restore -> continue, and a
rank that dies.  Every world has its own timeout.
"""
import os

import numpy as np
import pytest
import torch

import jax
from helpers import run_with_devices
from repro.core import qp as jqp
from repro.data import synthetic as jsynthetic
from repro.core import graph as jgraph
from repro.engine import invariants as jinv
from repro.kernels import ops as jops
from repro_torch.api import (DTSVM, OnlineSession, PlanBudget, SolverConfig,
                             backends, evaluate)
from repro_torch.core import dtsvm as core
from repro_torch.dist import RankError, sample, sharding
from repro_torch.dist.collectives import world_stats
from repro_torch.engine import invariants as inv_lib
from repro_torch.kernels import ops
from repro_torch.obs import Telemetry
from repro_torch.store import load_session, save_session
from test_torch_obs import _assert_streams_close

V, T, N, P = 3, 2, 64, 10
SHARDS = 4
ITERS, QP_ITERS = 5, 50
N_TEST = 32
STATE_TOL, PSUM_TOL, KERNEL_TOL = 1e-5, 2e-5, 3e-5
#: seconds any wait of a test's world may take
WORLD_TIMEOUT = 120.0
SOLVERS = ("fista", "pg")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    return jsynthetic.make_multitask_data(
        V=V, T=T, p=P, n_train=np.full((V, T), N, int), n_test=N_TEST,
        seed=0)


def _adj():
    return jgraph.make_graph("random", V, degree=0.8, seed=0)


def _prob(data=None):
    data = _data() if data is None else data
    return core.make_problem(data["X"], data["y"], data["mask"], _adj(),
                             device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sample-sharded fits (fista and pg with histories,
    psum, budgeted on 2 shards, telemetry), from one 4-device
    subprocess."""
    path = str(tmp_path_factory.mktemp("sample") / "reference.npz")
    run_with_devices(f"""
        import os
        os.environ["REPRO_USE_PALLAS"] = "0"
        import numpy as np
        from repro.api import PlanBudget, backends, evaluate
        from repro.core import dtsvm as core, graph
        from repro.data import synthetic
        from repro.obs import Telemetry
        V, T, N = {V}, {T}, {N}
        data = synthetic.make_multitask_data(
            V=V, T=T, p={P}, n_train=np.full((V, T), N, int),
            n_test={N_TEST}, seed=0)
        A = graph.make_graph("random", V, degree=0.8, seed=0)
        prob = core.make_problem(data["X"], data["y"], data["mask"], A)
        ev = evaluate.risk_eval_fn(V, data["X_test"], data["y_test"])
        out = {{}}
        kw = dict(backend="sample_shard", qp_iters={QP_ITERS})
        for solver in {SOLVERS!r}:
            st, h = backends.run(prob, {ITERS}, qp_solver=solver,
                                 n_shards={SHARDS}, eval_fn=ev, **kw)
            for k, v in zip(("r", "alpha", "beta", "lam"), st):
                out[solver + "/" + k] = np.asarray(v)
            out[solver + "/hist"] = np.asarray(h)
        runs = {{"psum": dict(n_shards={SHARDS}, reduce="psum"),
                 "budget": dict(n_shards=2, budget=PlanBudget(
                     max_elems=V * T * 8 * N))}}
        for name, extra in runs.items():
            st, _ = backends.run(prob, {ITERS}, **kw, **extra)
            for k, v in zip(("r", "alpha", "beta", "lam"), st):
                out[name + "/" + k] = np.asarray(v)
        tel = {{}}
        backends.run(prob, {ITERS}, n_shards={SHARDS}, **kw,
                     telemetry=Telemetry(), telemetry_out=tel)
        for k, v in tel["streams"].items():
            out["tel/" + k] = np.asarray(v)
        np.savez({path!r}, **out)
        print("DONE")
    """, n_devices=SHARDS)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def world4():
    with sharding.make_sample_world(N, SHARDS, device="cpu",
                                    timeout=WORLD_TIMEOUT) as world:
        yield world


def _want(reference, name):
    return [reference[f"{name}/{k}"] for k in core.DTSVMState._fields]


def _errs(got, want):
    return [float(np.abs(np.asarray(g) - np.asarray(w)).max())
            for g, w in zip(got, want)]


def _run(prob, world, **kw):
    kw = dict(dict(qp_iters=QP_ITERS, world=world), **kw)
    return backends.run(prob, ITERS, backend="sample_shard", **kw)


# ---------------------------------------------------------------------------
# row panels of K, against the reference's, in-process
# ---------------------------------------------------------------------------
def _z_a(seed=0, B=(2, 3), n=40, d=7):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=B + (n, d)).astype(np.float32)
    a = rng.uniform(0.2, 2.0, size=B + (d,)).astype(np.float32)
    return Z, a


@pytest.mark.parametrize("row0,rows", [(0, 40), (8, 16), (30, 10)])
def test_weighted_gram_rows_match_the_reference(row0, rows):
    Z, a = _z_a()
    got = ops.weighted_gram_rows(torch.from_numpy(Z), torch.from_numpy(a),
                                 row0, rows)
    want = np.asarray(jops.weighted_gram_rows(Z[..., row0:row0 + rows, :],
                                              a, Z))
    assert got.shape == want.shape == (2, 3, rows, 40)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.numpy() - want).max()) <= KERNEL_TOL * scale
    # the panel is those rows of the square K
    full = ops.weighted_gram(torch.from_numpy(Z), torch.from_numpy(a))
    torch.testing.assert_close(got, full[..., row0:row0 + rows, :],
                               rtol=KERNEL_TOL, atol=KERNEL_TOL * scale)


@pytest.mark.parametrize("row0,rows,chunk", [(0, 40, 16), (16, 24, 8)])
def test_streamed_row_panel_matches_the_reference(row0, rows, chunk):
    """The rectangular streamed build (its last chunk clamped inside the
    band) and its row sums against the reference's on ``Zm`` = those rows
    of Z."""
    Z, a = _z_a(1)
    K, rs = inv_lib.streamed_gram_panel(torch.from_numpy(Z),
                                        torch.from_numpy(a), chunk,
                                        row0=row0, rows=rows)
    jK, jrs = jinv.streamed_gram_panel(Z[..., row0:row0 + rows, :], a, Z,
                                       chunk)
    for got, want in ((K, jK), (rs, jrs)):
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got.numpy() - want).max()) <= KERNEL_TOL * scale
    dense = ops.weighted_gram_rows(torch.from_numpy(Z), torch.from_numpy(a),
                                   row0, rows)
    torch.testing.assert_close(K, dense, rtol=KERNEL_TOL, atol=1e-5)


@pytest.mark.parametrize("row0,rows", [(-1, 8), (36, 8), (0, 41)])
def test_a_panel_that_is_not_rows_of_z_is_refused(row0, rows):
    Z, a = _z_a()
    with pytest.raises(ValueError, match="not rows of a 40-row Z"):
        ops.weighted_gram_rows(torch.from_numpy(Z), torch.from_numpy(a),
                               row0, rows)


# ---------------------------------------------------------------------------
# the sharded dual solve and the fit, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qp_solver", SOLVERS)
def test_qp_rows_match_the_reference_dense_solver(qp_solver, world4):
    """Each rank holds N/4 rows of K and gathers the iterate every inner
    step; the joined lam is the reference's dense solve."""
    rng = np.random.default_rng(2)
    B, n, d = 3, 32, 5
    Zq = rng.normal(size=(B, n, d)).astype(np.float32)
    K = np.einsum("bnd,bmd->bnm", Zq, Zq).astype(np.float32)
    q = rng.normal(size=(B, n)).astype(np.float32)
    hi = rng.uniform(0.0, 0.5, size=(B, n)).astype(np.float32)
    lam0 = (rng.uniform(size=(B, n)) * hi).astype(np.float32)
    L = np.abs(K).sum(-1).max(-1).astype(np.float32)
    solve = {"fista": jqp.solve_box_qp_fista,
             "pg": jqp.solve_box_qp_pg}[qp_solver]
    want = np.asarray(jax.vmap(lambda k, q_, h, l0, l: solve(
        k, q_, h, iters=40, lam0=l0, L=l))(K, q, hi, lam0, L))
    m = n // SHARDS
    rows = lambda x, k: x[..., k * m:(k + 1) * m].copy()  # noqa: E731
    got = np.concatenate(world4.run(sample._rank_qp_rows, [
        (K[:, k * m:(k + 1) * m].copy(), rows(q, k),
         rows(hi, k), rows(lam0, k), L, 40, qp_solver)
        for k in range(SHARDS)]), axis=-1)
    assert got.shape == (B, n)
    assert float(np.abs(got - want).max()) <= \
        KERNEL_TOL * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("qp_solver", SOLVERS)
def test_gather_fit_matches_the_reference_and_vmap(qp_solver, reference,
                                                   world4):
    data = _data()
    prob = _prob(data)
    ev = evaluate.risk_eval_fn(V, data["X_test"], data["y_test"], "cpu")
    st, hist = _run(prob, world4, qp_solver=qp_solver, eval_fn=ev)
    errs = _errs(st, _want(reference, qp_solver))
    assert max(errs) < STATE_TOL, errs
    assert tuple(hist.shape) == (ITERS, V, T)
    assert float(np.abs(hist.numpy() - reference[f"{qp_solver}/hist"])
                 .max()) <= 1.0 / N_TEST
    st_v, hist_v = backends.run(prob, ITERS, backend="vmap",
                                qp_iters=QP_ITERS, qp_solver=qp_solver,
                                eval_fn=ev)
    bitwise = all(torch.equal(a, b) for a, b in zip(st, st_v))
    print(f"{qp_solver}/gather: vs reference {max(errs):.2e}, vs the port's "
          f"vmap {max(_errs(st, st_v)):.2e}, bitwise {bitwise}")
    assert max(_errs(st, st_v)) < STATE_TOL
    assert float((hist - hist_v).abs().max()) <= 1.0 / N_TEST


def test_psum_fit_is_within_the_reference_bar(reference, world4):
    prob = _prob()
    st, hist = _run(prob, world4, reduce="psum")
    assert hist is None
    assert max(_errs(st, _want(reference, "psum"))) < PSUM_TOL
    st_v, _ = backends.run(prob, ITERS, backend="vmap", qp_iters=QP_ITERS)
    assert max(_errs(st, st_v)) < PSUM_TOL


def test_budgeted_fit_equals_the_dense_one(reference, world4):
    """8-row chunks of each rank's 16-row panel (2 launches a rank)."""
    budget = PlanBudget(max_elems=V * T * 8 * N)
    assert budget.row_chunk(V * T, N // SHARDS, cols=N) == 8
    prob = _prob()
    dense, _ = _run(prob, world4)
    streamed, _ = _run(prob, world4, budget=budget)
    assert max(_errs(streamed, dense)) < STATE_TOL
    assert max(_errs(streamed, _want(reference, "budget"))) < STATE_TOL


def test_one_shard_is_the_vmap_fit_bitwise():
    """n_shards=1 (a world of one rank, started for the call): the panel
    is the whole K, and the fit is vmap's bit for bit
    (tests/test_scale.py:289)."""
    prob = _prob()
    st, _ = backends.run(prob, 4, backend="sample_shard", qp_iters=40,
                         n_shards=1)
    st_v, _ = backends.run(prob, 4, backend="vmap", qp_iters=40)
    for name, a, b in zip(core.DTSVMState._fields, st, st_v):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# refusals, what a rank holds, failures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(qp_solver="pallas_fused"), "fista.*pg"),
    (dict(qp_solver="pallas_fused_multi", reduce="nope"), "fista.*pg"),
    (dict(reduce="nope"), "unknown reduce"),
    (dict(n_shards=5, reduce="nope"), "unknown reduce"),
    (dict(n_shards=5), "64 samples do not tile evenly over 5"),
    (dict(qp_solver="pallas_fused_multi", qp_precision="bf16"),
     "vmap-backend"),
])
def test_sample_shard_refuses_what_the_reference_refuses(kw, match):
    """In the reference's order (the engine, the reduction, the tiling),
    each before any world starts."""
    with pytest.raises(ValueError, match=match):
        backends.run(_prob(), 1, backend="sample_shard", **kw)


def test_a_world_of_the_wrong_size_is_refused(world4):
    with pytest.raises(ValueError, match="a world of 4 ranks for "
                                         "n_shards=2"):
        _run(_prob(), world4, n_shards=2)
    data = jsynthetic.make_multitask_data(
        V=V, T=T, p=P, n_train=np.full((V, T), 6, int), n_test=4, seed=0)
    with pytest.raises(ValueError, match="6 samples do not tile evenly "
                                         "over 4"):
        _run(_prob(data), world4)


def test_a_rank_receives_only_its_rows(world4):
    world_stats(world4, reset=True)
    iters = 2
    backends.run(_prob(), iters, backend="sample_shard", qp_iters=7,
                 world=world4)
    Nl = N // SHARDS
    for r, s in enumerate(world_stats(world4)):
        assert s["rank"] == r and s["device"] == "cpu"
        assert s["received"] == {
            "X": (V, T, Nl, P), "y": (V, T, Nl), "mask": (V, T, Nl),
            "adj": (V, V), "active": (V, T), "couple": (V,),
            "lam": (V, T, Nl)}
        # Z once, the iterate every inner step, lam once an iteration;
        # the bound once; no neighbor sum is a collective here
        assert s["all_gathers"] == 1 + iters * (7 + 1)
        assert s["all_reduces"] == 1
        assert s["nbr_sums"] == 0 and s["host_copies"] == 0


def test_telemetry_is_invisible_and_matches_the_reference(reference,
                                                          world4):
    data = _data()
    prob = _prob(data)
    out = {}
    on, _ = _run(prob, world4, telemetry=Telemetry(), telemetry_out=out)
    off, _ = _run(prob, world4)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    want = {k.split("/", 1)[1]: v for k, v in reference.items()
            if k.startswith("tel/")}
    _assert_streams_close(out["streams"], want, float(data["mask"].sum()),
                          "sample_shard")
    # and the dense collector's streams on the port's vmap fit
    dense = {}
    backends.run(prob, ITERS, backend="vmap", qp_iters=QP_ITERS,
                 telemetry=Telemetry(), telemetry_out=dense)
    _assert_streams_close(out["streams"], dense["streams"],
                          float(data["mask"].sum()), "vs vmap")


def test_a_rank_that_dies_makes_the_fit_raise():
    world = sharding.make_sample_world(N, 2, device="cpu",
                                       timeout=WORLD_TIMEOUT)
    world._procs[1].kill()
    world._procs[1].join()
    with pytest.raises(RankError, match="rank 1 of 2"):
        _run(_prob(), world)
    assert world.closed
    assert all(not p.is_alive() for p in world._procs)


# ---------------------------------------------------------------------------
# the session and its snapshots
# ---------------------------------------------------------------------------
def _session_data():
    data = jsynthetic.make_multitask_data(
        V=4, T=2, p=P, n_train=np.full((4, 2), 8, int), n_test=20, seed=4)
    return data, jgraph.make_graph("random", 4, 0.7, seed=1)


def test_session_keeps_its_world_and_matches_vmap():
    data, adj = _session_data()
    kw = dict(mask=data["mask"], adj=adj, X_test=data["X_test"],
              y_test=data["y_test"], device="cpu")
    cfg = SolverConfig(iters=3, qp_iters=20)
    sess = OnlineSession(data["X"], data["y"], config=cfg.replace(
        backend="sample_shard", backend_options={"n_shards": 4,
                                                 "reduce": "gather"}),
        **kw)
    ref = OnlineSession(data["X"], data["y"], config=cfg, **kw)
    try:
        for s in (sess, ref):
            s.run(3)
            s.drop_task(1)
            s.run(3)
        world = sess._world
        assert world is not None and world.size == 4 and not world.closed
        assert max(_errs(sess.state, ref.state)) < STATE_TOL
        np.testing.assert_allclose(np.concatenate(sess.history),
                                   np.concatenate(ref.history), atol=1e-6)
        assert sess.plan_stats == {}
    finally:
        sess.close()
    assert world.closed


def test_save_restore_continue_equals_the_uninterrupted_session(tmp_path):
    """tests/test_store.py:484's sample_shard case: the restored session
    starts a world of its own and continues bitwise the uninterrupted
    one."""
    data, adj = _session_data()
    cfg = SolverConfig(iters=3, qp_iters=15, backend="sample_shard",
                       backend_options={"n_shards": 4, "reduce": "gather"})
    sessions = []

    def session():
        sessions.append(OnlineSession(data["X"], data["y"], adj=adj,
                                      config=cfg, device="cpu"))
        return sessions[-1]

    try:
        ref = session()
        ref.run(3)
        ref.drop_task(1)
        ref.run(3)
        twin = session()
        twin.run(3)
        path = os.path.join(str(tmp_path), "s.msgpack")
        save_session(path, twin)
        back = load_session(path, device="cpu")
        sessions.append(back)
        back.drop_task(1)
        back.run(3)
        for name, x, z in zip(ref.state._fields, back.state, ref.state):
            assert torch.equal(x, z), name
        assert back.iteration == ref.iteration == 6
        assert back._world is not twin._world
    finally:
        for s in sessions:
            s.close()


def test_a_fit_through_the_solver(world4):
    """``DTSVM(SolverConfig(backend="sample_shard", ...)).fit`` with the
    world in ``backend_options``, and the same fit through ``vmap``."""
    data = _data()
    cfg = SolverConfig(C=0.01, iters=3, qp_iters=20)
    m = DTSVM(cfg.replace(backend="sample_shard", backend_options={
        "world": world4, "reduce": "psum"}), device="cpu").fit(
        data["X"], data["y"], mask=data["mask"], adj=_adj())
    v = DTSVM(cfg, device="cpu").fit(data["X"], data["y"],
                                     mask=data["mask"], adj=_adj())
    assert max(_errs(m.state_, v.state_)) < PSUM_TOL
    np.testing.assert_allclose(m.risks(data["X_test"], data["y_test"]),
                               v.risks(data["X_test"], data["y_test"]),
                               atol=1.0 / N_TEST)
