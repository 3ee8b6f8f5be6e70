"""The port's predict model and batching server (``repro_torch.serve``)
against the reference's ``repro.serve`` (tests/test_serve.py).

The contract under test: batching and padding are invisible in the
VALUES.  Every request's answers are bitwise the canonical unbatched
computation (``PredictModel.decide_rows``), whatever bucket the rows were
padded to and whatever rows shared their product.  The port builds that
contract itself (``gemm_rows`` sums each element in a fixed order) and
holds it here at p = 4, 10 and 257; a plain ``torch.addmm`` need not
keep it (one test prints whether it did).  Across the packages, on the
same fitted state, the port's values are within 3e-5 of the reference's
(relative to their largest magnitude).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import OnlineSession as JOnlineSession
from repro.api.solvers import DTSVM as JDTSVM
from repro.api.solvers import SolverConfig as JSolverConfig
from repro.serve import PredictModel as JPredictModel
from repro.serve.model import gemm_rows as jgemm_rows
from repro_torch.api import DTSVM, OnlineSession, SolverConfig
from repro_torch.core import dtsvm as core
from repro_torch.kernels import ops, ref
from repro_torch.serve import PredictModel, PredictServer, serve_model
from repro_torch.serve.model import gemm_rows, row_bucket

V, T, P = 3, 2, 4
TOL = 3e-5
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r(seed=0, p=P):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(V, T, 2 * p + 2)).astype(np.float32)


def _model(seed=0, p=P) -> PredictModel:
    return PredictModel.from_r(_r(seed, p), device="cpu")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    N = 10
    X = rng.normal(size=(V, T, N, P)).astype(np.float32)
    y = np.sign(rng.normal(size=(V, T, N))).astype(np.float32)
    adj = ~np.eye(V, dtype=bool)
    return X, y, adj


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert float(np.abs(got - want).max()) <= tol * float(
        np.abs(want).max())


# ---------------------------------------------------------------------------
# the model view
# ---------------------------------------------------------------------------
def test_model_matches_core_and_the_reference():
    r = _r(1)
    X = np.random.default_rng(1).normal(size=(T, 9, P)).astype(np.float32)
    m, jm = PredictModel.from_r(r, device="cpu"), JPredictModel.from_r(r)
    assert m.shape == jm.shape == (V, T, P)
    assert m.W.device.type == "cpu" and m.W.dtype == torch.float32
    _close(m.W, jm.W)
    _close(m.b, jm.b)
    Xb = torch.from_numpy(np.broadcast_to(X[None], (V, T, 9, P)).copy())
    want = core.decision_values(torch.from_numpy(r), Xb)
    np.testing.assert_allclose(m.decision(X).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)
    assert torch.equal(m.predict(X), torch.sign(want))
    _close(m.decision(X), jm.decision(X))
    np.testing.assert_array_equal(m.predict(X).numpy(),
                                  np.asarray(jm.predict(X)))


def test_model_from_solver_and_session_match_the_reference():
    """The extraction paths, on the same data and config in both
    packages: the port's solver and session give one model, within TOL
    of the reference's."""
    X, y, adj = _data()
    cfg, jcfg = (SolverConfig(iters=3, qp_iters=10),
                 JSolverConfig(iters=3, qp_iters=10))
    solver = DTSVM(cfg, device="cpu").fit(X, y, adj=adj)
    m1 = PredictModel.from_solver(solver)
    sess = OnlineSession(X, y, adj=adj, config=cfg, device="cpu")
    sess.run(3)
    m2 = PredictModel.from_session(sess)
    assert torch.equal(m1.W, m2.W) and torch.equal(m1.b, m2.b)
    jm = JPredictModel.from_solver(JDTSVM(jcfg).fit(X, y, adj=adj))
    _close(m1.W, jm.W)
    _close(m1.b, jm.b)
    Xte = np.random.default_rng(2).normal(size=(T, 6, P)).astype(np.float32)
    np.testing.assert_allclose(m1.decision(Xte).numpy(),
                               solver.decision(Xte).numpy(), rtol=0,
                               atol=1e-6)
    rows = Xte[0]
    _close(m1.decide_rows(rows), jm.decide_rows(rows))


def test_model_requires_fit():
    with pytest.raises(RuntimeError, match="fit"):
        PredictModel.from_solver(DTSVM(SolverConfig(), device="cpu"))
    X, y, adj = _data()
    with pytest.raises(RuntimeError, match="run"):
        PredictModel.from_session(OnlineSession(X, y, adj=adj,
                                                device="cpu"))


def test_model_device_rule():
    """A numpy r goes to the card unless the caller asks for the CPU; a
    tensor keeps its device."""
    r = _r()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PredictModel.from_r(r)
    assert PredictModel.from_r(torch.from_numpy(r)).W.device.type == "cpu"


# ---------------------------------------------------------------------------
# the bucket contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [P, 10, 257])
def test_rows_bitwise_stable_across_buckets_and_offsets(p):
    """The keystone: a row's values depend neither on the bucket it was
    computed in (8 to 1024) nor on its place in the batch (offset 0 or
    3) nor on the rows beside it."""
    m = _model(p=p)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, p)).astype(np.float32)
    Wf, bf = m.flat()
    want = None
    for bucket in (8, 16, 32, 256, 1024):
        for off in (0, 3):
            Xp = rng.normal(size=(bucket, p)).astype(np.float32)
            Xp[off:off + 5] = x
            G = gemm_rows(Wf, bf, torch.from_numpy(Xp))[off:off + 5]
            want = G if want is None else want
            assert torch.equal(G, want), (bucket, off)
    assert np.array_equal(m.decide_rows(x), want.numpy())


def test_gemm_rows_against_the_reference_and_addmm():
    """Within TOL of the reference's jitted product and of addmm.  Whether
    addmm kept a row's bits across buckets at p = 257 is printed: a
    library product promises no order of its sum, which is why the port
    does not use it."""
    p = 257
    m = _model(p=p)
    Wf, bf = m.flat()
    rng = np.random.default_rng(4)
    X = rng.normal(size=(1024, p)).astype(np.float32)
    got = gemm_rows(Wf, bf, torch.from_numpy(X))
    jm = JPredictModel.from_r(_r(p=p))
    _close(got, jgemm_rows(*jm.flat(), jnp.asarray(X)))
    _close(got, torch.addmm(bf, torch.from_numpy(X), Wf.T))
    lib = [torch.addmm(bf, torch.from_numpy(X[:n]), Wf.T)[:8]
           for n in (8, 16, 1024)]
    print("addmm keeps a row's bits across buckets 8/16/1024 at p=257:",
          all(torch.equal(lib[0], g) for g in lib[1:]))


def test_gemm_rows_dispatch_and_plain_order():
    """A CPU operand runs the plain version, which sums the features in
    order (two roundings a step, the kernel's fmaf one)."""
    Wf = torch.tensor([[1.0, 1e8, -1e8]])
    bf = torch.tensor([0.5])
    X = torch.tensor([[1.0, 1.0, 1.0]])
    before = ops.launch_counts()["gemm_rows"]
    out = gemm_rows(Wf, bf, X)
    assert ops.launch_counts()["gemm_rows"] == before
    assert torch.equal(out, ref.gemm_rows(Wf, bf, X))
    # in order: (0.5 + 1) + 1e8 rounds to 1e8, and 1e8 - 1e8 is 0 (any
    # order that cancels the two large terms first gives 1.5)
    assert out.item() == 0.0
    assert ref.gemm_rows(Wf[:, :0], bf, X[:, :0]).tolist() == [[0.5]]
    with pytest.raises(ValueError, match="all be on"):
        ops.gemm_rows(Wf, bf, X.to("meta"))


def test_row_bucket_shapes():
    assert [row_bucket(n) for n in (1, 8, 9, 100)] == [8, 8, 16, 128]


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def test_batched_equals_direct_exact():
    m = _model()
    rng = np.random.default_rng(4)
    with PredictServer(m, window_ms=2.0, devices=CPU) as srv:
        reqs = []
        for _ in range(60):
            n = int(rng.integers(1, 9))
            x = rng.normal(size=(n, P)).astype(np.float32)
            v, t = int(rng.integers(V)), int(rng.integers(T))
            reqs.append((x, v, t, srv.submit(x, node=v, task=t)))
        for x, v, t, fut in reqs:
            np.testing.assert_array_equal(
                fut.result(30), m.decide_rows(x)[:, v * T + t])
        stats = srv.stats()
    assert stats["requests"] == 60
    assert stats["batches"] <= 60
    assert stats["p50_ms"] <= stats["p99_ms"]
    assert stats["rps"] > 0 and stats["devices"] == 1


def test_answers_match_the_reference_server():
    """The same requests through both servers on the same hyperplanes:
    within TOL."""
    from repro.serve import PredictServer as JPredictServer
    r = _r(5)
    rng = np.random.default_rng(5)
    reqs = [(rng.normal(size=(int(rng.integers(1, 7)), P))
             .astype(np.float32), int(rng.integers(V)), int(rng.integers(T)))
            for _ in range(12)]
    with PredictServer(PredictModel.from_r(r, device="cpu"), window_ms=1.0,
                       devices=CPU) as srv, \
            JPredictServer(JPredictModel.from_r(r), window_ms=1.0) as jsrv:
        futs = [(srv.submit(x, node=v, task=t),
                 jsrv.submit(x, node=v, task=t)) for x, v, t in reqs]
        for f, jf in futs:
            _close(f.result(30), jf.result(30))


@pytest.mark.parametrize("p", [P, 257])
def test_answers_independent_of_co_batching(p):
    """The same request answered alone and inside a packed batch yields
    bitwise-identical values."""
    m = _model(p=p)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, p)).astype(np.float32)
    with PredictServer(m, window_ms=0.0, devices=CPU) as srv:
        alone = srv.predict(x, node=1, task=0)
    with PredictServer(m, window_ms=20.0, devices=CPU) as srv:
        futs = [srv.submit(rng.normal(size=(int(rng.integers(1, 7)),
                                            p)).astype(np.float32),
                           node=int(rng.integers(V)),
                           task=int(rng.integers(T)))
                for _ in range(10)]
        packed = srv.submit(x, node=1, task=0).result(30)
        for f in futs:
            f.result(30)
        assert srv.stats()["batches"] < 11
    np.testing.assert_array_equal(alone, packed)


def test_scalar_request():
    m = _model()
    x = np.random.default_rng(6).normal(size=(P,)).astype(np.float32)
    with serve_model(m, window_ms=0.0, devices=CPU) as srv:
        got = srv.predict(x, node=2, task=1)
    assert np.ndim(got) == 0
    assert got == m.decide_rows(x[None])[0, 2 * T + 1]


def test_hot_swap_publish():
    m1, m2 = _model(0), _model(7)
    x = np.random.default_rng(8).normal(size=(4, P)).astype(np.float32)
    with PredictServer(m1, window_ms=0.0, devices=CPU) as srv:
        np.testing.assert_array_equal(srv.predict(x, node=0, task=0),
                                      m1.decide_rows(x)[:, 0])
        srv.publish(m2)
        np.testing.assert_array_equal(srv.predict(x, node=0, task=0),
                                      m2.decide_rows(x)[:, 0])


def test_publish_session_stage_swap():
    """Serve stage 1, run stage 2 live, publish: requests flip to the new
    hyperplanes, which are the reference session's within TOL."""
    X, y, adj = _data()
    sess = OnlineSession(X, y, adj=adj, device="cpu",
                         config=SolverConfig(iters=2, qp_iters=10))
    jsess = JOnlineSession(X, y, adj=adj,
                           config=JSolverConfig(iters=2, qp_iters=10))
    sess.run(2)
    jsess.run(2)
    x = np.random.default_rng(9).normal(size=(4, P)).astype(np.float32)
    with PredictServer(PredictModel.from_session(sess), window_ms=0.0,
                       devices=CPU) as srv:
        before = srv.predict(x, node=0, task=1)
        sess.drop_task(0)
        sess.run(2)
        jsess.drop_task(0)
        jsess.run(2)
        srv.publish_session(sess)
        after = srv.predict(x, node=0, task=1)
        want = PredictModel.from_session(sess).decide_rows(x)[:, 1]
    np.testing.assert_array_equal(after, want)
    assert not np.array_equal(before, after)
    _close(after, JPredictModel.from_session(jsess).decide_rows(x)[:, 1])


def test_concurrent_clients_all_exact():
    m = _model()
    errs = []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(15):
                n = int(rng.integers(1, 6))
                x = rng.normal(size=(n, P)).astype(np.float32)
                v, t = int(rng.integers(V)), int(rng.integers(T))
                got = srv.predict(x, node=v, task=t)
                np.testing.assert_array_equal(
                    got, m.decide_rows(x)[:, v * T + t])
        except Exception as e:          # surfaces in the main thread
            errs.append(e)

    with PredictServer(m, window_ms=1.0, devices=CPU) as srv:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
            assert not th.is_alive()
    assert not errs, errs


def test_request_validation():
    m = _model()
    with PredictServer(m, window_ms=0.0, max_batch=64, devices=CPU) as srv:
        with pytest.raises(ValueError, match="x must be"):
            srv.submit(np.zeros((2, P + 1), np.float32), node=0, task=0)
        with pytest.raises(ValueError, match="out of range"):
            srv.submit(np.zeros((2, P), np.float32), node=V, task=0)
        with pytest.raises(ValueError, match="exceeds"):
            srv.submit(np.zeros((65, P), np.float32), node=0, task=0)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros((1, P), np.float32), node=0, task=0)


def test_stats_counters_and_span():
    from repro_torch.obs import spans
    m = _model()
    spans.clear_spans()
    with PredictServer(m, window_ms=0.0, devices=CPU) as srv:
        s0 = srv.stats()
        assert s0["requests"] == 0 and s0["p50_ms"] is None
        for _ in range(5):
            srv.predict(np.zeros((2, P), np.float32), node=0, task=0)
        s = srv.stats()
    assert s["requests"] == 5 and s["rows"] == 10
    assert s["pad_ratio"] is not None and 0 <= s["pad_ratio"] < 1.0
    batches = [e for e in spans.iter_spans() if e["name"] == "serve_batch"]
    assert len(batches) == s["batches"]
    spans.validate_chrome_trace(spans.to_chrome_trace())


def test_default_devices_are_the_card():
    """``devices=None`` resolves as every entry point does: the card, or
    a RuntimeError where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is covered on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictServer(_model())


def test_round_robin_over_devices_exact():
    """Two entries in ``devices`` (the CPU twice here; the card's machine
    has one card) alternate batch by batch, and every answer is exact."""
    m = _model()
    rng = np.random.default_rng(0)
    with PredictServer(m, window_ms=1.0, devices=["cpu", "cpu"]) as srv:
        for _ in range(2):
            reqs = []
            for _ in range(20):
                x = rng.normal(size=(int(rng.integers(1, 9)), P)) \
                    .astype(np.float32)
                v, t = int(rng.integers(V)), int(rng.integers(T))
                reqs.append((x, v, t, srv.submit(x, node=v, task=t)))
            for x, v, t, fut in reqs:
                np.testing.assert_array_equal(
                    fut.result(30), m.decide_rows(x)[:, v * T + t])
        s = srv.stats()
    assert s["devices"] == 2 and s["batches"] >= 2
