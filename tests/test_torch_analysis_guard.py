"""Build-once invariants of the port as exact call counts on the CPU
(twin of tests/test_analysis_retrace.py).

The counters come from ``repro_torch.analysis.dispatch_audit.
call_counter``: eager PyTorch has no trace, so where the reference
counts traces of a jitted body the port counts calls.  Each test pins
the EXACT number the architecture promises: one Gram build per fit, one
for a whole sweep grid, only the changed slices on a replan, none for
the factored operator, one ``gemm_rows`` call per served batch at its
bucket's padded shape.  On the card chip_smoke.py phase 2 runs the same
guard and checks the kernels' launch counts too."""
import numpy as np

from repro_torch import api
from repro_torch.analysis.dispatch_audit import call_counter
from repro_torch.core import graph
from repro_torch.data import synthetic

V, T, N, P = 2, 2, 8, 4
GRAM = "repro_torch.kernels.ops:weighted_gram"
STEP = "repro_torch.engine.plan:plan_step"
GEMM = "repro_torch.kernels.ops:gemm_rows"


def _data():
    data = synthetic.make_multitask_data(
        V=V, T=T, p=P, n_train=np.full((V, T), N, int), n_test=4,
        relatedness=0.9, seed=0)
    adj = graph.make_graph("ring", V, seed=0)
    return data["X"], data["y"], data["mask"], adj


def test_fit_builds_invariants_once_and_steps_once_per_iteration():
    X, y, mask, adj = _data()
    with call_counter(GRAM, STEP) as c:
        api.DTSVM(iters=3, qp_iters=2, device="cpu").fit(X, y, mask, adj)
    assert c["weighted_gram"] == 1     # one invariant build per fit
    assert c["plan_step"] == 3         # one step per ADMM iteration


def test_sweep_fit_builds_once_for_all_configs():
    """The sweep stacks its configs: one Gram build for the whole grid,
    and one batched step per iteration for all three configs."""
    X, y, mask, adj = _data()
    cfgs = [{"C": 0.01}, {"C": 0.1}, {"C": 1.0}]
    with call_counter(GRAM, "repro_torch.engine.sweep:plan_step") as c:
        api.sweep_fit(X, y, cfgs, mask, adj, iters=3,
                      base=api.SolverConfig(qp_iters=2), device="cpu")
    assert c["weighted_gram"] == 1
    assert c["plan_step"] == 3


def test_session_add_task_replans_incrementally():
    """A membership event does NOT rebuild the plan from scratch: the
    replan enters the Gram build exactly once more (for the touched
    slices only) and the stats account for every reused slice."""
    X, y, mask, adj = _data()
    active0 = np.array([[1, 0], [1, 1]], np.float32)
    with call_counter(GRAM) as c:
        sess = api.OnlineSession(X, y, mask, adj, active=active0, iters=2,
                                 qp_iters=2, device="cpu")
        sess.run(2)
        assert c["weighted_gram"] == 1
        assert sess.plan_stats == {"gram_slices_computed": V * T,
                                   "gram_slices_reused": 0,
                                   "replans": 0}
        sess.add_task(1)
        sess.run(2)
        assert c["weighted_gram"] == 2     # one incremental rebuild
    # activating task 1 touches 3 of the 4 (v,t) weight rows (the new
    # slice plus the ntp-renormalized ones); the untouched slice is
    # carried over bit for bit
    assert sess.plan_stats == {"gram_slices_computed": V * T + 3,
                               "gram_slices_reused": 1,
                               "replans": 1}


def test_serve_gemm_runs_once_per_batch_at_its_bucket():
    """decide_rows makes one gemm_rows call per batch, padded to its row
    bucket: a repeat bucket runs at the same shape, a new one at its
    own."""
    import torch

    from repro_torch.serve import model as serve_model

    p = 7
    model = serve_model.PredictModel.from_r(
        torch.zeros((V, T, 2 * p + 2), dtype=torch.float32), device="cpu")
    shapes = []
    for rows in (3, 6, 9, 16):          # buckets 8, 8, 16, 16
        with call_counter(GEMM) as c:
            model.decide_rows(np.ones((rows, p), np.float32))
        assert c["gemm_rows"] == 1
        shapes += [tuple(a[2].shape) for a in c.calls[GEMM]]
    assert shapes == [(8, p), (8, p), (16, p), (16, p)]


def test_serve_server_runs_one_gemm_per_batch():
    """End to end through PredictServer: every coalesced batch of 1-8
    rows is one gemm_rows call at the bucket-8 shape."""
    import torch

    from repro_torch.serve.model import PredictModel
    from repro_torch.serve.server import PredictServer

    p = 7
    model = PredictModel.from_r(
        torch.arange(V * T * (2 * p + 2), dtype=torch.float32)
        .reshape(V, T, 2 * p + 2) / 100.0, device="cpu")
    with call_counter(GEMM) as c:
        with PredictServer(model, window_ms=0.0, devices=["cpu"]) as srv:
            futs = [srv.submit(np.full((1, p), i, np.float32), node=0,
                               task=1) for i in range(8)]
            for f in futs:
                f.result(timeout=30)
            batches = srv.stats()["batches"]
    assert c["gemm_rows"] == batches >= 1
    assert {tuple(a[2].shape) for a in c.calls[GEMM]} == {(8, p)}


def test_async_membership_adds_no_gram_build():
    """Node churn rides the same rounds: membership events are data
    (active-node masks), so a fit with crash / recover / leave events
    builds the Gram once, as the event-free async fit does."""
    from repro_torch.net import Membership, MembershipEvent, NetConfig

    X, y, mask, adj = _data()
    net = NetConfig(schedule="partial:0.75", seed=0)
    mem = Membership(events=(MembershipEvent(2, "crash", 1),
                             MembershipEvent(4, "recover", 1),
                             MembershipEvent(5, "leave", 0)))
    with call_counter(GRAM, STEP) as c:
        api.DTSVM(iters=8, qp_iters=2, net=net, device="cpu").fit(
            X, y, mask, adj)
        assert c["weighted_gram"] == 1
        api.DTSVM(iters=8, qp_iters=2, net=net, device="cpu").fit(
            X, y, mask, adj, membership=mem)
    assert c["weighted_gram"] == 2         # one build per fit, no more
    assert c["plan_step"] == 16            # one step per round


def test_error_feedback_adds_no_gram_build_over_int8():
    """Error-feedback compensation is a branch of the same exchange:
    turning it on over the int8 wire adds no Gram build."""
    from repro_torch.net import LinkPolicy, NetConfig

    X, y, mask, adj = _data()
    for ef in (False, True):
        net = NetConfig(policy=LinkPolicy(quant="int8"), seed=0,
                        error_feedback=ef)
        with call_counter(GRAM, STEP) as c:
            api.DTSVM(iters=4, qp_iters=2, net=net, device="cpu").fit(
                X, y, mask, adj)
        assert c["weighted_gram"] == 1, f"error_feedback={ef}"
        assert c["plan_step"] == 4, f"error_feedback={ef}"


def test_multi_engine_fit_builds_once():
    X, y, mask, adj = _data()
    with call_counter(GRAM, "repro_torch.kernels.ops:qp_pg_multi") as c:
        api.DTSVM(iters=3, qp_iters=2, qp_solver="pallas_fused_multi",
                  device="cpu").fit(X, y, mask, adj)
    assert c["weighted_gram"] == 1
    assert c["qp_pg_multi"] == 3           # one fused solve per iteration


def test_factored_fit_never_builds_gram():
    """qp_operator="factored" never enters the dense Gram build: the
    streamed Lipschitz pass goes through the row panels once and K stays
    unmaterialized."""
    X, y, mask, adj = _data()
    with call_counter(GRAM, "repro_torch.kernels.ops:weighted_gram_panels",
                      STEP) as c:
        api.DTSVM(iters=3, qp_iters=2, qp_solver="pallas_fused_multi",
                  qp_operator="factored", device="cpu").fit(X, y, mask, adj)
    assert c["weighted_gram"] == 0
    assert c["weighted_gram_panels"] == 1
    assert c["plan_step"] == 3
