"""The hand CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one.  The file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch; from the root of the repository:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py releases JAX's caches and so needs
JAX.)  Tolerance: the largest error at most 3e-5 (f32) or 1e-2 (bf16)
times the largest magnitude of the plain result.  The shapes
cover the one-problem edge, the paper regime (20 problems of 60 x 11),
odd sizes that exercise the masked edges, and N > 1024, where the
multi-iteration kernel takes its cooperative grid path.  The Gram
shapes cross the 128-row CTA tile and the 16-feature stage (N in
{1, 127, 128, 129, 300}, D in {1, 11, 16, 17, 257}).  The square K is
held bitwise symmetric, the tiled Gram kernel bitwise to the square
kernel's rows (each element in the roles the square kernel gives it),
and a budgeted fit to the dense fit.  The multi kernel is held on each
of its launch paths, bitwise to a second launch and to itself on a K
converted to bf16 beforehand, and with its iterate staged in chunks
(N = 26000 f32, 51300 bf16).  The serving product ``gemm_rows``
(``csrc/rows.cu``) is held to its plain version at 3e-5, and a row's
values bitwise across buckets 8-1024 and row offsets, with the
hyperplanes staged in shared memory and read from device memory.  Every
binding refuses a CPU tensor, an operand of another N and a float64
operand with ValueError.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

REL = {"f32": 3e-5, "bf16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only there")
    return torch.device("cuda")


def _close(got, want, rel):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


def _gram_inputs(rng, batch, n, d):
    Z = rng.normal(size=batch + (n, d)).astype(np.float32)
    a = rng.uniform(0.1, 2.0, size=batch + (d,)).astype(np.float32)
    return Z, a


def _qp_inputs(rng, batch, n):
    Z, a = _gram_inputs(rng, batch, n, 5)
    K = np.einsum("...nd,...d,...md->...nm", Z, a, Z).astype(np.float32)
    q = (1.0 + 0.3 * rng.normal(size=batch + (n,))).astype(np.float32)
    hi = np.full(batch + (n,), 0.2, np.float32)
    hi[..., n - n // 4:] = 0.0
    lam0 = rng.uniform(-0.1, 0.3, size=batch + (n,)).astype(np.float32)
    L = np.abs(K).sum(-1).max(-1)
    gamma = np.asarray(1.0 / np.maximum(L, 1e-12), np.float32)
    return K, q, hi, lam0, gamma


def _on(dev, *arrays):
    return [None if x is None else torch.from_numpy(x).to(dev)
            for x in arrays]


GRAM_SHAPES = [((), 1, 1), ((20,), 60, 11), ((2, 3), 130, 20),
               ((2,), 1500, 257)] + [
    ((20,) if n < 200 else (2,), n, d)
    for n in (1, 127, 128, 129, 300) for d in (1, 11, 16, 17, 257)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,d", GRAM_SHAPES)
def test_gram_kernel_matches_plain(cuda, batch, n, d):
    """The square K against the plain version, bitwise symmetric; then a
    panel of its rows that starts inside the first 128-row tile, against
    the plain rows and bitwise those rows of the square K."""
    Zc, ac = _on(cuda, *_gram_inputs(np.random.default_rng(n * 1000 + d),
                                     batch, n, d))
    before = ops.launch_counts()
    got = ops.weighted_gram(Zc, ac)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["weighted_gram"] == before["weighted_gram"] + 1
    assert after["gram_prescale"] == before["gram_prescale"] + 1
    assert got.shape == batch + (n, n)
    _close(got, ref.weighted_gram(Zc, ac), REL["f32"])
    assert torch.equal(got, got.transpose(-1, -2))

    start = n // 3
    rows = max(n - start - n // 5, 1)
    Zf, af = Zc.reshape(-1, n, d), ac.reshape(-1, d)
    [(_, panel)] = ops.weighted_gram_panels(Zf, af, [start], rows)
    torch.cuda.synchronize()
    assert ops.launch_counts()["weighted_gram_tiled"] == \
        after["weighted_gram_tiled"] + 1
    _close(panel, ref.weighted_gram_rows(Zf[:, start:start + rows], af, Zf),
           REL["f32"])
    assert torch.equal(panel,
                       got.reshape(-1, n, n)[:, start:start + rows])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(1, 1, 1), (3, 129, 17), (2, 300, 257),
                                   (20, 60, 11)])
def test_gram_prescale_is_the_plain_prescale(cuda, b, n, d):
    from repro_torch.kernels import gram as gram_kernel

    Z, a = _on(cuda, *_gram_inputs(np.random.default_rng(n), (b,), n, d))
    Zs = gram_kernel.prescale(Z, a)
    torch.cuda.synchronize()
    assert Zs.shape == (2, b, d, n)
    assert Zs.stride(2) == -(-n // 4) * 4       # rows 16-byte aligned
    assert Zs.untyped_storage().nbytes() == \
        4 * gram_kernel.prescale_elems(b, n, d)
    assert torch.equal(Zs, ref.gram_prescale(Z, a))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,chunk", [(20, 60, 11, 8), (2, 1000, 257, 64)])
def test_streamed_pass_holds_its_panel_and_the_operands(cuda, B, n, d,
                                                        chunk):
    """The device memory of a streamed |K| row-sum pass (the factored
    operator's L) is what PlanBudget's docstring states: the panel
    buffer and its |panel| temporary, the row sums, and the prescaled
    operands, prescale_elems(B, N, D) floats held for the whole pass."""
    from repro_torch.engine import invariants
    from repro_torch.kernels import gram as gram_kernel

    Z, a = _on(cuda, *_gram_inputs(np.random.default_rng(d), (B,), n, d))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    invariants._panel_rowsums(Z, a, chunk)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base
    operands = 4 * gram_kernel.prescale_elems(B, n, d)
    stated = operands + 4 * (2 * B * chunk * n + B * n + B * chunk)
    assert operands < held <= stated + 5 * 512, (held, stated)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [((), 1), ((20,), 60), ((2, 3), 130),
                                     ((2,), 3000)])
def test_qp_step_kernel_matches_plain(cuda, batch, n):
    K, q, hi, lam0, gamma = _on(cuda, *_qp_inputs(np.random.default_rng(n),
                                                  batch, n))
    before = ops.launch_counts()["qp_pg_step"]
    got = ops.qp_pg_step(lam0, K, q, hi, gamma)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qp_pg_step"] == before + 1
    _close(got, ref.qp_pg_step(lam0, K, q, hi, gamma), REL["f32"])


@pytest.mark.gpu
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("batch,n,iters", [((20,), 60, 50), ((2,), 1025, 5),
                                           ((3,), 3000, 4), ((1,), 7, 0),
                                           ((2,), 2000, 0)])
def test_qp_multi_kernel_matches_plain(cuda, batch, n, iters, precision,
                                       fold):
    rng = np.random.default_rng(n + iters)
    K, q, hi, lam0, gamma = _qp_inputs(rng, batch, n)
    Z = rng.normal(size=batch + (n, 9)).astype(np.float32) if fold else None
    K, q, hi, lam0, gamma, Z = _on(cuda, K, q, hi, lam0, gamma, Z)
    before = ops.launch_counts()["qp_pg_multi"]
    got = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                          precision=precision)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qp_pg_multi"] == before + 1
    want = ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                           precision=precision)
    for g, w in (zip(got, want) if fold else [(got, want)]):
        _close(g, w, REL[precision])


def _qp_inputs_on_card(dev, B, n, seed):
    """_qp_inputs' operands made on the card, for N too large to build K
    on the host."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Z = torch.randn(B, n, 5, generator=gen, device=dev)
    a = 0.1 + 1.9 * torch.rand(B, 5, generator=gen, device=dev)
    K = torch.einsum("bnd,bd,bmd->bnm", Z, a, Z)
    q = 1.0 + 0.3 * torch.randn(B, n, generator=gen, device=dev)
    hi = torch.full((B, n), 0.2, device=dev)
    hi[:, n - n // 4:] = 0.0
    lam0 = -0.1 + 0.4 * torch.rand(B, n, generator=gen, device=dev)
    gamma = 1.0 / K.abs().sum(-1).amax(-1).clamp_min(1e-12)
    return K, q, hi, lam0, gamma


# (precision, batch, n, path): each launch path of the multi kernel, and
# N at and just above the largest whose K fits in an H100 CTA's 227 KB of
# shared memory beside the iterates (232 f32, 328 bf16), above which the
# grid takes it; rows of N = 233, 329, 515 and 1025 are not on 16 bytes
# (element path), those of 244, 344 and 3000 are (16-byte loads); 300
# problems are more than an H100's resident CTAs, so a CTA's row groups
# span problems
MULTI_PATHS = [("f32", (20,), 60, "block"),
               ("f32", (2,), 232, "block"),
               ("f32", (2,), 233, "grid"),
               ("f32", (2,), 244, "grid"),
               ("f32", (2,), 515, "grid"),
               ("f32", (2,), 1025, "grid"),
               ("f32", (3,), 3000, "grid"),
               ("f32", (300,), 329, "grid"),
               ("bf16", (20,), 60, "block"),
               ("bf16", (2,), 328, "block"),
               ("bf16", (2,), 329, "grid"),
               ("bf16", (2,), 344, "grid"),
               ("bf16", (2,), 515, "grid"),
               ("bf16", (2,), 1025, "grid"),
               ("bf16", (3,), 3000, "grid"),
               ("bf16", (300,), 515, "grid")]


@pytest.mark.gpu
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("precision,batch,n,path", MULTI_PATHS)
def test_qp_multi_kernel_is_repeatable_on_every_path(cuda, precision, batch,
                                                     n, path, fold):
    """Each launch path, against the plain version; two launches on the
    same inputs are torch.equal (no atomics; fixed sums), and a K
    converted to bf16 beforehand gives the bits of an f32 K with
    precision="bf16"."""
    from repro_torch.kernels import qp_step as qp_kernel

    shape = qp_kernel.qp_multi_shape(batch[0], n, precision=precision,
                                     fold=fold)
    assert shape["path"] == path
    if path == "grid" and batch[0] > shape["blocks"]:
        assert shape["problems_per_cta"] >= 2
    rng = np.random.default_rng(n + 7)
    K, q, hi, lam0, gamma = _qp_inputs(rng, batch, n)
    Z = rng.normal(size=batch + (n, 9)).astype(np.float32) if fold else None
    K, q, hi, lam0, gamma, Z = _on(cuda, K, q, hi, lam0, gamma, Z)
    Kp = K.to(torch.bfloat16) if precision == "bf16" else K
    run = lambda K_: ops.qp_pg_multi(lam0, K_, q, hi, gamma, iters=6, Z=Z,
                                     precision=precision)
    first, second, pre = run(K), run(K), run(Kp)
    want = ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=6, Z=Z,
                           precision=precision)
    torch.cuda.synchronize()
    pairs = zip(first, want) if fold else [(first, want)]
    for g, w in pairs:
        _close(g, w, REL[precision])
    for a, b in ((first, second), (first, pre)):
        for x, y in (zip(a, b) if fold else [(a, b)]):
            assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("precision,n", [("f32", 26000), ("bf16", 51300)])
def test_qp_multi_grid_stages_the_iterate_in_chunks(cuda, precision, n):
    """An iterate larger than one CTA's staging (25600 f32 / 51200 bf16
    entries) is staged in column chunks; 51300 bf16 rows are not on 16
    bytes, so the chunks take the element path.  K is made on the card
    (2.7 GB f32 / 5.3 GB bf16) and converted before the launch."""
    from repro_torch.kernels import qp_step as qp_kernel

    shape = qp_kernel.qp_multi_shape(1, n, precision=precision, fold=True)
    assert shape["path"] == "grid"
    K, q, hi, lam0, gamma = _qp_inputs_on_card(cuda, 1, n, seed=n)
    if precision == "bf16":
        K = K.to(torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(1)
    Z = torch.randn(1, n, 9, generator=gen, device=cuda)
    got = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=3, Z=Z,
                          precision=precision)
    again = ops.qp_pg_multi(lam0, K, q, hi, gamma, iters=3, Z=Z,
                            precision=precision)
    want = ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=3, Z=Z,
                           precision=precision)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        _close(g, w, REL[precision])
        assert torch.equal(g, a)
    if precision == "f32":      # the f32 limit is below how far lam moved
        moved = float((want[0] - torch.minimum(lam0.clamp_min(0.0), hi))
                      .abs().max())
        assert REL["f32"] * float(want[0].abs().max()) < moved


@pytest.mark.gpu
def test_fit_on_the_card_matches_the_cpu(cuda):
    """A small DTSVM fit through the API, on the card and on the CPU."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, SolverConfig

    data, adj = quickstart.data_and_graph()
    for solver in ("pallas_fused", "pallas_fused_multi"):
        cfg = SolverConfig(iters=5, qp_iters=20, qp_solver=solver)
        risks = [DTSVM(cfg, device=dev).fit(
            data["X"], data["y"], mask=data["mask"], adj=adj).global_risks(
                data["X_test"], data["y_test"]) for dev in ("cuda", "cpu")]
        np.testing.assert_allclose(risks[0], risks[1], atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,N,d,start", [
    (1, 1, 1, 1, 0), (20, 24, 60, 11, 36), (2, 67, 131, 257, 5),
    (3, 61, 62, 1, 1), (2, 64, 256, 33, 64)])
def test_tiled_gram_kernel_matches_plain_into_an_offset_view(cuda, B, M, N,
                                                            d, start):
    """Rows [start, start + M) of an (N + 3)-row NaN-filled buffer take
    the panel of the same rows of K; M and N not multiples of 128 or 4
    exercise the masked edges, and an odd row stride or offset the scalar
    stores."""
    rng = np.random.default_rng(M * N + d)
    Z, a = _on(cuda, *_gram_inputs(rng, (B,), N, d))
    big = torch.full((B, N + 3, N), float("nan"), device=cuda)
    before = ops.launch_counts()
    [(_, got)] = ops.weighted_gram_panels(Z, a, [start], M, out=big)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["weighted_gram_tiled"] == before["weighted_gram_tiled"] + 1
    assert after["gram_prescale"] == before["gram_prescale"] + 1
    assert got.data_ptr() == big[:, start:].data_ptr()
    _close(big[:, start:start + M],
           ref.weighted_gram_rows(Z[:, start:start + M], a, Z), REL["f32"])
    assert torch.isnan(big[:, :start]).all()
    assert torch.isnan(big[:, start + M:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,d,chunk", [((20,), 60, 11, 8),
                                             ((2,), 300, 257, 72),
                                             ((3, 2), 129, 1, 24)])
def test_tiled_panels_are_the_square_kernels_rows(cuda, batch, n, d, chunk):
    from repro_torch.engine import invariants

    Z, a = _on(cuda, *_gram_inputs(np.random.default_rng(n), batch, n, d))
    K = ops.weighted_gram(Z, a)
    streamed, rs = invariants.streamed_gram_panel(Z, a, chunk)
    assert torch.equal(streamed, K)
    torch.testing.assert_close(rs, K.abs().sum(-1), rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,start,M", [
    (20, 60, 11, 20, 24),       # inside the one tile, across the diagonal
    (2, 300, 257, 100, 150),    # starts mid-tile, across two tile rows
    (3, 129, 17, 127, 2),       # the last rows of one tile and the next
    (2, 300, 16, 0, 300),       # the whole square through the tiled kernel
    (1, 400, 33, 250, 150),     # mid-tile start, columns on both sides
    (1, 700, 19, 200, 300),     # tiles left of, in and right of the block
    (2, 260, 1, 5, 255)])
def test_panels_across_the_diagonal_are_the_square_rows(cuda, B, n, d,
                                                        start, M):
    """Panels that start inside a 128-row tile and that the diagonal
    crosses, written into an offset view of a NaN-filled buffer with a
    wider row stride: bitwise the same rows of the square K."""
    from repro_torch.kernels import gram as gram_kernel

    Z, a = _on(cuda, *_gram_inputs(np.random.default_rng(n + start),
                                   (B,), n, d))
    K = ops.weighted_gram(Z, a)
    big = torch.full((B, M + 7, n + 5), float("nan"), device=cuda)
    view = big[:, 3:3 + M, 1:1 + n]
    gram_kernel.weighted_gram_tiled(gram_kernel.prescale(Z, a), start, view)
    torch.cuda.synchronize()
    assert torch.equal(view, K[:, start:start + M])
    assert torch.isnan(big[:, :3]).all() and torch.isnan(big[:, 3 + M:]).all()
    assert torch.isnan(big[:, :, 0]).all()
    assert torch.isnan(big[:, :, 1 + n:]).all()


@pytest.mark.gpu
def test_nonbinding_budget_launches_the_square_kernel(cuda):
    """A ``PlanBudget(tile=...)`` that does not bind builds K with one
    launch of the square kernel and none of the tiled one."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, PlanBudget, SolverConfig
    from repro_torch.engine import plan

    data, adj = quickstart.data_and_graph()
    cfg = SolverConfig(qp_solver="pallas_fused_multi")
    prob = DTSVM(cfg).make_problem(data["X"], data["y"], data["mask"], adj,
                                   device=cuda)
    dense = plan.compile_problem(prob, cfg)
    budget = PlanBudget(tile=(64, 128))
    assert budget.row_chunk(prob.X.shape[0] * prob.X.shape[1],
                            prob.X.shape[2]) is None
    before = ops.launch_counts()
    budgeted = plan.compile_problem(prob, cfg, budget=budget)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["weighted_gram"] == before["weighted_gram"] + 1
    assert after["weighted_gram_tiled"] == before["weighted_gram_tiled"]
    assert torch.equal(budgeted.inv.K, dense.inv.K)
    assert torch.equal(budgeted.inv.L, dense.inv.L)


@pytest.mark.gpu
def test_tiled_wrapper_refuses_cpu_tensors(cuda):
    from repro_torch.kernels import gram as gram_kernel

    Z = torch.ones(1, 8, 3, device=cuda)
    a = torch.ones(1, 3, device=cuda)
    Zs = gram_kernel.prescale(Z, a)
    with pytest.raises(ValueError):
        gram_kernel.weighted_gram_tiled(Zs.cpu(), 0, torch.empty(1, 8, 8))
    with pytest.raises(ValueError):
        gram_kernel.weighted_gram_tiled(Zs, 0, torch.empty(1, 8, 8))
    with pytest.raises(ValueError):        # rows 4..11 of an 8-row K
        gram_kernel.weighted_gram_tiled(
            Zs, 4, torch.empty(1, 8, 8, device=cuda))
    with pytest.raises(ValueError):        # 8 columns of a 5-row Z
        gram_kernel.weighted_gram_tiled(
            gram_kernel.prescale(Z[:, :5], a), 0,
            torch.empty(1, 4, 8, device=cuda))
    with pytest.raises(ValueError):
        list(ops.weighted_gram_panels(Z, a, [0], 8,
                                      out=torch.empty(1, 8, 8)))


def _binding_operands(ext, dev, binding):
    """A binding's good operands at B=1, N=8, D=3, and for each way to
    spoil them the operand list that does: a CPU tensor, an operand of
    another N (for the prescale, an ``a`` of N entries where it takes D),
    a float64 operand."""
    f32 = lambda *shape: torch.zeros(*shape, device=dev)
    Z, a = f32(1, 8, 3), f32(1, 3)
    Zs = ext.gram_prescale(Z, a)                      # (2, 1, 3, 8) view
    lam, K, one = f32(1, 8), f32(1, 8, 8), torch.ones(1, device=dev)
    good = {"gram_prescale": [Z, a],
            "weighted_gram": [Zs],
            "weighted_gram_tiled": [Zs, 0, f32(1, 4, 8)],
            "qp_pg_step": [lam, K, lam, lam, one],
            "qp_pg_multi": [lam, K, lam, lam, one, None, 3],
            "gemm_rows": [f32(6, 3), f32(6), f32(8, 3)]}[binding]
    wrong_n = {"gram_prescale": (1, f32(1, 8)),
               "weighted_gram": (0, Zs[..., :3]),     # rows 8 apart, not 4
               "weighted_gram_tiled": (2, f32(1, 4, 9)),
               "qp_pg_step": (1, f32(1, 9, 9)),
               "qp_pg_multi": (1, f32(1, 9, 9)),
               "gemm_rows": (2, f32(8, 4))}[binding]

    def spoil(i, t):
        return good[:i] + [t] + good[i + 1:]

    return good, {"cpu": spoil(0, good[0].cpu()),
                  "wrong_n": spoil(*wrong_n),
                  "wrong_dtype": spoil(0, good[0].double())}


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["cpu", "wrong_n", "wrong_dtype"])
@pytest.mark.parametrize("binding", ["gram_prescale", "weighted_gram",
                                     "weighted_gram_tiled", "qp_pg_step",
                                     "qp_pg_multi", "gemm_rows"])
def test_binding_checks_raise_value_errors(cuda, binding, bad):
    """An operand a kernel does not take raises ValueError from the
    binding's own checks (TORCH_CHECK_VALUE; several messages format
    integers), and the process goes on: the same binding then runs on
    good operands."""
    from repro_torch.kernels import build

    ext = build.extension()
    good, spoilt = _binding_operands(ext, cuda, binding)
    with pytest.raises(ValueError):
        getattr(ext, binding)(*spoilt[bad])
    getattr(ext, binding)(*good)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_extension_links_the_shared_libstdcxx(cuda):
    """The built module depends on the process's shared libstdc++ and
    carries no copy of its stream code (``build.LINK_FLAGS``): a copy
    linked in from libstdc++.a crashes on the first number it formats."""
    import subprocess

    from repro_torch.kernels import build

    so = build.extension().__file__
    ldd = subprocess.run(["ldd", so], capture_output=True, text=True,
                         check=True).stdout
    assert "libstdc++.so" in ldd, ldd
    nm = subprocess.run(["nm", "-D", "--defined-only", so],
                        capture_output=True, text=True, check=True).stdout
    assert "_ZNSo9_M_insert" not in nm           # std::ostream::_M_insert


@pytest.mark.gpu
def test_budgeted_fit_on_the_card_equals_the_dense_fit(cuda):
    """The quickstart's problem under an 8-row budget and under the
    factored operator, on the card: the budgeted K is the dense K
    bitwise, L and the states agree to rounding."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, PlanBudget, SolverConfig
    from repro_torch.engine import plan

    data, adj = quickstart.data_and_graph()
    cfg = SolverConfig(iters=5, qp_iters=20, qp_solver="pallas_fused_multi")
    prob = DTSVM(cfg).make_problem(data["X"], data["y"], data["mask"], adj,
                                   device=cuda)
    dense = plan.compile_problem(prob, cfg)
    budgeted = plan.compile_problem(prob, cfg,
                                    budget=PlanBudget(tile=(8, 128)))
    factored = plan.compile_problem(prob, cfg, qp_operator="factored")
    assert torch.equal(budgeted.inv.K, dense.inv.K)
    assert factored.inv.K is None
    for p in (budgeted, factored):
        torch.testing.assert_close(p.inv.L, dense.inv.L, rtol=1e-6, atol=0)
    want, _ = dense.run(iters=5)
    for p in (budgeted, factored):
        got, _ = p.run(iters=5)
        for name, g, w in zip(want._fields, got, want):
            _close(g, w, 1e-4)


@pytest.mark.gpu
def test_budgeted_replan_on_the_card_rebuilds_the_changed_slices(cuda):
    """A membership change under a budget rebuilds only the K slices whose
    ``a`` row changed, with the tiled kernel; the result is a fresh
    build's K, bitwise."""
    from repro_torch import quickstart
    from repro_torch.api import DTSVM, PlanBudget, SolverConfig
    from repro_torch.engine import invariants, plan

    data, adj = quickstart.data_and_graph()
    cfg = SolverConfig(qp_solver="pallas_fused_multi",
                       budget=PlanBudget(tile=(8, 128)))
    prob = DTSVM(cfg).make_problem(data["X"], data["y"], data["mask"], adj,
                                   device=cuda)
    compiled = plan.compile_problem(prob, cfg)
    active = torch.ones_like(prob.active)
    active[0, 1] = 0.0
    before = ops.launch_counts()["weighted_gram_tiled"]
    replanned = compiled.replan(active=active)
    torch.cuda.synchronize()
    n = replanned.stats["gram_slices_computed"] - prob.active.numel()
    assert 0 < n < prob.active.numel()
    assert ops.launch_counts()["weighted_gram_tiled"] > before
    fresh = invariants.compute_invariants(replanned.prob)
    assert torch.equal(replanned.inv.K, fresh.K)


# ---------------------------------------------------------------------------
# CSVM, sweeps and the figures on the card
# ---------------------------------------------------------------------------
def _fig_data(V=6, seed=0):
    from repro_torch.figures import common

    return common.build(V, [24, 120], degree=0.8, seed=seed, n_test=300)


@pytest.mark.gpu
def test_csvm_on_the_card_matches_the_cpu(cuda):
    """CSVM pooled per task: one square Gram launch per fit for all the
    tasks, w within 1e-4 and b within 1e-3 of the largest magnitude of the
    CPU port's (w, b) (the bias column weighs 1000), risks within one test
    sample."""
    from repro_torch.api import CSVM, SolverConfig

    data, _ = _fig_data()
    cfg = SolverConfig(C=0.01, qp_iters=600)
    before = ops.launch_counts()
    card = CSVM(cfg, device="cuda").fit(data["X"], data["y"],
                                        mask=data["mask"])
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["weighted_gram"] == before["weighted_gram"] + 1
    assert after["gram_prescale"] == before["gram_prescale"] + 1
    cpu = CSVM(cfg, device="cpu").fit(data["X"], data["y"],
                                      mask=data["mask"])
    scale = max(float(cpu.w_.abs().max()), float(cpu.b_.abs().max()))
    assert float((card.w_.cpu() - cpu.w_).abs().max()) <= \
        1e-4 * float(cpu.w_.abs().max())
    assert float((card.b_.cpu() - cpu.b_).abs().max()) <= 1e-3 * scale
    np.testing.assert_allclose(
        card.global_risks(data["X_test"], data["y_test"]),
        cpu.global_risks(data["X_test"], data["y_test"]), atol=1.0 / 300)


@pytest.mark.gpu
@pytest.mark.parametrize("qp_solver", ["fista", "pallas_fused",
                                       "pallas_fused_multi"])
def test_sweep_on_the_card_is_its_serial_fits(cuda, qp_solver):
    """A 4-config sweep with per-config masks on the card: one square Gram
    launch builds every config's K; each ADMM iteration is one multi
    launch (``pallas_fused_multi``) or ``qp_iters`` step launches
    (``pallas_fused``) over all S*V*T problems; each config's state
    within 1e-5 of the largest magnitude of its serial card fit's."""
    from repro_torch.api import dsvm_overrides
    from repro_torch.core import dtsvm
    from repro_torch.engine import compile_sweep, plan

    data, adj = _fig_data()
    V = adj.shape[0]
    active = np.ones((V, 2), np.float32)
    active[3:, 1] = 0.0
    couple = np.array([1, 1, 1, 0, 0, 0], np.float32)
    cfgs = [dict(eps1=0.1), dict(eps2=10.0, C=0.1), dsvm_overrides(V),
            dict(eps2=10.0, active=active, couple=couple)]
    prob = dtsvm.make_problem(data["X"], data["y"], data["mask"], adj,
                              device=cuda)
    iters, qp_iters = 4, 20
    before = ops.launch_counts()
    splan = compile_sweep(prob, cfgs, qp_iters=qp_iters, qp_solver=qp_solver)
    st, _ = splan.run(iters=iters)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    assert launched["weighted_gram"] == 1 and launched["gram_prescale"] == 1
    assert launched["qp_pg_multi"] == (iters if qp_solver ==
                                       "pallas_fused_multi" else 0)
    assert launched["qp_pg_step"] == (iters * qp_iters if qp_solver ==
                                      "pallas_fused" else 0)
    for s, pc in enumerate(splan.config_problems):
        want, _ = plan.compile_problem(pc, qp_iters=qp_iters,
                                       qp_solver=qp_solver).run(iters=iters)
        for name, g, w in zip(want._fields, st, want):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g[s] - w).abs().max()) <= 1e-5 * scale, (s, name)


@pytest.mark.gpu
def test_budgeted_sweep_on_the_card_streams_the_dense_k(cuda):
    """Under a binding budget the stacked K streams through tiled-kernel
    panels over all S*V*T problems, bitwise the dense stacked K."""
    from repro_torch.core import dtsvm
    from repro_torch.engine import PlanBudget, compile_sweep, invariants

    data, adj = _fig_data()
    prob = dtsvm.make_problem(data["X"], data["y"], data["mask"], adj,
                              device=cuda)
    cfgs = [dict(C=c) for c in (0.01, 0.1, 1.0)]
    dense = compile_sweep(prob, cfgs, qp_iters=5)
    budget = PlanBudget(tile=(8, 128))
    N = prob.X.shape[2]
    panels = len(invariants._row_starts(N, budget.row_chunk(36, N)))
    before = ops.launch_counts()
    streamed = compile_sweep(prob, cfgs, qp_iters=5, budget=budget)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["weighted_gram_tiled"] - before["weighted_gram_tiled"] \
        == panels > 1
    assert after["weighted_gram"] == before["weighted_gram"]
    assert torch.equal(streamed.inv.K, dense.inv.K)


@pytest.mark.gpu
def test_sweep_fit_on_the_card_matches_the_cpu(cuda):
    """Fig. 5's pair (DTSVM beside the DSVM overrides) through sweep_fit:
    the card's final states within 1e-4 of each leaf's largest magnitude
    of the CPU port's (the large fit's card-against-CPU tolerance), its
    risks within one test sample."""
    from repro_torch.figures import common
    from repro_torch.api import dsvm_overrides

    data, adj = _fig_data()
    cfgs = [dict(), dsvm_overrides(adj.shape[0])]
    res = {dev: common.run_sweep(data, adj, cfgs, 10, device=dev)[0]
           for dev in ("cuda", "cpu")}
    for name, g, w in zip(res["cpu"].states._fields, res["cuda"].states,
                          res["cpu"].states):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, name
    np.testing.assert_allclose(res["cuda"].final_risks(),
                               res["cpu"].final_risks(), atol=1.0 / 300)


@pytest.mark.gpu
def test_kernels_at_sweep_and_csvm_operands_match_plain(cuda, monkeypatch):
    """The kernels at the operands these paths hand them, each against
    its plain version: the square Gram kernel at a sweep's build (one Z
    shared by S configs' a; bitwise the K the sweep kept) and at CSVM's
    pooled build (one (p+1,) a over the tasks' Z), and the multi solve
    on the stacked sweep problems with the shared Z folded in (and more
    than the tolerance away from its warm start)."""
    from repro_torch.core import csvm, dtsvm
    from repro_torch.engine import compile_sweep

    data, adj = _fig_data()
    prob = dtsvm.make_problem(data["X"], data["y"], data["mask"], adj,
                              device=cuda)
    inv = compile_sweep(prob, [dict(eps1=e) for e in (0.1, 1.0, 10.0)],
                        qp_iters=20).inv
    Zb = ops.broadcast_z(inv.Z, inv.a)
    K = ops.weighted_gram(inv.Z, inv.a)
    assert torch.equal(K, inv.K)
    _close(K, ref.weighted_gram(Zb, inv.a), REL["f32"])

    gen = torch.Generator(device=cuda).manual_seed(0)
    lam0 = inv.hi * torch.rand(inv.hi.shape, generator=gen, device=cuda)
    q = 1.0 + 0.1 * torch.randn(inv.hi.shape, generator=gen, device=cuda)
    lam, zl = ops.qp_pg_multi(lam0, inv.K, q, inv.hi, 1.0 / inv.L,
                              iters=20, Z=inv.Z)
    lam_p, zl_p = ref.qp_pg_multi(lam0, inv.K, q, inv.hi, 1.0 / inv.L,
                                  iters=20, Z=Zb)
    _close(lam, lam_p, REL["f32"])
    _close(zl, zl_p, REL["f32"])
    moved = float((lam_p - torch.minimum(lam0, inv.hi)).abs().max())
    assert REL["f32"] * float(lam_p.abs().max()) < moved

    calls = []
    real = ops.weighted_gram
    monkeypatch.setattr(ops, "weighted_gram",
                        lambda Z, a: calls.append((Z, a)) or real(Z, a))
    X, y, mask = (torch.as_tensor(data[k], dtype=torch.float32,
                                  device=cuda) for k in ("X", "y", "mask"))
    pool = lambda a: a.transpose(0, 1).reshape(
        (a.shape[1], -1) + a.shape[3:])
    csvm.csvm_fit_tasks(pool(X), pool(y), 0.01, pool(mask), qp_iters=5)
    (Z, a), = calls
    assert a.ndim == 1 and Z.ndim == 3
    _close(real(Z, a), ref.weighted_gram(Z, a.expand(Z.shape[0], -1)),
           REL["f32"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fig2", "fig3", "fig4", "fig5", "fig6",
                                  "fig7", "fig7_churn"])
def test_golden_figures_on_the_card(cuda, name):
    """Each golden regime through the port on the card, within the
    fixtures' ATOL = 0.015 of tests/golden/<fig>.json (Fig. 7's churn
    variant over the lossy fabric, its replay audit bitwise)."""
    import json
    import os

    from repro_torch.figures import golden

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", f"{name}.json")
    with open(path) as f:
        want = json.load(f)
    got = golden.outputs(name, want["regime"], device="cuda")
    for key, val in want["outputs"].items():
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(val, np.float64), atol=0.015,
                                   err_msg=f"{name}/{key}")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [dict(qp_solver="fista"),
                                 dict(qp_solver="pallas_fused_multi"),
                                 dict(qp_solver="pallas_fused_multi",
                                      budget="panels"),
                                 dict(qp_solver="pallas_fused", jit=True)])
def test_session_on_the_card_matches_the_cpu(cuda, cfg):
    """Fig. 7's five stages through an ``OnlineSession`` on the card
    (incremental replans; under a binding budget the rebuilt slices
    stream through the tiled kernel; ``jit=True`` compiles per run):
    the final state within 1e-4 of each leaf's largest magnitude of the
    same session on the CPU, and a replay of its event log on the card
    bitwise the live session.  The sessions are Fig. 7's (the network,
    data and config of ``fig7_online.make_session``), built here so that
    ``jit`` can be set."""
    from repro_torch.api import OnlineSession, PlanBudget, SolverConfig
    from repro_torch.core import graph as graph_lib
    from repro_torch.data import synthetic
    from repro_torch.figures import fig7_online
    from repro_torch.store import EventLog, replay

    cfg = dict(cfg)
    jit = cfg.pop("jit", False)
    if cfg.pop("budget", None):
        cfg["budget"] = PlanBudget(tile=(8, 128))     # 8-row panels of 40
    V, T = fig7_online.V, fig7_online.T
    n_train = np.zeros((V, T), int)
    n_train[:, :2] = 10
    n_train[:, 2] = 40
    data = synthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=300, relatedness=0.9,
        noise=1.0, seed=0)
    sessions, logs = {}, {}
    for dev in ("cuda", "cpu"):
        logs[dev] = EventLog()
        sess = sessions[dev] = OnlineSession(
            data["X"], data["y"], mask=data["mask"], adj=graph_lib.full(V),
            config=SolverConfig(C=0.01, eps1=1.0, eps2=100.0, qp_iters=40,
                                **cfg),
            X_test=data["X_test"], y_test=data["y_test"],
            couple=np.zeros(V, np.float32), log=logs[dev], jit=jit,
            device=dev)
        for _, tasks, couple in fig7_online.STAGES:
            fig7_online.enter_stage(sess, tasks, couple)
            sess.run(4)
    card, cpu = sessions["cuda"], sessions["cpu"]
    for name, g, w in zip(cpu.state._fields, card.state, cpu.state):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, name
    assert card.plan_stats == cpu.plan_stats
    twin = replay(logs["cuda"], device="cuda")
    for name, g, w in zip(card.state._fields, twin.state, card.state):
        assert torch.equal(g, w), name
    for h, w in zip(twin.history, card.history):
        assert np.array_equal(h, w)


def _fabric_fit_data(V=6, T=2, N=40, p=10, seed=0):
    from repro_torch.core import graph as graph_lib
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(V, T, N, p)).astype(np.float32)
    y = np.where(X[..., 0] + 0.3 * rng.normal(size=(V, T, N)) > 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y, graph_lib.make_graph("random", V, degree=0.6, seed=seed)


@pytest.mark.gpu
@pytest.mark.parametrize("qp_solver", ["fista", "pallas_fused",
                                       "pallas_fused_multi"])
def test_identity_async_fit_on_the_card_is_the_vmap_fit(cuda, qp_solver):
    """The identity fabric (``net=NetConfig()``) on CUDA tensors gives
    the vmap fit's state bit for bit, per QP engine."""
    from repro_torch.api import DTSVM, NetConfig, SolverConfig

    X, y, A = _fabric_fit_data()
    cfg = SolverConfig(iters=6, qp_iters=30, qp_solver=qp_solver)
    vmap = DTSVM(cfg, device="cuda").fit(X, y, adj=A)
    asy = DTSVM(cfg.replace(net=NetConfig()), device="cuda").fit(X, y, adj=A)
    assert asy.net_report_["mode"] == "buffer"
    for name, a, b in zip(vmap.state_._fields, asy.state_, vmap.state_):
        assert a.is_cuda and torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("qp_solver", ["fista", "pallas_fused",
                                       "pallas_fused_multi"])
def test_fabric_path_launches_the_kernels(cuda, qp_solver):
    """A lossy async fit on the card (int8 wire, drops, partial
    activation, a crash and a recovery) launches the Gram kernel and
    its prescale once, and the QP engine's kernel as the vmap path
    does: the step kernel qp_iters times per round, the multi kernel
    once per round; its state within 1e-4 of each leaf's largest
    magnitude of the same fit on the CPU."""
    from repro_torch.api import (DTSVM, LinkPolicy, Membership,
                                 MembershipEvent, NetConfig, SolverConfig)

    X, y, A = _fabric_fit_data(seed=1)
    iters, qp_iters = 8, 20
    cfg = SolverConfig(iters=iters, qp_iters=qp_iters, qp_solver=qp_solver,
                       net=NetConfig(policy=LinkPolicy(quant="int8",
                                                       drop=0.1),
                                     schedule="partial:0.9", seed=2,
                                     stale_limit=3, error_feedback=True))
    mem = Membership(events=(MembershipEvent(2, "crash", 3),
                             MembershipEvent(5, "recover", 3)))
    ops.reset_launch_counts()
    card = DTSVM(cfg, device="cuda").fit(X, y, adj=A, membership=mem)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    want = {"weighted_gram": 1, "weighted_gram_tiled": 0,
            "gram_prescale": 1, "gemm_rows": 0,
            "qp_pg_step": (iters * qp_iters if qp_solver == "pallas_fused"
                           else 0),
            "qp_pg_multi": iters if qp_solver == "pallas_fused_multi"
            else 0}
    assert got == want
    cpu = DTSVM(cfg, device="cpu").fit(X, y, adj=A, membership=mem)
    for name, g, w in zip(cpu.state_._fields, card.state_, cpu.state_):
        assert float((g.cpu() - w).abs().max()) <= \
            1e-4 * float(w.abs().max()), name
    assert card.net_report_["msgs_sent"] == cpu.net_report_["msgs_sent"]
    assert card.net_report_["membership"] == cpu.net_report_["membership"]


@pytest.mark.gpu
def test_async_refuses_the_bf16_and_factored_modes_on_the_card(cuda):
    """The async fabric steps the materialized f32 dual path: a bf16 or
    factored config raises the reference's ValueError, on CUDA tensors
    as on the CPU."""
    from repro_torch.api import DTSVM, NetConfig, SolverConfig, backends
    from repro_torch.core import dtsvm as core
    from repro_torch.engine import plan as engine_plan
    from repro_torch.net import run_async

    X, y, A = _fabric_fit_data()
    for mode in (dict(qp_precision="bf16"), dict(qp_operator="factored")):
        cfg = SolverConfig(iters=1, qp_iters=5, net=NetConfig(),
                           qp_solver="pallas_fused_multi", **mode)
        with pytest.raises(ValueError, match="vmap-backend features"):
            DTSVM(cfg, device="cuda").fit(X, y, adj=A)
    prob = core.make_problem(X, y, adj=A, device="cuda")
    with pytest.raises(ValueError, match="vmap-backend features"):
        backends.run(prob, 1, backend="async", qp_iters=5,
                     qp_solver="pallas_fused_multi", qp_precision="bf16")
    plan = engine_plan.compile_problem(prob, qp_iters=5,
                                       qp_solver="pallas_fused_multi",
                                       qp_precision="bf16")
    with pytest.raises(ValueError, match="materialized f32"):
        run_async(prob, 1, plan=plan)



#: (M, K, p, offset): offset > 0 takes X as rows [offset, offset + M) of a
#: larger tensor (a view whose start may be off 16 bytes)
GEMM_ROWS_SHAPES = [(1, 1, 1, 0), (8, 20, 10, 0), (1024, 2, 256, 0),
                    (37, 20, 257, 0), (1024, 20, 784, 0), (16, 60, 784, 0),
                    (8, 20, 784, 0), (1024, 20, 784, 3), (33, 2, 257, 0),
                    (7, 20, 10, 0), (64, 20, 2000, 0), (33, 2, 1027, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,p,offset", GEMM_ROWS_SHAPES)
def test_gemm_rows_kernel_matches_plain(cuda, M, K, p, offset):
    """The serving product against its plain version (the kernel splits
    each sum over a lane group and chains with fmaf, the plain version
    sums in order and rounds twice a step); (16, 60, 784) has K (p + 1)
    floats past 48 KB, (1024, 20, 784) at offset 3 reads X from a view of
    a larger tensor, p = 2000 (float4) and 1027 (scalar) run past the
    1024 features a lane group holds in registers."""
    rng = np.random.default_rng(M * 7 + K * 3 + p + offset)
    Wf, bf, Xs = _on(cuda, rng.normal(size=(K, p)).astype(np.float32),
                     rng.normal(size=(K,)).astype(np.float32),
                     rng.normal(size=(M + offset, p)).astype(np.float32))
    X = Xs[offset:]
    before = ops.launch_counts()["gemm_rows"]
    got = ops.gemm_rows(Wf, bf, X)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gemm_rows"] == before + 1
    assert got.shape == (M, K)
    _close(got, ref.gemm_rows(Wf, bf, X), REL["f32"])


@pytest.mark.gpu
@pytest.mark.parametrize("K,p", [(20, 10), (2, 256), (20, 784), (60, 784),
                                 (2, 257), (20, 2000), (2, 1027)])
def test_gemm_rows_bucket_contract_on_the_card(cuda, K, p):
    """Rows 0-7 give the same bits in buckets 8 to 1024, at row offset 0
    and 3, with other rows beside them, and on a second launch; in
    batches of 1, 7, 33 and 1000 rows; in rows [3, 11) of a view X[3:] of
    a larger tensor; and where X starts 4 bytes past a 16-byte boundary
    (the kernel's scalar loads, where p % 4 == 0 would take float4 ones).
    (60, 784) has K (p + 1) floats past 48 KB; (20, 2000) and (2, 1027)
    run past the 1024 features a lane group holds in registers."""
    rng = np.random.default_rng(K + p)
    Wf, bf, x = _on(cuda, rng.normal(size=(K, p)).astype(np.float32),
                    rng.normal(size=(K,)).astype(np.float32),
                    rng.normal(size=(8, p)).astype(np.float32))
    want = ops.gemm_rows(Wf, bf, x)
    for bucket in (8, 16, 32, 256, 1024):
        for off in (0, 3):
            if off + 8 > bucket:
                continue
            X = torch.randn(bucket, p, device=cuda)
            X[off:off + 8] = x
            assert torch.equal(ops.gemm_rows(Wf, bf, X)[off:off + 8],
                               want), (bucket, off)
    for M in (1, 7, 33, 1000):
        n = min(M, 8)
        X = torch.randn(M, p, device=cuda)
        X[:n] = x[:n]
        assert torch.equal(ops.gemm_rows(Wf, bf, X)[:n], want[:n]), M
    big = torch.randn(1027, p, device=cuda)
    big[3:11] = x
    assert torch.equal(ops.gemm_rows(Wf, bf, big[3:])[:8], want)
    flat = torch.randn(1 + 64 * p, device=cuda)
    shifted = flat[1:].view(64, p)
    assert shifted.data_ptr() % 16 == 4
    shifted[:8] = x
    assert torch.equal(ops.gemm_rows(Wf, bf, shifted)[:8], want)
    assert torch.equal(ops.gemm_rows(Wf, bf, x), want)


@pytest.mark.gpu
def test_serving_on_the_card_is_exact(cuda):
    """A card server's answers are bitwise ``decide_rows`` on the card,
    and within 3e-5 of the CPU model's; every batch launches the
    kernel."""
    from repro_torch.serve import PredictModel, PredictServer

    rng = np.random.default_rng(11)
    r = rng.normal(size=(4, 3, 2 * 10 + 2)).astype(np.float32)
    m = PredictModel.from_r(r)
    assert m.W.device.type == "cuda"
    before = ops.launch_counts()["gemm_rows"]
    with PredictServer(m, window_ms=1.0) as srv:
        reqs = []
        for _ in range(40):
            x = rng.normal(size=(int(rng.integers(1, 9)), 10)) \
                .astype(np.float32)
            v, t = int(rng.integers(4)), int(rng.integers(3))
            reqs.append((x, v, t, srv.submit(x, node=v, task=t)))
        for x, v, t, fut in reqs:
            np.testing.assert_array_equal(
                fut.result(30), m.decide_rows(x)[:, v * 3 + t])
        batches = srv.stats()["batches"]
    assert ops.launch_counts()["gemm_rows"] >= before + batches
    x = rng.normal(size=(5, 10)).astype(np.float32)
    cpu = PredictModel.from_r(r, device="cpu").decide_rows(x)
    _close(torch.from_numpy(m.decide_rows(x)), torch.from_numpy(cpu),
           REL["f32"])
