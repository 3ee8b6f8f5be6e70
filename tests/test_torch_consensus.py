"""The consensus trainer (``repro_torch.core.consensus``, and
``repro_torch.train.steps``' ``ConsensusTrainState``,
``make_consensus_train_state``, ``consensus_state_specs`` and
``make_consensus_train_step``) against the reference's on the CPU.

The reference's functions run in process under ``jax.vmap(fn,
axis_name="data")``, which gives ``ppermute``, ``psum`` and ``pmean`` a
replica axis on one device.  Its step runs once per module, in one
4-device subprocess (a ``data=4, model=1`` mesh), over reduced qwen2 (3
steps exchanging every step, 4 exchanging every other) and reduced
mamba2 (2 steps), each from a state desynchronized by a numpy-drawn
factor (1 + 0.05 N(0, 1)) per element; it dumps every step's metrics
with every shard of ``grad_norm`` and ``consensus_gap``, and the state
after every step.  The port runs each case twice: its own run from the
same start, and each step alone from the reference's state before it.

Tolerances, fp32 compute, as ``test_torch_train.py``'s doc sets them:
the loss within rtol 1e-5; each gradient-derived leaf (the dual, the
moments) within 1e-4 of that leaf's largest magnitude; the parameters
within 2 lr a step, at most 1e-3 of them past lr / 100; ``grad_norm``
and ``consensus_gap`` within rtol 1e-5 of the reference's shard 0,
which is what its caller reads (each shard computes its own and
``out_specs=P()`` keeps device 0's).  The core functions: fp32 leaves
within 1e-6 of each leaf's largest magnitude, bf16 leaves within one
bf16 step (2^-8) of it.

The dual and the moments are held step by step, from the reference's
own state: the dual sums eta/2 (2 r_v - r_{v-1} - r_{v+1}) over the
parameters' history, and the moments take the same terms through the
augmented gradient, so in a run they inherit the parameters' lr-sized
differences (Adam's first steps, the module doc of
``test_torch_train.py``).  After three steps of the port's own run the
dual of reduced qwen2's key bias, whose loss gradient is zero in exact
arithmetic, is 3.3e-2 of its largest magnitude off the reference's, and
the weights' duals up to 2.2e-4; those differences are the parameters'
own, which the run's parameter bound already holds.
"""
import functools

import jax
import jax.numpy as jnp
import jax.tree_util as tu
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro import configs as jconfigs
from repro.core import consensus as jcons
from repro.models import model as jmodel
from repro.optim.adamw import AdamWState as JAdamWState
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.convert import (consensus_state_to_torch,
                                 train_state_to_numpy)
from repro_torch.core import consensus
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.train import steps

R = 4
LR = 3e-4
ETA = 0.1
B, S = 8, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FLIP = 2 * LR
NEAR = LR / 100
FAR_FRACTION = 1e-3
#: (case, arch, every, steps)
CASES = (("qwen2-every1", "qwen2-0.5b", 1, 3),
         ("qwen2-every2", "qwen2-0.5b", 2, 4),
         ("mamba2", "mamba2-130m", 1, 2))
FULL_ARCH = "qwen2-0.5b"
FULL_PARAMS = 494_032_768
SIZES = (1, 2, 3, 4, 5)
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once, and the port's
    steps at these sizes are many small torch ops: intra-op threads would
    only oversubscribe the cores (this file took 976 s under the whole
    suite with the default thread count, 75 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(arch):
    return jconfigs.get_reduced_config(arch).replace(compute_dtype="float32")


def _cfg(arch):
    return configs.get_reduced_config(arch).replace(compute_dtype="float32")


def _key(path) -> str:
    return tu.keystr(path)


# ---------------------------------------------------------------------------
# the reference's step, once per module
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per case the desynchronized start (``<case>/init``), the batch,
    every step's metrics (all shards) and the state after step i
    (``<case>/s<i>``), keyed ``<case>/<part>/<leaf path>``;
    ``specs/<leaf path>`` the shapes of the reference's
    ``consensus_state_specs`` at qwen2-0.5b's full size."""
    path = str(tmp_path_factory.mktemp("consensus") / "reference.npz")
    run_with_devices(f"""
        import numpy as np, jax, jax.numpy as jnp
        import jax.tree_util as tu
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.configs import get_config, get_reduced_config
        from repro.core.consensus import ConsensusConfig
        from repro.dist import compat
        from repro.launch import mesh as mesh_lib
        from repro.train import steps

        mesh = mesh_lib.make_debug_mesh(data={R}, model=1)
        out = {{}}

        def dump(prefix, tree):
            for p, x in tu.tree_flatten_with_path(tree)[0]:
                out[prefix + tu.keystr(p)] = np.asarray(x)

        def put(x):
            spec = P("data") if np.ndim(x) else P()
            return jax.device_put(x, NamedSharding(mesh, spec))

        def dump_state(prefix, st):
            dump(prefix + "/params", st.params)
            dump(prefix + "/mu", st.opt.mu)
            dump(prefix + "/nu", st.opt.nu)
            dump(prefix + "/dual", st.dual)
            out[prefix + "/opt_step"] = np.asarray(st.opt.step)
            out[prefix + "/step"] = np.asarray(st.step)

        for case, arch, every, n_steps in {CASES!r}:
            cfg = get_reduced_config(arch).replace(compute_dtype="float32")
            rng = np.random.default_rng(7)
            st = steps.make_consensus_train_state(cfg, jax.random.key(0),
                                                  mesh, lr={LR})
            st = st._replace(params=jax.tree.map(
                lambda x: x * (1.0 + 0.05 * rng.standard_normal(
                    x.shape)).astype(np.float32), st.params))
            st = jax.tree.map(put, st)
            toks = rng.integers(0, cfg.vocab_size,
                                ({B}, {S} + 1)).astype(np.int32)
            batch = {{"tokens": jnp.asarray(toks[:, :-1]),
                      "targets": jnp.asarray(toks[:, 1:])}}
            out[case + "/tokens"] = toks
            dump_state(case + "/init", st)
            step = steps.make_consensus_train_step(
                cfg, mesh, ConsensusConfig(eta={ETA}, every=every),
                lr={LR})
            with compat.set_mesh(mesh):
                for i in range(n_steps):
                    st, m = step(st, batch)
                    for k, v in m.items():
                        out[f"{{case}}/{{k}}/{{i}}"] = np.asarray(
                            [np.asarray(s.data) for s in
                             sorted(v.addressable_shards,
                                    key=lambda s: s.device.id)])
                        out[f"{{case}}/{{k}}_read/{{i}}"] = np.asarray(
                            float(v))
                    dump_state(f"{{case}}/s{{i}}", st)
        specs = steps.consensus_state_specs(get_config("{FULL_ARCH}"), mesh)
        for p, x in tu.tree_flatten_with_path(specs)[0]:
            out["specs" + tu.keystr(p)] = np.asarray(
                list(x.shape) + [np.dtype(x.dtype).itemsize])
        np.savez({path!r}, **out)
        print("DONE")
    """, n_devices=R)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@functools.lru_cache(maxsize=None)
def _param_spec(arch):
    """The reference's parameter tree (shapes only)."""
    return jax.eval_shape(lambda k: jmodel.init_params(_jcfg(arch), k),
                          jax.random.key(0))


def _ref_tree(ref, prefix, arch):
    return tu.tree_map_with_path(lambda p, _: ref[prefix + _key(p)],
                                 _param_spec(arch))


def _ref_state(ref, prefix, arch):
    """The reference's ``ConsensusTrainState`` of numpy leaves dumped under
    ``prefix``."""
    tree = functools.partial(_ref_tree, ref, arch=arch)
    return jsteps.ConsensusTrainState(
        params=tree(prefix + "/params"),
        opt=JAdamWState(step=ref[prefix + "/opt_step"],
                        mu=tree(prefix + "/mu"), nu=tree(prefix + "/nu")),
        dual=tree(prefix + "/dual"), step=ref[prefix + "/step"])


def _port_steps(ref, case, start, n):
    """``n`` port steps from the reference's state dumped under ``start``:
    each step's metrics and per-replica gaps, and the state after each as
    the reference's tree."""
    _, arch, every, _ = next(c for c in CASES if c[0] == case)
    cfg = _cfg(arch)
    st = consensus_state_to_torch(_ref_state(ref, start, arch), cfg,
                                  device="cpu")
    toks = torch.from_numpy(ref[case + "/tokens"])
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = steps.make_consensus_train_step(
        cfg, R, consensus.ConsensusConfig(eta=ETA, every=every), lr=LR)
    out = []
    for _ in range(n):
        st, m = step(st, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    consensus.consensus_gap(st.params).numpy(),
                    train_state_to_numpy(st)))
    return out


@pytest.fixture(scope="module")
def port(reference):
    """Per case, run once a module: the port's free run of every step from
    the reference's start (``"run"``), and each step alone from the
    reference's own state before it (``"each"``)."""
    runs = {}

    def run(case):
        if case not in runs:
            n = next(c[3] for c in CASES if c[0] == case)
            runs[case] = {
                "run": _port_steps(reference, case, case + "/init", n),
                "each": [_port_steps(reference, case, _before(case, i), 1)[0]
                         for i in range(n)]}
        return runs[case]
    return run


def _before(case, i):
    return case + ("/init" if i == 0 else f"/s{i - 1}")


def _leaf_errors(got_tree, ref, prefix):
    """Per leaf of the reference's tree: the largest difference over the
    leaf's largest magnitude."""
    out = {}
    for p, x in tu.tree_flatten_with_path(got_tree)[0]:
        want = ref[prefix + _key(p)]
        assert x.shape == want.shape, (_key(p), x.shape, want.shape)
        out[_key(p)] = float(np.abs(x - want).max()
                             / max(np.abs(want).max(), 1e-30))
    return out


def _close_params(got_tree, ref, prefix, steps_taken):
    """The parameters in lr units (the module doc)."""
    d = np.concatenate([
        np.abs(x - ref[prefix + _key(p)]).ravel()
        for p, x in tu.tree_flatten_with_path(got_tree)[0]])
    assert d.max() <= FLIP * steps_taken, d.max() / LR
    assert (d > NEAR).mean() <= FAR_FRACTION, (d > NEAR).mean()


def _close_metrics(case, i, m, gaps, ref):
    for k in ("loss", "grad_norm", "consensus_gap"):
        shards = ref[f"{case}/{k}/{i}"]
        assert float(ref[f"{case}/{k}_read/{i}"]) == shards[0]
        np.testing.assert_allclose(m[k], shards[0], rtol=LOSS_RTOL,
                                   err_msg=f"{k} at step {i}")
    np.testing.assert_allclose(gaps, ref[f"{case}/consensus_gap/{i}"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_each_step_matches_the_reference(port, reference, case):
    """Each step alone, from the reference's state before it: the loss
    (the replicas' mean), grad_norm and consensus_gap (the reference's
    shard 0, and the port's per-replica gaps every shard), the dual and
    both moments per leaf, the parameters in lr units, the steps."""
    for i, (m, gaps, got) in enumerate(port(case)["each"]):
        _close_metrics(case, i, m, gaps, reference)
        pre = f"{case}/s{i}"
        for part, tree in (("/dual", got.dual), ("/mu", got.opt.mu),
                           ("/nu", got.opt.nu)):
            errs = _leaf_errors(tree, reference, pre + part)
            worst = max(errs, key=errs.get)
            assert errs[worst] <= GRAD_TOL, (i, part, worst, errs[worst])
        _close_params(got.params, reference, pre + "/params", 1)
        np.testing.assert_array_equal(got.opt.step,
                                      reference[pre + "/opt_step"])
        assert int(got.step) == int(reference[pre + "/step"]) == i + 1


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_the_run_stays_on_the_reference(port, reference, case):
    """Every step of the port's own run from the same start: the metrics
    as above, and the final parameters within 2 lr a step."""
    run = port(case)["run"]
    for i, (m, gaps, _) in enumerate(run):
        _close_metrics(case, i, m, gaps, reference)
    n = len(run)
    _close_params(run[-1][2].params, reference, f"{case}/s{n - 1}/params",
                  n)
    assert int(run[-1][2].step) == n


def test_the_reference_reads_shard_zero(port, reference):
    """The reference's ``grad_norm`` and ``consensus_gap`` differ across
    its shards, and ``float()`` of each reads shard 0, not their max (its
    docstring says "max_v"): the port's step returns replica 0's."""
    case = CASES[0][0]
    m, gaps, _ = port(case)["run"][0]
    for k in ("grad_norm", "consensus_gap"):
        shards = reference[f"{case}/{k}/0"]
        assert len(set(shards.tolist())) > 1, (k, shards)
        assert float(reference[f"{case}/{k}_read/0"]) == shards[0] \
            != shards.max()
    assert m["consensus_gap"] == gaps[0] != gaps.max()


def test_state_converter_round_trip_is_bitwise(reference):
    """Reference tree -> port -> reference tree, and port -> reference
    -> port, every leaf (the stacked moments and steps too) bitwise."""
    case, arch = CASES[0][0], CASES[0][1]
    want = _ref_state(reference, case + "/init", arch)
    st = consensus_state_to_torch(want, _cfg(arch), device="cpu")
    back = train_state_to_numpy(st)
    pairs = [(back.params, want.params), (back.dual, want.dual),
             (back.opt.mu, want.opt.mu), (back.opt.nu, want.opt.nu)]
    for got, ref in pairs:
        for a, b in zip(tu.tree_leaves(got), tu.tree_leaves(ref),
                        strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(back.opt.step, want.opt.step)
    assert back.step.dtype == np.int32 and back.step == want.step
    again = consensus_state_to_torch(back, _cfg(arch), device="cpu")
    assert list(again.params) == list(st.params)
    for a, b in ((again.params, st.params), (again.dual, st.dual),
                 (again.opt.mu, st.opt.mu), (again.opt.nu, st.opt.nu)):
        assert all(torch.equal(a[n], b[n]) for n in b)
    assert st.step.device.type == "cpu" and st.step.dtype == torch.int32


def test_full_size_specs_follow_the_reference(reference):
    """``consensus_state_specs`` at qwen2-0.5b's full size on meta: every
    leaf of the params, dual and moments with the reference's shape (its
    stacked layers' leaves per layer) and width, R x the model's
    494,032,768 parameters, the steps (R,) and 0-d int32."""
    spec = steps.consensus_state_specs(configs.get_config(FULL_ARCH), R)
    assert all(p.device.type == "meta" for p in spec.params.values())
    assert sum(p.numel() for p in spec.params.values()) == R * FULL_PARAMS
    ref = {k[len("specs"):]: v.tolist() for k, v in reference.items()
           if k.startswith("specs")}
    assert ref[".opt.step"] == [R, 4] and ref[".step"] == [4]
    assert spec.opt.step.shape == (R,) and spec.opt.step.dtype == torch.int32
    assert spec.step.shape == () and spec.step.dtype == torch.int32
    got = {}
    for part, mapping in (("params", spec.params), ("dual", spec.dual),
                          ("opt.mu", spec.opt.mu), ("opt.nu", spec.opt.nu)):
        for n, p in mapping.items():
            path, row = transformer.reference_path(n)
            key = f".{part}" + "".join(f"[{k!r}]" for k in path)
            shape = list(p.shape) + [p.element_size()]
            if row is not None:
                got.setdefault(key, shape[:1] + [0] + shape[1:])[1] += 1
            else:
                got[key] = shape
    assert got == {k: v for k, v in ref.items() if "step" not in k}


# ---------------------------------------------------------------------------
# the core functions against the reference's, in process
# ---------------------------------------------------------------------------
def _stacked(R_, dtype, seed=0):
    """A stacked tree of two nested leaves (R, 3, 5) and (R, 7) as numpy
    (fp32 values exactly representable in ``dtype``)."""
    rng = np.random.default_rng(seed)
    tree = {"a": {"w": rng.standard_normal((R_, 3, 5))},
            "b": rng.standard_normal((R_, 7))}
    return jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, dtype).astype(jnp.float32)), tree)


def _flat(tree):
    """The port's mapping (dotted names) of a nested numpy tree."""
    return {"a.w": tree["a"]["w"], "b": tree["b"]}


def _port(tree, dtype):
    return {n: torch.from_numpy(np.array(x)).to(getattr(torch, dtype))
            for n, x in _flat(tree).items()}


def _jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _close(got, want_tree, dtype):
    """Every leaf within the module doc's bound of its largest magnitude."""
    tol = 1e-6 if (dtype == "float32") else 2.0 ** -8
    for n, w in _flat(jax.tree.map(
            lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
            want_tree)).items():
        g = got[n].float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), n


def _vmap(fn, *args):
    return jax.vmap(fn, axis_name="data")(*args)


JCFG = jcons.ConsensusConfig(eta=ETA)
PCFG = consensus.ConsensusConfig(eta=ETA)
ZERO = jnp.zeros((), jnp.int32)


def _inputs(R_, dtype):
    """Params and gradients in ``dtype``, an fp32 dual."""
    p, g = _stacked(R_, dtype, 0), _stacked(R_, dtype, 1)
    return p, g, jax.tree.map(lambda x: 0.01 * x, _stacked(R_, "float32", 2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R_", SIZES)
def test_ring_neighbor_sum_matches_the_reference(R_, dtype):
    """Two rolls of the replica axis against the reference's two
    ppermutes, the count 2 at every R (R = 1: the replica itself twice;
    R = 2: the other one twice)."""
    p, _, _ = _inputs(R_, dtype)
    want = _vmap(lambda x: jcons.ring_neighbor_sum(x, "data")[0],
                 _jax(p, dtype))
    got, n = consensus.ring_neighbor_sum(_port(p, dtype))
    assert n == 2
    _close(got, want, dtype)
    if R_ == 1:
        assert torch.equal(got["b"], 2 * _port(p, dtype)["b"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R_", SIZES)
def test_consensus_grads_match_the_reference(R_, dtype):
    p, g, b = _inputs(R_, dtype)
    jp, jg, jb = _jax(p, dtype), _jax(g, dtype), _jax(b, "float32")

    def ref(g_, p_, b_):
        s, n = jcons.ring_neighbor_sum(p_, "data")
        return jcons.consensus_grads(g_, p_, jcons.ConsensusState(b_, ZERO),
                                     s, n, JCFG)
    want = _vmap(ref, jg, jp, jb)
    pp = _port(p, dtype)
    s, n = consensus.ring_neighbor_sum(pp)
    got = consensus.consensus_grads(
        _port(g, dtype), pp,
        consensus.ConsensusState(_port(b, "float32"), torch.zeros(())),
        s, n, PCFG)
    assert all(t.dtype == getattr(torch, dtype) for t in got.values())
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R_", SIZES)
def test_dual_update_matches_the_reference(R_, dtype):
    p, _, b = _inputs(R_, dtype)

    def ref(p_, b_):
        s, n = jcons.ring_neighbor_sum(p_, "data")
        return jcons.dual_update(p_, jcons.ConsensusState(b_, ZERO), s, n,
                                 JCFG).dual
    want = _vmap(ref, _jax(p, dtype), _jax(b, "float32"))
    pp = _port(p, dtype)
    s, n = consensus.ring_neighbor_sum(pp)
    st = consensus.dual_update(
        pp, consensus.ConsensusState(_port(b, "float32"),
                                     torch.zeros((), dtype=torch.int32)),
        s, n, PCFG)
    assert all(t.dtype == torch.float32 for t in st.dual.values())
    assert int(st.step) == 1
    _close(st.dual, want, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R_", SIZES)
def test_consensus_round_matches_the_reference(R_, dtype):
    p, g, b = _inputs(R_, dtype)

    def ref(g_, p_, b_):
        out, st = jcons.consensus_round(
            g_, p_, jcons.ConsensusState(b_, ZERO), JCFG)
        return out, st.dual
    want_g, want_b = _vmap(ref, _jax(g, dtype), _jax(p, dtype),
                           _jax(b, "float32"))
    got_g, st = consensus.consensus_round(
        _port(g, dtype), _port(p, dtype),
        consensus.init_state(_port(p, dtype))._replace(
            dual=_port(b, "float32")), PCFG)
    _close(got_g, want_g, dtype)
    _close(st.dual, want_b, "float32")
    assert st.step.device.type == "cpu" and int(st.step) == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R_", SIZES)
def test_consensus_gap_is_each_shards(R_, dtype):
    """The port's (R,) gaps against each replica's value under the
    reference's pmean."""
    p, _, _ = _inputs(R_, dtype)
    want = _vmap(lambda x: jcons.consensus_gap(x, "data"), _jax(p, dtype))
    got = consensus.consensus_gap(_port(p, dtype))
    assert got.shape == (R_,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_state_matches_the_reference(dtype):
    p = _port(_stacked(3, dtype), dtype)
    st = consensus.init_state(p)
    ref = jcons.init_state(_jax(_stacked(3, dtype), dtype))
    assert [tuple(t.shape) for t in st.dual.values()] == \
        [x.shape for x in _flat(ref.dual).values()]
    assert all(t.dtype == torch.float32 and not t.any()
               for t in st.dual.values())
    assert st.step.dtype == torch.int32 and int(st.step) == int(ref.step)
    assert consensus.ConsensusConfig() == (0.05, 1, "data") == \
        tuple(jcons.ConsensusConfig())


# ---------------------------------------------------------------------------
# the step's own contracts
# ---------------------------------------------------------------------------
def _desynced(cfg, replicas, seed=3, lr=LR):
    st = steps.make_consensus_train_state(cfg, 0, replicas, lr=lr,
                                          device="cpu")
    rng = np.random.default_rng(seed)
    for p in st.params.values():
        p.mul_(torch.from_numpy((1 + 0.05 * rng.standard_normal(
            p.shape)).astype(np.float32)))
    return st


def _batch(cfg, rows, seed=4):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, S + 1)).astype(np.int32))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_every_replica_reads_the_pre_step_parameters():
    """The dual after one step is eq. (9) over the parameters *before* the
    step, on every replica: a replica loop that updates replica r in
    place before forming replica r + 1's neighbour sum breaks it (by
    about eta/2 x lr, far past the bound).  The learning rate is large so
    that any replica's early update shows."""
    cfg = _cfg("qwen2-0.5b")
    st = _desynced(cfg, 3, lr=0.05)
    before = {n: p.clone() for n, p in st.params.items()}
    dual0 = {n: b.clone() for n, b in st.dual.items()}
    step = steps.make_consensus_train_step(
        cfg, 3, consensus.ConsensusConfig(eta=ETA), lr=0.05)
    st, _ = step(st, _batch(cfg, 6))
    for n, p in before.items():
        assert not torch.equal(st.params[n], p) or not p.any(), n
        s = torch.roll(p, 1, 0) + torch.roll(p, -1, 0)
        want = dual0[n] + 0.5 * ETA * (2 * p - s)
        torch.testing.assert_close(st.dual[n], want, rtol=0, atol=1e-7,
                                   msg=n)


def test_every_k_gates_the_exchange():
    """``every=2``: steps 0 and 2 exchange and move the dual, step 1
    leaves it as it was; the step counts every call (the reference's
    tests/test_dist.py regime: every 4, 3 steps, ``step == 3``)."""
    cfg = _cfg("qwen2-0.5b")
    st = _desynced(cfg, R)
    step = steps.make_consensus_train_step(
        cfg, R, consensus.ConsensusConfig(eta=ETA, every=2), lr=LR)
    batch = _batch(cfg, B)
    duals = []
    for _ in range(3):
        st, _ = step(st, batch)
        duals.append({n: b.clone() for n, b in st.dual.items()})
    assert all(torch.equal(duals[0][n], duals[1][n]) for n in duals[0])
    assert not all(torch.equal(duals[1][n], duals[2][n]) for n in duals[0])
    assert int(st.step) == 3 and st.step.device.type == "cpu"
    st = _desynced(cfg, R)
    step4 = steps.make_consensus_train_step(
        cfg, R, consensus.ConsensusConfig(eta=ETA, every=4), lr=1e-3)
    for _ in range(3):
        st, _ = step4(st, batch)
    assert int(st.step) == 3 and st.opt.step.tolist() == [3] * R


def test_consensus_training_learns_and_agrees():
    """The reference's tests/test_dist.py regime on the port (reduced
    qwen2 at its bf16 compute, R = 4, eta 0.1, lr 3e-3, 10 steps): the
    loss and replica 0's gap both fall."""
    cfg = configs.get_reduced_config("qwen2-0.5b")
    st = _desynced(cfg, R, lr=3e-3)
    step = steps.make_consensus_train_step(
        cfg, R, consensus.ConsensusConfig(eta=0.1, every=1), lr=3e-3)
    batch = _batch(cfg, B)
    losses, gaps = [], []
    for _ in range(10):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        gaps.append(float(m["consensus_gap"]))
    assert losses[-1] < losses[0], losses
    assert gaps[-1] < gaps[0], gaps


def test_the_batch_must_split_over_the_replicas():
    cfg = _cfg("qwen2-0.5b")
    step = steps.make_consensus_train_step(cfg, R)
    with pytest.raises(ValueError, match="do not split"):
        step(_desynced(cfg, R), _batch(cfg, 6))


def test_batch_spec_has_no_meaning_on_one_card():
    with pytest.raises(ValueError, match="batch_spec"):
        steps.make_consensus_train_step(_cfg("qwen2-0.5b"), R,
                                        batch_spec=("data",))


def test_consensus_state_starts_as_identical_replicas():
    """``make_consensus_train_state``: R copies of ``init_params`` from
    the same seed (the reference's broadcast), zero duals and moments,
    every step count zero."""
    cfg = _cfg("qwen2-0.5b")
    st = steps.make_consensus_train_state(cfg, 5, 3, device="cpu")
    net = transformer.named_leaves(model_lib.init_params(cfg, 5,
                                                         device="cpu"))
    assert list(st.params) == list(net) == list(st.dual) == list(st.opt.mu)
    for n, p in net.items():
        assert st.params[n].shape == (3,) + tuple(p.shape)
        assert all(torch.equal(st.params[n][r], p) for r in range(3))
        assert not st.dual[n].any() and not st.opt.nu[n].any()
    assert st.opt.step.tolist() == [0, 0, 0] and int(st.step) == 0
