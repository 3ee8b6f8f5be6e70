"""The training CLI (``repro_torch.launch.train``) against the reference's
(``repro.launch.train``) on the CPU, through checkpoints.

The port draws its parameters from a seeded ``torch.Generator``, not the
reference's, so the packages meet in a checkpoint: one package writes
step 2, then each package resumes its own copy of that directory to step
4, and the two step-4 files are compared.  Both directions run, for the
allreduce trainer (reduced qwen2-0.5b) and the ADMM-consensus trainer
(reduced mamba2-130m, the end-to-end example's arch, ``--mesh 2x1``;
the reference in one 2-device subprocess).  Every case runs with fp32
compute: the test replaces the module attribute ``get_reduced_config``
of both CLIs with an fp32 copy of the config.

Bounds, as ``test_torch_train.py``'s doc sets them: the two step-4
files have the same tree (keys, tuple and list arities, leaf order,
shapes, dtypes) and the same step counters; the losses the CLIs read
(each step's metrics, caught at the step function) within rtol 1e-5 and
the printed lines equal to them at the printed precision; the
parameters in units of lr, within 2 lr a step and at most 1e-3 of them
past lr / 100; the gradient-derived leaves (mu, nu, the dual) within
1e-4 of each leaf's largest magnitude.

The two reference behaviours the port keeps (ROADMAP queue 3) are shown
in both packages: a resumed run's data key restarts at ``key(seed +
1)``, so it re-reads the stream's first batches; a run whose ``steps`` is
a multiple of ``ckpt_every`` saves its last step twice.
"""
import contextlib
import io
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro import configs as jconfigs
from repro.checkpoint import msgpack_ckpt as jckpt
from repro.data import synthetic as jsynthetic
from repro.launch import train as jtrain
from repro_torch import configs
from repro_torch.checkpoint import latest_step, load, msgpack_ckpt
from repro_torch.data import synthetic
from repro_torch.launch import train as ptrain
from repro_torch.net import prng

LR = 3e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FLIP = 2 * LR
NEAR = LR / 100
FAR_FRACTION = 1e-3
#: steps written by the first package, then resumed to by each
WRITE, RESUME = 2, 4
COMMON = ["--reduced", "--batch", "4", "--seq", "32", "--lr", str(LR),
          "--log-every", "1", "--seed", "3"]
ALLREDUCE = ["--arch", "qwen2-0.5b", *COMMON]
ADMM = ["--arch", "mamba2-130m", "--trainer", "admm", "--mesh", "2x1",
        *COMMON]


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """fp32 compute in both CLIs, and one torch thread: the suite runs
    in several worker processes at once, and these steps are many small
    ops."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "get_reduced_config", lambda a: jconfigs.
               get_reduced_config(a).replace(compute_dtype="float32"))
    mp.setattr(ptrain, "get_reduced_config", lambda a: configs.
               get_reduced_config(a).replace(compute_dtype="float32"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


class _Steps:
    """A module proxy whose step factories record each step's metrics."""

    def __init__(self, module, log):
        self._module, self._log = module, log

    def __getattr__(self, name):
        return getattr(self._module, name)

    def _wrap(self, fn):
        def step(state, batch):
            state, m = fn(state, batch)
            self._log.append({k: float(v) for k, v in m.items()})
            return state, m
        return step

    def make_train_step(self, *a, **k):
        return self._wrap(self._module.make_train_step(*a, **k))

    def make_consensus_train_step(self, *a, **k):
        return self._wrap(self._module.make_consensus_train_step(*a, **k))

    def jit(self, fn, **kw):             # the reference's jax.jit of a step
        return self._wrap(jax.jit(fn, **kw))


def _run(package: str, argv):
    """One CLI run in process: its stdout, every step's metrics, the
    steps it saved and the batches it drew (numpy tokens)."""
    mod = ptrain if package == "port" else jtrain
    rec = {"metrics": [], "saves": [], "tokens": []}
    real_save, real_batch = mod.save_step, mod.token_batch

    def save(d, step, tree):
        rec["saves"].append(step)
        return real_save(d, step, tree)

    def batch(*a, **k):
        b = real_batch(*a, **k)
        rec["tokens"].append(np.asarray(
            b["tokens"].numpy() if package == "port" else b["tokens"]))
        return b

    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "save_step", save)
    mp.setattr(mod, "token_batch", batch)
    if package == "port":
        mp.setattr(mod, "steps_lib", _Steps(mod.steps_lib, rec["metrics"]))
        argv = [*argv, "--device", "cpu"]
    else:
        mp.setattr(mod, "jax", _Steps(jax, rec["metrics"]))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main(argv)
    finally:
        mp.undo()
    rec["stdout"] = out.getvalue()
    return rec


@pytest.fixture(scope="module")
def allreduce(tmp_path_factory):
    """Reduced qwen2 under allreduce: per run its record and directory,
    keyed ``ref``/``port`` (the step-WRITE runs, a save every step) and
    ``<writer>-<resumer>`` (the resumes)."""
    root = str(tmp_path_factory.mktemp("allreduce"))
    runs = {}
    for who in ("ref", "port"):
        d = os.path.join(root, who)
        runs[who] = _run(who, [*ALLREDUCE, "--steps", str(WRITE),
                               "--ckpt-dir", d, "--ckpt-every", "1"])
    for src in ("ref", "port"):
        for who in ("ref", "port"):
            d = os.path.join(root, f"{src}-{who}")
            shutil.copytree(os.path.join(root, src), d)
            runs[f"{src}-{who}"] = _run(who, [
                *ALLREDUCE, "--steps", str(RESUME), "--ckpt-dir", d,
                "--ckpt-every", "100"])
    return root, runs


_REF_ADMM = """
import contextlib, io, json, os, shutil
from repro import configs
from repro.launch import train
from repro.train import steps

train.get_reduced_config = lambda a: configs.get_reduced_config(a).replace(
    compute_dtype="float32")
log = []
make = steps.make_consensus_train_step


def wrapped(*a, **k):
    fn = make(*a, **k)

    def step(state, batch):
        state, m = fn(state, batch)
        log.append({{k: float(v) for k, v in m.items()}})
        return state, m
    return step


steps.make_consensus_train_step = wrapped
root, argv = {root!r}, {argv!r}
out = {{}}


def run(name, args):
    log.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv + args)
    out[name] = {{"metrics": list(log), "stdout": buf.getvalue()}}


run("ref", ["--steps", "{write}", "--ckpt-dir", os.path.join(root, "ref"),
            "--ckpt-every", "1"])
for src in ("ref", "port"):
    d = os.path.join(root, src + "-ref")
    shutil.copytree(os.path.join(root, src), d)
    run(src + "-ref", ["--steps", "{resume}", "--ckpt-dir", d,
                       "--ckpt-every", "100"])
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def admm(tmp_path_factory):
    """Reduced mamba2 under the consensus trainer, ``--mesh 2x1``: the
    port writes step WRITE, then one 2-device subprocess runs the
    reference's write and its two resumes, then the port resumes both."""
    root = str(tmp_path_factory.mktemp("admm"))
    runs = {"port": _run("port", [*ADMM, "--steps", str(WRITE), "--ckpt-dir",
                                  os.path.join(root, "port"),
                                  "--ckpt-every", "1"])}
    out = run_with_devices(_REF_ADMM.format(root=root, argv=ADMM,
                                            write=WRITE, resume=RESUME),
                           n_devices=2)
    runs.update(json.loads(out.split("RESULT", 1)[1]))
    for src in ("ref", "port"):
        d = os.path.join(root, f"{src}-port")
        shutil.copytree(os.path.join(root, src), d)
        runs[f"{src}-port"] = _run("port", [
            *ADMM, "--steps", str(RESUME), "--ckpt-dir", d,
            "--ckpt-every", "100"])
    return root, runs


# ---------------------------------------------------------------------------
# comparing two checkpoint trees
# ---------------------------------------------------------------------------
def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", [(k, _structure(v)) for k, v in tree.items()])
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, [_structure(v) for v in tree])
    return (str(tree.dtype), tuple(tree.shape))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _kind(path, consensus: bool) -> str:
    if consensus:
        top = {0: "params", 2: "dual", 3: "step"}.get(path[0])
    else:
        top = "params" if path[0] == "params" else None
    return top or {0: "step", 1: "mu", 2: "nu"}[path[1]]


def _hold_files(a_path, b_path, consensus: bool, steps_taken: int):
    a, b = load(a_path), load(b_path)
    assert _structure(a) == _structure(b)
    diffs = []
    for (pa, xa), (pb, xb) in zip(_flat(a), _flat(b), strict=True):
        assert pa == pb
        kind = _kind(pa, consensus)
        if kind == "step":
            np.testing.assert_array_equal(xa, xb)
        elif kind == "params":
            diffs.append(np.abs(xa.astype(np.float64) - xb).reshape(-1))
        else:
            scale = max(float(np.abs(xb).max()), 1e-30)
            err = float(np.abs(xa.astype(np.float64) - xb).max()) / scale
            assert err <= GRAD_TOL, (kind, pa, err)
    d = np.concatenate(diffs)
    assert d.max() <= FLIP * steps_taken, d.max() / LR
    assert (d > NEAR).mean() <= FAR_FRACTION, (d > NEAR).mean()


_LINE = re.compile(r"^step +(\d+) (.*) tok/s=\d+$")


def _printed(stdout: str):
    """Each printed step's number and metrics, as the line gives them."""
    out = []
    for line in stdout.splitlines():
        m = _LINE.match(line)
        if m:
            out.append((int(m.group(1)), [kv.split("=") for kv in
                                          m.group(2).split(" ")]))
    return out


def _hold_run(got, want, start: int, steps: int):
    """Metrics within LOSS_RTOL, and each printed line the reference's
    format: sorted keys at 4 decimals, equal to the caught metrics."""
    assert len(got["metrics"]) == len(want["metrics"]) == steps - start
    for g, w in zip(got["metrics"], want["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (k, g, w)
    for rec in (got, want):
        lines = _printed(rec["stdout"])
        assert [n for n, _ in lines] == list(range(start + 1, steps + 1))
        for (_, kvs), m in zip(lines, rec["metrics"]):
            assert [k for k, _ in kvs] == sorted(m)
            assert all(v == f"{m[k]:.4f}" for k, v in kvs)
        assert rec["stdout"].rstrip().endswith("done")
    if start:
        for rec in (got, want):
            assert f"resumed from step {start}\n" in rec["stdout"]


def _step_file(root, name, step):
    return os.path.join(root, name, f"ckpt_{step:08d}.msgpack")


# ---------------------------------------------------------------------------
# the twin of tests/test_launch.py's CLI test
# ---------------------------------------------------------------------------
def test_train_cli_runs_and_checkpoints(tmp_path):
    d = str(tmp_path)
    ptrain.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "4",
                 "--batch", "2", "--seq", "32", "--ckpt-dir", d,
                 "--ckpt-every", "2", "--log-every", "2", "--device", "cpu"])
    assert latest_step(d) == 4
    # resume continues from the checkpoint instead of restarting
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = ptrain.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                             "6", "--batch", "2", "--seq", "32",
                             "--ckpt-dir", d, "--ckpt-every", "2",
                             "--log-every", "2", "--device", "cpu"])
    assert latest_step(d) == 6
    assert "resumed from step 4" in out.getvalue()
    assert int(state["opt"].step) == 6


# ---------------------------------------------------------------------------
# across the packages, through checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ("ref", "port"))
def test_allreduce_resume_across_packages(allreduce, writer):
    root, runs = allreduce
    _hold_run(runs[f"{writer}-port"], runs[f"{writer}-ref"], WRITE, RESUME)
    _hold_files(_step_file(root, f"{writer}-port", RESUME),
                _step_file(root, f"{writer}-ref", RESUME), False,
                RESUME - WRITE)
    for who in ("ref", "port"):
        assert latest_step(os.path.join(root, f"{writer}-{who}")) == RESUME


@pytest.mark.parametrize("writer", ("ref", "port"))
def test_admm_resume_across_packages(admm, writer):
    root, runs = admm
    _hold_run(runs[f"{writer}-port"], runs[f"{writer}-ref"], WRITE, RESUME)
    _hold_files(_step_file(root, f"{writer}-port", RESUME),
                _step_file(root, f"{writer}-ref", RESUME), True,
                RESUME - WRITE)


@pytest.mark.parametrize("case", ("allreduce", "admm"))
def test_written_files_share_the_reference_tree(allreduce, admm, case):
    """The step-WRITE files of both packages: the same tree; the
    parameters differ (each package draws its own)."""
    root = (allreduce if case == "allreduce" else admm)[0]
    a, b = (load(_step_file(root, who, WRITE)) for who in ("port", "ref"))
    assert _structure(a) == _structure(b)
    params = a["params"] if case == "allreduce" else a[0]
    assert {"embed", "final_norm", "layers"} <= set(params)


def test_a_resumed_run_rereads_the_first_batches(allreduce):
    """Kept behaviour: the data key restarts at key(seed + 1) on resume,
    in both packages, so steps 3-4 train on steps 1-2's batches."""
    _, runs = allreduce
    for writer in ("ref", "port"):
        for who in ("ref", "port"):
            resumed = runs[f"{writer}-{who}"]["tokens"]
            first = runs[who]["tokens"]
            assert len(resumed) == len(first) == WRITE
            for r, f in zip(resumed, first):
                np.testing.assert_array_equal(r, f)
    for r, f in zip(runs["ref"]["tokens"], runs["port"]["tokens"]):
        np.testing.assert_array_equal(r, f)


def test_the_last_step_is_saved_twice(allreduce):
    """Kept behaviour: ``steps`` a multiple of ``ckpt_every`` saves the
    last step in the loop and again after it, in both packages."""
    _, runs = allreduce
    for who in ("ref", "port"):
        assert runs[who]["saves"] == [1, 2, 2]
        assert runs[f"{who}-{who}"]["saves"] == [RESUME]


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------
def test_admm_needs_a_mesh():
    with pytest.raises(SystemExit):
        ptrain.main(["--arch", "mamba2-130m", "--reduced", "--trainer",
                     "admm", "--steps", "1", "--device", "cpu"])


def test_the_model_axis_is_unused(admm, tmp_path):
    """``--mesh 2x2`` writes the bytes ``2x1`` writes, and says M is
    unused."""
    root, _ = admm
    argv = [a if a != "2x1" else "2x2" for a in ADMM]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ptrain.main([*argv, "--steps", str(WRITE), "--ckpt-dir",
                     str(tmp_path), "--ckpt-every", "1", "--device", "cpu"])
    assert "the model axis (2) is unused" in out.getvalue()
    for step in range(1, WRITE + 1):
        with open(_step_file(root, "port", step), "rb") as f:
            want = f.read()
        with open(os.path.join(str(tmp_path), f"ckpt_{step:08d}.msgpack"),
                  "rb") as f:
            assert f.read() == want


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        ptrain.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])


def test_token_batch_at_the_full_vocab():
    """The CLI's first batch at qwen2's full vocab (151936, past 2^16):
    the reference's tokens exactly."""
    vocab = configs.get_config("qwen2-0.5b").vocab_size
    assert vocab == 151936
    _, sub = prng.split(prng.key(1))
    _, jsub = jax.random.split(jax.random.key(1))
    got = synthetic.token_batch(sub, vocab, 8, 256, device="cpu")
    want = jsynthetic.token_batch(jsub, vocab, 8, 256)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("case", ("allreduce", "admm"))
def test_the_file_is_the_reference_codecs_bytes(allreduce, admm, case):
    """The port's writer streams each leaf from its own buffer; the file
    it wrote is ``encode_tree``'s bytes of the same tree, and the
    reference's ``encode_tree`` gives the same bytes (numpy leaves, the
    tuples as the checkpoint decodes them)."""
    root = (allreduce if case == "allreduce" else admm)[0]
    path = _step_file(root, "port-port", RESUME)
    with open(path, "rb") as f:
        raw = f.read()
    tree = load(path)
    assert msgpack_ckpt.encode_tree(tree) == raw
    assert jckpt.encode_tree(tree) == raw
