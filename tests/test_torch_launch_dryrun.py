"""The one-card dry run (``repro_torch.launch.dryrun``) on the CPU.

The dry run runs the port's real step once on fake tensors
(``FakeTensorMode``) under a byte tracker (``dryrun.LiveBytes``) and
``FlopCounterMode``.  Held here, on fake CPU tensors (this build cannot
index a fake ``cuda`` tensor; the card traces on fake ``cuda`` tensors,
chip_smoke.py phase 24):

- every reduced arch's train, prefill, decode and ADMM (R = 2) step at
  a small shape gives an ``ok`` record;
- for a dense, an SSM and an MoE arch, the fake trace equals the same
  step run on real CPU tensors: its FLOPs equal ``FlopCounterMode``'s
  count over the real run, its peak the tracker's over the real run, its
  arguments the real state's and inputs' bytes (counted here on their
  own, storage by storage, as the caching allocator rounds); its bytes
  accessed agree to 1e-3 (the MoE router's one-hot and sort take other
  ops on real tensors than on fake ones);
- the tracker itself on a known sequence of allocations, views and
  in-place ops;
- full-size qwen2-0.5b at decode_32k: FLOPs within 2% of
  ``costs.step_costs`` and 53.5 GB of arguments, with nothing allocated;
- ``fits`` against one budget (``dryrun.budget``): the H100's memory
  less the CUDA context and cuBLAS's workspace, at its edge and for two
  full-size decodes beside it;
- the CLI: a record per combination, the reference's skip reasons, the
  reference's mesh names refused, an error record's non-zero exit, the
  device rule, and ``python -m`` without jax.
"""
import json
import os
import resource
import subprocess
import sys

import pytest
import torch

from repro import configs as jconfigs
from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 get_reduced_config)
from repro_torch.configs.base import InputShape
from repro_torch.launch import costs, dryrun, mesh
from repro_torch.models import model as model_lib
from repro_torch.train import steps

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
#: the small shapes: (step kind, mode, replicas)
KINDS = {"train": ("train", "allreduce", 1), "admm": ("train", "admm", 2),
         "prefill": ("prefill", "allreduce", 1),
         "decode": ("decode", "allreduce", 1)}
SMALL = dict(seq=32, batch=2)
#: a dense, an SSM and an MoE arch
HELD = ("qwen2-0.5b", "mamba2-130m", "phi3.5-moe-42b-a6.6b")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reduced(monkeypatch):
    """``run_one`` on the smoke-scale configs."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced_config)


def _shape(kind: str) -> InputShape:
    step_kind = KINDS[kind][0]
    return InputShape(f"small_{kind}", SMALL["seq"], SMALL["batch"],
                      step_kind)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_reduced_step_traces(arch, kind, reduced):
    _, mode, R = KINDS[kind]
    rec = dryrun.run_one(arch, _shape(kind), mesh.make_debug_mesh(R, 1),
                         mode, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory"]
    assert rec["mesh"] == (f"{R}x1" if mode == "admm" else "1x1")
    assert rec["chips"] == 1 and rec["device"] == "cpu"
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == \
        mem["peak_bytes"] - mem["argument_size_in_bytes"]
    assert mem["fits"] and mem["device_bytes"] == mesh.HBM_BYTES
    assert mem["usable_bytes"] == dryrun.budget(torch.device("cpu"))[1]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    cfg = get_reduced_config(arch)
    assert rec["params"] == cfg.param_count()
    ac = costs.step_costs(cfg, _shape(kind))
    assert rec["analytic"]["flops"] == ac.flops
    if kind == "admm":
        # R replicas of the parameters, AdamW's moments and the dual
        assert mem["argument_size_in_bytes"] >= 4 * R * 4 * cfg.param_count()


def _real(cfg, shape, mode, R):
    """The step ``dryrun.build`` traces, on real CPU tensors from the
    port's own constructors."""
    gen = torch.Generator().manual_seed(0)
    long_mode = model_lib.use_long_mode(cfg, shape)
    inputs = model_lib.make_inputs(cfg, shape, gen, device="cpu")
    if shape.step_kind == "train":
        if mode == "admm":
            state = steps.make_consensus_train_state(cfg, gen, R, shape,
                                                     device="cpu")
            return (steps.make_consensus_train_step(cfg, R,
                                                    long_mode=long_mode),
                    (state, inputs))
        state = steps.make_train_state(cfg, gen, shape, device="cpu")
        return steps.make_train_step(cfg, long_mode=long_mode), \
            (state, inputs)
    params = model_lib.init_params(cfg, gen, shape, device="cpu")
    if shape.step_kind == "prefill":
        return steps.make_prefill_step(cfg, long_mode), (params, inputs)
    return (steps.make_decode_step(cfg, long_mode),
            (params, inputs["tokens"], inputs["cache"],
             inputs["cache_index"]))


def _storage_bytes(args) -> int:
    """The arguments' bytes counted apart from the tracker: each distinct
    storage once (by its address), rounded up to 512 B."""
    seen = {}

    def add(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for p in x.parameters():
                add(p)
        elif isinstance(x, torch.Tensor):
            add(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(args)
    return sum(seen.values())


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", HELD)
def test_fake_trace_equals_the_real_run(arch, kind):
    _, mode, R = KINDS[kind]
    cfg = get_reduced_config(arch)
    shape = _shape(kind)
    fake = dryrun.trace(cfg, shape, mode, R, "cpu")
    step, args = _real(cfg, shape, mode, R)
    held = _storage_bytes(args)
    real = dryrun.measure(step, args, "cpu")
    assert fake["argument_size_in_bytes"] == held
    assert real["argument_size_in_bytes"] == held
    assert fake["flops"] == real["flops"] > 0
    assert fake["peak_bytes"] == real["peak_bytes"] > held
    assert fake["output_size_in_bytes"] == real["output_size_in_bytes"]
    assert fake["bytes_accessed"] == pytest.approx(real["bytes_accessed"],
                                                   rel=1e-3)


def test_live_bytes_counts_storages_as_the_allocator_does():
    """A storage counts once, rounded up to 512 B, from its op until its
    last tensor dies; views and in-place results add nothing; the bytes
    accessed skip views and count a broadcast dimension once."""
    lb = dryrun.LiveBytes("cpu")
    a = torch.ones(1000)                       # 4000 B -> 4096
    assert lb.track({"a": [a]}) == 4096
    with lb:
        b = a * 2                              # + 4096
        v = b[10:].view(10, 99)                # a view: + 0
        v.add_(1)                              # in place: + 0
        c = torch.zeros(100, dtype=torch.bfloat16)   # 200 B -> 512
        assert (lb.live, lb.peak) == (8704, 8704)
        del b
        assert lb.live == 8704                 # v holds b's storage
        del v, c
        assert lb.live == 4096
        e = a.expand(3, 1000).sum(0)           # reads a's 4000 B once
    assert lb.peak == 8704 and lb.live == 8192
    # mul: 4000 + 4000; add_: 3960 + 3960; zeros 200; sum: 4000 + 4000
    assert lb.accessed == 8000 + 7920 + 200 + 8000
    assert e.shape == (1000,)
    assert dryrun.alloc_bytes(0) == 0 and dryrun.alloc_bytes(513) == 1024


def test_full_size_decode_allocates_nothing():
    """qwen2-0.5b at decode_32k, full size: its FLOPs within 2% of the
    analytic model, its arguments the fp32 parameters and the 51.5 GB
    bf16 cache, and the process's peak resident set grows by less than
    1 GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.run_one("qwen2-0.5b", "decode_32k", device="cpu")
    grew = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) \
        * 1024
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config("qwen2-0.5b")
    ac = costs.step_costs(cfg, SHAPES["decode_32k"])
    assert rec["flops"] == pytest.approx(ac.flops, rel=0.02)
    mem = rec["memory"]
    cache = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    assert mem["argument_size_in_bytes"] >= 4 * cfg.param_count() + cache
    assert mem["argument_size_in_bytes"] > 51.5e9 and mem["fits"]
    assert grew < 1e9


def test_the_budget_is_the_card_less_what_the_allocator_cannot_use():
    total, usable = dryrun.budget(torch.device("cpu"))
    assert total == mesh.HBM_BYTES == 85_017_493_504
    assert usable == total - mesh.CONTEXT_BYTES - mesh.CUBLAS_WORKSPACE_BYTES


@pytest.mark.parametrize("over", [-1, 0, 1])
def test_fits_at_the_edge_of_the_budget(over, monkeypatch):
    """A peak of the usable bytes fits; one byte more does not, though
    it lies under the card's memory."""
    usable = dryrun.budget(torch.device("cpu"))[1]
    monkeypatch.setattr(dryrun, "trace", lambda *a, **k: {
        "seconds": 0.0, "argument_size_in_bytes": 1,
        "output_size_in_bytes": 1, "peak_bytes": usable + over,
        "flops": 1, "bytes_accessed": 1})
    mem = dryrun.run_one("qwen2-0.5b", "decode_32k", device="cpu")["memory"]
    assert mem["peak_bytes"] < mem["device_bytes"]
    assert mem["fits"] is (over <= 0)


@pytest.mark.parametrize("batch,fits", [(198, True), (200, False)])
def test_a_full_size_decode_beside_the_budget(batch, fits):
    """qwen2-0.5b decoding ``batch`` x 32768 at full size: 198 rows fit;
    200 rows peak at 84.7 GB, under the card's 85.0 but over what the
    CUDA context and cuBLAS's workspace leave, and do not."""
    rec = dryrun.run_one("qwen2-0.5b", InputShape("near", 32768, batch,
                                                  "decode"), device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory"]
    assert mem["fits"] is fits
    assert mem["peak_bytes"] < mem["device_bytes"]
    assert abs(mem["peak_bytes"] - mem["usable_bytes"]) < 1e9


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_writes_a_record_per_combination(tmp_path, capsys):
    out = tmp_path / "dr.jsonl"
    dryrun.main(["--arch", "mamba2-130m,qwen2-0.5b", "--shape",
                 "decode_32k,long_500k", "--mesh", "1x1,2x2", "--mode",
                 "admm", "--device", "cpu", "--out", str(out)])
    recs = _records(out)
    assert [(r["arch"], r["shape"]) for r in recs] == [
        (a, s) for a in ("mamba2-130m", "qwen2-0.5b")
        for s in ("decode_32k", "long_500k") for _ in range(2)]
    # a serving step computes no replicas
    assert {r["mesh"] for r in recs} == {"1x1"}
    assert [r["status"] for r in recs] == ["ok"] * 6 + ["skipped"] * 2
    printed = capsys.readouterr().out
    assert "mesh 2x2: the model axis (2) is unused" in printed
    assert printed.count("[ok     ]") == 6


def test_an_admm_train_record_has_the_replica_mesh(reduced):
    """``--mesh 4x2`` under admm: a train step computes 4 replicas, the
    model axis unused."""
    rec = dryrun.run_one("qwen2-0.5b", InputShape("small", 32, 4, "train"),
                         mesh.make_debug_mesh(4, 2), "admm", device="cpu")
    assert (rec["status"], rec["mesh"], rec["mode"]) == ("ok", "4x1",
                                                         "admm")
    assert rec["tokens"] == 4 * 32 and rec["step_kind"] == "train"
    two = dryrun.run_one("qwen2-0.5b", InputShape("small", 32, 4, "train"),
                         mesh.make_debug_mesh(2, 1), "admm", device="cpu")
    assert rec["memory"]["argument_size_in_bytes"] > \
        two["memory"]["argument_size_in_bytes"]


def test_skip_reasons_are_the_reference_s():
    for arch in ARCHS:
        for name in SHAPES:
            ok, why = jconfigs.shape_applicable(jconfigs.get_config(arch),
                                                jconfigs.SHAPES[name])
            if ok:
                continue
            rec = dryrun.run_one(arch, name, device="cpu")
            assert (rec["status"], rec["reason"]) == ("skipped", why)


@pytest.mark.parametrize("name", ["single", "multi"])
def test_the_reference_meshes_exit(name, tmp_path):
    with pytest.raises(SystemExit, match=name):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--mesh", name, "--device", "cpu",
                     "--out", str(tmp_path / "dr.jsonl")])


def test_an_error_record_exits_non_zero(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise ValueError("a broken step")

    monkeypatch.setattr(dryrun, "trace", broken)
    out = tmp_path / "dr.jsonl"
    with pytest.raises(SystemExit, match="1 combinations failed"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--mesh", "1x1", "--device", "cpu",
                     "--out", str(out)])
    (rec,) = _records(out)
    assert rec["status"] == "error"
    assert rec["error"] == "ValueError: a broken step"
    assert "a broken step" in rec["traceback"]


def test_the_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "dr.jsonl"
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_one("qwen2-0.5b", "decode_32k")


def test_module_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun`` in a fresh interpreter,
    which must import neither jax nor the reference."""
    out = tmp_path / "dr.jsonl"
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'gemma2-2b', '--shape', "
            "'decode_32k,long_500k', '--mesh', '1x1', "
            f"'--device', 'cpu', '--out', {str(out)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [r["status"] for r in _records(out)] == ["ok", "ok"]
