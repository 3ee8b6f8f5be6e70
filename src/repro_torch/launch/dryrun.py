"""One-card dry run (twin of ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) combination this runs the
real step once on fake tensors (``FakeTensorMode``: shapes, dtypes and
devices, no storage, no kernel) and records whether the step fits the
card, without allocating:

- memory: the state's and inputs' bytes, the result's, and the peak of
  the live bytes over the step (:class:`LiveBytes`), against what the
  card leaves a step's tensors (:func:`budget`);
- FLOPs: the matrix products the step runs (``FlopCounterMode``);
- bytes accessed: every op's tensor inputs and outputs.

The reference answers the question for a 256- or 512-chip TPU mesh by
compiling against placeholder devices and reading XLA's
``memory_analysis()`` and ``cost_analysis()``; eager PyTorch has no
compiler to ask, so the port runs the step itself on fake tensors:

- ``peak_bytes`` counts each new storage's bytes, rounded up to 512 B as
  the caching allocator rounds, from the op that makes it to the moment
  its last tensor dies; views and in-place results add nothing.  It
  sees the tensors a step makes, not a library's own workspaces nor the
  allocator's unsplit blocks (0.3-0.9% more on the card, chip_smoke.py
  phase 24).
- ``fits`` compares that peak with one budget on either device: the
  card's memory less what the process holds outside the allocator (the
  CUDA context) and cuBLAS's workspace (:func:`budget`).
- ``flops`` counts every product the step runs: Python loops (layers,
  attention blocks, SSD chunks, microbatches, replicas) unroll, so
  unlike XLA's count it is not undercounted by a scan.
- ``bytes_accessed`` is eager PyTorch's traffic (each op reads its
  inputs and writes its outputs; view ops move nothing): unfused, so
  above a compiler's.
- The reference's ``collective_bytes`` and ``_shape_bytes`` have no
  twin: they parse XLA's HLO, which the port never has, and one card
  runs no collective.

``--mesh DxM``: D is the consensus replica count under ``--mode admm``
(the reference's ``data`` axis, a leading replica axis on the card); M
has no meaning on one card and is printed as unused; a record's mesh is
the layout the step computes (``Dx1`` for an admm train step, else
``1x1``).  ``--device`` defaults to the card (``cuda``) and raises
without one; ``--device cpu`` traces on fake CPU tensors against the
H100's budget from ``mesh``'s constants.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch qwen2-0.5b] [--shape decode_32k] [--mesh 4x1]
        [--mode allreduce|admm] [--out results/dryrun.jsonl]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Union

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import device as device_lib
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import costs as costs_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.train import steps as steps_lib

#: the caching allocator's block: every allocation is a multiple of it
ALLOC_BLOCK = 512


def alloc_bytes(nbytes: int) -> int:
    """The bytes the caching allocator counts for a storage of
    ``nbytes``."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast dimension
    (stride 0) is read once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


def _tensors(tree):
    """The tensors of ``tree``, a module's parameters and buffers among
    them."""
    out = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, nn.Module):
            out += [*leaf.parameters(), *leaf.buffers()]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


class LiveBytes(TorchDispatchMode):
    """The live storages' bytes on one device type while the mode is on:
    ``live`` now, ``peak`` the most so far, ``accessed`` the bytes of
    every non-view op's tensor inputs and outputs.  A storage counts from
    the op that makes it (or from :meth:`track`) until its last tensor
    dies (a weakref finalizer on the storage), rounded by
    :func:`alloc_bytes`."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.live = self.peak = self.accessed = 0
        self._held = set()

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors not counted yet (the
        step's arguments, made before the mode); the live bytes after."""
        for t in _tensors(tree):
            self._hold(t)
        return self.live

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = alloc_bytes(st.nbytes())
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            self.accessed += sum(
                distinct_bytes(t) for t in _tensors((args, kwargs, out))
                if t.device.type == self.device_type)
        for t in _tensors(out):
            self._hold(t)
        return out


def measure(step, args: tuple, device) -> Dict[str, Any]:
    """``step(*args)`` once under :class:`LiveBytes` and
    ``FlopCounterMode``, real or fake tensors alike: the arguments', the
    result's and the peak bytes, the FLOPs, the bytes accessed and the
    seconds."""
    live = LiveBytes(device)
    argument = live.track(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with live, flops:
        out = step(*args)
    seconds = time.perf_counter() - t0
    result = LiveBytes(device).track(out)
    return {"argument_size_in_bytes": argument,
            "output_size_in_bytes": result,
            "peak_bytes": live.peak,
            "flops": flops.get_total_flops(),
            "bytes_accessed": live.accessed,
            "seconds": seconds}


def _fake_model(spec: transformer.Transformer, dev) -> transformer.Transformer:
    """``spec``'s model (on meta) made again on ``dev``: under
    ``FakeTensorMode`` its parameters are fake."""
    rows = spec["pos_dec"].shape[0] if "pos_dec" in spec else 0
    return transformer.Transformer(spec.cfg, dev, max_seq=rows)


def build(cfg: ModelConfig, shape: InputShape, mode: str, replicas: int,
          dev) -> tuple:
    """The step and its arguments for one combination, every meta spec
    made on ``dev`` (fake under ``FakeTensorMode``): the state from
    ``train_state_specs``, ``consensus_state_specs`` or
    ``model.param_specs``, the inputs from ``model.input_specs``.  The
    consensus state's ``step`` stays a real 0-d CPU tensor, as the live
    state's; a decode's ``cache_index`` is 0."""
    def make(spec):
        if isinstance(spec, torch.Tensor) and spec.is_meta:
            return torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        return 0 if spec is int else spec

    long_mode = model_lib.use_long_mode(cfg, shape)
    inputs = pytree.tree_map(make, model_lib.input_specs(cfg, shape))
    if shape.step_kind == "train":
        if mode == "admm":
            state = pytree.tree_map(
                make, steps_lib.consensus_state_specs(cfg, replicas, shape))
            step = steps_lib.make_consensus_train_step(
                cfg, replicas, long_mode=long_mode)
        else:
            specs = steps_lib.train_state_specs(cfg, shape)
            state = {"params": _fake_model(specs["params"], dev),
                     "opt": pytree.tree_map(make, specs["opt"])}
            step = steps_lib.make_train_step(cfg, long_mode=long_mode)
        return step, (state, inputs)
    params = _fake_model(model_lib.param_specs(cfg, shape), dev)
    if shape.step_kind == "prefill":
        return steps_lib.make_prefill_step(cfg, long_mode), (params, inputs)
    return (steps_lib.make_decode_step(cfg, long_mode),
            (params, inputs["tokens"], inputs["cache"],
             inputs["cache_index"]))


def budget(dev: torch.device) -> tuple:
    """(the card's memory, the bytes a step's tensors may take of it): the
    memory less what the process holds outside the caching allocator (the
    CUDA context and its modules, at least ``mesh.CONTEXT_BYTES``) and
    less cuBLAS's workspace.  On the card both are read from it; a trace
    on the CPU takes the H100's from ``mesh``, so a step gets one answer
    on either device."""
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        outside = total - free - torch.cuda.memory_reserved(dev)
    else:
        total, outside = mesh_lib.HBM_BYTES, 0
    return total, (total - max(outside, mesh_lib.CONTEXT_BYTES)
                   - mesh_lib.CUBLAS_WORKSPACE_BYTES)


def trace(cfg: ModelConfig, shape: InputShape, mode: str = "allreduce",
          replicas: int = 1, device=None) -> Dict[str, Any]:
    """One combination's step run once on fake tensors on ``device``
    (``None`` meaning ``"cuda"``): :func:`measure`'s record."""
    dev = device_lib.resolve(device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build(cfg, shape, mode, replicas, dev)
        return measure(step, args, dev)


def _layout(shape: InputShape, mode: str, mesh: mesh_lib.Mesh) -> tuple:
    """(replicas, the record's mesh): D replicas for an admm train step,
    else one."""
    if mode == "admm" and shape.step_kind == "train":
        return mesh.shape[0], f"{mesh.shape[0]}x1"
    return 1, "1x1"


def run_one(arch: str, shape: Union[str, InputShape],
            mesh: Optional[mesh_lib.Mesh] = None, mode: str = "allreduce",
            device=None) -> Dict[str, Any]:
    """One combination's record (the reference's keys where the meaning
    holds); a failure is an ``error`` record with its traceback.
    ``device`` ``None`` means ``"cuda"``."""
    dev = device_lib.resolve(device)
    mesh = mesh or mesh_lib.make_production_mesh()
    cfg = get_config(arch)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    replicas, layout = _layout(shape, mode, mesh)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": layout,
        "chips": mesh_lib.num_chips(mesh), "mode": mode}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    try:
        got = trace(cfg, shape, mode, replicas, dev)
        ac = costs_lib.step_costs(
            cfg, shape, long_mode=model_lib.use_long_mode(cfg, shape))
        total, usable = budget(dev)
        rec.update({
            "status": "ok",
            "device": dev.type,
            "trace_s": got["seconds"],
            "memory": {
                "argument_size_in_bytes": got["argument_size_in_bytes"],
                "output_size_in_bytes": got["output_size_in_bytes"],
                "temp_size_in_bytes":
                    got["peak_bytes"] - got["argument_size_in_bytes"],
                "peak_bytes": got["peak_bytes"],
                "device_bytes": total,
                "usable_bytes": usable,
                "fits": got["peak_bytes"] <= usable},
            "flops": float(got["flops"]),
            "bytes_accessed": float(got["bytes_accessed"]),
            "analytic": {"flops": ac.flops, "hbm_bytes": ac.hbm_bytes,
                         "param_state_bytes": ac.param_bytes_state,
                         "cache_bytes": ac.cache_bytes},
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": shape.global_batch * (shape.seq_len
                                            if shape.step_kind != "decode"
                                            else 1),
            "step_kind": shape.step_kind,
        })
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="4x1",
                    help="comma list of 'DxM': D consensus replicas under "
                         "--mode admm, M unused")
    ap.add_argument("--mode", default="allreduce",
                    choices=["allreduce", "admm"])
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    device_lib.resolve(args.device)
    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [mesh_lib.parse_mesh(name, args.mode)
              for name in args.mesh.split(",")]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh in meshes:
                rec = run_one(arch, shape_name, mesh, args.mode,
                              args.device)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                status = rec["status"]
                extra = ""
                if status == "ok":
                    mem = rec["memory"]
                    extra = (f"args={mem['argument_size_in_bytes']/1e9:.2f}GB "
                             f"peak={mem['peak_bytes']/1e9:.2f}GB "
                             f"fits={mem['fits']} "
                             f"flops={rec['flops']:.3g} "
                             f"trace={rec['trace_s']:.1f}s")
                elif status == "error":
                    n_fail += 1
                    extra = rec["error"][:200]
                else:
                    extra = rec["reason"]
                print(f"[{status:7s}] {arch:24s} {shape_name:12s} "
                      f"{rec['mesh']:8s} {extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} combinations failed")


if __name__ == "__main__":
    main()
