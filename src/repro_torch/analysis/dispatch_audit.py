"""Dispatch-level audits of the real entry points, the call counter and
the launch guard (twin of ``repro/analysis/jaxpr_audit.py``).

Where the lint reasons about source, this module reasons about what the
port actually runs:

- :func:`audit_fn` runs a callable under a ``TorchDispatchMode`` that
  records every aten op, and reports any **denied op** (unordered
  accumulations: ``index_add``, ``scatter_add``, ``scatter_reduce``,
  ``index_put`` with ``accumulate=True``; and aten random ops: the
  fabric's drop stream is the host threefry of ``net/prng.py``, so none
  belongs on a step) and any **denied dtype** in an op's inputs or
  outputs (float64 always; bfloat16 and float16 except on a plan
  compiled with ``qp_precision="bf16"``, which allows bfloat16).
- :func:`audit_entry_points` applies it to the paths the contracts
  cover: ``compile_problem(...).step`` (f32, and bf16 with bf16
  allowed), ``compile_sweep``'s step, one async fabric round over a
  lossy, delayed f32 net (``net.async_admm._fabric_step``), and
  ``kernels.ops.gemm_rows`` at two serve buckets.  The hand kernels are
  pybind calls, opaque to the mode: on the card it audits the torch ops
  around them, on the CPU also their plain twins.
- :func:`call_counter` counts calls of module attributes (the twin of
  ``trace_counter``; eager PyTorch has no trace, so a count of calls is
  what there is), and :func:`launch_guard` pins the build-once
  invariants with it: one ``ops.weighted_gram`` entry per dense fit and
  per sweep compile, none for a factored fit, one ``ops.gemm_rows``
  entry per served batch.  On the card the same numbers come from
  ``ops.launch_counts()``, and the extension is loaded once per process.

The reference's ``jit_cache_size`` has no twin: nothing is compiled per
shape in eager PyTorch (the kernels are built once per process, which
the guard checks on the card).
"""
from __future__ import annotations

import contextlib
import functools
import importlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.linter import Finding

#: aten ops (overload packets, in-place ``_`` stripped) whose
#: accumulation order is unordered
UNORDERED_OPS = frozenset({"index_add", "scatter_add", "scatter_reduce",
                           "index_reduce"})
#: aten ops that draw random numbers on the device
RANDOM_OPS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "uniform", "normal", "multinomial",
    "exponential", "geometric", "cauchy", "log_normal", "random",
    "native_dropout", "poisson",
})
#: both are forbidden on a contract path
DENY_OPS = UNORDERED_OPS | RANDOM_OPS
#: ops that are unordered only with ``accumulate=True``, the positional
#: argument at :data:`_ACCUMULATE_ARG` (``index_put(self, indices,
#: values, accumulate)`` and its kin)
ACCUMULATE_OPS = frozenset({"index_put", "_index_put_impl", "put"})
_ACCUMULATE_ARG = 3

#: dtypes a contract path never holds: float64 means an ambient default
#: leaked past the pinned-f32 policy; bf16/f16 are only intended on a
#: ``qp_precision="bf16"`` plan (bf16, see :func:`audit_fn`)
DENY_DTYPES = frozenset({"torch.float64", "torch.bfloat16",
                         "torch.float16"})


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


class _Recorder(TorchDispatchMode):
    """Records each aten op's name, the dtypes of its tensor inputs and
    outputs, and whether it accumulated."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _op_name(func)
        dtypes = {str(t.dtype) for t in tree_leaves((args, kwargs, out))
                  if isinstance(t, torch.Tensor)}
        acc = name in ACCUMULATE_OPS and bool(kwargs.get(
            "accumulate", len(args) > _ACCUMULATE_ARG
            and args[_ACCUMULATE_ARG]))
        self.ops.append((name, dtypes, acc))
        return out


def audit_fn(fn: Callable, *args, name: Optional[str] = None,
             allow_bf16: bool = False, **kwargs) -> List[Finding]:
    """Run ``fn(*args, **kwargs)`` under the recorder and audit every
    aten op it ran.

    Returns findings with rule ids ``dispatch-denied-op`` and
    ``dispatch-denied-dtype``; ``path`` carries the entry point's name
    (an aten op has no source line).  ``allow_bf16`` allows bfloat16 (a
    ``qp_precision="bf16"`` plan).  An empty list means clean.
    """
    name = name or getattr(fn, "__name__", "<fn>")
    deny_dtypes = DENY_DTYPES - ({"torch.bfloat16"} if allow_bf16
                                 else set())
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    findings: List[Finding] = []
    seen = set()
    for op, dtypes, acc in rec.ops:
        if (op in DENY_OPS or acc) and ("op", op) not in seen:
            seen.add(("op", op))
            what = ("accumulate=True" if acc else "a device random draw"
                    if op in RANDOM_OPS else "an unordered accumulation")
            findings.append(Finding(
                "dispatch-denied-op", name, 0,
                f"aten.{op} ({what}) on a contract path: its order or its "
                "numbers are not the same from run to run or backend to "
                "backend"))
        for dt in sorted(dtypes & deny_dtypes):
            if ("dtype", dt, op) not in seen:
                seen.add(("dtype", dt, op))
                findings.append(Finding(
                    "dispatch-denied-dtype", name, 0,
                    f"dtype {dt} at aten.{op}: the pinned-f32 policy "
                    "forbids it on this path (an ambient default leaked, "
                    "or an unintended low-precision cast)"))
    return findings


# ----------------------------------------------------------------------
# call counting
# ----------------------------------------------------------------------


class CallCounts:
    """Calls per wrapped target, filled while :func:`call_counter` is
    active.  Index with the full ``"module:attr"`` target or just the
    attribute name (``counts["weighted_gram"]``)."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        #: the positional arguments of every call, per target
        self.calls: Dict[str, list] = {}

    def __getitem__(self, key: str) -> int:
        if key in self._counts:
            return self._counts[key]
        hits = [v for k, v in self._counts.items()
                if k.rsplit(":", 1)[-1] == key]
        if len(hits) > 1:
            raise KeyError(f"{key!r} is ambiguous; use 'module:attr'")
        return hits[0] if hits else 0

    def snapshot(self) -> Dict[str, int]:
        """A plain dict copy of all counters."""
        return dict(self._counts)


@contextlib.contextmanager
def call_counter(*targets: str):
    """Count calls of module attributes.

    ``targets`` are ``"module.path:attr"`` strings, e.g.
    ``"repro_torch.kernels.ops:weighted_gram"``.  Each named attribute is
    replaced, for the duration of the context, by a counting wrapper, and
    restored after.  Target the attribute where the caller looks it up: a
    call through the module (``kops.weighted_gram``) sees a wrapper on
    that module; a ``from x import f`` binding in module ``m`` must be
    patched as ``"m:f"``.
    """
    counts = CallCounts()
    saved = []
    try:
        for target in targets:
            modname, attr = target.split(":")
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            counts._counts[target] = 0
            counts.calls[target] = []

            def wrapper(*a, __fn=fn, __t=target, **kw):
                counts._counts[__t] += 1
                counts.calls[__t].append(a)
                return __fn(*a, **kw)

            functools.update_wrapper(wrapper, fn)
            setattr(mod, attr, wrapper)
            saved.append((mod, attr, fn))
        yield counts
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


# ----------------------------------------------------------------------
# the entry points and the guard
# ----------------------------------------------------------------------


def _tiny_problem(device=None):
    """The smallest representative problem (V=2, T=2, N=8, p=4)."""
    from repro_torch.core import dtsvm as core
    from repro_torch.core import graph
    from repro_torch.data import synthetic

    V, T, N, p = 2, 2, 8, 4
    data = synthetic.make_multitask_data(
        V=V, T=T, p=p, n_train=np.full((V, T), N, int), n_test=4,
        relatedness=0.9, seed=0)
    adj = graph.make_graph("ring", V, seed=0)
    return core.make_problem(data["X"], data["y"], data["mask"], adj,
                             device=device)


def audit_entry_points(device=None) -> List[Finding]:
    """Audit every contract entry point on ``device`` (``None`` means
    ``"cuda"``; see ``repro_torch.device``).  Returns the concatenated
    findings (empty: all clean)."""
    from repro_torch import device as device_lib
    from repro_torch.engine.plan import compile_problem
    from repro_torch.engine.sweep import compile_sweep
    from repro_torch.kernels import ops
    from repro_torch.net import async_admm, fabric as fabric_lib
    from repro_torch.net.policies import LinkPolicy, NetConfig
    from repro_torch.serve.model import row_bucket

    dev = device_lib.resolve(device)
    prob = _tiny_problem(dev)
    findings: List[Finding] = []

    plan = compile_problem(prob, qp_iters=3)
    findings += audit_fn(plan.step, plan.init_state(),
                         name="compile_problem(...).step")

    plan16 = compile_problem(prob, qp_iters=3,
                             qp_solver="pallas_fused_multi",
                             qp_precision="bf16")
    findings += audit_fn(plan16.step, plan16.init_state(), allow_bf16=True,
                         name="compile_problem(qp_precision='bf16').step")

    sweep = compile_sweep(prob, [{"C": 0.01}, {"C": 0.1}], qp_iters=3)
    findings += audit_fn(sweep.step, sweep.init_state(),
                         name="compile_sweep(...).step")

    # a lossy, delayed f32 wire: the keyed drop stream and the mailbox
    # rings (quantized links are outside the bitwise contract)
    net = NetConfig(policy=LinkPolicy(drop=0.3, delay=1), seed=7)
    fab = fabric_lib.build_fabric(prob, net)
    state = plan.init_state()
    fst = fab.init_state(state.r * prob.active[..., None])
    V = fab.V
    act = torch.ones((V,), dtype=torch.float32, device=dev)
    keep = fab.keep_masks(0, 1)[0]
    findings += audit_fn(
        lambda: async_admm._fabric_step(
            plan, fab, state, fst, act, None, prob.active.sum(1), rnd=0,
            keep=keep),
        name="async_admm._fabric_step")

    p = prob.X.shape[-1]
    Wf = torch.zeros((V * prob.X.shape[1], p), dtype=torch.float32,
                     device=dev)
    bf = torch.zeros((V * prob.X.shape[1],), dtype=torch.float32,
                     device=dev)
    for n in (1, 100):
        b = row_bucket(n)
        X = torch.zeros((b, p), dtype=torch.float32, device=dev)
        findings += audit_fn(ops.gemm_rows, Wf, bf, X,
                             name=f"ops.gemm_rows[bucket={b}]")
    return findings


def launch_guard(device=None) -> List[Finding]:
    """The build-once invariants, checked live on the tiny problem: one
    ``ops.weighted_gram`` entry per dense fit and per 3-config sweep
    compile, none for a factored fit, and one ``ops.gemm_rows`` entry per
    served batch, a repeat bucket at the same padded shape.  On the card
    the launch counts must say the same, and the extension is loaded at
    most once (not at all where it was loaded before)."""
    from repro_torch import device as device_lib
    from repro_torch.engine.plan import compile_problem
    from repro_torch.engine.sweep import compile_sweep
    from repro_torch.kernels import build, ops
    from repro_torch.serve import model as serve_model

    dev = device_lib.resolve(device)
    card = dev.type == "cuda"
    findings: List[Finding] = []

    def expect(where: str, got: int, want: int, what: str) -> None:
        if got != want:
            findings.append(Finding(
                "launch-guard", where, 0,
                f"{what}: expected exactly {want}, measured {got}"))

    def launched(key: str) -> int:
        return ops.launch_counts()[key] if card else 0

    loaded_before = build._EXT is not None
    gram = "repro_torch.kernels.ops:weighted_gram"
    with contextlib.ExitStack() as stack:
        loads = stack.enter_context(
            call_counter("torch.utils.cpp_extension:load")) if card else None
        prob = _tiny_problem(dev)
        ops.reset_launch_counts()
        with call_counter(gram) as c:
            compile_problem(prob, qp_iters=2).run(iters=3)
        expect("fit", c["weighted_gram"], 1, "weighted_gram entries per fit")
        if card:
            expect("fit", launched("weighted_gram"), 1,
                   "Gram launches per fit")

        ops.reset_launch_counts()
        with call_counter(gram) as c:
            compile_sweep(prob, [{"C": 0.01}, {"C": 0.1}, {"C": 1.0}],
                          qp_iters=2).run(iters=3)
        expect("sweep", c["weighted_gram"], 1,
               "weighted_gram entries per 3-config sweep compile")
        if card:
            expect("sweep", launched("weighted_gram"), 1,
                   "Gram launches per 3-config sweep compile")

        ops.reset_launch_counts()
        with call_counter(gram) as c:
            compile_problem(prob, qp_iters=2, qp_solver="pallas_fused_multi",
                            qp_operator="factored").run(iters=3)
        expect("factored", c["weighted_gram"], 0,
               "weighted_gram entries per factored fit")
        if card:
            expect("factored", launched("weighted_gram"), 0,
                   "Gram launches per factored fit")

        V, T, p = 2, 2, 4
        model = serve_model.PredictModel.from_r(
            torch.zeros((V, T, 2 * p + 2), dtype=torch.float32), device=dev)
        shapes = []
        for rows in (3, 5, 100):       # bucket 8, bucket 8 again, 128
            ops.reset_launch_counts()
            with call_counter("repro_torch.kernels.ops:gemm_rows") as c:
                model.decide_rows(np.ones((rows, p), np.float32))
            expect(f"serve[{rows} rows]", c["gemm_rows"], 1,
                   "gemm_rows entries per served batch")
            if card:
                expect(f"serve[{rows} rows]", launched("gemm_rows"), 1,
                       "gemm_rows launches per served batch")
            shapes += [tuple(a[2].shape) for a in
                       c.calls["repro_torch.kernels.ops:gemm_rows"]]
        expect("serve", int(shapes[0] == shapes[1]), 1,
               f"a repeat bucket at the same padded shape ({shapes[:2]})")
        expect("serve", int(shapes[2] == (serve_model.row_bucket(100), p)),
               1, f"100 rows padded to their bucket ({shapes[2]})")
    if card:
        expect("build", loads["load"], 0 if loaded_before else 1,
               "extension loads in this process")
        expect("build", int(build.extension() is build.extension()), 1,
               "one extension object per process")
    return findings
