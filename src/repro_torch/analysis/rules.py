"""The port's lint rules (twin of ``repro/analysis/rules.py``).

Each rule encodes a real past bug or a standing contract of the code,
in its torch form; each class docstring names it.  Rules are pure AST:
no torch import, no execution.  Each keeps its reference twin's id and
path scope, with paths relative to ``repro_torch``.

The reference's ``scalar-closure-in-scan`` has no twin here: it guards a
Python scalar captured by a traced ``lax.scan`` body, which embeds as an
HLO literal.  Eager PyTorch traces nothing, so a captured scalar is just
a scalar.

Adding a rule: subclass :class:`Rule`, set ``id`` / ``summary`` /
``history`` / ``paths``, implement ``check(mod) -> Iterator[Finding]``,
append an instance to ``_REGISTRY`` at the bottom, and add a paired good
and bad fixture under ``tests/torch_analysis_fixtures/``
(``tests/test_torch_analysis.py`` checks that every rule has one).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.linter import Finding, SourceModule

# ----------------------------------------------------------------------
# shared AST helpers
# ----------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _numpy_aliases(tree: ast.AST) -> Set[str]:
    """Local names bound to the ``numpy`` module (``np`` usually)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out


def _functions_by_name(mod: SourceModule) -> Dict[str, List[ast.AST]]:
    cache = getattr(mod, "_fn_index", None)
    if cache is None:
        cache = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cache.setdefault(node.name, []).append(node)
        mod._fn_index = cache
    return cache


#: hot roots, matched by bare function name in every module: the
#: per-iteration step bodies, the fabric's per-round methods, the QP
#: engines, the kernel entry ops and the telemetry collectors (the
#: reference's set, every name of which exists in the port).  Host-side
#: orchestration (compile_problem, PredictServer._run_batch,
#: PredictModel.decide_rows) is deliberately not here: numpy and host
#: syncs are its job.
HOT_ROOTS = frozenset({
    "plan_step", "consensus_update", "dtsvm_step", "_fabric_step",
    "gemm_rows", "reduce", "exchange", "_per_edge_quant",
    "apply_membership",
    "solve_fista", "solve_pg", "solve_pallas_fused",
    "solve_pallas_fused_multi", "solve_factored_multi",
    "solve_box_qp_pg", "solve_box_qp_fista",
    "weighted_gram", "weighted_gram_rows", "qp_pg_step", "qp_pg_multi",
    "_qp_rows",
    "collect_diagnostics", "collect_shard_diagnostics",
})

#: the port's own per-iteration roots, scoped by path (``_step``,
#: ``timed``, ``nbr_reduce``, ``train_step`` and ``update`` are common
#: names): a shard_map rank's neighbor sums, a sample rank's ADMM
#: iteration, the rank backends' collectives, and the staging helper they
#: run inside; the allreduce and the consensus train steps, the
#: consensus round and gap they run, and the optimizers' update.  The
#: training CLI's loop (``launch/train.py:main``) is not a root: it is
#: host orchestration (the token draw, the log's ``float()`` reads, which
#: the reference makes too, the checkpoint codec) in a substrate path the
#: rules skip, and the steps it calls are the roots above.
PATH_ROOTS: Dict[str, frozenset] = {
    "core/dtsvm_dist.py": frozenset({"nbr_reduce"}),
    "core/consensus.py": frozenset({"consensus_round", "consensus_gap"}),
    "dist/sample.py": frozenset({"_step"}),
    "dist/collectives.py": frozenset({"all_gather", "all_reduce",
                                      "timed"}),
    "train/steps.py": frozenset({"train_step", "consensus_step"}),
    "optim/adamw.py": frozenset({"update"}),
}


def _hot_functions(mod: SourceModule) -> List[ast.AST]:
    """Function nodes reachable (static call graph of the one module)
    from the hot roots; cached on the module."""
    cache = getattr(mod, "_hot_cache", None)
    if cache is not None:
        return cache
    idx = _functions_by_name(mod)
    roots = HOT_ROOTS | PATH_ROOTS.get(mod.relpath, frozenset())
    work = [fn for name in sorted(roots) for fn in idx.get(name, [])]
    seen = {id(fn) for fn in work}
    order = list(work)
    while work:
        fn = work.pop()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = None
            if isinstance(node.func, ast.Name):
                callee = node.func.id
            elif (isinstance(node.func, ast.Attribute)
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id in ("self", "cls")):
                callee = node.func.attr
            if callee is None:
                continue
            for target in idx.get(callee, []):
                if id(target) not in seen:
                    seen.add(id(target))
                    work.append(target)
                    order.append(target)
    mod._hot_cache = order
    return order


def _hot_calls(mod: SourceModule) -> Iterator[ast.Call]:
    """Every Call node inside the hot-reachable set, deduplicated."""
    seen: Set[int] = set()
    for fn in _hot_functions(mod):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and id(node) not in seen:
                seen.add(id(node))
                yield node


# ----------------------------------------------------------------------
# rule base + registry
# ----------------------------------------------------------------------


#: the seed substrate's packages (ROADMAP queue 1, item 9) the lint
#: rules skip, as the reference's do: the models, configs and the
#: serving launcher.  ``optim/`` and ``train/`` hold the train step, a
#: per-iteration path, so the rules run there
SUBSTRATE_PATHS = ("models/", "configs/", "launch/")

#: where the hot-path rules run: the reference's scope plus ``dist/``,
#: which holds the port's rank backends, and ``train/`` and ``optim/``,
#: which hold the train step (their per-iteration roots are
#: :data:`PATH_ROOTS`)
HOT_PATHS = ("engine/", "net/", "core/", "kernels/", "api/", "serve/",
             "obs/", "dist/", "train/", "optim/")


class Rule:
    """One lint rule: id, docs metadata, path scope and ``check``."""
    id: str = ""
    summary: str = ""
    #: the real past bug or standing contract this rule encodes
    history: str = ""
    #: package-relative path prefixes the rule runs on (None = all)
    paths: Optional[Tuple[str, ...]] = None
    #: package-relative prefixes the rule never runs on
    exclude: Tuple[str, ...] = ("analysis/",) + SUBSTRATE_PATHS

    def applies(self, relpath: str) -> bool:
        """Whether the rule runs on a package-relative path."""
        if relpath.startswith(self.exclude):
            return False
        return self.paths is None or relpath.startswith(self.paths)

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Yield the findings of one parsed module."""
        raise NotImplementedError

    def finding(self, mod: SourceModule, line: int, message: str
                ) -> Finding:
        """A Finding carrying this rule's id at ``mod.path:line``."""
        return Finding(self.id, mod.path, line, message)


# ----------------------------------------------------------------------
# silent-downcast
# ----------------------------------------------------------------------

_RESTORE_NAME = ("restore", "_restore", "load", "_load", "decode",
                 "_decode", "from_")


class SilentDowncast(Rule):
    """``torch.as_tensor`` / ``torch.tensor`` without an explicit dtype
    on a checkpoint or restore path.

    Without a dtype the result's type follows the input and the default
    dtype: Python floats and lists of them come back float32, whatever
    width was saved, so a restored leaf can differ from the saved one and
    break the bitwise save -> restore -> continue promise (the
    reference's checkpoint decoder once did this with ``jnp.asarray``).
    Restores pin the dtype or stay in numpy.
    """
    id = "silent-downcast"
    summary = ("torch.as_tensor/torch.tensor without dtype on a restore "
               "path: the leaf's width follows the default dtype")
    history = ("the reference's checkpoint decode returned f32 for "
               "saved f64 leaves; the port's restores pin float32 "
               "explicitly (store/session_store.py:_tensor)")
    paths = None  # everywhere, gated on path OR function name below

    _FUNCS = ("torch.as_tensor", "torch.tensor")

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Flag dtype-less torch.as_tensor/tensor in restore-path code."""
        in_store = mod.relpath.startswith(("checkpoint/", "store/"))
        seen: Set[int] = set()   # nested defs are walked once only
        for fn_name, fns in _functions_by_name(mod).items():
            if not (in_store or fn_name.startswith(_RESTORE_NAME)):
                continue
            for fn in fns:
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call) or id(node) in seen:
                        continue
                    seen.add(id(node))
                    d = _dotted(node.func)
                    if d not in self._FUNCS:
                        continue
                    positional = d == "torch.as_tensor" and \
                        len(node.args) >= 2
                    if positional or any(kw.arg in ("dtype", None)
                                         for kw in node.keywords):
                        continue
                    yield self.finding(
                        mod, node.lineno,
                        f"{d} without an explicit dtype on a restore "
                        "path: the restored leaf's width follows the "
                        "input and the default dtype; pass the dtype or "
                        "keep the leaf in numpy")


# ----------------------------------------------------------------------
# host-sync-in-hot-path
# ----------------------------------------------------------------------

#: tensor methods that wait for the card and copy to the host
_SYNC_METHODS = ("item", "cpu", "numpy", "tolist")


class HostSyncInHotPath(Rule):
    """Host round-trips inside functions reachable from the hot roots
    (``plan_step``, the fabric round, the QP engines, the kernel entry
    ops, ``gemm_rows``, a sample rank's ``_step``, the collectives: see
    :data:`HOT_ROOTS` and :data:`PATH_ROOTS`).

    ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, ``float()`` or
    ``int()`` of a tensor and ``torch.cuda.synchronize`` each wait for
    the card and stall the launch queue once per call; numpy calls run on
    the host and force a copy; ``print`` formats a tensor (a sync).  The
    engine's contract is a per-iteration step that only enqueues work
    (chip_smoke's obs phase checks it at run time with
    ``torch.cuda.set_sync_debug_mode``).
    """
    id = "host-sync-in-hot-path"
    summary = ("host sync (.item()/.cpu()/.numpy()/.tolist()/float()/"
               "int()/np.*/print/torch.cuda.synchronize) in code "
               "reachable from a hot root")
    history = ("standing contract of the plan/execute engine: the "
               "per-iteration step only enqueues device work; chip_smoke's "
               "obs phase checks it with set_sync_debug_mode")
    paths = HOT_PATHS

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Flag host round-trips in the hot-reachable call set."""
        np_aliases = _numpy_aliases(mod.tree)
        for call in _hot_calls(mod):
            msg = self._violation(call, np_aliases)
            if msg:
                yield self.finding(mod, call.lineno, msg)

    @staticmethod
    def _violation(call: ast.Call, np_aliases: Set[str]) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id == "print":
                return ("print() on the hot path formats its arguments on "
                        "the host (a sync for a tensor); move it to the "
                        "host-side caller")
            if (f.id in ("float", "int") and call.args
                    and not isinstance(call.args[0], ast.Constant)):
                return (f"{f.id}() on a non-literal on the hot path: on a "
                        "tensor it waits for the card; keep the value as "
                        "a tensor")
            return None
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            return (f".{f.attr}() waits for the card and copies to the "
                    "host once per call")
        d = _dotted(f)
        if d is None:
            return None
        if d.split(".", 1)[0] in np_aliases:
            return (f"numpy call {d}() on the hot path runs on the host "
                    "and forces a copy; use torch")
        if d == "cuda.synchronize" or d.endswith(".cuda.synchronize"):
            return ("torch.cuda.synchronize() on the hot path waits for "
                    "the whole device queue")
        return None


# ----------------------------------------------------------------------
# raw-einsum-in-plan
# ----------------------------------------------------------------------


class RawEinsumInPlan(Rule):
    """``einsum`` inside the hot set.

    ``torch.einsum`` hands the contraction to a library product whose
    order of summation is the library's choice, and it can differ
    between shapes that hold the same numbers (a batched (S, V, T) stack
    against one fit; a (1, V) adjacency row against the dense (V, V)
    product: a fault the port once had).  The port's bitwise contracts
    across backends rest on each deliberate contraction summing in the
    same order everywhere it runs.  A deliberate einsum on the hot path
    is allowed only with a ``noqa`` attestation that says why its order
    is the same on every path that must agree bitwise.
    """
    id = "raw-einsum-in-plan"
    summary = ("einsum on the hot path must carry an attestation that "
               "its summation order is the same on every path that must "
               "agree bitwise (or use mul+reduce)")
    history = ("the reference's q linear term became mul+reduce after "
               "einsum lowered differently under batching; the port's "
               "shard_map graph neighbor sum's (1, V) row summed in "
               "another order than the dense (V, V) product")
    paths = HOT_PATHS

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Flag einsum calls in the hot-reachable call set."""
        for call in _hot_calls(mod):
            d = _dotted(call.func)
            if d == "einsum" or (d and d.endswith(".einsum")):
                yield self.finding(
                    mod, call.lineno,
                    "einsum on the hot path: prefer the mul+reduce form; "
                    "if einsum is required, attest with a noqa reason "
                    "why its summation order holds on every path")


# ----------------------------------------------------------------------
# untiled-gram-call
# ----------------------------------------------------------------------

#: (path, function) of the budget route: the one place a dense
#: ``weighted_gram`` call belongs, as the budget's own fall-through
GRAM_BUDGET_ROUTE = ("engine/invariants.py", "gram_and_lipschitz")


class UntiledGramCall(Rule):
    """A ``weighted_gram`` call outside the budget route.

    The port's ``kernels.ops.weighted_gram`` takes no ``tile=``: the
    large-n build is budget-aware through
    ``engine/invariants.py:gram_and_lipschitz(..., budget=)``, which
    streams row panels when the budget binds and falls through to the
    dense build when it does not.  A direct call elsewhere silently
    builds the whole (N, N) K, whatever budget the caller was given.
    """
    id = "untiled-gram-call"
    summary = ("weighted_gram called outside "
               "engine/invariants.py:gram_and_lipschitz bypasses the "
               "PlanBudget streaming path")
    history = ("dense Gram builds ran out of memory on "
               "the large-n path; the budgeted build is the supported "
               "route (the port's PlanBudget)")
    paths = ("engine/", "api/", "net/", "serve/", "store/", "dist/")

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Flag weighted_gram calls outside the budget route."""
        route = _budget_route_calls(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or id(node) in route:
                continue
            d = _dotted(node.func)
            if not d or d.rsplit(".", 1)[-1] != "weighted_gram":
                continue
            yield self.finding(
                mod, node.lineno,
                "weighted_gram(...) outside the budget route: call "
                "engine.invariants.gram_and_lipschitz(Z, a, budget) so "
                "the build can stream under a memory budget")


def _budget_route_calls(mod: SourceModule) -> Set[int]:
    """ids of the Call nodes inside the budget route's function."""
    path, name = GRAM_BUDGET_ROUTE
    if mod.relpath != path:
        return set()
    return {id(node) for fn in _functions_by_name(mod).get(name, [])
            for node in ast.walk(fn) if isinstance(node, ast.Call)}


# ----------------------------------------------------------------------
# env-dependent-dtype
# ----------------------------------------------------------------------

#: attribute writes that set fp32 precision: (dotted target, values that
#: turn a lower precision ON)
_PRECISION_FLAGS = {
    "torch.backends.cuda.matmul.allow_tf32": (True,),
    "torch.backends.cudnn.allow_tf32": (True,),
    "torch.backends.cuda.matmul.fp32_precision": ("tf32",),
    "torch.backends.cudnn.fp32_precision": ("tf32",),
}
#: calls that set process-wide dtype or precision: (dotted name, argument
#: values that turn a lower precision ON; None: none does, the call
#: still makes results depend on ambient process state)
_PRECISION_CALLS = {
    "torch.set_float32_matmul_precision": ("high", "medium"),
    "torch.set_default_dtype": None,
}


class EnvDependentDtype(Rule):
    """Process-wide dtype or fp32-precision state written outside
    ``device.py``.

    ``device.py`` is the port's one blessed place (the reference's is
    ``dist/compat.py``), and its writes turn TF32 *off*: the north star
    forbids TF32 in fp32.  A write anywhere else makes numeric results
    depend on which module ran first; a write that turns TF32 on (or
    ``set_float32_matmul_precision("high"/"medium")``) is a finding
    wherever it stands, ``device.py`` included.
    """
    id = "env-dependent-dtype"
    summary = ("set_default_dtype / allow_tf32 / fp32_precision / "
               "set_float32_matmul_precision written outside device.py, "
               "or set to a lower precision anywhere")
    history = ("standing policy: dtypes are pinned per leaf and fp32 "
               "products never use TF32 (ROADMAP north star); the "
               "reference's rule guarded the x64 switch")
    paths = None

    #: the one module allowed to write these (to turn TF32 off)
    BLESSED = "device.py"

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Flag writes of the precision flags and calls that set them."""
        blessed = mod.relpath == self.BLESSED
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    d = _dotted(tgt)
                    if d not in _PRECISION_FLAGS:
                        continue
                    value = _constant(node.value)
                    lowers = value in _PRECISION_FLAGS[d]
                    if blessed and not lowers and value is not _UNKNOWN:
                        continue
                    yield self.finding(mod, node.lineno,
                                       self._message(d, lowers))
            elif isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d not in _PRECISION_CALLS:
                    continue
                value = _constant(node.args[0]) if node.args else _UNKNOWN
                lowering = _PRECISION_CALLS[d] or ()
                lowers = value in lowering
                if blessed and not lowers and value is not _UNKNOWN:
                    continue
                yield self.finding(mod, node.lineno,
                                   self._message(d, lowers))

    @staticmethod
    def _message(what: str, lowers: bool) -> str:
        if lowers:
            return (f"{what} turns a lower precision (TF32) on for fp32: "
                    "the port's fp32 contract forbids it anywhere")
        return (f"{what} written outside device.py: process-wide dtype "
                "state belongs to repro_torch.device only")


_UNKNOWN = object()


def _constant(node: Optional[ast.AST]):
    """The value of a literal node, else a sentinel."""
    if isinstance(node, ast.Constant):
        return node.value
    return _UNKNOWN


# ----------------------------------------------------------------------
# telemetry-read-in-kernel
# ----------------------------------------------------------------------

_OBS = "repro_torch.obs"


class TelemetryReadInKernel(Rule):
    """``repro_torch.obs`` imported, or telemetry collected, inside the
    kernel package.

    The telemetry contract (the reference's and the port's):
    diagnostics are computed by the engine's step beside the state, so
    the kernels stay observation-free and telemetry-on is bitwise
    telemetry-off.  A collector call or an obs import under ``kernels/``
    threads observation into the kernels' wrappers, where a telemetry
    toggle would change what launches.
    """
    id = "telemetry-read-in-kernel"
    summary = ("repro_torch.obs imported / telemetry collected inside "
               "the kernel package: kernels must stay observation-free")
    history = ("telemetry is collected by "
               "the engine step only, so telemetry-on is bitwise "
               "telemetry-off and a kernel launches the same either way")
    paths = ("kernels/",)

    _COLLECTORS = ("collect_diagnostics", "collect_shard_diagnostics")

    def check(self, mod: SourceModule) -> Iterator[Finding]:
        """Flag obs imports and collector calls anywhere in the file."""
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == _OBS or a.name.startswith(_OBS + "."):
                        yield self.finding(
                            mod, node.lineno,
                            f"import {a.name} inside kernels/: the kernel "
                            "package is observation-free; collect "
                            "telemetry in the engine step")
            elif isinstance(node, ast.ImportFrom):
                names = {a.name for a in node.names}
                from_obs = node.module is not None and (
                    node.module == _OBS or node.module.startswith(
                        _OBS + "."))
                if from_obs or (node.module == "repro_torch"
                                and "obs" in names):
                    yield self.finding(
                        mod, node.lineno,
                        "repro_torch.obs imported inside kernels/: the "
                        "kernel package is observation-free; collect "
                        "telemetry in the engine step")
            elif isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d and d.rsplit(".", 1)[-1] in self._COLLECTORS:
                    yield self.finding(
                        mod, node.lineno,
                        f"{d}() inside kernels/: telemetry is the engine "
                        "step's, never part of a kernel's wrapper (a "
                        "toggle would change what launches)")


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

_REGISTRY: Dict[str, Rule] = {r.id: r for r in [
    SilentDowncast(),
    HostSyncInHotPath(),
    RawEinsumInPlan(),
    UntiledGramCall(),
    EnvDependentDtype(),
    TelemetryReadInKernel(),
]}

#: the reference's rules with no twin here, and why
DROPPED_RULES = {
    "scalar-closure-in-scan": (
        "guards a Python scalar captured by a traced lax.scan/jit body, "
        "which embeds as an HLO literal; eager PyTorch traces nothing"),
}

#: meta rule ids raised by the linter itself (not suppressible targets)
META_RULES = ("bare-noqa", "unknown-noqa", "malformed-noqa",
              "syntax-error")


def all_rules() -> List[Rule]:
    """Every registered rule, in registration order."""
    return list(_REGISTRY.values())


def get_rule(rule_id: str) -> Rule:
    """Look up one rule by id (KeyError on unknown)."""
    return _REGISTRY[rule_id]


def is_known(rule_id: str) -> bool:
    """Whether ``rule_id`` is a registered (suppressible) rule."""
    return rule_id in _REGISTRY
