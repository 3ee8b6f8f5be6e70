"""The launch audit of the hand kernels (twin of
``repro/analysis/pallas_audit.py``).

Every CUDA launch in ``kernels/csrc`` derives its geometry in C++; the
pure functions of :mod:`repro_torch.kernels.launch` derive the same
numbers from the same shapes.  This module checks them without a card:

- **Hopper's limits** at every audited shape: grid x at most 2^31 - 1,
  grid y and z at most 65535 (the bindings' guards, ``bindings.cpp:90-93,
  110-111,177``), threads a multiple of 32 and at most 1024 (and at most
  the kernel's ``__launch_bounds__``), static shared memory at most
  48 KB, dynamic shared memory at most the 227 KB opt-in and above 48 KB
  only where the launcher raises the limit, and a cooperative grid no
  larger than the CTAs the card can hold at once.
- **Constants**: each source's ``constexpr int`` constants, parsed out of
  the ``.cu`` files, against the ones ``kernels.launch`` states.
- **Coverage**: every key of ``ops.launch_counts()`` has its plain twin
  in ``kernels/ref.py`` and is referenced by ``tests/test_torch_kernels.py``
  or ``tests/test_torch_gpu.py``; every ``<<<`` or
  ``cudaLaunchCooperativeKernel`` site in ``csrc/*.cu`` launches a kernel
  registered here (a text scan, the counterpart of the reference's
  ``ast`` scan for ``pallas_call``), and every registered kernel has one.

On the card, :func:`audit_extension` holds the same data against the
built extension: ``kernel_info()``'s static shared bytes and maximum
threads, and ``qp_multi_shape`` at every multi-solve shape, f32 and
bf16, with and without the fold.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.linter import Finding
from repro_torch.kernels import launch as L

# Hopper's launch limits (CUDA programming guide, compute capability 9.0)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_THREADS = 1024
WARP = 32
MAX_STATIC_SMEM = 48 * 1024
#: the dynamic shared bytes a launch may use without raising the limit
DEFAULT_DYNAMIC_SMEM = 48 * 1024

#: registered kernels: base name -> source file under ``kernels/csrc``
KERNELS = {
    "gram_prescale_kernel": "gram.cu",
    "gram_kernel": "gram.cu",
    "gram_tiled_kernel": "gram.cu",
    "qp_step_kernel": "qp_step.cu",
    "qp_multi_block_kernel": "qp_multi.cu",
    "qp_multi_grid_kernel": "qp_multi.cu",
    "rows_kernel": "rows.cu",
}

#: each key of ``kernels.ops.launch_counts()`` -> its plain twin in
#: ``kernels.ref``
PLAIN_TWINS = {
    "weighted_gram": "weighted_gram",
    "weighted_gram_tiled": "weighted_gram_rows",
    "gram_prescale": "gram_prescale",
    "qp_pg_step": "qp_pg_step",
    "qp_pg_multi": "qp_pg_multi",
    "gemm_rows": "gemm_rows",
}

#: the test files that must reference every launch-counted kernel
KERNEL_TESTS = ("test_torch_kernels.py", "test_torch_gpu.py")

# ----------------------------------------------------------------------
# the audited shapes
# ----------------------------------------------------------------------

_EDGE_B = 65535                       # the bindings' batch guard
_EDGE_N = L.gram_max_rows()           # repro_gram_max_rows()
_EDGE_D = 65535 * 32                  # the prescale's feature guard

#: (label, B, N, D) of the Gram builds: the paper regime (the
#: quickstart's shapes), Fig. 3's 16-config sweep as chip_smoke's figures
#: phase runs it (16 configs x V=10 x T=2, N=40, p=10), the large regime
#: (benchmarks/bench_scale.py's large fit) and the largest the guards admit
GRAM_SHAPES = (("paper", 20, 60, 11), ("fig3_sweep", 320, 40, 11),
               ("large", 2, 20000, 257), ("edge", _EDGE_B, _EDGE_N, _EDGE_D))
#: (label, B, N, D, row0, M) of the row panels: the paper regime's two
#: panels across the diagonal, the first and last 3352-row streamed
#: panels of the large build (PlanBudget(max_elems=2**27)), a sample
#: rank's panel (rows 5000-9999 of N=20000, 4 ranks) and a whole K at the
#: guards' edge
PANEL_SHAPES = (("paper", 20, 60, 11, 36, 24), ("paper", 20, 60, 11, 20, 24),
                ("large/streamed", 2, 20000, 257, 0, 3352),
                ("large/streamed", 2, 20000, 257, 16648, 3352),
                ("large/sample_rank", 2, 20000, 257, 5000, 5000),
                ("edge", _EDGE_B, _EDGE_N, 257, 0, _EDGE_N))
#: (label, B, N) of the QP kernels: as for the Gram builds, plus
#: chip_smoke's ``--only multi_mid`` grid (where K leaves a CTA's shared
#: memory) and the batch guard's edge
QP_SHAPES = ((("paper", 20, 60), ("fig3_sweep", 320, 40),
              ("large", 2, 20000))
             + tuple(("multi_mid", b, n) for b in (2, 20, 300)
                     for n in (328, 329, 515, 1000))
             + (("edge", _EDGE_B, 60), ("edge", _EDGE_B, 20000)))
#: (label, M, K, p) of the serving product: the server's row buckets 8 to
#: 1024 at the large fit's (K, p) = (2, 256) and the quickstart's
#: (20, 10), and the bindings' M*K guard
ROWS_SHAPES = (tuple(("serve", m, k, p) for k, p in ((2, 256), (20, 10))
                     for m in (8, 16, 32, 64, 128, 256, 512, 1024))
               + (("edge", (2 ** 31 - 1) // 20, 20, 10),))


def audited_launches(*, sms: int = L.H100_SMS,
                     ctas_per_sm: Optional[Dict] = None,
                     optin: int = L.HOPPER_SMEM_OPTIN
                     ) -> List[Tuple[str, L.Launch, Optional[int]]]:
    """``(name, launch, resident CTAs or None)`` of every kernel at every
    audited shape.  ``ctas_per_sm`` maps ``(bf16, fold, N)`` to the
    card's occupancy answer for the multi solve's grid path (default:
    ``kGridCtasPerSm`` everywhere)."""
    out = []

    def add(name, launch, resident=None):
        if launch is not None:
            out.append((name, launch, resident))

    for label, B, N, D in GRAM_SHAPES:
        add(f"gram_prescale[{label} B={B} N={N} D={D}]",
            L.gram_prescale_launch(B, N, D))
        add(f"gram[{label} B={B} N={N}]", L.gram_launch(B, N, D))
    for label, B, N, D, row0, M in PANEL_SHAPES:
        add(f"gram_tiled[{label} B={B} N={N} rows {row0}+{M}]",
            L.gram_tiled_launch(B, N, D, row0, M))
    for label, B, N in QP_SHAPES:
        add(f"qp_step[{label} B={B} N={N}]", L.qp_step_launch(B, N))
        for bf16 in (False, True):
            for fold in (False, True):
                per_sm = (ctas_per_sm or {}).get(
                    (bf16, fold, N), L.MULTI_GRID_CTAS_PER_SM)
                launch = L.qp_multi_launch(B, N, bf16=bf16, fold=fold,
                                           sms=sms, ctas_per_sm=per_sm,
                                           optin=optin)
                add(f"qp_multi[{label} B={B} N={N} "
                    f"{'bf16' if bf16 else 'f32'}{' fold' if fold else ''}]",
                    launch, per_sm * sms)
    for label, M, K, p in ROWS_SHAPES:
        add(f"gemm_rows[{label} M={M} K={K} p={p}]", L.rows_launch(M, K, p))
    return out


# ----------------------------------------------------------------------
# the limits
# ----------------------------------------------------------------------


def check_launch(launch: L.Launch, name: str,
                 resident: Optional[int] = None,
                 optin: int = L.HOPPER_SMEM_OPTIN) -> List[Finding]:
    """Check one launch against Hopper's limits; ``resident`` is the
    number of CTAs of this kernel the card holds at once (for a
    cooperative launch).  Findings carry ``name`` as their path."""
    f: List[Finding] = []

    def flag(rule, msg):
        f.append(Finding(rule, name, 0, f"{launch.kernel}: {msg}"))

    x, y, z = launch.grid
    if not 1 <= x <= MAX_GRID_X:
        flag("launch-grid", f"grid x {x} outside [1, {MAX_GRID_X}]")
    for axis, n in (("y", y), ("z", z)):
        if not 1 <= n <= MAX_GRID_YZ:
            flag("launch-grid", f"grid {axis} {n} outside [1, "
                                f"{MAX_GRID_YZ}]")
    t = launch.threads
    bound = L.LAUNCH_BOUNDS.get(launch.kernel, MAX_THREADS)
    if t < 1 or t % WARP or t > min(MAX_THREADS, bound):
        flag("launch-threads",
             f"{t} threads a block: not a multiple of {WARP} in [32, "
             f"{min(MAX_THREADS, bound)}] (__launch_bounds__ {bound})")
    if launch.static_smem > MAX_STATIC_SMEM:
        flag("launch-static-smem",
             f"{launch.static_smem} B of static shared memory exceeds "
             f"{MAX_STATIC_SMEM} B")
    dyn = launch.dynamic_smem
    if dyn + launch.static_smem > optin:
        flag("launch-dynamic-smem",
             f"{dyn} B dynamic + {launch.static_smem} B static shared "
             f"memory exceeds the {optin} B opt-in")
    elif dyn > DEFAULT_DYNAMIC_SMEM and not launch.opt_in:
        flag("launch-dynamic-smem",
             f"{dyn} B of dynamic shared memory above "
             f"{DEFAULT_DYNAMIC_SMEM} B without raising the limit "
             f"(cudaFuncAttributeMaxDynamicSharedMemorySize)")
    if launch.cooperative:
        ctas = x * y * z
        if resident is None or ctas > resident:
            flag("launch-cooperative",
                 f"a cooperative grid of {ctas} CTAs, more than the "
                 f"{resident} the card holds at once")
    return f


def audit_launch_geometry(**kw) -> Tuple[List[Finding], int]:
    """Every audited launch against the limits: (findings, launches)."""
    launches = audited_launches(**kw)
    findings: List[Finding] = []
    for name, launch, resident in launches:
        findings += check_launch(launch, name, resident,
                                 kw.get("optin", L.HOPPER_SMEM_OPTIN))
    return findings, len(launches)


# ----------------------------------------------------------------------
# constants and coverage
# ----------------------------------------------------------------------


def _csrc() -> str:
    import repro_torch.kernels as kpkg
    return os.path.join(os.path.dirname(os.path.abspath(kpkg.__file__)),
                        "csrc")


_CONSTEXPR = re.compile(r"^constexpr int (k\w+) = ([^;]+);", re.M)


def source_constants(path: str) -> Dict[str, int]:
    """The namespace-level ``constexpr int`` constants of a CUDA source,
    evaluated (integer arithmetic, earlier constants by name)."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    values: Dict[str, int] = {}
    for name, expr in _CONSTEXPR.findall(text):
        py = re.sub(r"(?<![/])/(?![/])", "//", expr.strip())
        if not re.fullmatch(r"[\w\s*+()/-]+", py):
            raise ValueError(f"{path}: cannot evaluate {name} = {expr}")
        values[name] = int(eval(py, {"__builtins__": {}}, dict(values)))
    return values


def audit_constants(csrc: Optional[str] = None) -> List[Finding]:
    """Each source's constants against ``kernels.launch.CUDA_CONSTANTS``."""
    csrc = csrc or _csrc()
    findings: List[Finding] = []
    for fname, want in L.CUDA_CONSTANTS.items():
        path = os.path.join(csrc, fname)
        got = source_constants(path)
        for name in sorted(set(want) | set(got)):
            if got.get(name) != want.get(name):
                findings.append(Finding(
                    "launch-constant-drift", path, 0,
                    f"{name}: the source has {got.get(name)}, "
                    f"kernels/launch.py {want.get(name)}"))
    return findings


_SITE = re.compile(
    r"(\w+)\s*(?:<[^<>;]*>)?\s*<<<|cudaLaunchCooperativeKernel\s*\(\s*"
    r"\(void\s*\*\)\s*(\w+)")
_ALIAS = re.compile(r"auto\s+(\w+)\s*=\s*(\w+)\s*<")


def launch_sites(path: str) -> List[Tuple[str, int]]:
    """(kernel base name, line) of each ``<<<`` or
    ``cudaLaunchCooperativeKernel`` site in a CUDA source; a local alias
    (``auto kernel = name<...>``) resolves to the kernel it names."""
    sites = []
    aliases: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh, start=1):
            code = line.split("//", 1)[0]
            for alias, target in _ALIAS.findall(code):
                aliases[alias] = target
            for m in _SITE.finditer(code):
                name = m.group(1) or m.group(2)
                sites.append((aliases.get(name, name), i))
    return sites


def audit_call_sites(csrc: Optional[str] = None,
                     tests_dir: Optional[str] = None) -> List[Finding]:
    """The coverage checks (see the module doc).  The test-reference
    check is skipped where the tests are not on disk (an installed
    package)."""
    from repro_torch.kernels import ops, ref

    csrc = csrc or _csrc()
    if tests_dir is None:
        tests_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.dirname(csrc)))), "tests")
    test_src = ""
    for name in KERNEL_TESTS:
        path = os.path.join(tests_dir, name)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                test_src += fh.read()

    findings: List[Finding] = []
    for key in sorted(ops.launch_counts()):
        twin = PLAIN_TWINS.get(key)
        if twin is None or not hasattr(ref, twin):
            findings.append(Finding(
                "launch-missing-twin", "kernels/ops.py", 0,
                f"launch-counted kernel {key!r} has no plain twin in "
                f"kernels/ref.py (registered: {twin!r})"))
        if test_src and not re.search(rf"\b{key}\b", test_src):
            findings.append(Finding(
                "launch-missing-test", "kernels/ops.py", 0,
                f"launch-counted kernel {key!r} is referenced by none of "
                f"{', '.join(KERNEL_TESTS)}"))
    launched = set()
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith(".cu"):
            continue
        path = os.path.join(csrc, fname)
        for kernel, line in launch_sites(path):
            launched.add(kernel)
            if KERNELS.get(kernel) != fname:
                findings.append(Finding(
                    "launch-unaudited-site", path, line,
                    f"launch of {kernel!r} is not registered in "
                    f"analysis.launch_audit.KERNELS for {fname}"))
    for kernel in sorted(set(KERNELS) - launched):
        findings.append(Finding(
            "launch-unaudited-site", os.path.join(csrc, KERNELS[kernel]), 0,
            f"registered kernel {kernel!r} has no launch site"))
    return findings


def audit_kernels(**kw) -> List[Finding]:
    """The whole audit on the CPU: limits, constants and coverage."""
    findings, _ = audit_launch_geometry(**kw)
    return findings + audit_constants() + audit_call_sites()


# ----------------------------------------------------------------------
# on the card: the data against the built extension
# ----------------------------------------------------------------------


def _multi_shapes() -> Iterable[Tuple[int, int, bool, bool]]:
    for _label, B, N in QP_SHAPES:
        for bf16 in (False, True):
            for fold in (False, True):
                yield B, N, bf16, fold


def audit_extension(ext, device) -> Tuple[List[Finding], dict]:
    """Hold the audit's data against the built extension on ``device``
    (a CUDA device): ``kernel_info()`` (static shared bytes equal, maximum
    threads at least every audited launch's), and ``qp_multi_shape``
    equal to :func:`kernels.launch.qp_multi_shape` at every multi shape.
    The card answers the SM count, the opt-in shared size and the grid
    path's CTAs an SM holds (``qp_multi_shape`` at a batch larger than
    any card holds gives the resident CTAs).  Then the limits at the
    card's own values.  Returns (findings, a record)."""
    import torch

    props = torch.cuda.get_device_properties(device)
    sms = props.multi_processor_count
    optin = getattr(props, "shared_memory_per_block_optin", None)
    optin_from_card = optin is not None
    optin = optin if optin_from_card else L.HOPPER_SMEM_OPTIN
    findings: List[Finding] = []

    per_sm: Dict[Tuple[bool, bool, int], int] = {}
    big = 1 << 16        # more problems than any card's resident CTAs
    for _B, N, bf16, fold in _multi_shapes():
        key = (bf16, fold, N)
        if key in per_sm:
            continue
        path, blocks, _slots, _smem = ext.qp_multi_shape(bf16, fold, big, N)
        if path == 1:
            if blocks % sms:
                findings.append(Finding(
                    "launch-ext-mismatch", "qp_multi_shape", 0,
                    f"{blocks} resident CTAs at N={N} is not a whole "
                    f"number per SM of {sms}"))
            per_sm[key] = blocks // sms

    compared = []
    for B, N, bf16, fold in _multi_shapes():
        got = ext.qp_multi_shape(bf16, fold, B, N)
        want = L.qp_multi_shape(
            B, N, bf16=bf16, sms=sms, optin=optin,
            ctas_per_sm=per_sm.get((bf16, fold, N),
                                   L.MULTI_GRID_CTAS_PER_SM))
        want_t = (L.MULTI_PATHS.index(want["path"]), want["blocks"],
                  want["slots"], want["smem"])
        compared.append({"B": B, "N": N, "bf16": bf16, "fold": fold,
                         "path": want["path"], "blocks": want["blocks"],
                         "slots": want["slots"], "smem": want["smem"]})
        if tuple(got) != want_t:
            findings.append(Finding(
                "launch-ext-mismatch", "qp_multi_shape", 0,
                f"B={B} N={N} bf16={bf16} fold={fold}: the extension "
                f"says (path, CTAs, slots, smem) = {tuple(got)}, "
                f"kernels/launch.py {want_t}"))

    launches = audited_launches(sms=sms, ctas_per_sm=per_sm, optin=optin)
    for name, launch, resident in launches:
        findings += check_launch(launch, name, resident, optin)
    most_threads: Dict[str, int] = {}
    for _name, launch, _resident in launches:
        most_threads[launch.kernel] = max(
            most_threads.get(launch.kernel, 0), launch.threads)
    info = {name: (static, max_threads) for name, _regs, static, _local,
            max_threads in ext.kernel_info()}
    for kernel in sorted(set(info) | set(L.STATIC_SMEM)):
        if kernel not in info or kernel not in L.STATIC_SMEM:
            findings.append(Finding(
                "launch-ext-mismatch", "kernel_info", 0,
                f"{kernel!r} is in only one of kernel_info() and "
                f"kernels/launch.py"))
            continue
        static, max_threads = info[kernel]
        if static != L.STATIC_SMEM[kernel]:
            findings.append(Finding(
                "launch-ext-mismatch", "kernel_info", 0,
                f"{kernel}: {static} B of static shared memory built, "
                f"kernels/launch.py says {L.STATIC_SMEM[kernel]} B"))
        if max_threads < most_threads.get(kernel, 0):
            findings.append(Finding(
                "launch-ext-mismatch", "kernel_info", 0,
                f"{kernel}: launched with {most_threads[kernel]} threads, "
                f"the built kernel takes at most {max_threads}"))
    record = {
        "sms": sms, "optin": optin, "optin_from_card": optin_from_card,
        "grid_ctas_per_sm": sorted({v for v in per_sm.values()}),
        "kGridCtasPerSm": L.MULTI_GRID_CTAS_PER_SM,
        "kernel_info_compared": len(info),
        "multi_shapes_compared": len(compared),
        "launches_checked": len(launches),
    }
    return findings, record
