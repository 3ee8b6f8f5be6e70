#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--out FILE]

Runs from the root of a checkout, on a machine with one CUDA card, the
CUDA toolkit and ninja; it builds the hand kernels itself into
``build/repro_torch_kernels/``.  Every phase prints one JSON line, and
any failure raises and exits non-zero:

1. the card (name and power limit, as nvidia-smi gives them);
2. the kernel build: its seconds, and registers / shared / local memory
   of every kernel as the compiler left them;
3. each kernel against its plain PyTorch version on the card, in the
   paper regime (B=20 problems, N=60, D=11: the quickstart's shapes) and
   the large regime (B=2, N=20000, D=257: benchmarks/bench_scale.py's
   large_fit), with the error, the kernel's ms, the plain version's ms,
   the bound's ms and one library call's ms where there is one (the
   error at most 3e-5 (f32) or 1e-2 (bf16) of the plain result's largest
   magnitude, and for the QP kernels less than the plain solve moves lam
   from its warm start);
4. the main path: the quickstart (DTSVM and DSVM, V=10, T=2, N=60,
   p=10, 60 ADMM iterations of 100 QP iterations) through
   ``repro_torch.quickstart.main(device="cuda")`` for every QP engine,
   each against the same on the CPU (risk gap <= 1e-3), with the kernel
   launch counts set to 0 just before each engine's fits and read just
   after: each must equal what the engine's config implies;
5. the large fit (V=2, T=1, N=20000, p=256, 2 ADMM iterations of 10 QP
   iterations, pallas_fused_multi in f32 and bf16) against the same fit
   on the CPU, its launch counts kept the same way;
6. a torch.profiler trace of each quickstart engine: device busy share
   and kernel launches;
7. the ``kernels`` line, the card line, and the result line.

Without a CUDA device, or without the rest of the repository beside it,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores (the port's fp32 never uses TF32).
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

# (name in the kernels line, source, the TPU kernel it replaces)
KERNELS = {
    "weighted_gram": ("src/repro_torch/kernels/csrc/gram.cu",
                      "src/repro/kernels/gram.py:77"),
    "qp_pg_step": ("src/repro_torch/kernels/csrc/qp_step.cu",
                   "src/repro/kernels/qp_step.py:76"),
    "qp_pg_multi": ("src/repro_torch/kernels/csrc/qp_multi.cu",
                    "src/repro/kernels/qp_step.py:238"),
}
# the quickstart's engine runs: (label, SolverConfig overrides)
ENGINE_RUNS = [
    ("fista", {"qp_solver": "fista"}),
    ("pg", {"qp_solver": "pg"}),
    ("pallas_fused", {"qp_solver": "pallas_fused"}),
    ("pallas_fused_multi/f32", {"qp_solver": "pallas_fused_multi"}),
    ("pallas_fused_multi/bf16", {"qp_solver": "pallas_fused_multi",
                                 "qp_precision": "bf16"}),
]
LARGE_FIT = dict(V=2, T=1, N=20000, p=256, iters=2, qp_iters=10)
REGIMES = {"paper": dict(B=20, N=60, D=11, iters=100, reps=200),
           "large": dict(B=2, N=20000, D=257, iters=10, reps=5)}
# a kernel's largest error against its plain version, relative to the
# plain result's largest magnitude (no floor: lam lies in [0, 0.02] in the
# large regime, and an absolute limit there would pass a kernel that
# returned its warm start)
RTOL = {"f32": 3e-5, "bf16": 1e-2}
# the large fit on the card against the same fit on the CPU, relative to
# each state leaf's largest magnitude: besides the kernels, two ADMM
# iterations of cuBLAS products stand against the CPU's
RTOL_FIT = {"f32": 1e-4, "bf16": 1e-2}

RECORDS = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls (CUDA
    events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, rtol):
    """(largest error, largest magnitude of ``want``, within ``rtol`` of
    that magnitude)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, scale, err <= rtol * scale


def moved(want, lam0, hi) -> float:
    """How far the plain solve moved lam from its clipped warm start.  The
    check of a QP kernel must allow less than this, or a kernel that did
    nothing would pass it."""
    return float((want - torch.minimum(lam0.clamp_min(0.0), hi)).abs().max())


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version on the card
# ---------------------------------------------------------------------------
def regime_inputs(name: str, dev):
    """Operands at a regime's shapes.  Paper: the quickstart's own DTSVM
    invariants.  Large: bench_scale's large_fit data (seeded)."""
    from repro_torch.engine import invariants
    from repro_torch.core import dtsvm
    from repro_torch import quickstart

    r = REGIMES[name]
    if name == "paper":
        data, adj = quickstart.data_and_graph()
        prob = dtsvm.make_problem(data["X"], data["y"], data["mask"], adj,
                                  C=0.01, device=dev)
        inv = invariants.compute_invariants(prob)
        Z, a, hi = (inv.Z.reshape(r["B"], r["N"], r["D"]),
                    inv.a.reshape(r["B"], r["D"]),
                    inv.hi.reshape(r["B"], r["N"]))
    else:
        rng = np.random.default_rng(0)
        Z = torch.from_numpy(rng.normal(size=(r["B"], r["N"], r["D"]))
                             .astype(np.float32)).to(dev)
        a = torch.from_numpy(rng.uniform(0.05, 0.5, size=(r["B"], r["D"]))
                             .astype(np.float32)).to(dev)
        hi = torch.full((r["B"], r["N"]), 0.02, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    q = 1.0 + 0.1 * torch.randn(hi.shape, generator=gen, device=dev)
    lam0 = hi * torch.rand(hi.shape, generator=gen, device=dev)
    return Z, a, q, hi, lam0


def check_kernels(dev) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.core import qp

    cases = {k: [] for k in KERNELS}
    for regime, r in REGIMES.items():
        B, N, D, iters, reps = r["B"], r["N"], r["D"], r["iters"], r["reps"]
        Z, a, q, hi, lam0 = regime_inputs(regime, dev)
        shape = {"regime": regime, "B": B, "N": N, "D": D}

        # the weighted Gram build
        K = ops.weighted_gram(Z, a)
        K_plain = ref.weighted_gram(Z, a)
        torch.cuda.synchronize()
        err, scale, ok = max_err(K, K_plain, RTOL["f32"])
        # K is symmetric: the function needs N(N+1)/2 dot products of
        # length D per problem, and the scaling of Z by a
        b_ms, b_by = bound(4 * (B * N * D + B * D + B * N * N),
                           B * N * (N + 1) * D + B * N * D)
        rec = dict(shape, max_abs_err=err, max_abs_plain=scale,
                   rtol=RTOL["f32"],
                   ms=cuda_ms(lambda: ops.weighted_gram(Z, a), reps),
                   plain_ms=cuda_ms(lambda: ref.weighted_gram(Z, a), reps),
                   library_ms=cuda_ms(lambda: torch.einsum(
                       "bnd,bd,bmd->bnm", Z, a, Z), reps),
                   bound_ms=b_ms, bound_by=b_by)
        del K_plain
        emit({"kernel_check": "weighted_gram", **rec})
        if not ok:
            raise AssertionError(f"weighted_gram disagrees: {rec}")
        cases["weighted_gram"].append(rec)

        gamma = 1.0 / qp.gershgorin_lipschitz(K)

        # one fused PG step
        out = ops.qp_pg_step(lam0, K, q, hi, gamma)
        out_plain = ref.qp_pg_step(lam0, K, q, hi, gamma)
        torch.cuda.synchronize()
        err, scale, ok = max_err(out, out_plain, RTOL["f32"])
        lam_moved = moved(out_plain, lam0, hi)
        ok = ok and RTOL["f32"] * scale < lam_moved
        b_ms, b_by = bound(4 * (B * N * N + 4 * B * N + B),
                           2 * B * N * N + 5 * B * N)
        rec = dict(shape, max_abs_err=err, max_abs_plain=scale,
                   rtol=RTOL["f32"], moved_from_warm_start=lam_moved,
                   ms=cuda_ms(lambda: ops.qp_pg_step(lam0, K, q, hi, gamma),
                              reps * 4),
                   plain_ms=cuda_ms(
                       lambda: ref.qp_pg_step(lam0, K, q, hi, gamma),
                       reps * 4),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit({"kernel_check": "qp_pg_step", **rec})
        if not ok:
            raise AssertionError(f"qp_pg_step disagrees: {rec}")
        cases["qp_pg_step"].append(rec)

        # the fused multi-iteration solve, f32 and bf16, with and without
        # the zl fold
        for precision in ("f32", "bf16"):
            for fold in (False, True):
                Zf = Z if fold else None
                run = lambda: ops.qp_pg_multi(lam0, K, q, hi, gamma,
                                              iters=iters, Z=Zf,
                                              precision=precision)
                run_plain = lambda: ref.qp_pg_multi(
                    lam0, K, q, hi, gamma, iters=iters, Z=Zf,
                    precision=precision)
                got, want = run(), run_plain()
                torch.cuda.synchronize()
                pairs = zip(got, want) if fold else [(got, want)]
                errs = [max_err(g, w, RTOL[precision]) for g, w in pairs]
                lam_moved = moved(want[0] if fold else want, lam0, hi)
                discriminates = RTOL[precision] * errs[0][1] < lam_moved
                b_ms, b_by = bound(
                    4 * (B * N * N + 4 * B * N + B
                         + (B * N * D + B * D if fold else 0)),
                    iters * (2 * B * N * N + 5 * B * N)
                    + (2 * B * N * D if fold else 0))
                rec = dict(shape, precision=precision, fold=fold,
                           iters=iters, max_abs_err=max(e[0] for e in errs),
                           max_abs_plain=errs[0][1],
                           zl_max_abs_err=errs[1][0] if fold else None,
                           zl_max_abs_plain=errs[1][1] if fold else None,
                           rtol=RTOL[precision],
                           moved_from_warm_start=lam_moved,
                           ms=cuda_ms(run, max(reps // 2, 3)),
                           plain_ms=cuda_ms(run_plain, max(reps // 20, 2),
                                            warmup=1),
                           library_ms=None, bound_ms=b_ms, bound_by=b_by)
                emit({"kernel_check": "qp_pg_multi", **rec})
                if not (discriminates and all(e[2] for e in errs)):
                    raise AssertionError(f"qp_pg_multi disagrees: {rec}")
                cases["qp_pg_multi"].append(rec)
        del K
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------
def risk_gap(a: dict, b: dict) -> float:
    return max(abs(x - y) for k in ("dtsvm", "dsvm")
               for x, y in zip(a[k], b[k]))


def expected_launches(qp_solver: str, fits: int, iters: int,
                      qp_iters: int) -> dict:
    """The launches of each kernel that ``fits`` fits must make: the Gram
    once per fit, the step kernel qp_iters times per ADMM iteration with
    ``pallas_fused``, the multi kernel once per ADMM iteration with
    ``pallas_fused_multi`` (every problem of a fit in one launch)."""
    return {"weighted_gram": fits,
            "qp_pg_step": (fits * iters * qp_iters
                           if qp_solver == "pallas_fused" else 0),
            "qp_pg_multi": (fits * iters
                            if qp_solver == "pallas_fused_multi" else 0)}


def check_launches(path: str, launches: dict, want: dict) -> None:
    emit({"path_launches": path, "launches": launches, "expected": want})
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches}, "
                             f"expected {want}")


def main_path(by_path: dict) -> None:
    """The quickstart per engine; each engine's launches are counted from
    0 just before its fits on the card and read just after."""
    from repro_torch import quickstart
    from repro_torch.kernels import ops

    for label, kw in ENGINE_RUNS:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        gpu = quickstart.main(device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[f"quickstart/{label}"] = launches = ops.launch_counts()
        cpu = quickstart.main(device="cpu", **kw)
        gap = risk_gap(gpu, cpu)
        emit({"quickstart": label, "wall_s": wall, "risks_cuda": gpu,
              "risks_cpu": cpu, "risk_gap": gap})
        # DTSVM and DSVM: two fits of quickstart.main's config
        check_launches(f"quickstart/{label}", launches, expected_launches(
            kw["qp_solver"], fits=2, iters=60, qp_iters=100))
        if not gap <= 1e-3:
            raise AssertionError(f"{label}: risks on the card differ from "
                                 f"the CPU by {gap}")
        if not gpu["dtsvm"][0] < gpu["dsvm"][0]:
            raise AssertionError(f"{label}: no transfer gain {gpu}")


def large_fit(by_path: dict) -> None:
    """The large fit per precision (the only path that takes the multi
    kernel's cooperative grid), its launches counted like main_path's."""
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import graph
    from repro_torch.kernels import ops

    V, T, N, p = (LARGE_FIT[k] for k in ("V", "T", "N", "p"))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(V, T, N, p)).astype(np.float32)
    y = np.sign(rng.normal(size=(V, T, N))).astype(np.float32)
    y = np.where(y == 0, 1.0, y).astype(np.float32)
    adj = graph.make_graph("ring", V, seed=0)
    for precision in ("f32", "bf16"):
        cfg = SolverConfig(C=0.01, iters=LARGE_FIT["iters"],
                           qp_iters=LARGE_FIT["qp_iters"],
                           qp_solver="pallas_fused_multi",
                           qp_precision=precision)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fit = DTSVM(cfg, device="cuda").fit(X, y, adj=adj)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        by_path[f"large_fit/{precision}"] = launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        st = fit.state_
        finite = all(bool(torch.isfinite(t).all()) for t in st)
        cpu = DTSVM(cfg, device="cpu").fit(X, y, adj=adj).state_
        errs = {}
        for name, g, c in zip(st._fields, st, cpu):
            errs[name] = max_err(g.cpu(), c, RTOL_FIT[precision])
        emit({"large_fit": precision, **LARGE_FIT, "fit_s": fit_s,
              "peak_mem_bytes": peak, "finite": finite,
              "vs_cpu_max_abs_err": {k: e[0] for k, e in errs.items()},
              "cpu_max_abs": {k: e[1] for k, e in errs.items()},
              "rtol": RTOL_FIT[precision]})
        check_launches(f"large_fit/{precision}", launches, expected_launches(
            "pallas_fused_multi", fits=1, iters=LARGE_FIT["iters"],
            qp_iters=LARGE_FIT["qp_iters"]))
        if not finite:
            raise AssertionError("the large fit's state is not finite")
        if not all(e[2] for e in errs.values()):
            raise AssertionError(f"large fit on the card differs from the "
                                 f"CPU: {errs}")
        del fit, st, cpu
    torch.cuda.empty_cache()


def profile_engines() -> dict:
    """Trace each quickstart engine; returns the launches of each hand
    kernel the profiler saw over all of them."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import quickstart

    ours = {"weighted_gram": "gram_kernel", "qp_pg_step": "qp_step_kernel",
            "qp_pg_multi": "qp_multi_"}
    seen = {k: 0 for k in ours}
    for label, kw in ENGINE_RUNS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            quickstart.main(device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us, launches, per_kernel = 0.0, 0, {k: 0 for k in ours}
        top = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            busy_us += dev_us
            launches += ev.count
            top.append((dev_us, ev.key[:80], ev.count))
            for k, frag in ours.items():
                if frag in ev.key:
                    per_kernel[k] += ev.count
        for k in ours:
            seen[k] += per_kernel[k]
        top.sort(reverse=True)
        rec = {"profile": label, "traced_wall_s": wall,
               "device_busy_s": busy_us / 1e6,
               "device_busy_share": busy_us / 1e6 / wall,
               "device_launches": launches, "our_kernels": per_kernel,
               "top": [{"name": n, "calls": c, "device_ms": t / 1e3}
                       for t, n, c in top[:5]]}
        emit(rec)
    if not all(seen.values()):
        raise AssertionError(f"the profiler saw none of some kernels: "
                             f"{seen}")
    return seen


# ---------------------------------------------------------------------------
def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import device as device_lib
    from repro_torch.kernels import build

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for fp32 matmuls")
    dev = device_lib.resolve("cuda")
    smi = nvidia_smi()
    name, limit = (s.strip() for s in smi.split(",", 1))
    emit({"card": name, "power_limit": limit,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    ext = build.extension()
    emit({"build_s": build.build_seconds, "kernel_info": [
        {"kernel": k, "registers": r, "static_shared_bytes": s,
         "local_bytes": loc, "max_threads": m}
        for k, r, s, loc, m in ext.kernel_info()]})

    cases = check_kernels(dev)
    by_path = {}
    main_path(by_path)
    large_fit(by_path)
    traced = profile_engines()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 came on during the run")

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        large = [c for c in cases[kname] if c["regime"] == "large"
                 and c.get("precision", "f32") == "f32"
                 and c.get("fold", True)][0]
        per_path = {path: n[kname] for path, n in by_path.items()}
        if not sum(per_path.values()) > 0:
            raise AssertionError(f"{kname} never launched on the main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "profiler_launches": traced[kname],
            "max_abs_err": large["max_abs_err"],
            "ms": large["ms"], "plain_ms": large["plain_ms"],
            "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
            "library_ms": large["library_ms"], "cases": cases[kname]})
    emit({"kernels": kernels})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RECORDS, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
