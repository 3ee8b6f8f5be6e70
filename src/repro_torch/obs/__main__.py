"""CLI for repro_torch.obs: render metrics registries, demo the pipeline
(twin of ``repro/obs/__main__.py``).

    python -m repro_torch.obs report <registry.json>
        Load a MetricsRegistry document (either package's) and print its
        rendered report.

    python -m repro_torch.obs demo [--iters N] [--trace PATH]
                                   [--registry PATH] [--device cuda|cpu]
        Fit a tiny synthetic problem with telemetry + spans enabled on
        the device (default: the card; raises without one unless
        ``--device cpu``), write the Chrome-trace JSON and the
        metrics-registry JSON, and print the report.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.obs.registry import MetricsRegistry


def _cmd_report(args) -> int:
    """Render one registry JSON to stdout."""
    reg = MetricsRegistry.load(args.path)
    print(reg.render())
    return 0


def _cmd_demo(args) -> int:
    """A tiny instrumented fit: telemetry streams + spans + registry."""
    import numpy as np

    from repro_torch import device as device_lib
    from repro_torch import obs
    from repro_torch.api import DTSVM, SolverConfig
    from repro_torch.core import graph
    from repro_torch.data import synthetic

    dev = device_lib.resolve(args.device)     # raises before any output
    obs.clear_spans()
    V, T = 3, 2
    data = synthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=np.full((V, T), 16), n_test=64, seed=0)
    cfg = SolverConfig(iters=args.iters, qp_iters=20, telemetry=True)
    with obs.span("demo_fit", iters=args.iters):
        solver = DTSVM(cfg, device=dev).fit(
            data["X"], data["y"], mask=data["mask"], adj=graph.ring(V))
    reg = MetricsRegistry.from_solver(solver)
    reg.record_spans()
    reg.save(args.registry)
    obs.save_trace(args.trace)
    print(f"wrote {args.trace} ({len(obs.iter_spans())} spans) and "
          f"{args.registry} on {dev}")
    print(reg.render())
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Entry point for ``python -m repro_torch.obs``."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="observability tools: registry reports, demo runs")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_report = sub.add_parser(
        "report", help="render a metrics-registry JSON")
    p_report.add_argument("path", help="registry JSON written by "
                                       "MetricsRegistry.save")
    p_report.set_defaults(fn=_cmd_report)

    p_demo = sub.add_parser(
        "demo", help="instrumented tiny fit; writes trace + registry")
    p_demo.add_argument("--iters", type=int, default=5)
    p_demo.add_argument("--trace", default="obs-trace.json")
    p_demo.add_argument("--registry", default="obs-metrics.json")
    p_demo.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the fit runs (default: the card)")
    p_demo.set_defaults(fn=_cmd_demo)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
