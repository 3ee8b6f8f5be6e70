"""repro_torch.obs — observability (twin of ``repro/obs/``): telemetry
streams, spans, the metrics registry and the timing helper.

Nothing here imports the engine, so every layer can import obs:

- ``obs.telemetry`` — device-side per-iteration ADMM diagnostics
  (primal/dual residuals, per-task disagreement, QP box saturation),
  collected inside the fit's own loop without a sync and copied to the
  host once after it; telemetry-on is bitwise telemetry-off on all
  model outputs.  Enable with ``SolverConfig(telemetry=True)``; read
  ``solver.telemetry_`` / ``session.telemetry_``.
- ``obs.spans`` — host-side phase timing (invariant builds, plan
  compiles, loops, replans, snapshots, serve batches) exported as
  Chrome-trace JSON; each span is also a ``torch.profiler`` range.
- ``obs.registry`` — ``MetricsRegistry``: one versioned JSON document
  absorbing ``net_report_``, serve stats, ``plan_stats`` and telemetry
  summaries, in the reference's format; ``python -m repro_torch.obs
  report`` renders it.
- ``obs.timing.timeit`` — the benchmark-timing helper (warmup +
  ``perf_counter`` + ``torch.cuda.synchronize``).
"""
from repro_torch.obs.registry import OBS_SCHEMA_VERSION, MetricsRegistry
from repro_torch.obs.spans import (clear_spans, dropped_spans, iter_spans,
                                   save_trace, span, to_chrome_trace,
                                   validate_chrome_trace)
from repro_torch.obs.telemetry import (STREAMS, Telemetry,
                                       collect_diagnostics, concat_streams,
                                       materialize, summarize)
from repro_torch.obs.timing import Timing, timeit

__all__ = [
    "OBS_SCHEMA_VERSION", "MetricsRegistry",
    "clear_spans", "dropped_spans", "iter_spans", "save_trace", "span",
    "to_chrome_trace", "validate_chrome_trace",
    "STREAMS", "Telemetry", "collect_diagnostics", "concat_streams",
    "materialize", "summarize",
    "Timing", "timeit",
]
