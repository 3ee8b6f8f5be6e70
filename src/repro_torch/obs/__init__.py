"""repro_torch.obs: observability (twin of ``repro/obs/``), so far its
host-side span recorder, ``obs.spans``: phase timings (store snapshots
and restores, serve batches) exported as Chrome-trace JSON.  Telemetry,
the metrics registry and the timing helper are ROADMAP.md, 'Modules to
port', item 5 (observability)."""
from repro_torch.obs.spans import (clear_spans, dropped_spans, iter_spans,
                                   save_trace, span, to_chrome_trace,
                                   validate_chrome_trace)

__all__ = ["clear_spans", "dropped_spans", "iter_spans", "save_trace",
           "span", "to_chrome_trace", "validate_chrome_trace"]
