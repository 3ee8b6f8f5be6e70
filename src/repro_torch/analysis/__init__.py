"""Static analysis and sanitizers for the port (twin of
``repro.analysis``).

The port's contracts (no TF32 in fp32, no host sync in the ADMM step,
bitwise across backends where the port promises it, one Gram launch per
fit and one ``gemm_rows`` launch per served batch, launches within
Hopper's limits) are checked here, not only by tests at run time:

- :mod:`repro_torch.analysis.linter` / :mod:`repro_torch.analysis.rules`:
  an AST lint with the port's rules, each born from a real bug or a
  standing contract (the catalog: ``python -m repro_torch.analysis
  --list-rules``, and README.md).
- :mod:`repro_torch.analysis.dispatch_audit`: runs the real entry points
  under a ``TorchDispatchMode`` and denies float64, unintended bf16/f16,
  unordered accumulations and device random ops; the ``call_counter``
  and the launch guard.
- :mod:`repro_torch.analysis.launch_audit`: each CUDA kernel's launch
  geometry (``repro_torch.kernels.launch``) against Hopper's limits, the
  sources' constants and coverage, and on the card against the built
  extension.
- :mod:`repro_torch.analysis.substrate`: the import graph's reachability
  (informational, never a failure).

CLI: ``python -m repro_torch.analysis src/repro_torch --device cpu``
(the card is the default device) exits 1 on any unsuppressed finding.
Suppress one finding with ``# repro: noqa[rule-id] — reason`` (the
reason is mandatory).
"""
from repro_torch.analysis.linter import (Finding, lint_paths, lint_source,
                                         render_text)
from repro_torch.analysis.rules import all_rules, get_rule
from repro_torch.analysis.dispatch_audit import (audit_fn, call_counter,
                                                 launch_guard)
from repro_torch.analysis.launch_audit import audit_kernels
from repro_torch.analysis.substrate import substrate_report

__all__ = [
    "Finding", "lint_paths", "lint_source", "render_text",
    "all_rules", "get_rule",
    "audit_fn", "call_counter", "launch_guard",
    "audit_kernels", "substrate_report",
]
