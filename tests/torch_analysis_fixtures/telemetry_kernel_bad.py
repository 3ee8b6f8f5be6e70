"""BAD: telemetry-read-in-kernel — obs reads inside the kernel package."""
import torch

from repro_torch.obs import telemetry


def fused_step(K, q, lam, hi, prob, prev):
    lam = torch.minimum(torch.clamp_min(lam + q - K @ lam, 0.0), hi)
    tel = telemetry.collect_diagnostics(prob, hi, lam, prev)
    return lam, tel
