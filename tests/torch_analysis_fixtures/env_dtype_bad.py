"""BAD: env-dependent-dtype — process-wide dtype and fp32 precision
written outside device.py (and TF32 turned on)."""
import torch


def enable_fast_matmul():
    torch.backends.cuda.matmul.allow_tf32 = True


def loosen():
    torch.set_float32_matmul_precision("high")
    torch.set_default_dtype(torch.float64)
