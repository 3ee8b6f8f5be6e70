"""GOOD: fp32 precision is read, never written, outside device.py; the
device rule turns TF32 off in one place."""
import torch

from repro_torch import device


def check():
    dev = device.resolve("cpu")
    return dev, torch.backends.cuda.matmul.allow_tf32
