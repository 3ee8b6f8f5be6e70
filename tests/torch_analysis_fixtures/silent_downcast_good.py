"""GOOD: restore paths pin the dtype or stay in numpy; a non-restore
helper may use torch.as_tensor freely."""
import numpy as np
import torch


def restore_state(tree):
    return {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in tree.items()}


def load_weights(blob):
    return np.asarray(blob["w"])


def decode_leaf(raw):
    return torch.as_tensor(raw, torch.float32)


def project(x):
    return torch.as_tensor(x)
