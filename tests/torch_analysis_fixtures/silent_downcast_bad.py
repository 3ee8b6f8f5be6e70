"""BAD: silent-downcast — torch.as_tensor / torch.tensor without a dtype
on restore paths (the leaf's width follows the input and the default
dtype)."""
import torch


def restore_state(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def load_weights(blob):
    w = torch.tensor(blob["w"])
    return w
