"""The port's allreduce training path on the state-space, hybrid and
encoder-decoder families (mamba2, zamba2 with its weight-tied shared
attention block, whisper over stub frames) against the reference's on
the CPU, with ``test_torch_train.py``'s helpers and tolerances.

zamba2's shared block takes gradients from each of its flagged layers
(two in the reduced stack); whisper's encoder, cross attention and both
position tables take theirs through the decoder's loss (``pos_dec``'s
rows past the sequence get zeros, as ``jax.grad`` gives them).
"""
import pytest

from test_torch_train import (check_forward_train, check_remat,
                              check_train_steps)

FAMILIES = ("mamba2-130m", "zamba2-1.2b", "whisper-small")


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_matches_the_reference(arch):
    check_forward_train(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_the_reference(arch):
    check_train_steps(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_gradients(arch):
    """zamba2's shared block runs inside its flagged layers' checkpoint;
    mamba2's SSD, padded or not, recomputes the same."""
    check_remat(arch)
