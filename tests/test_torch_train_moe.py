"""The port's allreduce training path on the mixture-of-experts family
(phi3.5-moe, and deepseek-v2 with its latent attention and a dense
leading layer) against the reference's on the CPU, with
``test_torch_train.py``'s helpers and tolerances.

Each MoE layer's aux load-balance loss is part of the loss, as in the
reference.  The reduced configs' dropless capacity factor (8.0 = E / K
or more) keeps drops out, so no top-k pick depends on the batch; the
fp32 routing of both packages picks the same experts for every token
of these inputs (the losses agree to ~1e-7).
"""
import pytest

from test_torch_train import (check_bf16_grads, check_forward_train,
                              check_remat, check_train_steps)

MOE = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")


@pytest.mark.parametrize("arch", MOE)
def test_forward_train_matches_the_reference(arch):
    check_forward_train(arch)


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_the_reference(arch):
    check_train_steps(arch)


def test_two_train_steps_match_the_reference():
    check_train_steps("phi3.5-moe-42b-a6.6b", n_steps=2)


def test_microbatch_matches_the_reference():
    """microbatch=2 over a batch of 4: each chunk routes its own tokens
    (its own groups and capacity), as the reference's scan does."""
    check_train_steps("phi3.5-moe-42b-a6.6b", microbatch=2, B=4)


def test_bf16_gradients_are_as_accurate_as_the_reference():
    """One pick moves at a near tie on these inputs (test_torch_train.py's
    module doc): token (0, 21) of the last layer, left out of the loss."""
    assert list(check_bf16_grads("phi3.5-moe-42b-a6.6b")) == [(1, 21)]


@pytest.mark.parametrize("arch", MOE)
def test_remat_gives_the_same_gradients(arch):
    """The aux loss returned through each checkpointed layer; deepseek's
    dense leading layer is not checkpointed, as in the reference."""
    check_remat(arch)
