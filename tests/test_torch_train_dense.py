"""The port's allreduce training path on the dense family (qwen2,
qwen2.5, gemma2 and gemma3 with their local layers and softcaps,
internvl2 with its vision prefix) against the reference's on the CPU,
with ``test_torch_train.py``'s helpers and tolerances: fp32 loss,
logits and every gradient leaf, and one ``make_train_step``; and
gemma2's gradients across the masked KV blocks of ``_flash_sdpa``.
"""
import numpy as np
import pytest
import torch

from test_torch_train import (LOSS_RTOL, _jgrad, check_forward_train,
                              check_train_steps, close_grads, grads_of,
                              leaves, train_batch, train_models)

DENSE = ("qwen2-0.5b", "qwen2.5-32b", "gemma2-2b", "gemma3-12b",
         "internvl2-2b")


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_the_reference(arch):
    check_forward_train(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_the_reference(arch):
    check_train_steps(arch)


def test_gradients_are_finite_across_masked_kv_blocks():
    """gemma2 at 4096 tokens: both layers attend through ``_flash_sdpa``
    (512-query by 2048-key blocks), where the causal mask and the local
    layer's 64-token window mask whole key blocks; its ``-inf`` scores
    and the ``torch.where`` around ``exp`` must carry no NaN or inf into
    the backward.  Held against the reference's gradients too."""
    jcfg, cfg, params, net = train_models("gemma2-2b")
    jb, tb = train_batch(cfg, B=1, S=4096)
    _, loss, g = grads_of(net, cfg, tb)
    assert bool(torch.isfinite(loss))
    assert all(np.isfinite(a).all() for a in leaves(g))
    (jl, _), jg = _jgrad(jcfg)(params, jb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    close_grads(g, jg)
