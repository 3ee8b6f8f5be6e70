"""The port's figure runners (``repro_torch.figures``) reproduce the golden
fixtures ``tests/golden/fig{2..7}.json`` on the CPU, through
``repro_torch.figures.golden``.

Each runner is called at its fixture's own ``regime`` (read from the
JSON) and held to the fixtures' ``ATOL = 0.015``
(tests/test_golden_figures.py), the bound the JAX package's own golden
tests use; the observed gap is printed (on this tree about 3e-8; Fig. 7
1.5e-8, its replay audit bitwise inside ``stage_marks``).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.figures import golden

ATOL = 0.015
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes; these runs make many
    tiny torch ops, which intra-op threads would only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.golden
@pytest.mark.parametrize("name", golden.FIGURES)
def test_port_reproduces_the_golden_figure(name):
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        want = json.load(f)
    got = golden.outputs(name, want["regime"], device="cpu")
    assert set(got) == set(want["outputs"])
    gap = 0.0
    for key, val in want["outputs"].items():
        g = np.asarray(got[key], np.float64)
        w = np.asarray(val, np.float64)
        assert g.shape == w.shape, key
        gap = max(gap, float(np.abs(g - w).max()))
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"{name}/{key}")
    print(f"{name}: largest gap to the fixture {gap:.3e}")
