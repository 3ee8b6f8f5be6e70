"""The port's numpy modules against the reference: the synthetic data and
the graphs must be exactly equal (they are numpy on both sides)."""
import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.data import synthetic as jsynthetic
from repro_torch.core import graph
from repro_torch.data import synthetic


@pytest.mark.parametrize("kw", [
    dict(V=10, T=2, p=10, n_tgt=40, n_src=600, n_test=1800,
         relatedness=0.92, seed=0),
    dict(V=4, T=3, p=5, n_tgt=9, n_src=50, n_test=31, relatedness=0.5,
         seed=3),
    dict(V=3, T=1, p=2, n_tgt=0, n_src=7, n_test=4, relatedness=0.0,
         seed=11),
])
def test_make_multitask_data_exactly_equal(kw):
    kw = dict(kw)
    V, T = kw["V"], kw["T"]
    n_train = np.zeros((V, T), int)
    n_train[:, 0] = synthetic.split_counts(kw.pop("n_tgt"), V)
    n_train[:, 1:] = synthetic.split_counts(kw.pop("n_src"), V)[:, None]
    pos_frac = np.linspace(0.2, 0.8, V * T).reshape(V, T)
    got = synthetic.make_multitask_data(n_train=n_train, pos_frac=pos_frac,
                                        **kw)
    want = jsynthetic.make_multitask_data(n_train=n_train, pos_frac=pos_frac,
                                          **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("total,V", [(40, 10), (600, 10), (7, 3), (0, 4)])
def test_split_counts_exactly_equal(total, V):
    np.testing.assert_array_equal(synthetic.split_counts(total, V),
                                  jsynthetic.split_counts(total, V))


@pytest.mark.parametrize("kind,V,degree,seed", [
    ("ring", 1, 0.8, 0), ("ring", 2, 0.8, 0), ("ring", 7, 0.8, 0),
    ("full", 5, 0.8, 0), ("random", 10, 0.8, 0), ("random", 12, 0.3, 5),
])
def test_graphs_exactly_equal(kind, V, degree, seed):
    got = graph.make_graph(kind, V, degree=degree, seed=seed)
    want = jgraph.make_graph(kind, V, degree=degree, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert graph.is_connected(got) == jgraph.is_connected(want)


def test_is_connected_matches_on_a_split_graph():
    A = np.zeros((4, 4), bool)
    A[0, 1] = A[1, 0] = A[2, 3] = A[3, 2] = True
    assert graph.is_connected(A) is False
    assert jgraph.is_connected(A) is False


def test_unknown_graph_kind_raises():
    with pytest.raises(ValueError):
        graph.make_graph("star", 4)
