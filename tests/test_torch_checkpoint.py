"""The port's msgpack checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``, tests/test_checkpoint.py): bitwise
round trips of every leaf dtype (torch bf16 included), the step index,
retention, corrupt files and the fallback; the port's own msgpack codec
byte for byte against the ``msgpack`` package; and files crossing
between the two packages in both directions, bitwise."""
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro_torch import checkpoint
from repro_torch.checkpoint import (CheckpointError, available_steps,
                                    gc_steps, latest_step, restore_latest,
                                    save_step)
from repro_torch.checkpoint import _msgpack, msgpack_ckpt


def _raw(x) -> tuple:
    """(dtype name, shape, raw bytes) of a numpy or torch leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return ("bfloat16", tuple(x.shape),
                    x.contiguous().reshape(-1).view(torch.int16).numpy()
                    .tobytes())
        x = x.numpy()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, z in zip(la, lb):
        if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
            assert _raw(x) == _raw(z)
        else:
            assert x == z and type(x) is type(z)


def _roundtrip(tmp_path, tree):
    path = os.path.join(tmp_path, "t.msgpack")
    checkpoint.save(path, tree)
    return checkpoint.load(path)


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------
LEAVES = {
    "f32-scalar": np.float32(1.5),
    "bool-scalar": np.bool_(True),
    "0d-f32": np.asarray(0.1, np.float32),
    "empty": np.zeros((0,), np.float32),
    "empty-3d": np.zeros((3, 0, 2), np.float64),
    "bools": np.asarray([True, False, True]),
    "int32": np.arange(6, dtype=np.int32).reshape(2, 3),
    "int64": np.arange(-3, 3, dtype=np.int64),
    "uint8": np.arange(250, 256, dtype=np.uint8),
    "float16": np.asarray([1.0, -2.5, 65504.0], np.float16),
    "specials": np.asarray([np.nan, np.inf, -np.inf, -0.0], np.float32),
}


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_numpy_leaf_roundtrip_bitwise(tmp_path, name):
    leaf = LEAVES[name]
    got = _roundtrip(tmp_path, {"x": leaf})["x"]
    assert isinstance(got, np.ndarray)
    # raw bytes: NaN payloads and -0.0 survive too
    assert _raw(got) == _raw(leaf)


TENSORS = {
    "f32": lambda: torch.tensor([1.0, -0.0, float("nan")]),
    "0d-f32": lambda: torch.tensor(2.25),
    "int32": lambda: torch.arange(6, dtype=torch.int32).reshape(3, 2),
    "bool": lambda: torch.tensor([[True], [False]]),
    "strided": lambda: torch.arange(12.0).reshape(3, 4).t(),
    "bf16": lambda: torch.tensor([1.0, 2.0, -3.5, 1e-3],
                                 dtype=torch.bfloat16),
    "0d-bf16": lambda: torch.tensor(2.5, dtype=torch.bfloat16),
    "empty-bf16": lambda: torch.zeros((2, 0), dtype=torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_tensor_leaf_roundtrip_bitwise(tmp_path, name):
    """A tensor is encoded from ``.detach().cpu()``: it decodes to numpy
    with the same bytes, except bf16, which decodes to a CPU bf16 tensor
    from the same raw bytes."""
    leaf = TENSORS[name]()
    got = _roundtrip(tmp_path, {"x": leaf})["x"]
    if leaf.dtype == torch.bfloat16:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == torch.bfloat16
    else:
        assert isinstance(got, np.ndarray)
    assert _raw(got) == _raw(leaf.contiguous())


def test_nested_structure_roundtrip(tmp_path):
    tree = {
        "a": [np.float32(3.0), {"b": (np.arange(4),
                                      np.zeros((0, 2), np.float32))}],
        "c": {"d": None, "e": True, "f": 7, "g": "hi", "h": 2.5},
        "t": (1, (2, [np.bool_(False)])),
        "u": torch.ones(2, 3),
    }
    got = _roundtrip(tmp_path, tree)
    # tuples stay tuples, lists stay lists, None/str/bool/int pass through
    assert isinstance(got["a"], list) and isinstance(got["t"], tuple)
    assert got["c"]["d"] is None and got["c"]["g"] == "hi"
    _leaves_equal(tree, got)


def test_namedtuple_flattens_to_tuple(tmp_path):
    from repro_torch.net.fabric import FabricState
    n = len(FabricState._fields)
    st = FabricState(*[torch.tensor(float(i)) for i in range(n)])
    got = _roundtrip(tmp_path, {"st": st})["st"]
    assert type(got) is tuple and len(got) == n
    _leaves_equal(tuple(st), got)


def test_unserializable_raises():
    with pytest.raises(TypeError, match="cannot serialize"):
        msgpack_ckpt._encode(object())
    with pytest.raises(TypeError):
        _msgpack.packb({"x": {1, 2}})


@pytest.mark.parametrize("raw,match", [
    (b"\xc1", "unsupported"),                   # the never-used type byte
    (b"\xd4\x01\x00", "unsupported"),           # fixext 1
    (b"\x93\x01", "truncated"),                 # array of 3, one item
    (b"\xc5\x00\x10abc", "truncated"),          # bin 16 of 16 bytes, 3
    (b"\x81\x01\x02", "map key"),               # int map key
    (b"\x01\x02", "extra data"),                # bytes past the object
])
def test_unpackb_rejects(raw, match):
    with pytest.raises(ValueError, match=match):
        _msgpack.unpackb(raw)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # optional test dependency
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    _DTYPES = [np.dtype(np.float32), np.dtype(np.float64),
               np.dtype(np.int32), np.dtype(np.int8), np.dtype(bool)]

    @st.composite
    def _arrays(draw):
        dt = draw(st.sampled_from(_DTYPES))
        shape = tuple(draw(st.lists(st.integers(0, 4), min_size=0,
                                    max_size=3)))
        rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
        if dt == np.dtype(bool):
            arr = rng.integers(0, 2, size=shape).astype(bool)
        elif dt.kind == "f":
            arr = rng.normal(size=shape).astype(dt)
        else:
            arr = rng.integers(-100, 100, size=shape).astype(dt)
        return torch.from_numpy(arr) if draw(st.booleans()) else arr

    def _trees(leaves):
        return st.recursive(
            leaves,
            lambda kids: st.one_of(
                st.lists(kids, max_size=3),
                st.tuples(kids, kids),
                st.dictionaries(st.text(
                    alphabet="abcdefgh", min_size=1, max_size=4),
                    kids, max_size=3)),
            max_leaves=8)

    @settings(max_examples=30, deadline=None, database=None)
    @given(tree=_trees(st.one_of(
        _arrays(), st.none(), st.booleans(),
        st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=False),
        st.text(max_size=40))))
    def test_pytree_roundtrip_property(tmp_path_factory, tree):
        """Any nested tree round-trips bitwise (tensors come back as
        numpy), and the port's bytes are the ``msgpack`` package's."""
        msgpack = pytest.importorskip("msgpack")
        tmp = tmp_path_factory.mktemp("ckpt")
        got = _roundtrip(str(tmp), tree)
        _leaves_equal(tree, got)
        enc = msgpack_ckpt._encode(tree)
        assert _msgpack.packb(enc) == msgpack.packb(enc, use_bin_type=True)


# ---------------------------------------------------------------------------
# the codec against the msgpack package
# ---------------------------------------------------------------------------
_EDGES = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
          2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -2**15,
          -2**15 - 1, -2**31, -2**31 - 1, -2**63, 0.0, -0.0, 1.5, 1e300,
          float("inf"), "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
          "a" * 65536, "é漢", b"", b"x" * 255, b"x" * 256,
          b"x" * 65536, list(range(15)), list(range(16)),
          list(range(65536)), (1, 2), {str(i): i for i in range(15)},
          {str(i): i for i in range(16)},
          {str(i): None for i in range(65536)}]


@pytest.mark.parametrize("i", range(len(_EDGES)))
def test_packb_bytes_equal_msgpack(i):
    """Every header width, at both sides of each boundary."""
    msgpack = pytest.importorskip("msgpack")
    obj = _EDGES[i]
    raw = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_unpackb_reads_float32_and_reference_trees():
    msgpack = pytest.importorskip("msgpack")
    raw = msgpack.packb([1.5, {"a": -2.25}], use_single_float=True)
    assert raw[1] == 0xCA
    assert _msgpack.unpackb(raw) == [1.5, {"a": -2.25}]


def _reference_tree():
    """A tree of every kind the reference writes, numpy leaves only."""
    return {"schema_version": 3, "kind": "online_session",
            "a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "s": np.float32(0.5), "b": np.asarray([True, False]),
            "n": [None, 1.5, -7, "x" * 40, (np.int32(3),)],
            "big": np.zeros((300, 257), np.float32)}


def test_encode_tree_bytes_equal_the_reference():
    """On numpy trees the port's file is the reference's, byte for
    byte."""
    tree = _reference_tree()
    assert msgpack_ckpt.encode_tree(tree) == \
        jcheckpoint.msgpack_ckpt.encode_tree(tree)


def test_reference_file_loads_in_the_port(tmp_path):
    path = os.path.join(str(tmp_path), "ref.msgpack")
    tree = _reference_tree()
    tree["h"] = jnp.asarray([1.0, -2.0, 0.5], jnp.bfloat16)
    tree["h0"] = jnp.asarray(2.5, jnp.bfloat16)
    jcheckpoint.save(path, tree)
    got = checkpoint.load(path)
    for key in ("h", "h0"):
        assert isinstance(got[key], torch.Tensor)
        assert got[key].dtype == torch.bfloat16
        assert _raw(got[key])[1:] == _raw(np.asarray(tree[key]))[1:]
    del tree["h"], tree["h0"], got["h"], got["h0"]
    _leaves_equal(tree, got)


def test_port_file_loads_in_the_reference(tmp_path):
    path = os.path.join(str(tmp_path), "port.msgpack")
    tree = {"x": torch.arange(5.0), "h": torch.tensor(
        [1.0, -2.0, 0.5], dtype=torch.bfloat16), "t": (1, "two", None),
        "m": {"k": np.int64(-9)}}
    checkpoint.save(path, tree)
    got = jcheckpoint.load(path)
    assert str(got["h"].dtype) == "bfloat16"
    assert got["h"].tobytes() == _raw(tree["h"])[2]
    np.testing.assert_array_equal(got["x"], tree["x"].numpy())
    assert got["t"] == (1, "two", None)
    assert got["m"]["k"].dtype == np.int64 and int(got["m"]["k"]) == -9


# ---------------------------------------------------------------------------
# step index: retention GC
# ---------------------------------------------------------------------------
def test_save_step_and_gc_keep_last(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 5, 9):
        save_step(d, step, {"s": np.int32(step)})
    assert available_steps(d) == [1, 2, 5, 9]
    assert latest_step(d) == 9
    assert gc_steps(d, keep_last=2) == [1, 2]
    assert available_steps(d) == [5, 9]
    step, tree = restore_latest(d)
    assert step == 9 and int(tree["s"]) == 9


def test_save_step_with_keep_last_prunes_inline(tmp_path):
    d = str(tmp_path)
    for step in range(6):
        save_step(d, step, {"s": np.int32(step)}, keep_last=3)
    assert available_steps(d) == [3, 4, 5]
    assert latest_step(d) == 5


def test_gc_keep_last_validates(tmp_path):
    with pytest.raises(ValueError, match="keep_last"):
        gc_steps(str(tmp_path), keep_last=0)


def test_gc_noop_when_fewer_steps(tmp_path):
    d = str(tmp_path)
    save_step(d, 1, {"s": np.int32(1)})
    assert gc_steps(d, keep_last=5) == []
    assert available_steps(d) == [1]


# ---------------------------------------------------------------------------
# corruption: clear errors, fallback to the previous step
# ---------------------------------------------------------------------------
def _corrupt(path, payload=b"\x93\x01"):
    with open(path, "wb") as f:
        f.write(payload)


def test_load_truncated_raises_checkpoint_error(tmp_path):
    path = os.path.join(str(tmp_path), "c.msgpack")
    checkpoint.save(path, {"x": np.arange(100)})
    with open(path, "rb") as f:
        raw = f.read()
    _corrupt(path, raw[: len(raw) // 2])
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        checkpoint.load(path)


@pytest.mark.parametrize("payload", [b"", b"not msgpack",
                                     b"\x81\xa1x\x83\xa7__arr__\xc3"
                                     b"\xa5dtype\xa4nope\xa5shape\x90"])
def test_load_empty_or_garbage_raises(tmp_path, payload):
    path = os.path.join(str(tmp_path), "e.msgpack")
    _corrupt(path, payload)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        checkpoint.load(path)


def test_restore_latest_falls_back_past_corrupt_head(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        save_step(d, step, {"s": np.int32(step)})
    _corrupt(os.path.join(d, "ckpt_00000003.msgpack"))
    step, tree = restore_latest(d)            # fallback=True default
    assert step == 2 and int(tree["s"]) == 2
    with pytest.raises(CheckpointError):
        restore_latest(d, fallback=False)


def test_restore_latest_all_corrupt_raises_aggregate(tmp_path):
    d = str(tmp_path)
    for step in (1, 2):
        save_step(d, step, {"s": np.int32(step)})
        _corrupt(os.path.join(d, f"ckpt_{step:08d}.msgpack"))
    with pytest.raises(CheckpointError, match="no readable checkpoint"):
        restore_latest(d)


def test_restore_latest_empty_dir(tmp_path):
    assert restore_latest(str(tmp_path)) == (None, None)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: int


def test_step_files_cross_between_the_packages(tmp_path):
    """A step index written by one package resumes in the other."""
    d = str(tmp_path)
    jcheckpoint.save_step(d, 1, {"s": np.int32(1)})
    save_step(d, 2, {"s": _Pair(torch.tensor(2, dtype=torch.int32), 3)})
    step, tree = jcheckpoint.restore_latest(d)
    assert step == 2 and int(tree["s"][0]) == 2 and tree["s"][1] == 3
    _corrupt(os.path.join(d, "ckpt_00000002.msgpack"))
    step, tree = restore_latest(d)
    assert step == 1 and int(tree["s"]) == 1
