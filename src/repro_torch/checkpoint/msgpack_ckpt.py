"""Msgpack pytree checkpoints (twin of ``repro/checkpoint/msgpack_ckpt.py``).

Arrays are serialized as (dtype, shape, raw bytes), so a round trip is
bitwise, which is what lets the durable session layer
(``repro_torch.store``) promise that save -> restore -> continue equals
the uninterrupted run.  The tree is encoded as nested dicts, lists and
tuples; NamedTuples flatten to plain tuples (callers that need the class
back rebuild it: ``repro_torch.net.fabric.restore_state``).  Writes are
atomic (a temporary file, then a rename), and a ``LATEST`` index file
tracks the newest step for a resume.

The file format is the reference's, byte for byte (map keys sorted, as
the reference's pytree flattening leaves them), written and read by the
port's own msgpack codec (``_msgpack``):

- a ``torch.Tensor`` is encoded from ``.detach().cpu()``; numpy arrays
  and numpy scalars as in the reference (a scalar as a 0-d array);
- arrays decode to numpy, as in the reference, except ``bfloat16``,
  which numpy lacks: such a leaf decodes to a CPU ``torch.bfloat16``
  tensor from the same raw bytes, and a bf16 tensor encodes under the
  dtype name ``"bfloat16"``, as the reference writes one through
  ``ml_dtypes``.

Durability on the step index:

- ``save_step(..., keep_last=k)`` / ``gc_steps``: retention, pruning all
  but the ``k`` newest ``ckpt_*.msgpack`` files after a save;
- ``load`` raises ``CheckpointError`` (with the path and the cause) on a
  truncated, corrupt or empty file;
- ``restore_latest(..., fallback=True)`` walks back past an unreadable
  newest file to the next-newest one.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

_ARR = "__arr__"
_TUP = "__tup__"
_BF16 = "bfloat16"
_STEP_RE = re.compile(r"^ckpt_(\d{8})\.msgpack$")


class CheckpointError(RuntimeError):
    """A checkpoint file could not be read (truncated, corrupt, empty)."""


def _array_record(dtype: str, shape, arr: np.ndarray) -> dict:
    """An array's record; its ``data`` a byte view of ``arr`` in C order
    (copied only where ``arr`` is not contiguous), which the writer packs
    without a copy."""
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return {_ARR: True, "dtype": dtype, "shape": list(shape), "data": data}


def _encode(obj: Any):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _array_record(_BF16, t.shape,
                                 t.reshape(-1).view(torch.int16).numpy())
        obj = t.numpy()
    # np.generic covers numpy scalars (np.float32(0.), np.bool_(True)),
    # which are not ndarrays: they round-trip as 0-d arrays of their dtype
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        return _array_record(str(arr.dtype), arr.shape, arr)
    if isinstance(obj, dict):
        # keys sorted, as the reference's files have them (its encoder
        # reads the tree through jax's pytree flattening, which sorts)
        return {k: _encode(obj[k]) for k in sorted(obj)}
    if isinstance(obj, tuple):           # NamedTuples too
        return {_TUP: [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    raise TypeError(f"cannot serialize {type(obj)}")


def _decode_array(obj: dict):
    shape = [int(n) for n in obj["shape"]]
    data = obj["data"]
    if obj["dtype"] == _BF16:
        if not data:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data),
                                dtype=torch.bfloat16).reshape(shape)
    # numpy, not torch: the caller picks the dtype and the device it
    # wants (repro_torch.store.session_store.restore_session)
    return np.frombuffer(data, dtype=np.dtype(obj["dtype"])).reshape(shape)


def _decode(obj: Any):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            return _decode_array(obj)
        if _TUP in obj:
            return tuple(_decode(v) for v in obj[_TUP])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def encode_tree(tree: Any) -> bytes:
    """One pytree as a standalone msgpack blob."""
    return _msgpack.packb(_encode(tree))


def decode_tree(payload: Any):
    """Inverse of the per-record encoding of ``encode_tree`` (takes the
    already-unpacked msgpack object)."""
    return _decode(payload)


def save(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically: ``encode_tree(tree)``'s
    bytes, streamed to the file from the leaves' own buffers (a train
    state's file is as large as the state; it is never held twice)."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    record = _encode(tree)
    fd, tmp = tempfile.mkstemp(dir=folder)
    with os.fdopen(fd, "wb") as f:
        _msgpack.pack_to(record, f.write)
    os.replace(tmp, path)


def load(path: str) -> Any:
    """Read one checkpoint file; ``CheckpointError`` on a bad read."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if not raw:
            raise ValueError("empty file")
        # each array a read-only view into ``raw``: no second copy
        return _decode(_msgpack.unpackb(raw))
    except (OSError, ValueError, TypeError, KeyError, RuntimeError) as e:
        raise CheckpointError(
            f"checkpoint {path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}); restore an earlier step "
            f"(see restore_latest(..., fallback=True))") from e


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.msgpack")


def available_steps(ckpt_dir: str) -> List[int]:
    """Sorted step numbers with a ``ckpt_*.msgpack`` file on disk."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def gc_steps(ckpt_dir: str, keep_last: int) -> List[int]:
    """Delete all but the ``keep_last`` newest step files; returns the
    pruned step numbers.  The newest step always survives, so ``LATEST``
    stays valid."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    steps = available_steps(ckpt_dir)
    pruned = steps[:-keep_last] if len(steps) > keep_last else []
    for step in pruned:
        os.remove(_step_path(ckpt_dir, step))
    return pruned


def save_step(ckpt_dir: str, step: int, tree: Any,
              keep_last: Optional[int] = None) -> str:
    """Write ``tree`` as step ``step``, update ``LATEST``, and (with
    ``keep_last``) prune older step files down to the ``k`` newest.
    Returns the written path."""
    path = _step_path(ckpt_dir, step)
    save(path, tree)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(str(step))
    if keep_last is not None:
        gc_steps(ckpt_dir, keep_last)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step ``LATEST`` names, or None without an index."""
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_latest(ckpt_dir: str, fallback: bool = True):
    """The newest checkpoint as ``(step, tree)`` (``(None, None)`` when
    the directory holds none).

    With ``fallback`` (the default) an unreadable newest file is passed
    over for the next-newest on disk, walking back until one reads;
    ``CheckpointError`` only when every candidate is bad.
    """
    steps = available_steps(ckpt_dir)
    head = latest_step(ckpt_dir)
    if head is not None and head in steps:          # newest first
        steps = [s for s in steps if s != head] + [head]
    if not steps:
        return None, None
    errors = []
    for step in reversed(steps):
        try:
            return step, load(_step_path(ckpt_dir, step))
        except CheckpointError as e:
            errors.append(str(e))
            if not fallback:
                raise
    raise CheckpointError(
        f"no readable checkpoint in {ckpt_dir!r}; tried steps "
        f"{sorted(steps, reverse=True)}: " + " | ".join(errors))
