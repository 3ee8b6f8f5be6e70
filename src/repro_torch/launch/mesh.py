"""The one card's mesh and peak rates (twin of ``repro/launch/mesh.py``).

The reference targets TPU v5e pods: one pod of 16 x 16 = 256 chips
(``("data", "model")``) or two of them, 512 chips (``("pod", "data",
"model")``), and keeps the v5e's per-chip constants for its roofline.
The port runs on one NVIDIA H100 SXM, so its production mesh is that one
card, 1 x 1 over ``("data", "model")``.  ``make_debug_mesh(data, model)``
is the ``--mesh DxM`` layout the training CLI and the dry run read
through :func:`parse_mesh`: D consensus replicas on the card (a leading
replica axis of every state leaf), M unused (one card has no
tensor-parallel axis).

The reference's ``ICI_BW_PER_LINK`` has no counterpart: one card sends
nothing over a link.  The functions, as the reference's, build a mesh
only when called; this module imports no torch and touches no device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

# NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores, H100 SXM
PEAK_FLOPS_F32 = 67e12            # FLOP/s, fp32 outside the tensor cores,
#                                   H100 SXM (the port's fp32 has no TF32)
HBM_BW = 3.35e12                  # bytes/s, HBM3, H100 SXM
# The budget of the dry run's ``fits``, one on the card and on the CPU.
# NVIDIA H100 80GB HBM3's total_memory (torch.cuda.get_device_properties,
# chip_smoke.py phase 24); on the card the dry run reads the card's own
HBM_BYTES = 85_017_493_504
# What a process holds on an NVIDIA H100 80GB HBM3 outside the caching
# allocator once it has run a step (the CUDA context and its modules:
# total - free - reserved, 789,381,120 B after chip_smoke.py phase 24's
# real steps, rounded up to 64 MiB); on the card the dry run takes the
# larger of this and its own reading
CONTEXT_BYTES = 768 * 2**20
# cuBLAS's workspace on Hopper, which the allocator holds beside a step's
# tensors (33,554,432 B held after the first product, chip_smoke.py
# phase 24)
CUBLAS_WORKSPACE_BYTES = 32 * 2**20


class Mesh(NamedTuple):
    """A mesh's axis sizes and names (the port's ``jax.sharding.Mesh``:
    a layout on the one card, no devices)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The one card, 1 x 1 over ``("data", "model")``; ``multi_pod`` (the
    reference's 2 x 16 x 16 TPU mesh) raises ``ValueError``."""
    if multi_pod:
        raise ValueError("the reference's multi-pod mesh is 2 x 16 x 16 = "
                         "512 TPU v5e chips; the port runs on one card")
    return Mesh((1, 1), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2) -> Mesh:
    """``--mesh DxM``: ``data`` consensus replicas on the card, ``model``
    unused."""
    return Mesh((data, model), ("data", "model"))


def parse_mesh(spec: str, mode: str) -> Mesh:
    """``--mesh DxM`` under ``mode`` (the trainer, ``allreduce`` or
    ``admm``), printing what one card leaves unused; the reference's
    ``single`` and ``multi`` TPU meshes exit."""
    if spec in ("single", "multi"):
        raise SystemExit(
            f"--mesh {spec}: the reference's {spec}-pod TPU mesh "
            f"({'256' if spec == 'single' else '512'} chips) has no twin "
            f"on one card; give DxM")
    d, m = (int(x) for x in spec.split("x"))
    if mode == "admm":
        if m != 1:
            print(f"mesh {spec}: the model axis ({m}) is unused on one card; "
                  f"computing {d}x1")
    else:
        print(f"mesh {spec}: unused under allreduce (one card holds the "
              f"whole batch)")
    return make_debug_mesh(d, m)


def num_chips(mesh: Mesh) -> int:
    """Cards the mesh runs on: always the one."""
    return 1
