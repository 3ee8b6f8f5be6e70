"""Build and load the hand kernels.

One ``torch.utils.cpp_extension.load`` of every source under ``csrc/``,
for ``sm_90a``, at first use, into ``build/repro_torch_kernels/`` at the
root of the repository (``/build/`` is git-ignored).  The ``.cu`` files
hold the kernels behind plain C launchers and include no PyTorch header;
``bindings.cpp`` is the one source that includes ``torch/extension.h``.
Nothing here runs at import: a machine without ``nvcc`` imports the
package and runs the plain versions on the CPU.  A rank of a
``repro_torch.dist.World`` does not build: its parent built the module
before it spawned the ranks, and each rank loads that file
(``load_built``), since V builds into one directory would race.

The link names the shared libstdc++ first (``LINK_FLAGS``).  Where the
toolchain's default link of an extension pulls libstdc++.a in instead,
the module carries a second copy of the iostream and locale code beside
the process's shared one, and the first number that the module itself
formats into a stream (``c10::str``, a ``TORCH_CHECK`` message with an
integer) calls through the wrong locale facet and ends the process with
a segmentation fault.
"""
from __future__ import annotations

import importlib.util
import pathlib
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("bindings.cpp", "gram.cu", "qp_step.cu", "qp_multi.cu", "rows.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")
LINK_FLAGS = ("-l:libstdc++.so.6",)

_EXT = None
#: seconds the last build (or cache check) took, for chip_smoke.py
build_seconds = None


def extension():
    """The loaded extension module, built on the first call."""
    global _EXT, build_seconds
    if _EXT is None:
        from torch.utils import cpp_extension

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _EXT = cpp_extension.load(
            name="repro_torch_kernels",
            sources=[str(CSRC / s) for s in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O2"],
            extra_cuda_cflags=list(CUDA_FLAGS),
            extra_ldflags=list(LINK_FLAGS),
            verbose=False)
        build_seconds = time.perf_counter() - t0
    return _EXT


def load_built():
    """Load the module that ``extension`` built into ``BUILD_DIR``,
    without building or checking its sources (a rank of a world, whose
    parent built it).  Raises ``FileNotFoundError`` if it was not built."""
    global _EXT
    if _EXT is None:
        path = BUILD_DIR / "repro_torch_kernels.so"
        if not path.is_file():
            raise FileNotFoundError(f"no built kernels at {path}; call "
                                    f"extension() first")
        spec = importlib.util.spec_from_file_location("repro_torch_kernels",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _EXT = module
    return _EXT
