"""Launch geometry of the hand kernels, as inspectable data (twin of
``repro/kernels/launch.py``).

Each CUDA kernel in ``csrc/`` derives its grid, threads a block, dynamic
shared bytes and launch kind from the shapes, in C++.  The functions here
derive the same numbers from the same shapes, line for line as the
``.cu`` files do, so that the launch audit
(``repro_torch.analysis.launch_audit``) checks each launch against
Hopper's limits without a card, and, on the card, against what the built
extension reports (``kernel_info``, ``qp_multi_shape``).  The ``.cu``
files cannot call Python, so the two are held together by that
comparison and by a test that parses the ``constexpr`` constants out of
the sources and compares them with the ones below.

Pure Python: no torch import, nothing at import.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

# gram.cu:72-80
GRAM_TILE = 128          # kTile: output tile edge
GRAM_DEPTH = 16          # kDepth: features per stage
GRAM_STAGES = 3          # kStages: stages of the cp.async ring
GRAM_THREADS = 256       # kThreads
GRAM_MIN_BLOCKS = 2      # kMinBlocks
GRAM_VEC = 4             # kVec: floats per 16-byte copy
GRAM_PRESCALE_TILE = 32  # kPrescaleTile
# qp_common.cuh:15-17
QP_ROWS = 4              # kRows: rows per warp
QP_WARPS = 8             # kWarps: warps per block
QP_THREADS = QP_WARPS * 32
# qp_multi.cu:68-75
MULTI_BLOCK_THREADS = 512    # kBlockThreads
MULTI_SPAN_THREADS = 256     # kSpanThreads
MULTI_GRID_THREADS = 256     # kGridThreads
MULTI_GRID_WARPS = MULTI_GRID_THREADS // 32
MULTI_GRID_CTAS_PER_SM = 2   # kGridCtasPerSm
MULTI_UNROLL = 2             # kUnroll
MULTI_STAGE_BYTES = 100 * 1024   # kStageBytes
# rows.cu:26-27
ROWS_THREADS = 256
ROWS_STAGED_FLOATS = 48 * 1024 // 4

#: each source's ``constexpr int`` constants as this module states them
#: (the names are the sources' own)
CUDA_CONSTANTS = {
    "gram.cu": {"kTile": GRAM_TILE, "kHalf": GRAM_TILE // 2,
                "kDepth": GRAM_DEPTH, "kStages": GRAM_STAGES,
                "kThreads": GRAM_THREADS, "kMinBlocks": GRAM_MIN_BLOCKS,
                "kVec": GRAM_VEC,
                "kChunks": GRAM_DEPTH * GRAM_TILE // GRAM_VEC,
                "kPrescaleTile": GRAM_PRESCALE_TILE},
    "qp_common.cuh": {"kRows": QP_ROWS, "kWarps": QP_WARPS,
                      "kThreads": QP_THREADS},
    "qp_multi.cu": {"kBlockThreads": MULTI_BLOCK_THREADS,
                    "kSpanThreads": MULTI_SPAN_THREADS,
                    "kGridThreads": MULTI_GRID_THREADS,
                    "kGridWarps": MULTI_GRID_WARPS,
                    "kGridCtasPerSm": MULTI_GRID_CTAS_PER_SM,
                    "kUnroll": MULTI_UNROLL,
                    "kStageBytes": MULTI_STAGE_BYTES},
    "rows.cu": {"kThreads": ROWS_THREADS,
                "kStagedFloats": ROWS_STAGED_FLOATS},
}

INT_MAX = 2 ** 31 - 1

#: an H100 SXM's streaming multiprocessors, the multi solve's default
#: for the card's count (the card's own count is passed on the card)
H100_SMS = 132
#: the opt-in shared memory a block can use on Hopper (bytes)
HOPPER_SMEM_OPTIN = 232448

#: bytes of the operand types
_F32, _BF16 = 4, 2


class Launch(NamedTuple):
    """One kernel launch: the kernel instance (the name ``kernel_info``
    reports), its grid (x, y, z), threads a block, dynamic and static
    shared bytes, whether the launcher raises the dynamic shared limit
    (``cudaFuncAttributeMaxDynamicSharedMemorySize``), and whether the
    launch is cooperative (``cudaLaunchCooperativeKernel``)."""
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    dynamic_smem: int = 0
    static_smem: int = 0
    opt_in: bool = False
    cooperative: bool = False


#: static shared bytes and ``__launch_bounds__`` threads of every kernel
#: instance, as the sources declare them
STATIC_SMEM = {
    # __shared__ float tile[kPrescaleTile][kPrescaleTile + 1]
    "gram_prescale_kernel": GRAM_PRESCALE_TILE * (GRAM_PRESCALE_TILE + 1)
    * _F32,
    # __shared__ Ring ring: float op[kStages][2][kDepth][kTile]
    "gram_kernel": GRAM_STAGES * 2 * GRAM_DEPTH * GRAM_TILE * _F32,
    "gram_tiled_kernel": GRAM_STAGES * 2 * GRAM_DEPTH * GRAM_TILE * _F32,
    "qp_step_kernel": 0,
    **{f"qp_multi_{path}_kernel<{t}>": 0 for path in ("block", "grid")
       for t in ("f32", "f32,fold", "bf16", "bf16,fold")},
    "rows_kernel<staged>": 0,
    "rows_kernel<global>": 0,
}
LAUNCH_BOUNDS = {
    "gram_prescale_kernel": GRAM_THREADS,
    "gram_kernel": GRAM_THREADS,
    "gram_tiled_kernel": GRAM_THREADS,
    "qp_step_kernel": QP_THREADS,
    **{f"qp_multi_block_kernel<{t}>": MULTI_BLOCK_THREADS
       for t in ("f32", "f32,fold", "bf16", "bf16,fold")},
    **{f"qp_multi_grid_kernel<{t}>": MULTI_GRID_THREADS
       for t in ("f32", "f32,fold", "bf16", "bf16,fold")},
    "rows_kernel<staged>": ROWS_THREADS,
    "rows_kernel<global>": ROWS_THREADS,
}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _launch(kernel: str, grid, threads: int, **kw) -> Launch:
    return Launch(kernel, tuple(grid), threads,
                  static_smem=STATIC_SMEM[kernel], **kw)


# ----------------------------------------------------------------------
# gram.cu
# ----------------------------------------------------------------------


def gram_ld(n: int) -> int:
    """``repro_gram_ld``: the feature-major row stride, N rounded up to
    16 bytes."""
    return _round_up(n, GRAM_VEC)


def gram_max_rows() -> int:
    """``repro_gram_max_rows``: the most rows a square build or a panel
    takes (the bindings' guard)."""
    return 65535 * GRAM_TILE


def gram_prescale_launch(B: int, N: int, D: int) -> Optional[Launch]:
    """``repro_gram_prescale_launch`` (gram.cu:387-389); None where the
    launcher launches nothing."""
    if B == 0 or N == 0 or D == 0:
        return None
    return _launch("gram_prescale_kernel",
                   (_cdiv(N, GRAM_PRESCALE_TILE),
                    _cdiv(D, GRAM_PRESCALE_TILE), B), GRAM_THREADS)


def gram_launch(B: int, N: int, D: int) -> Optional[Launch]:
    """``repro_gram_launch`` (gram.cu:397-401): one CTA per tile pair
    ti <= tj of each problem, static shared memory only."""
    if B == 0 or N == 0:
        return None
    tiles = _cdiv(N, GRAM_TILE)
    return _launch("gram_kernel", (tiles * (tiles + 1) // 2, 1, B),
                   GRAM_THREADS)


def gram_tiled_launch(B: int, N: int, D: int, row0: int,
                      M: int) -> Optional[Launch]:
    """``repro_gram_tiled_launch`` (gram.cu:410-418): the R·(t−R) +
    R(R+1)/2 tile pairs a row panel [row0, row0 + M) overlaps.  Raises
    ``ValueError`` where the launcher refuses the grid (more than
    ``INT_MAX`` CTAs, ``cudaErrorInvalidConfiguration``)."""
    if B == 0 or M == 0 or N == 0:
        return None
    tiles = _cdiv(N, GRAM_TILE)
    R = (row0 + M - 1) // GRAM_TILE - row0 // GRAM_TILE + 1
    blocks = R * (tiles - R) + R * (R + 1) // 2
    if blocks > INT_MAX:
        raise ValueError(f"{blocks} CTAs: the tiled Gram launcher refuses "
                         f"more than INT_MAX")
    return _launch("gram_tiled_kernel", (blocks, 1, B), GRAM_THREADS)


# ----------------------------------------------------------------------
# qp_step.cu
# ----------------------------------------------------------------------


def qp_step_launch(B: int, N: int) -> Optional[Launch]:
    """``repro_qp_step_launch`` (qp_step.cu:49-51): kRows rows a warp,
    kWarps warps a block, the batch in grid y."""
    if B == 0 or N == 0:
        return None
    return _launch("qp_step_kernel", (_cdiv(N, QP_WARPS * QP_ROWS), B, 1),
                   QP_THREADS)


# ----------------------------------------------------------------------
# qp_multi.cu
# ----------------------------------------------------------------------


def _vec(bf16: bool) -> int:
    """Elements of K in 16 bytes (``Vec<KT>::n``)."""
    return 8 if bf16 else 4


def multi_block_span(N: int) -> int:
    """``block_span``: lanes per pair of rows on the block path."""
    pairs = (N + 1) // 2
    span = 1
    while span < 32 and 2 * span * pairs <= MULTI_SPAN_THREADS:
        span *= 2
    return span


def multi_block_threads(N: int) -> int:
    """``block_threads``: span * ceil(N/2) rounded up to a warp."""
    return _round_up(multi_block_span(N) * ((N + 1) // 2), 32)


def multi_k_stride(N: int, bf16: bool) -> int:
    """``k_stride<KT>``: K's row stride in shared memory, in elements."""
    size = _BF16 if bf16 else _F32
    span = multi_block_span(N)
    ld = _round_up(N, _vec(bf16))
    if span < 8:
        while ld * size % 128 != 16 * span:
            ld += _vec(bf16)
    return ld


def multi_block_smem(N: int, bf16: bool) -> int:
    """``block_smem<KT>``: both iterates (and their bf16 copies) and K."""
    size = _BF16 if bf16 else _F32
    ld = _round_up(N, _vec(bf16))
    nbytes = 2 * ld * _F32
    if bf16:
        nbytes += 2 * ld * size
    return nbytes + N * multi_k_stride(N, bf16) * size


def multi_stage_chunk(N: int, bf16: bool) -> int:
    """``stage_chunk<KT>``: iterate entries a grid-path CTA stages."""
    return min(N, MULTI_STAGE_BYTES // (_BF16 if bf16 else _F32))


def multi_grid_smem(N: int, bf16: bool) -> int:
    """The grid path's dynamic shared bytes: the staged chunk, rounded to
    16 bytes."""
    return _round_up(multi_stage_chunk(N, bf16) * (_BF16 if bf16 else _F32),
                     16)


#: the multi solve's launch paths, by the number ``csrc/qp_multi.cu`` gives
MULTI_PATHS = ("block", "grid")


def qp_multi_shape(B: int, N: int, *, bf16: bool = False,
                   sms: int = H100_SMS,
                   ctas_per_sm: int = MULTI_GRID_CTAS_PER_SM,
                   optin: int = HOPPER_SMEM_OPTIN) -> dict:
    """``repro_qp_multi_shape`` (qp_multi.cu:597-640): the path, CTAs,
    the most problems one CTA's rows touch (``slots``) and the dynamic
    shared bytes a CTA, for B problems of N rows.

    The card answers two of its inputs: its SM count (``sms``) and how
    many grid-path CTAs its occupancy calculator lets one SM hold at this
    shared size (``ctas_per_sm``; ``kGridCtasPerSm`` is what the
    kernel's ``__launch_bounds__`` asks for).  They are arguments, not
    guesses; the defaults are an H100's 132 SMs and that 2.  The fold
    changes which kernel launches, not the shape."""
    if B == 0 or N == 0:
        return {"path": "block", "blocks": 1, "slots": 1, "smem": 0}
    if (multi_block_smem(N, bf16) <= optin
            and multi_block_threads(N) <= MULTI_BLOCK_THREADS):
        return {"path": "block", "blocks": B, "slots": 1,
                "smem": multi_block_smem(N, bf16)}
    smem = multi_grid_smem(N, bf16)
    resident = ctas_per_sm * sms
    if resident < 1:
        raise ValueError("no grid-path CTA fits an SM "
                         "(cudaErrorLaunchOutOfResources)")
    groups = _cdiv(N, QP_ROWS)
    blocks = resident if B >= resident else \
        B * min(resident // B, _cdiv(groups, MULTI_GRID_WARPS))
    total = B * groups
    slots = 1
    for c in range(blocks):
        f0 = total * c // blocks
        f1 = total * (c + 1) // blocks
        slots = max(slots, (f1 - 1) // groups - f0 // groups + 1)
    return {"path": "grid", "blocks": blocks, "slots": slots, "smem": smem}


def qp_multi_launch(B: int, N: int, *, bf16: bool = False,
                    fold: bool = False, sms: int = H100_SMS,
                    ctas_per_sm: int = MULTI_GRID_CTAS_PER_SM,
                    optin: int = HOPPER_SMEM_OPTIN) -> Optional[Launch]:
    """``launch<KT, FOLD>`` (qp_multi.cu:643-672): the block path launches
    ``block_threads(N)`` threads a problem, the grid path a cooperative
    grid of ``kGridThreads``-thread CTAs; both raise the dynamic shared
    limit first."""
    if B == 0 or N == 0:
        return None
    shape = qp_multi_shape(B, N, bf16=bf16, sms=sms,
                           ctas_per_sm=ctas_per_sm, optin=optin)
    kind = ("bf16" if bf16 else "f32") + (",fold" if fold else "")
    name = f"qp_multi_{shape['path']}_kernel<{kind}>"
    if shape["path"] == "block":
        return _launch(name, (shape["blocks"], 1, 1), multi_block_threads(N),
                       dynamic_smem=shape["smem"], opt_in=True)
    return _launch(name, (shape["blocks"], 1, 1), MULTI_GRID_THREADS,
                   dynamic_smem=shape["smem"], opt_in=True,
                   cooperative=True)


# ----------------------------------------------------------------------
# rows.cu
# ----------------------------------------------------------------------


def rows_fits(K: int, p: int) -> bool:
    """``fits``: the hyperplanes and biases fit the staged 48 KB."""
    return K * (p + 1) <= ROWS_STAGED_FLOATS


def rows_launch(M: int, K: int, p: int) -> Optional[Launch]:
    """``repro_rows_launch`` (rows.cu:56,62-73): one thread an output
    element; the staged instance takes K(p+1) floats of dynamic shared
    memory, at most 48 KB, without raising the limit."""
    if M == 0 or K == 0:
        return None
    blocks = _cdiv(M * K, ROWS_THREADS)
    if rows_fits(K, p):
        return _launch("rows_kernel<staged>", (blocks, 1, 1), ROWS_THREADS,
                       dynamic_smem=_F32 * (K * p + K))
    return _launch("rows_kernel<global>", (blocks, 1, 1), ROWS_THREADS)
