"""Layout and padding glue, and the one home of Hopper kernel geometry.

The CUDA kernels zero-fill their ragged edges in shared memory, so the glue
pads nothing: it flattens leading dims and hands over strides. The SSD
kernel needs no fold either: it reads the model
layout ``(B, L, H, P)`` through strides, indexes B and C by group
``h // (H / G)`` instead of repeating them per head, and writes ``y`` and the
final state in the model layout.

:data:`HOPPER` holds the geometry the CUDA kernels of ``csrc/`` run with.
These numbers are chosen for an H100 (16x16x16 tensor-core fragments, at
most 227 KB of shared memory per block); none is carried over from the TPU
but the log-depth tree's ``radix`` and ``fan_in``, which shape the
algorithm, not a chip's timing.
"""
from __future__ import annotations

import dataclasses

MMA_TILE = 16          # tensor-core tile edge (rows of an mma, wmma edge)
WARP = 32              # threads of a warp

HOPPER = {
    # SSD chunk, q = 64 steps. f16/bf16 (the tensor-core instance of
    # csrc/ssd_chunk.cuh, q <= 64, P <= 64, N <= 128): four warps per
    # (batch, head), each owning 16 rows p of the transposed state, which
    # stays in f32 registers; a two-stage ring of 16-bit B, C, X tiles of
    # 64 steps and the hi/lo G tiles take 108 KB of shared memory, so two
    # chains share an SM and the served 256 chains run in one wave. f32
    # (the FMA instance): the (N, P) state, B^T, C, X.dt and the q x q
    # C.B^T block in about 130 KB of f32 shared memory, one block per SM.
    "ssd": {"q": 64},
    # the weighted scan (csrc/weighted_scan.cu, loop csrc/wscan_tile.cuh): a
    # warp owns one piece (a row, or a column range of one) and walks it in
    # steps of 256 columns, 8 per lane, ``depth`` steps of 16-byte loads in
    # flight (whole rows of one step: 4 rows a warp), eight warps a block.
    # weighted_scan_plan keeps one piece per row when the rows give every
    # SM ``warps_per_sm`` warps. Fewer rows of at most ``block_warps`` x
    # ``depth`` steps are folded into a block: up to 8 pieces a row, one
    # batch of loads each, joined through shared memory in one launch.
    # Longer rows are cut into pieces of at least ``min_steps`` steps,
    # which a fixed-order carry pass joins. 16 warps an SM with four steps
    # of x and log_a in flight are 64 to 128 KB of loads per SM, the same
    # budget as the reduce and scan.
    "weighted_scan": {"step": 256, "depth": 4, "warps_per_sm": 16,
                      "min_steps": 16, "max_blocks_per_sm": 8,
                      "block_warps": 8},
    # the log-depth family (tile_logdepth): the local passes of
    # csrc/matmul_scan.cu, then a tree over the block totals.
    # - scan: every ``block_n`` columns of a row are one piece of the
    #   reduce/scan streaming loop (csrc/tcu_tile.cuh), scanned from zero; a
    #   warp owns 16 pieces. 256 columns are eight f16 or sixteen f32 steps;
    #   a 2^20-long row is 4096 independent pieces, and the tree then
    #   combines 4096 totals per row in three levels.
    # - weighted_scan: blocks of q columns on the weighted scan's streaming
    #   loop, each restarted from zero (a segment of q / 8 lanes of a step);
    #   q = 64 makes a 2^20-long row 16384 blocks, whose totals the tree
    #   combines in four levels.
    # - ssd: the chunk body of ssd_scan.cu without the carried state.
    #   f16/bf16 at q <= 64: the same 108 KB ring, two blocks per SM, each
    #   walking the chunks strided by the grid; f32: one block per chunk,
    #   about 100 KB of f32 tiles at N = 128, P = 64.
    # ``radix`` and ``fan_in`` are the tree's branching factor and base-case
    # width: algorithm constants taken from the reference's layout (16 and
    # 16 on both of its backends), not timings of any chip.
    "scan_logdepth": {"block_n": 256, "radix": 16, "fan_in": 16},
    "weighted_scan_logdepth": {"q": 64, "radix": 16, "fan_in": 16},
    "ssd_logdepth": {"q": 64, "radix": 16, "fan_in": 16},
    # segmented reduce and scan (csrc/tcu_reduce.cu, tcu_scan.cu): a warp
    # owns 16 pieces (rows, or column ranges of rows) and walks them in
    # steps of 64 bytes per piece (16 f32 or 32 f16/bf16 columns), eight
    # warps a block. reduce_scan_plan keeps one piece per row when the
    # rows' 16-row groups give every SM ``warps_per_sm`` warps, and cuts
    # longer rows into pieces of at least ``min_steps`` steps otherwise.
    # 16 warps an SM with 4 steps of 16-byte loads in flight per lane are
    # 64 KB of loads in flight per SM, about what 3.35 TB/s over 132 SMs
    # needs at a microsecond of latency. A grid-stride loop caps the grid
    # at ``max_blocks_per_sm`` blocks an SM.
    "reduce_scan": {"warps_per_sm": 16, "min_steps": 8,
                    "max_blocks_per_sm": 8, "block_warps": 8},
    # RMSNorm: threads per row from the row count (rmsnorm_threads below).
    # Many rows (at least ``many_rows``, four warps for each of the card's
    # SMs): ``vectors_many`` 16-byte vectors per thread, a warp per row up
    # to 1024 bf16 values and 4 warps at 4096. A warp per row at 4096 would
    # hold 16 vectors a thread, which ptxas spills; at 8 vectors (two warps)
    # a block needs 166 registers a thread and runs alone on its SM, slower
    # on the card. Few rows: a block of up to 256 threads per row, one
    # vector each, so that a decode step's 4 rows spread over 4 SMs. No
    # thread holds more than ``max_vectors``; a longer row is streamed.
    "rmsnorm": {"many_rows": 4 * 132, "vectors_many": 4, "max_vectors": 8,
                "max_threads": 256},
    # flash attention has no entry: csrc/flash_attention.cu is compiled for
    # its geometries and owns them. f16/bf16: one warpgroup of 64 query
    # rows per block and a two-stage TMA ring of K/V tiles; D = 64 takes
    # 64-key tiles at four blocks per SM up to Lk = 1024 and 128-key tiles
    # at three beyond (about 74 KB of shared memory each), D = 128 64-key
    # tiles at two blocks (about 82 KB). f32: 64 query rows of four warps
    # and 64-key tiles staged through shared memory.
}

# Largest dynamic shared memory a block may use on an H100 (bytes).
MAX_SMEM = 232448


def fit_block(size: int, block: int, multiple: int) -> int:
    """Clamp a block size against the axis it tiles: round ``block`` down to
    the hardware ``multiple`` (never below it) and cap it at the padded
    extent of ``size``."""
    b = max(multiple, (int(block) // multiple) * multiple)
    ext = -(-max(int(size), 1) // multiple) * multiple
    return min(b, ext)


def rmsnorm_threads(rows: int, d: int, itemsize: int) -> int:
    """Threads per row of ``csrc/rmsnorm.cu`` for ``rows`` rows of ``d``
    elements of ``itemsize`` bytes: a power of two from 32 to 256. Many rows
    get ``vectors_many`` 16-byte vectors per thread; few rows one vector per
    thread where the row allows. No thread holds more than ``max_vectors``
    vectors unless the row exceeds 256 threads' worth, which the kernel
    then streams."""
    geo = HOPPER["rmsnorm"]
    nvec = -(-max(int(d), 1) // (16 // int(itemsize)))
    per = geo["vectors_many"] if rows >= geo["many_rows"] else 1
    tpr = max(WARP, _pow2_at_least(-(-nvec // per)),
              _pow2_at_least(-(-nvec // geo["max_vectors"])))
    return min(tpr, geo["max_threads"])


@dataclasses.dataclass(frozen=True)
class PiecePlan:
    """Launch plan of the streaming kernels that cut rows into pieces
    (``csrc/tcu_reduce.cu``, ``tcu_scan.cu``, ``weighted_scan.cu``).

    Row r is cut into ``pieces`` column ranges of ``length`` columns (the
    last one shorter when n is ragged, or empty); piece p of row r is the
    kernels' piece ``r * pieces + p``. ``blocks`` caps the grid of the
    streaming kernels, ``combine_threads`` is the block of the fixed-order
    pass over each row's pieces (where there is one), and ``workspace`` the
    f32 scratch the wrapper allocates for that pass."""

    pieces: int
    length: int
    blocks: int
    combine_threads: int
    workspace: int


def _split(n: int, want: int, step: int, min_steps: int) -> tuple[int, int]:
    """``(pieces, length)``: n columns cut into about ``want`` pieces of
    whole steps, none shorter than ``min_steps`` steps; one piece of n when
    that leaves no cut."""
    length = max(-(-n // want), min_steps * step)
    length = -(-length // step) * step
    return (-(-n // length), length) if length < n else (1, n)


def reduce_scan_plan(rows: int, n: int, itemsize: int, sms: int, *,
                     scan: bool) -> PiecePlan:
    """The plan of ``tcu_reduce.cu`` and ``tcu_scan.cu`` for ``rows`` rows of
    ``n`` elements of ``itemsize`` bytes on a card of ``sms`` streaming
    multiprocessors.

    A warp owns 16 consecutive pieces. With 2 to 16 pieces (a power of two)
    a row's pieces share one warp, which combines them in the same launch;
    with more, a second launch combines each row's sums from the
    workspace: the reduce's warps first add runs of 16 pieces (so its
    pieces are a multiple of 16), the scan's combine writes every piece's
    carry. The workspace holds the pieces' totals, and for the scan also
    their carries."""
    geo = HOPPER["reduce_scan"]
    rows, n = max(1, int(rows)), max(1, int(n))
    step = 64 // int(itemsize)                     # columns per step
    target = int(sms) * geo["warps_per_sm"]        # warps that fill the card
    pieces, length = 1, n
    if -(-rows // MMA_TILE) < target:
        pieces, length = _split(n, -(-target * MMA_TILE // rows), step,
                                geo["min_steps"])
    if 1 < pieces <= MMA_TILE:
        # 2, 4, 8 or 16 pieces, so that a row's pieces share a warp's
        # group, which combines them itself (tail pieces may be empty)
        pieces = _pow2_at_least(pieces)
    elif pieces > MMA_TILE and not scan:
        # whole runs of 16, which each warp adds before writing
        pieces = -(-pieces // MMA_TILE) * MMA_TILE
    if pieces > 1:
        length = -(-(-(-n // pieces)) // step) * step
    groups = -(-rows * pieces // MMA_TILE)
    blocks = min(-(-groups // geo["block_warps"]),
                 int(sms) * geo["max_blocks_per_sm"])
    # the sums of a row the combine pass adds: one warp per 256 of them
    sums = 1 if pieces <= MMA_TILE else (pieces if scan
                                         else pieces // MMA_TILE)
    combine = _pow2_at_least(min(1024, max(WARP, WARP * -(-sums // 256))))
    work = 0 if sums == 1 else rows * sums * (2 if scan else 1)
    return PiecePlan(pieces, length, blocks, combine, work)


def weighted_scan_plan(rows: int, n: int, sms: int) -> PiecePlan:
    """The plan of ``weighted_scan.cu`` for ``rows`` rows of ``n`` elements
    on a card of ``sms`` streaming multiprocessors (the same for every
    dtype: a step is 256 columns of x and of log_a).

    A warp owns one piece. With one piece a row the scan is one launch.
    With 2, 4 or 8 pieces of at most one batch (``depth`` steps) a row's
    pieces are warps of one block, which joins them through shared memory:
    one launch, no workspace. With more, whole steps each, three launches:
    every piece's total ``(sum of log_a, state from zero)`` into the
    workspace, each row's carries from those totals in a fixed order (one
    block of ``combine_threads`` per row), then every piece scanned from
    its carry; the workspace holds the totals' two arrays and the
    carries."""
    geo = HOPPER["weighted_scan"]
    rows, n = max(1, int(rows)), max(1, int(n))
    step = geo["step"]
    target = int(sms) * geo["warps_per_sm"]        # warps that fill the card
    pieces, length = 1, n
    if rows < target and step < n <= geo["block_warps"] * geo["depth"] * step:
        # folded in a block: 2, 4 or 8 pieces of whole steps
        pieces = min(geo["block_warps"], _pow2_at_least(-(-n // step)))
        length = -(-(-(-n // pieces)) // step) * step
    elif rows < target:
        pieces, length = _split(n, -(-target // rows), step,
                                geo["min_steps"])
    blocks = min(-(-rows * pieces // geo["block_warps"]),
                 int(sms) * geo["max_blocks_per_sm"])
    # the carry pass: a thread folds ceil(pieces / threads) pieces in order
    combine = min(256, max(WARP, _pow2_at_least(pieces)))
    split = pieces > 1 and not weighted_folded(pieces, length)
    work = 3 * rows * pieces if split else 0
    return PiecePlan(pieces, length, blocks, combine, work)


def weighted_folded(pieces: int, length: int) -> bool:
    """Whether ``csrc/weighted_scan.cu`` joins a row's pieces inside one
    block (its ``fold_ok``): 2, 4 or 8 pieces of at most one batch."""
    geo = HOPPER["weighted_scan"]
    return (1 < pieces <= geo["block_warps"]
            and geo["block_warps"] % pieces == 0
            and length <= geo["depth"] * geo["step"])


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()
