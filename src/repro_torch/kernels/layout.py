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

MMA_TILE = 16          # tensor-core fragment edge (wmma 16x16x16)
WARP = 32              # threads of a warp

HOPPER = {
    # SSD chunk: the (N, P) state, the chunk's B, C, X.dt and the q x q
    # C.B^T block stay in shared memory; q = 64 keeps that near 128 KB at
    # N = 128, P = 64, under the card's 227 KB per block
    "ssd": {"q": 64},
    "weighted_scan": {"q": 64},
    # the log-depth family (tile_logdepth): the local passes of
    # csrc/matmul_scan.cu, then a tree over the block totals.
    # - scan: a warp owns one block of 16 rows (the wmma fragment's edge,
    #   fixed in the kernel) x ``block_n`` columns. 256 columns are eight
    #   staged 32-column steps; a 2^20-long row is 4096 independent blocks,
    #   about 31 warps per SM, and the tree then combines 4096 totals per
    #   row in three levels.
    # - weighted_scan: a warp owns one (row, q-block); q = 64 keeps the q/2
    #   exps per element low and 64 x 4096 rows at 4096 warps.
    # - ssd: the chunk of ssd_scan.cu, whose shared-memory budget holds at
    #   q = 64 (about 99 KB at N = 128, P = 64 without the carried state).
    # ``radix`` and ``fan_in`` are the tree's branching factor and base-case
    # width: algorithm constants taken from the reference's layout (16 and
    # 16 on both of its backends), not timings of any chip.
    "scan_logdepth": {"block_n": 256, "radix": 16, "fan_in": 16},
    "weighted_scan_logdepth": {"q": 64, "radix": 16, "fan_in": 16},
    "ssd_logdepth": {"q": 64, "radix": 16, "fan_in": 16},
    # flash attention has no entry: csrc/flash_attention.cu is compiled for
    # its one geometry (kFaBQ = 64 query rows, four warps of 16, and
    # kFaBK = 64 key rows per tile) and owns it. At D = 64 in bf16 a block
    # stages Q, K, V, the scores, P and the f32 accumulators, rows padded
    # against bank conflicts, in about 74 KB, so three blocks share an SM;
    # f32 inputs (three bf16 parts each) at D = 128 stay under 227 KB.
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
