"""repro_torch.core — the paper's contribution: matmul-form reduction and
scan, and the kernel-selection layer (``policy``, ``autotune``,
``dispatch``) that picks the formulation per call.

Tile level  (paper: warp/WMMA fragment)  -> tiles.py constructors + reduce/scan
Block level (paper: thread block)        -> multi-tile composition in reduce/scan
Device/grid level (paper: multi-kernel)  -> distributed.py collectives
"""
from repro_torch.core import autotune, dispatch, policy
from repro_torch.core.distributed import (
    dist_exclusive_carry,
    dist_reduce,
    dist_scan,
    dist_weighted_scan,
    weighted_exclusive_carry,
)
from repro_torch.core.policy import (
    KernelPolicy,
    TuneSpec,
    get_policy,
    set_policy,
    using_policy,
)
from repro_torch.core.ragged import (
    tcu_ragged_segment_reduce,
    tcu_ragged_segment_scan,
)
from repro_torch.core.reduce import tcu_reduce, tcu_segmented_reduce
from repro_torch.core.scan import (
    tcu_scan,
    tcu_segmented_scan,
    tcu_weighted_scan,
)
from repro_torch.core.tiles import (
    DEFAULT_TILE,
    l_matrix,
    ones_matrix,
    p_matrix,
    segsum,
    strict_u_matrix,
    u_matrix,
)

__all__ = [
    "DEFAULT_TILE",
    "KernelPolicy",
    "TuneSpec",
    "autotune",
    "dispatch",
    "dist_exclusive_carry",
    "dist_reduce",
    "dist_scan",
    "dist_weighted_scan",
    "get_policy",
    "policy",
    "set_policy",
    "using_policy",
    "l_matrix",
    "ones_matrix",
    "p_matrix",
    "segsum",
    "strict_u_matrix",
    "tcu_ragged_segment_reduce",
    "tcu_ragged_segment_scan",
    "tcu_reduce",
    "tcu_scan",
    "tcu_segmented_reduce",
    "tcu_segmented_scan",
    "tcu_weighted_scan",
    "u_matrix",
    "weighted_exclusive_carry",
]
