from repro_torch.optim.adamw import (
    OptConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_at,
)
from repro_torch.optim.compress import compress_grads, stochastic_round_bf16

__all__ = [
    "OptConfig",
    "adamw_update",
    "compress_grads",
    "global_norm",
    "init_opt_state",
    "lr_at",
    "stochastic_round_bf16",
]
