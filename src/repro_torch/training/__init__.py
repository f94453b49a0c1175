from repro_torch.training.train_lib import (
    TrainConfig,
    init_sharded_train_state,
    init_train_state,
    make_serve_step,
    make_train_step,
    shard_train_state,
    state_shape_structs,
    state_shardings,
    train_state_pspecs,
    value_and_grad,
)

__all__ = ["TrainConfig", "init_sharded_train_state", "init_train_state",
           "make_serve_step", "make_train_step", "shard_train_state",
           "state_shape_structs", "state_shardings", "train_state_pspecs",
           "value_and_grad"]
