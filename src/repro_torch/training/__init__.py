from repro_torch.training.train_lib import (
    TrainConfig,
    init_train_state,
    make_train_step,
    value_and_grad,
)

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "value_and_grad"]
