"""Training substrate: optimizer, data pipeline, train-step factory."""
from repro_torch.training.data import DataConfig, make_pipeline
from repro_torch.training.optimizer import OptimizerConfig, adamw_update, init_opt_state, lr_at
from repro_torch.training.train_loop import (
    TrainConfig, batch_shardings, init_train_state, make_grads_fn, make_train_step,
    place_state, state_axes, state_shardings, train_state_from_numpy,
)

__all__ = [
    "DataConfig", "OptimizerConfig", "TrainConfig",
    "adamw_update", "batch_shardings", "init_opt_state", "init_train_state", "lr_at",
    "make_grads_fn", "make_pipeline", "make_train_step", "place_state", "state_axes",
    "state_shardings", "train_state_from_numpy",
]
