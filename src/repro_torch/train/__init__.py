from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import abstract_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "AdamWConfig",
    "adamw_update",
    "init_opt_state",
    "abstract_state",
    "make_train_step",
    "Trainer",
    "TrainerConfig",
]
