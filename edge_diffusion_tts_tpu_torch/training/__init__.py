"""Training: state and optimizer, the phase steps, the 3-phase driver,
checkpoints (counterpart of ``edge_diffusion_tts_tpu/training``)."""

from .checkpoint import (
    resolve_checkpoint_dir,
    restore_checkpoint,
    save_checkpoint,
    save_final_model,
)
from .state import (
    Optimizer,
    TrainState,
    constant_schedule,
    create_train_state,
    ema_update,
    make_lr_schedule,
    make_optimizer,
)
from .steps import Trainer
from .train import init_models, progressive_step_schedule, train, train_v2

__all__ = [
    "Optimizer",
    "TrainState",
    "Trainer",
    "constant_schedule",
    "create_train_state",
    "ema_update",
    "init_models",
    "make_lr_schedule",
    "make_optimizer",
    "progressive_step_schedule",
    "resolve_checkpoint_dir",
    "restore_checkpoint",
    "save_checkpoint",
    "save_final_model",
    "train",
    "train_v2",
]
