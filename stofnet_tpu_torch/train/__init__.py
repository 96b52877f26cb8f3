"""Training and evaluation of the port (replaces
``stofnet_tpu/train/__init__.py``): losses, metrics, steps, early stopping
and checkpoints."""

from stofnet_tpu_torch.train.checkpoint import (
    find_checkpoint, load_checkpoint, load_model_variables, save_checkpoint,
)
from stofnet_tpu_torch.train.early_stop import EarlyStopping
from stofnet_tpu_torch.train.loss import (
    first_valid_toa, heatmap_loss, regression_loss,
)
from stofnet_tpu_torch.train.metrics import toa_rmse
from stofnet_tpu_torch.train.steps import (
    LossConfig, fused_loss, make_eval_step,
    make_fused_train_step, make_optimizer, make_train_step, resume_optimizer,
)

__all__ = [
    "EarlyStopping", "LossConfig", "find_checkpoint",
    "first_valid_toa", "fused_loss", "heatmap_loss", "load_checkpoint",
    "load_model_variables", "make_eval_step", "make_fused_train_step",
    "make_optimizer", "make_train_step", "regression_loss", "resume_optimizer",
    "save_checkpoint", "toa_rmse",
]
