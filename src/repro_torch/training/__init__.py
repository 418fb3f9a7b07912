"""Training for the length predictor (the port of ``repro.training``):
AdamW over parameter trees, the loop, and checkpoints in the JAX
package's layout."""
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    schedule_lr,
)
from repro_torch.training.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.loop import make_train_step, train

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "latest_step",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
    "schedule_lr",
    "train",
]
