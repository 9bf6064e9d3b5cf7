from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw,
                                            schedule_fn)
from repro_torch.training.train_loop import make_train_step, train
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_update", "init_adamw", "schedule_fn",
    "make_train_step", "train", "load_checkpoint", "save_checkpoint",
]
