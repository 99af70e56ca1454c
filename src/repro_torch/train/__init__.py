"""Training: plain-function optimisers and LR schedules (``optim``), the
full-batch distributed trainer (``trainer``), crash-consistent
checkpoints (``checkpoint``) and CSV helpers (``metrics``)."""

from .optim import (Optimizer, adamw, apply_updates, clip_by_global_norm,
                    constant_lr, cosine_lr, global_norm, linear_decay_lr,
                    sgd)

__all__ = [
    "Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
    "constant_lr", "cosine_lr", "global_norm", "linear_decay_lr", "sgd",
    "History", "TrainResult", "checkpoint", "train_gnn",
]


def __getattr__(name):
    # lazy: the trainer imports repro_torch.dist.gnn_parallel, which
    # imports repro_torch.train.optim — an eager import would be circular
    if name in ("History", "TrainResult", "train_gnn"):
        from . import trainer
        return getattr(trainer, name)
    if name == "checkpoint":           # the submodule, imported on demand
        import importlib
        return importlib.import_module(f"{__name__}.checkpoint")
    raise AttributeError(name)
