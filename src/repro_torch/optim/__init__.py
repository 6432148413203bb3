"""Optimizers, schedules and clipping of the training path (torch port of
the JAX package's ``optim``)."""

from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.adafactor import Adafactor, AdafactorState
from repro_torch.optim.schedule import warmup_cosine, constant, global_norm, clip_by_global_norm


def build_optimizer(run_cfg):
    """Construct the optimizer named by a RunConfig."""
    sched = warmup_cosine(run_cfg.learning_rate, run_cfg.warmup_steps, run_cfg.total_steps)
    if run_cfg.optimizer == "adafactor":
        return Adafactor(learning_rate=sched, weight_decay=run_cfg.weight_decay)
    return AdamW(
        learning_rate=sched,
        weight_decay=run_cfg.weight_decay,
        amsgrad=run_cfg.amsgrad,
        moments_dtype=run_cfg.moments_dtype,
    )


__all__ = [
    "AdamW", "AdamWState", "Adafactor", "AdafactorState",
    "warmup_cosine", "constant", "global_norm", "clip_by_global_norm",
    "build_optimizer",
]
