"""Optimizers (port of ``repro.optim``): the functional ``Optimizer``
pair, its transforms, learning-rate schedules, SGD and AdamW.

``adafactor`` / ``adafactor_fused`` come with recsys training and
``compression.py`` with the multi-GPU mesh path (ROADMAP queue 1)."""

from repro_torch.optim.base import (Optimizer, add_decayed_weights,
                                    apply_updates, chain, clip_by_global_norm,
                                    scale, scale_by_schedule)
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.optim.schedules import constant, inverse_time, warmup_cosine

__all__ = [
    "Optimizer", "add_decayed_weights", "apply_updates", "chain",
    "clip_by_global_norm", "scale", "scale_by_schedule", "adamw", "sgd",
    "constant", "inverse_time", "warmup_cosine",
]
