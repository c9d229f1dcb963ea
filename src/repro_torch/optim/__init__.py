"""Optimizers (port of ``repro.optim``): the functional ``Optimizer``
pair, its transforms, learning-rate schedules, SGD, AdamW, Adafactor and
the fused Adafactor that recsys training runs, and (``compression``) the
int8 and top-k gradient compression of a data-parallel all-reduce."""

from repro_torch.optim.base import (Optimizer, add_decayed_weights,
                                    apply_updates, chain, clip_by_global_norm,
                                    scale, scale_by_schedule)
from repro_torch.optim.optimizers import (adafactor, adafactor_fused, adamw,
                                          sgd)
from repro_torch.optim.schedules import constant, inverse_time, warmup_cosine

__all__ = [
    "Optimizer", "add_decayed_weights", "apply_updates", "chain",
    "clip_by_global_norm", "scale", "scale_by_schedule", "adafactor",
    "adafactor_fused", "adamw", "sgd", "constant", "inverse_time",
    "warmup_cosine",
]
