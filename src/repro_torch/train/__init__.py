"""Training: the generic loop with checkpoints and restarts
(``trainer``, ``checkpoint``, ``fault``), a checkpoint moved onto another
mesh (``elastic``) and streaming online learning over signature chunks
(``online``)."""

from repro_torch.train import checkpoint
from repro_torch.train.fault import Heartbeat, RestartStats, run_with_restarts
from repro_torch.train.online import (CacheStats, EpochStats, OnlineTrainer,
                                      SignatureCache, make_family)
from repro_torch.train.trainer import (EpochTimes, TrainState, Trainer,
                                       make_train_step, online_epochs)

__all__ = [
    "EpochTimes", "TrainState", "Trainer", "make_train_step",
    "online_epochs", "CacheStats", "EpochStats", "OnlineTrainer",
    "SignatureCache", "make_family", "checkpoint", "Heartbeat",
    "RestartStats", "run_with_restarts",
]
