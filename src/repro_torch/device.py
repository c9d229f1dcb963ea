"""Device choice shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Asking for the card (``None`` or a CUDA device) where no CUDA device is
    present raises: the port never carries on on the CPU unless the caller
    asked for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def same_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    """The one device all given tensors live on (raises if they differ)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors live on different devices: {sorted(map(str, devs))}")
    return devs.pop()
