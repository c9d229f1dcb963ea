"""Shared building blocks (port of part of ``repro.models.layers``):
``normal_init``, ``mlp`` and ``init_mlp``.  The rest of the reference's
layers come with the models that use them (``ROADMAP.md`` queue 1).

Initialisation draws from an explicit ``torch.Generator`` on the device
the tensors are made on, so a seed gives the same weights in every
process; the values differ from ``jax.random``'s (the tests carry weights
over instead).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) * ``scale`` on the generator's device, drawn in float32 and
    cast to ``dtype``.  Filled in place, so a large table is never held
    twice."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t.normal_(0.0, 1.0, generator=generator).mul_(scale)
    return t if dtype == torch.float32 else t.to(dtype)


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor],
        act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` between layers (and after the last
    with ``final_act``)."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w + b
        if i < len(weights) - 1 or final_act:
            x = act(x)
    return x


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32) -> Dict[str, List[torch.Tensor]]:
    """``{"w": [...], "b": [...]}``: weights N(0, 1/fan_in), zero biases."""
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        ws.append(normal_init(generator, (fan_in, fan_out),
                              scale=fan_in ** -0.5, dtype=dtype))
        bs.append(torch.zeros((fan_out,), dtype=dtype,
                              device=generator.device))
    return {"w": ws, "b": bs}
