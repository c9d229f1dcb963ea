"""SGD (+momentum) and AdamW (port of ``repro.optim.optimizers``).

AdamW is the reference's functional update, not ``torch.optim.AdamW``:
the reference adds ``weight_decay * p`` to the Adam direction and scales
the sum by the learning rate, and puts eps after ``sqrt(v_hat)``, with
the bias corrections applied to m and v; ``torch.optim.AdamW`` decays the
weights apart from the update and rounds differently.  The state is a
dict ``{"count", "m", "v"}`` (``{"count", "mu"}`` for SGD) of the same
names and dtypes as the reference's, so a checkpoint of it crosses.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.optim.base import Optimizer, zero_count
from repro_torch.tree import tree_map

LR = Union[Callable[[torch.Tensor], torch.Tensor], float]


def sgd(lr: LR, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else ()
        return {"count": zero_count(params), "mu": mu}

    def update(grads, state, params):
        count = state["count"]
        step = lr_fn(count)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return (tree_map(lambda m: -step * m, mu),
                    {"count": count + 1, "mu": mu})
        return tree_map(lambda g: -step * g, grads), {"count": count + 1, "mu": ()}

    return Optimizer(init, update)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
        return {"count": zero_count(params), "m": tree_map(zeros32, params),
                "v": tree_map(zeros32, params)}

    def update(grads, state, params):
        count = state["count"] + 1
        cf = count.to(torch.float32)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.to(torch.float32)), state["v"], grads)
        mh = 1.0 - b1 ** cf
        vh = 1.0 - b2 ** cf
        step = lr_fn(state["count"])

        def upd(m_, v_, p):
            u = (m_ / mh) / (torch.sqrt(v_ / vh) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (-step * u).to(p.dtype)

        return tree_map(upd, m, v, params), {"count": count, "m": m, "v": v}

    return Optimizer(init, update)
