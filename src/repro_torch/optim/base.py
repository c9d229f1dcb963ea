"""Minimal optimizer framework (port of ``repro.optim.base``).

An optimizer is a pair of functions over trees of tensors
(``repro_torch.tree``):

    init(params) -> state
    update(grads, state, params) -> (updates, state)

``apply_updates`` adds updates to params.  Both return new tensors and
leave their inputs as they were, as the reference's pure functions do;
they run under ``torch.no_grad`` in ``make_train_step``.  A state's step
counter is a 0-d int32 tensor on the parameters' device, so a schedule
reads it without a host sync.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def params_device(params) -> torch.device:
    """The device of the first tensor leaf (the CPU if there is none)."""
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def zero_count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params_device(params))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose gradient transformations left-to-right."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_states = []
        for t, s in zip(transforms, state):
            grads, ns = t.update(grads, s, params)
            new_states.append(ns)
        return grads, tuple(new_states)

    return Optimizer(init, update)


def scale(factor: float) -> Optimizer:
    return Optimizer(lambda p: (),
                     lambda g, s, p: (tree_map(lambda x: x * factor, g), s))


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Optimizer:
    def update(grads, count, params):
        lr = schedule(count)
        return tree_map(lambda g: -lr * g, grads), count + 1

    return Optimizer(zero_count, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def update(grads, state, params):
        norm = torch.sqrt(sum(torch.square(g.to(torch.float32)).sum()
                              for g in tree_leaves(grads)))
        factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return tree_map(lambda g: g * factor, grads), state

    return Optimizer(lambda p: (), update)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    def update(grads, state, params):
        return (tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                         grads, params), state)

    return Optimizer(lambda p: (), update)
