"""SGD (+momentum), AdamW and Adafactor (port of
``repro.optim.optimizers``).

AdamW is the reference's functional update, not ``torch.optim.AdamW``:
the reference adds ``weight_decay * p`` to the Adam direction and scales
the sum by the learning rate, and puts eps after ``sqrt(v_hat)``, with
the bias corrections applied to m and v; ``torch.optim.AdamW`` decays the
weights apart from the update and rounds differently.  The state is a
dict ``{"count", "m", "v"}`` (``{"count", "mu"}`` for SGD) of the same
names and dtypes as the reference's, so a checkpoint of it crosses.

Adafactor (Shazeer & Stern) keeps factored second moments: row and column
means of g^2 (``vr``, ``vc``) for every leaf of two or more dimensions, a
full ``v`` for the rest, and bfloat16 momentum when ``momentum`` is set.
``adafactor_fused`` applies its own update (``update(g, s, p) ->
(new_params, new_state)``) and updates a leaf of three or more dimensions
whose axis 0 holds at least ``scan_min_leading`` slices one slice at a
time, as the reference's ``lax.scan`` does: the factored statistics are
exact per slice and the RMS clip is per slice.  Both keep the reference's
arithmetic in its order (``eps`` added to g^2, ``max(mean(vr), eps)``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.optim.base import Optimizer, zero_count
from repro_torch.tree import tree_leaves, tree_map, unflatten_like

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


def _beta2(count: torch.Tensor, decay: float) -> torch.Tensor:
    return 1.0 - count.to(torch.float32) ** (-decay)


def _adafactor_state(params, momentum, momentum_dtype):
    def v_for(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if p.dim() >= 2:
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    state = {"count": zero_count(params), "v": tree_map(v_for, params)}
    if momentum is not None:
        state["m"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=momentum_dtype, device=p.device), params)
    return state


def _precondition(g32, vr, vc, beta2, eps, clip_threshold):
    """One leaf (or slice): the new statistics and the clipped direction.
    ``vr`` is None for an unfactored leaf, whose ``v`` is passed as ``vc``."""
    g2 = torch.square(g32) + eps
    if vr is not None:
        vr = beta2 * vr + (1 - beta2) * g2.mean(-1)
        vc = beta2 * vc + (1 - beta2) * g2.mean(-2)
        denom_r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
        precond = g32 / (torch.sqrt(denom_r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps)
    else:
        vc = beta2 * vc + (1 - beta2) * g2
        precond = g32 / (torch.sqrt(vc) + eps)
    rms = torch.sqrt(torch.mean(torch.square(precond)) + 1e-30)
    return vr, vc, precond / torch.clamp(rms / clip_threshold, min=1.0)


def adafactor_fused(lr: LR, momentum: Optional[float] = None,
                    momentum_dtype: torch.dtype = torch.bfloat16,
                    decay: float = 0.8, eps: float = 1e-30,
                    clip_threshold: float = 1.0,
                    scan_min_leading: int = 8) -> Optimizer:
    """Adafactor fused with the parameter apply, leaves of >= 3 dimensions
    and >= ``scan_min_leading`` slices updated slice by slice (see the
    module docstring).  ``update(grads, state, params)`` returns
    ``(new_params, new_state)``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return _adafactor_state(params, momentum, momentum_dtype)

    def update_apply(grads, state, params):
        count = state["count"] + 1
        beta2 = _beta2(count, decay)
        step = lr_fn(state["count"])

        def slice_update(g, p, vr, vc, m):
            vr, vc, precond = _precondition(g.to(torch.float32), vr, vc,
                                            beta2, eps, clip_threshold)
            if m is not None:
                m = (momentum * m.to(torch.float32)
                     + (1 - momentum) * precond).to(momentum_dtype)
                precond = m.to(torch.float32)
            new_p = (p.to(torch.float32) - step * precond).to(p.dtype)
            return new_p, vr, vc, m

        def leaf(g, p, v, m):
            vr, vc = v.get("vr"), v.get("vc", v.get("v"))
            if p.dim() >= 3 and p.shape[0] >= scan_min_leading:
                new_p, nvr, nvc = (torch.empty_like(p), torch.empty_like(vr),
                                   torch.empty_like(vc))
                nm = None if m is None else torch.empty_like(m)
                for i in range(p.shape[0]):
                    out = slice_update(g[i], p[i], vr[i], vc[i],
                                       None if m is None else m[i])
                    new_p[i], nvr[i], nvc[i] = out[:3]
                    if nm is not None:
                        nm[i] = out[3]
            else:
                new_p, nvr, nvc, nm = slice_update(g, p, vr, vc, m)
            return new_p, ({"vr": nvr, "vc": nvc} if "vr" in v
                           else {"v": nvc}), nm

        flat_g = tree_leaves(grads)
        flat_m = (tree_leaves(state["m"]) if momentum is not None
                  else [None] * len(flat_g))
        v_of = _leaf_states(params, state["v"])
        outs = [leaf(g, p, v, m) for g, p, v, m in
                zip(flat_g, tree_leaves(params), v_of, flat_m)]
        new_state = {"count": count,
                     "v": unflatten_like(params, [o[1] for o in outs])}
        if momentum is not None:
            new_state["m"] = unflatten_like(params, [o[2] for o in outs])
        return unflatten_like(params, [o[0] for o in outs]), new_state

    return Optimizer(init, update_apply)


def _leaf_states(params, v_tree) -> list:
    """The per-leaf ``{"vr", "vc"}`` / ``{"v"}`` dicts of ``v_tree``, in
    ``params``' leaf order (``tree_leaves`` would flatten the dicts)."""
    out = []
    tree_map(lambda _, v: out.append(v), params, v_tree)
    return out


def adafactor(lr: LR, momentum: Optional[float] = 0.9,
              momentum_dtype: torch.dtype = torch.bfloat16,
              decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored-second-moment optimizer; ``update`` returns updates (the
    whole-leaf counterpart of ``adafactor_fused``)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return _adafactor_state(params, momentum, momentum_dtype)

    def update(grads, state, params):
        count = state["count"] + 1
        beta2 = _beta2(count, decay)
        step = lr_fn(state["count"])

        def upd_one(g, v):
            vr, vc, precond = _precondition(
                g.to(torch.float32), v.get("vr"), v.get("vc", v.get("v")),
                beta2, eps, clip_threshold)
            return precond, ({"vr": vr, "vc": vc} if "vr" in v
                             else {"v": vc})

        outs = [upd_one(g, v) for g, v in
                zip(tree_leaves(grads), _leaf_states(params, state["v"]))]
        precs = unflatten_like(params, [o[0] for o in outs])
        new_state = {"count": count,
                     "v": unflatten_like(params, [o[1] for o in outs])}
        if momentum is not None:
            m = tree_map(lambda m_, u: (momentum * m_.to(torch.float32)
                                        + (1 - momentum) * u
                                        ).to(momentum_dtype),
                         state["m"], precs)
            new_state["m"] = m
            updates = tree_map(lambda m_, p: (-step * m_.to(torch.float32)
                                              ).to(p.dtype), m, params)
        else:
            updates = tree_map(lambda u, p: (-step * u).to(p.dtype), precs,
                               params)
        return updates, new_state

    return Optimizer(init, update)
