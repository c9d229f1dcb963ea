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
exact per slice and the RMS clip is per slice.  A slice of more than
``UPDATE_CHUNK`` elements goes in chunks of whole matrices (the RMS summed
over the chunks), and ``inplace`` writes the new parameters and state over
the old: together they fit an LM's step on one card.  Both keep the
reference's arithmetic in its order (``eps`` added to g^2,
``max(mean(vr), eps)``).

On a process mesh ``adafactor_fused``'s ``update`` takes ``shards=(ents,
mesh)``, each leaf's per-dim mesh axes (a tree of the parameters' shape):
its leaves are then local shards, and every mean the update takes over a
dim that an axis shards -- the factored statistics, ``mean(vr)`` and the
RMS of the clip -- is summed across that axis's ranks (shards are equal,
so the mean of the shards' means).  AdamW is elementwise and runs on
shards as it is.
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


class _Whole:
    """Means over whole (unsharded) dims."""

    def mean(self, t, dim, param_dim, keepdim=False):
        return t.mean(dim, keepdim=keepdim)

    def mean_all(self, t):
        return torch.mean(t)

    def sum_all_(self, t):
        return t

    def numel(self, n: int) -> int:
        return n


class _Sharded(_Whole):
    """Means over dims of a local shard: each summed across the ranks of
    the axes sharding the parameter's dim (``axes``: per parameter dim,
    counted from the last)."""

    def __init__(self, mesh, axes):
        from repro_torch.sharding import spmd
        self.spmd, self.mesh, self.axes = spmd, mesh, list(axes)
        self.all = tuple(a for ax in self.axes for a in (ax or ()))

    def mean(self, t, dim, param_dim, keepdim=False):
        return self.spmd.pmean_(t.mean(dim, keepdim=keepdim), self.mesh,
                                self.axes[param_dim] or ())

    def mean_all(self, t):
        return self.spmd.pmean_(torch.mean(t), self.mesh, self.all)

    def sum_all_(self, t):
        return self.spmd.pmean_(t, self.mesh, self.all).mul_(
            self.mesh.extent(self.all))

    def numel(self, n: int) -> int:
        return n * self.mesh.extent(self.all)

    def slice(self) -> "_Sharded":
        out = _Sharded.__new__(_Sharded)
        out.spmd, out.mesh, out.axes = self.spmd, self.mesh, self.axes[1:]
        out.all = tuple(a for ax in out.axes for a in (ax or ()))
        return out


_WHOLE = _Whole()


def _statistics(g32, vr, vc, beta2, eps, red=_WHOLE):
    """One leaf, slice or chunk: the new second-moment statistics.  ``vr``
    is None for an unfactored leaf, whose ``v`` is passed as ``vc``."""
    g2 = torch.square(g32).add_(eps)
    if vr is not None:
        return (beta2 * vr + (1 - beta2) * red.mean(g2, -1, -1),
                beta2 * vc + (1 - beta2) * red.mean(g2, -2, -2))
    return None, beta2 * vc + (1 - beta2) * g2


def _direction(g32, vr, vc, eps, red=_WHOLE):
    """g / sqrt(v) from the new statistics, before the clip."""
    if vr is not None:
        denom_r = vr / torch.clamp(red.mean(vr, -1, -2, keepdim=True),
                                   min=eps)
        denom = (torch.sqrt(denom_r)[..., None]
                 * torch.sqrt(vc)[..., None, :]).add_(eps)
    else:
        denom = torch.sqrt(vc).add_(eps)
    return torch.div(g32, denom, out=denom)


def _clip(rms, clip_threshold):
    """The divisor that clips a direction of this RMS to the threshold."""
    return torch.clamp(rms / clip_threshold, min=1.0)


def _precondition(g32, vr, vc, beta2, eps, clip_threshold, red=_WHOLE):
    """One leaf (or slice): the new statistics and the clipped direction."""
    vr, vc = _statistics(g32, vr, vc, beta2, eps, red)
    precond = _direction(g32, vr, vc, eps, red)
    rms = torch.sqrt(red.mean_all(torch.square(precond)) + 1e-30)
    return vr, vc, precond.div_(_clip(rms, clip_threshold))


# float32 elements of a slice the fused update holds at once (1 GiB): a
# larger slice of three or more dimensions is updated in chunks along its
# leading axes, in two passes (its statistics and RMS, then the step), so
# a 7.5 GB bfloat16 expert stack never has whole-slice float32 temporaries
UPDATE_CHUNK = 1 << 28


def adafactor_fused(lr: LR, momentum: Optional[float] = None,
                    momentum_dtype: torch.dtype = torch.bfloat16,
                    decay: float = 0.8, eps: float = 1e-30,
                    clip_threshold: float = 1.0,
                    scan_min_leading: int = 8,
                    inplace: bool = False) -> Optimizer:
    """Adafactor fused with the parameter apply, leaves of >= 3 dimensions
    and >= ``scan_min_leading`` slices updated slice by slice (see the
    module docstring).  ``update(grads, state, params)`` returns
    ``(new_params, new_state)``; with ``inplace`` they are ``params`` and
    ``state``'s own tensors, written over (the reference's train step
    donates both), so a step holds no second copy of either."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return _adafactor_state(params, momentum, momentum_dtype)

    def update_apply(grads, state, params, shards=None):
        count = state["count"] + 1
        beta2 = _beta2(count, decay)
        step = lr_fn(state["count"])

        def apply(p, precond, m, out_p, out_m):
            """Momentum and the step on one slice or chunk, written into
            ``out_p`` / ``out_m``."""
            if m is not None:
                # momentum * m + (1 - momentum) * precond, rounded to
                # momentum_dtype, and the step from the rounded value
                m32 = m.to(torch.float32, copy=True).mul_(momentum)
                out_m.copy_(m32.add_(precond.mul_(1 - momentum)))
                precond = m32.copy_(out_m)
            upd = precond.mul_(step)
            out_p.copy_(torch.sub(p.to(torch.float32), upd, out=upd))

        def slice_update(g, p, vr, vc, m, out, red):
            out_p, out_vr, out_vc, out_m = out
            if p.dim() < 3 or p.numel() <= UPDATE_CHUNK:
                nvr, nvc, precond = _precondition(
                    g.to(torch.float32), vr, vc, beta2, eps, clip_threshold,
                    red)
                if nvr is not None:
                    out_vr.copy_(nvr)
                out_vc.copy_(nvc)
                apply(p, precond, m, out_p, out_m)
                return
            # chunks of whole matrices along the leading axes: the
            # factored statistics stay exact per chunk; the clip takes the
            # RMS of the whole slice, so the step waits for a second pass
            r, c = p.shape[-2:]
            mats = lambda t: None if t is None else t.view(-1, r, c)
            vecs = lambda t, n: t.view(-1, n)
            g3, p3, m3, op3, om3 = map(mats, (g, p, m, out_p, out_m))
            vr2, vc2 = vecs(vr, r), vecs(vc, c)
            ovr2, ovc2 = vecs(out_vr, r), vecs(out_vc, c)
            per = max(1, UPDATE_CHUNK // (r * c))
            chunks = [slice(a, a + per) for a in range(0, g3.shape[0], per)]
            ssq = torch.zeros((), dtype=torch.float32, device=p.device)
            for sl in chunks:
                g32 = g3[sl].to(torch.float32)
                nvr, nvc = _statistics(g32, vr2[sl], vc2[sl], beta2, eps,
                                       red)
                ovr2[sl].copy_(nvr)
                ovc2[sl].copy_(nvc)
                ssq += torch.square(_direction(g32, nvr, nvc, eps, red)).sum()
            clip = _clip(torch.sqrt(red.sum_all_(ssq) / red.numel(p.numel())
                                    + 1e-30), clip_threshold)
            for sl in chunks:
                precond = _direction(g3[sl].to(torch.float32), ovr2[sl],
                                     ovc2[sl], eps, red).div_(clip)
                apply(p3[sl], precond, None if m3 is None else m3[sl],
                      op3[sl], None if om3 is None else om3[sl])

        def leaf(g, p, v, m, red):
            vr, vc = v.get("vr"), v.get("vc", v.get("v"))
            outs = (p, vr, vc, m)
            if not inplace:
                outs = tuple(None if t is None else torch.empty_like(t)
                             for t in outs)
            if p.dim() >= 3 and p.shape[0] >= scan_min_leading:
                pick = lambda t, i: None if t is None else t[i]
                red_i = red.slice() if isinstance(red, _Sharded) else red
                for i in range(p.shape[0]):
                    slice_update(g[i], p[i], vr[i], vc[i], pick(m, i),
                                 [pick(t, i) for t in outs], red_i)
            else:
                slice_update(g, p, vr, vc, m, outs, red)
            new_p, nvr, nvc, nm = outs
            return new_p, ({"vr": nvr, "vc": nvc} if "vr" in v
                           else {"v": nvc}), nm

        flat_g = tree_leaves(grads)
        flat_m = (tree_leaves(state["m"]) if momentum is not None
                  else [None] * len(flat_g))
        v_of = _leaf_states(params, state["v"])
        if shards is None:
            reds = [_WHOLE] * len(flat_g)
        else:
            ents, mesh = shards
            reds = [_Sharded(mesh, e) for e in _leaf_states(params, ents)]
        outs = [leaf(g, p, v, m, r) for g, p, v, m, r in
                zip(flat_g, tree_leaves(params), v_of, flat_m, reds)]
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
