"""Mixture-of-experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``).

Top-k routing -> stable sort of the (token, slot) assignments by expert ->
scatter into per-expert capacity buffers (an assignment past its expert's
capacity is dropped) -> batched expert products -> weighted combine.
O(T*k) bookkeeping, no (T, E, C) one-hot tensor.  DeepSeek-MoE structure:
``n_shared`` always-on shared experts plus ``n_experts`` routed ones, with
sigmoid (aux-loss-free) or softmax routing.

``moe_ffn`` dispatches as the reference's does: on a process mesh to the
expert-parallel path -- ``_moe_ep_local`` in a model body on local shards
(``sharding.spmd.Shards``), or ``moe_ffn_ep`` for DTensor operands, which
runs ``_moe_ep_local`` (the reference's ``shard_map`` body) under
``local_map`` -- else to ``_moe_ffn_dense``.  On the mesh: experts live
on the EP group of ``ep_layout`` (numbered "model" major, as the
reference numbers them); when the token count divides the mesh, tokens go
to their experts' owners by an all-to-all over that group and come back
the same way, else (the psum fallback) each rank runs its own experts on
the tokens it holds and one psum over the group combines.  Capacity per rank is
``_capacity_local`` (rounded to 4, where the dense path rounds to 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu
from repro_torch.sharding import spmd


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"      # "softmax" | "sigmoid" (aux-loss-free)


def init_moe_params(draw: Callable, d_model: int, cfg: MoEConfig,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The reference's MoE leaves and scales; ``draw(shape, scale, dtype)``
    makes one leaf (``transformer.init_params`` passes a generator's
    normal draw, ``param_shapes`` a shape on the meta device).  The router
    stays float32 whatever ``dtype``."""
    E, f = cfg.n_experts, cfg.d_ff
    s = d_model ** -0.5
    p = {"router": draw((d_model, E), s, torch.float32),
         "w_gate": draw((E, d_model, f), s, dtype),
         "w_up": draw((E, d_model, f), s, dtype),
         "w_down": draw((E, f, d_model), f ** -0.5, dtype)}
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {"w_gate": draw((d_model, fs), s, dtype),
                       "w_up": draw((d_model, fs), s, dtype),
                       "w_down": draw((fs, d_model), fs ** -0.5, dtype)}
    return p


def _capacity(T: int, cfg: MoEConfig) -> int:
    c = int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def route(params: Dict, x: torch.Tensor, cfg: MoEConfig):
    """(T, k) normalised weights and expert ids, best first: scores from
    float32 router logits (sigmoid or softmax), their top k, divided by
    their sum."""
    logits = x.float() @ params["router"]
    scores = (torch.sigmoid(logits) if cfg.router == "sigmoid"
              else torch.softmax(logits, dim=-1))
    topv, topi = torch.topk(scores, cfg.top_k, dim=-1, sorted=True)
    return topv / topv.sum(-1, keepdim=True).clamp(min=1e-9), topi


class Dispatch(NamedTuple):
    """The T*k assignments sorted by expert (stable, so by token within an
    expert): each one's token, weight, whether it fits its expert's
    capacity, its buffer row (``E * C``, a spare row, if not) and its
    index in the (T, k) routing order."""
    tok: torch.Tensor
    weight: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    order: torch.Tensor


def dispatch(topv: torch.Tensor, topi: torch.Tensor, n_experts: int,
             capacity: int) -> Dispatch:
    T, k = topi.shape
    dev = topi.device
    order = torch.argsort(topi.reshape(-1), stable=True)
    e_sorted = topi.reshape(-1)[order]
    starts = torch.searchsorted(e_sorted,
                                torch.arange(n_experts, device=dev,
                                             dtype=e_sorted.dtype))
    pos_in_e = torch.arange(T * k, device=dev) - starts[e_sorted]
    keep = pos_in_e < capacity
    dest = torch.where(keep, e_sorted * capacity + pos_in_e,
                       n_experts * capacity)
    return Dispatch(tok=order // k, weight=topv.reshape(-1)[order],
                    keep=keep, dest=dest, order=order)


def moe_ffn(params: Dict, x: torch.Tensor, cfg: MoEConfig,
            shards: Optional[spmd.Shards] = None,
            ents=spmd.WHOLE) -> torch.Tensor:
    """x: (T, d_model) -> (T, d_model).  In a body on a process mesh
    (``shards``, ``ents`` the leaves' per-dim axes, ``params`` and ``x``
    the rank's shards) the expert-parallel ``_moe_ep_local``; under a
    current process mesh with a "model" axis (DTensor operands)
    ``moe_ffn_ep``; otherwise the single-device ``_moe_ffn_dense``."""
    if shards is not None and shards.mesh is not None:
        return _moe_ep_local(params, ents, x, cfg, shards.mesh, shards.rows)
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.sharding.rules import current_mesh
    mesh = current_mesh()
    if isinstance(mesh, ProcessMesh) and "model" in mesh.axis_names:
        return moe_ffn_ep(params, x, cfg, mesh)
    return _moe_ffn_dense(params, x, cfg)


def _moe_ffn_dense(params: Dict, x: torch.Tensor,
                   cfg: MoEConfig) -> torch.Tensor:
    """Sort-based capacity dispatch: every expert runs on its (C, d)
    buffer, empty rows included."""
    T, d = x.shape
    E = cfg.n_experts
    C = _capacity(T, cfg)
    topv, topi = route(params, x, cfg)
    dp = dispatch(topv, topi, E, C)
    # row E * C takes every dropped assignment (the reference's
    # mode="drop" scatter) and is cut off
    buf = x.new_zeros((E * C + 1, d)).index_copy_(0, dp.dest, x[dp.tok])
    buf = buf[:E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"]).reshape(E * C, d)
    gathered = (out_buf[torch.where(dp.keep, dp.dest, 0)] * dp.keep[:, None]
                * dp.weight[:, None].to(x.dtype))
    out = x.new_zeros((T, d)).index_add_(0, dp.tok, gathered)
    if "shared" in params:
        sp = params["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out


# ---------------------------------------------------------------------------
# Expert parallelism over a process mesh
# ---------------------------------------------------------------------------

def ep_layout(mesh, E: int):
    """Expert-parallel group: as many mesh axes as E divides into.

    256-expert models span ("model", "data") = the whole 256-chip pod (1
    expert a chip, whole (d, f) weights); 16-expert models span
    ("model",) with d_ff FSDP'd over the remaining axes and gathered just
    in time.  Returns (ep_axes, ffn_shard_axes, complement_token_axes).
    Reads only ``axis_names`` and ``shape``, so any mesh serves.
    """
    ep_axes = []
    size = 1
    for name in ("model", "data"):
        if name in mesh.axis_names and E % (size * mesh.shape[name]) == 0:
            ep_axes.append(name)
            size *= mesh.shape[name]
    ep_axes = tuple(ep_axes)
    ffn_axes = tuple(n for n in ("data", "pod")
                     if n in mesh.axis_names and n not in ep_axes)
    tok_rest = tuple(n for n in ("pod", "data")
                     if n in mesh.axis_names and n not in ep_axes)
    return ep_axes, ffn_axes, tok_rest


def _capacity_local(T_loc: int, cfg: MoEConfig) -> int:
    c = int(T_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, ((c + 3) // 4) * 4)


def _dispatch_local(x: torch.Tensor, ids: torch.Tensor,
                    weights: torch.Tensor, k: int, n_buckets: int,
                    bucket_cap: int):
    """The reference's sort-based dispatch of the (T*k) copies into
    (n_buckets, bucket_cap) slots; ``ids == n_buckets`` marks an invalid
    copy.  As there, only the first ``n_buckets * bucket_cap`` sorted
    copies are considered.  Returns (buf, dest, tok, w, keep)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    tok_s = order // k
    w_s = weights[order]
    starts = torch.searchsorted(ids_s, torch.arange(
        n_buckets, device=ids.device, dtype=ids_s.dtype))
    # an invalid id indexes past ``starts``; jax clamps such an index
    pos = torch.arange(n, device=ids.device) - starts[
        ids_s.clamp(max=n_buckets - 1)]
    n_slots = n_buckets * bucket_cap
    m = min(n_slots, n)
    ids_s, tok_s, w_s, pos = ids_s[:m], tok_s[:m], w_s[:m], pos[:m]
    keep = (ids_s < n_buckets) & (pos < bucket_cap)
    dest = torch.where(keep, ids_s * bucket_cap + pos, n_slots)
    buf = x.new_zeros((n_slots + 1, x.shape[1])).index_copy(
        0, dest, x[tok_s])[:n_slots]
    return buf, dest, tok_s, w_s, keep


def _combine(out_flat, dest, tok_s, w_s, keep, T_loc: int, x):
    contrib = (out_flat[torch.where(keep, dest, 0)] * keep[:, None]
               * w_s[:, None].to(x.dtype))
    return x.new_zeros((T_loc, x.shape[1])).index_add(0, tok_s, contrib)


def _experts(buf, w_gate, w_up, w_down):
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def swiglu_tp(x: torch.Tensor, p: Dict, ents,
              shards: Optional[spmd.Shards] = None) -> torch.Tensor:
    """``swiglu`` in a body on a process mesh (``shards``): x (..., d)
    replicated over "model"; ``w_gate`` / ``w_up`` column-parallel and
    ``w_down`` row-parallel over "model" where their d_ff dim is sharded
    there (one psum at the end), else run whole on every rank; every
    weight's FSDP shard gathered just in time.  ``ents``: each weight's
    per-dim axes.  With no mesh, ``swiglu`` itself."""
    sh = shards or spmd.Shards()
    tp = ("model",) if sh.model_split(ents["w_gate"]) else ()
    w = lambda n: sh.use(p[n], ents[n], tp)
    # the reference constrains the hidden to ("batch", None, "model")
    return spmd.psum(swiglu(spmd.enter(x, sh.mesh, tp), w("w_gate"),
                            w("w_up"), w("w_down")), sh.mesh, tp)


def _moe_ep_local(p: Dict, ents: Dict, x: torch.Tensor, cfg: MoEConfig,
                  mesh, rows) -> torch.Tensor:
    """The reference's ``moe_ffn_ep`` body on local shards.  x: (T_r, d),
    the tokens split over ``rows`` (all the batch axes, or none) and
    replicated over "model"; returns the same layout.  ``p``: the MoE
    leaves' local shards, ``ents`` their per-dim axes."""
    rows = tuple(rows)
    T_r, d = x.shape
    T = T_r * mesh.extent(rows)
    E, k = cfg.n_experts, cfg.top_k
    ep, _, tok_rest = ep_layout(mesh, E)
    n_ep = mesh.extent(ep)
    E_loc = E // n_ep
    tp = mesh.shape.get("model", 1)
    batch_axes = tuple(n for n in ("pod", "data") if n in mesh.axis_names)
    a2a = (T % mesh.size == 0) and (T // mesh.size > 0) and d % tp == 0
    if rows and rows != batch_axes:
        raise ValueError(f"tokens split over {rows}: the EP body takes "
                         f"them over all of {batch_axes} or none")
    if a2a:
        tok = batch_axes + (("model",) if "model" in mesh.axis_names else ())
    elif tok_rest and T % mesh.extent(tok_rest) == 0:
        tok = tok_rest
    else:
        tok = ()
    split = tuple(dict.fromkeys(tok + ep))         # the body's split axes
    # tokens: from the caller's layout to the body's
    gathered = ()
    if not rows:
        xb = spmd.scatter(x, 0, mesh, tok)
    elif tok[:len(rows)] == rows:
        xb = spmd.scatter(x, 0, mesh, tok[len(rows):])
    else:                                  # tok is a prefix of rows
        gathered = rows[len(tok):]
        xb = x
        for a in reversed(gathered):
            xb = spmd.gather(xb, 0, mesh, (a,),
                             "sum" if a in split else "slice")
    xb = spmd.enter(xb, mesh, tuple(a for a in split if a not in tok
                                    and a not in gathered))
    T_loc = xb.shape[0]
    C = _capacity_local(T_loc, cfg)
    router = spmd.use(p["router"], mesh, ents["router"], split=split)

    def expert_weight(name):
        e_dim = 0
        e_held = tuple(ents[name][e_dim] or ())
        if ep[:len(e_held)] != e_held:
            raise ValueError(f"{name}'s experts over {e_held} are not a "
                             f"prefix of the EP group {ep}")
        narrow = ep[len(e_held):]
        w = spmd.use(p[name], mesh, ents[name], keep=e_held,
                     split=tuple(a for a in split if a not in narrow))
        return spmd.scatter(w, 0, mesh, narrow)

    w_gate, w_up, w_down = map(expert_weight, ("w_gate", "w_up", "w_down"))
    logits = xb.float() @ router
    scores = (torch.sigmoid(logits) if cfg.router == "sigmoid"
              else torch.softmax(logits, dim=-1))
    topv, topi = torch.topk(scores, k, dim=-1, sorted=True)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    if a2a:
        # bucket id = global expert id; owner = id // E_loc on the EP group
        buf, dest, tok_s, w_s, keep = _dispatch_local(
            xb, topi.reshape(-1), topv.reshape(-1), k, E, C)
        recv = spmd.all_to_all(buf.reshape(n_ep, E_loc * C, d), mesh, ep)
        xs = recv.reshape(n_ep, E_loc, C, d).transpose(0, 1).reshape(
            E_loc, n_ep * C, d)
        ys = _experts(xs, w_gate, w_up, w_down)
        back = ys.reshape(E_loc, n_ep, C, d).transpose(0, 1).reshape(
            n_ep, E_loc * C, d)
        got = spmd.all_to_all(back, mesh, ep)
        y = _combine(got.reshape(E * C, d), dest, tok_s, w_s, keep, T_loc,
                     xb)
    else:
        e_local = topi.reshape(-1) - mesh.index(ep) * E_loc
        ids = torch.where((e_local >= 0) & (e_local < E_loc), e_local, E_loc)
        buf, dest, tok_s, w_s, keep = _dispatch_local(
            xb, ids, topv.reshape(-1), k, E_loc, C)
        ys = _experts(buf.reshape(E_loc, C, d), w_gate, w_up, w_down)
        y = _combine(ys.reshape(E_loc * C, d), dest, tok_s, w_s, keep,
                     T_loc, xb)
        y = spmd.psum(y, mesh, tuple(a for a in ep if a not in gathered))
    # back to the caller's layout
    if gathered:
        for a in gathered:
            y = (spmd.reduce_scatter(y, 0, mesh, (a,)) if a in ep
                 else spmd.scatter(y, 0, mesh, (a,)))
    elif not rows:
        y = spmd.gather(y, 0, mesh, tok)
    else:
        y = spmd.gather(y, 0, mesh, tok[len(rows):])
    if "shared" in p:
        y = y + swiglu_tp(x, p["shared"], ents["shared"],
                          spmd.Shards(mesh, rows))
    return y


def moe_ffn_ep(params: Dict, x, cfg: MoEConfig, mesh):
    """Expert parallelism over a process mesh.  ``params``: the MoE leaves
    as DTensors under their specs (``sharding.params.lm_param_specs``);
    ``x``: a (T, d) DTensor (or a plain tensor, taken as replicated).
    Returns a DTensor of tokens over the batch axes, replicated over
    "model".  ``_moe_ep_local`` runs on the local shards under
    ``local_map``."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.rules import (constrain, entries_of, set_mesh)
    from repro_torch.tree import path_leaves, unflatten_like
    with set_mesh(mesh):
        x = constrain(x, "batch", None)
    rows = entries_of(x.placements, mesh, 2)[0] or ()
    leaves = path_leaves(params)
    ents = unflatten_like(params, [entries_of(t.placements, mesh, t.dim())
                                   for _, t in leaves])

    def body(x_loc, *locs):
        return _moe_ep_local(unflatten_like(params, list(locs)), ents,
                             x_loc, cfg, mesh, rows)

    fn = local_map(body, out_placements=list(x.placements),
                   in_placements=(x.placements,) + tuple(
                       t.placements for _, t in leaves),
                   device_mesh=mesh.device_mesh)
    return fn(x, *[t for _, t in leaves])


def moe_load_balance_loss(logits: torch.Tensor, topi: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    p_e = torch.softmax(logits.float(), dim=-1).mean(0)
    f_e = F.one_hot(topi[..., 0].long(), E).float().mean(0)
    return E * (p_e * f_e).sum()
