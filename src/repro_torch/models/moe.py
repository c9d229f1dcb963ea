"""Mixture-of-experts FFN with sort-based capacity dispatch (port of the
no-mesh path of ``repro.models.moe``).

Top-k routing -> stable sort of the (token, slot) assignments by expert ->
scatter into per-expert capacity buffers (an assignment past its expert's
capacity is dropped) -> batched expert products -> weighted combine.
O(T*k) bookkeeping, no (T, E, C) one-hot tensor.  DeepSeek-MoE structure:
``n_shared`` always-on shared experts plus ``n_experts`` routed ones, with
sigmoid (aux-loss-free) or softmax routing.

The reference's expert-parallel ``moe_ffn_ep`` belongs to the mesh path
(``ROADMAP.md`` queue 1, "Training on a mesh"); ``moe_ffn`` here is
the reference's single-device ``_moe_ffn_dense``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu


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


def moe_ffn(params: Dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (T, d_model) -> (T, d_model); the reference's ``_moe_ffn_dense``
    (no mesh)."""
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


def moe_load_balance_loss(logits: torch.Tensor, topi: torch.Tensor,
                          E: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    p_e = torch.softmax(logits.float(), dim=-1).mean(0)
    f_e = F.one_hot(topi[..., 0].long(), E).float().mean(0)
    return E * (p_e * f_e).sum()
