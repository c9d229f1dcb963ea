"""Linear SVM and logistic regression on b-bit signatures (port of
``repro.models.linear``), paper §5-§6.

The weight vector lives in (k * 2^b,): the Eq. (5) expansion is implicit,
``margin = sum_j w[j * 2^b + z_j] / sqrt(k) + bias``.  Features arrive as
(n, k) b-bit values (``"hashed"``), as the packed wire words
(``"packed"``), unpacked on the device inside the step, or as dense
vectors (``"dense"``: VW-hashed or original data, the paper's baselines).
Sentinel OPH codes (value 2^b) and EMPTY are zero-coded: an empty bin adds
nothing.

The batch objectives of Eqs. (6)/(7) (``make_loss_fn``) are differentiated
by autograd.  The gradient of ``hashed_margin``'s gather ``w[tok]`` is a
scatter-add, done on the card with atomics in no fixed order; a caller
that needs bit-identical steps runs them under
``torch.use_deterministic_algorithms(True)``.

``sgd_svm_step`` updates the SGD state IN PLACE: the reference donates
the state buffer to its jitted step (``donate_argnums``), so nothing
holds the old weights; here the same buffers are simply overwritten.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch

from repro_torch.core.bbit import expand_tokens, unpack_codes
from repro_torch.core.u32 import widen
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class LinearModel:
    w: torch.Tensor          # (dim,) float32
    bias: torch.Tensor       # () float32

    @staticmethod
    def create(dim: int, device: DeviceLike = None) -> "LinearModel":
        dev = resolve_device(device)
        return LinearModel(w=torch.zeros(dim, device=dev),
                           bias=torch.zeros((), device=dev))


def packed_to_values(packed: torch.Tensor, *, k: int, b: int,
                     sentinel: bool = False) -> torch.Tensor:
    """Wire words -> (n, k) values; sentinel wires carry (b+1)-bit codes
    whose EMPTY code 2^b ``_valid_tokens`` already zero-codes."""
    return unpack_codes(packed, b + 1 if sentinel else b, k)


def _as_hashed(feats: torch.Tensor, feature_kind: str, b: int,
               k: Optional[int], sentinel: bool) -> Tuple[torch.Tensor, str]:
    """Unpack 'packed' features to b-bit values ('hashed'); pass 'hashed'
    and 'dense' through."""
    if feature_kind in ("hashed", "dense"):
        return feats, feature_kind
    if feature_kind != "packed":
        raise ValueError(f"feature_kind must be 'hashed', 'packed' or "
                         f"'dense', got {feature_kind!r}")
    if k is None:
        raise ValueError("feature_kind='packed' needs k= (signature length)")
    return packed_to_values(feats, k=k, b=b, sentinel=sentinel), "hashed"


def _valid_tokens(sig_b: torch.Tensor, b: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, validity) for Eq. (5): values >= 2^b (EMPTY, sentinel
    codes) become token of value 0 with validity False."""
    v = widen(sig_b)
    valid = torch.ones_like(v, dtype=torch.bool) if b >= 32 else v < (1 << b)
    return expand_tokens(torch.where(valid, v, 0), b), valid


def _scale(k: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(k, dtype=torch.float32, device=device))


def hashed_margin(model: LinearModel, sig_b: torch.Tensor, b: int
                  ) -> torch.Tensor:
    """w . phi(x) for the implicit Eq. (5) expansion; (n,) scores."""
    tok, valid = _valid_tokens(sig_b, b)
    contrib = torch.where(valid, model.w[tok], 0.0)
    return contrib.sum(-1) * _scale(sig_b.shape[-1], model.w.device) + model.bias


def dense_margin(model: LinearModel, x: torch.Tensor) -> torch.Tensor:
    return x @ model.w + model.bias


def _margin(model: LinearModel, feats: torch.Tensor, fkind: str,
            b: int) -> torch.Tensor:
    return (hashed_margin(model, feats, b) if fkind == "hashed"
            else dense_margin(model, feats))


def svm_objective(margins: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  C: float) -> torch.Tensor:
    """Eq. (6): (1/2)||w||^2 + C sum max(1 - y m, 0) (sum over batch).
    ``torch.maximum`` splits the gradient at a tie as ``jnp.maximum``."""
    hinge = torch.maximum(1.0 - y * margins, torch.zeros_like(margins))
    return 0.5 * (w * w).sum() + C * hinge.sum()


def logistic_objective(margins: torch.Tensor, y: torch.Tensor,
                       w: torch.Tensor, C: float) -> torch.Tensor:
    """Eq. (7): (1/2)||w||^2 + C sum log(1 + exp(-y m)), the log term as
    ``logaddexp(-y m, 0)`` (the reference's ``softplus``)."""
    z = -y * margins
    return 0.5 * (w * w).sum() + C * torch.logaddexp(z, torch.zeros_like(z)).sum()


def make_loss_fn(kind: str, feature_kind: str, b: int, C: float, *,
                 k: Optional[int] = None, sentinel: bool = False
                 ) -> Callable[[LinearModel, torch.Tensor, torch.Tensor],
                               torch.Tensor]:
    """Loss(model, features, y), the batch objective divided by the batch
    size (so C matches the paper's per-example weighting under
    mini-batching).  feature_kind: 'hashed' | 'packed' | 'dense'."""
    obj = svm_objective if kind == "svm" else logistic_objective

    def loss(model: LinearModel, feats: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        feats, fkind = _as_hashed(feats, feature_kind, b, k, sentinel)
        return obj(_margin(model, feats, fkind, b), y, model.w, C) / y.shape[0]

    return loss


def accuracy(model: LinearModel, feats: torch.Tensor, y: torch.Tensor, *,
             feature_kind: str, b: int = 0, k: Optional[int] = None,
             sentinel: bool = False) -> torch.Tensor:
    """Fraction of examples with sign(margin) == y, as a 0-d tensor."""
    feats, fkind = _as_hashed(feats, feature_kind, b, k, sentinel)
    m = _margin(model, feats, fkind, b)
    return (torch.sign(m) == y).to(torch.float32).mean()


# ---------------------------------------------------------------------------
# Bottou-style online SGD (§6, Eq. 11-12)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SGDState:
    model: LinearModel
    t: torch.Tensor          # () float32 step counter (for the lr schedule)
    avg_w: torch.Tensor      # ASGD running average
    avg_bias: torch.Tensor
    avg_start: float         # step at which averaging starts


def sgd_svm_init(dim: int, avg_start: float = 0.0,
                 device: DeviceLike = None) -> SGDState:
    m = LinearModel.create(dim, device)
    return SGDState(model=m, t=torch.zeros((), device=m.w.device),
                    avg_w=torch.zeros_like(m.w),
                    avg_bias=torch.zeros((), device=m.w.device),
                    avg_start=avg_start)


def sgd_svm_step(state: SGDState, feats: torch.Tensor, y: torch.Tensor, *,
                 lam: float, eta0: float, b: int, feature_kind: str = "hashed",
                 kind: str = "svm", average: bool = False,
                 k: Optional[int] = None, sentinel: bool = False) -> SGDState:
    """One mini-batch update with Bottou's eta0 / (1 + lam*eta0*t) rate.

    Eq. (12): w <- w - eta * (lam w + g), g the mini-batch mean of the
    per-example (hinge or logistic) gradients; the sparse gradient is a
    scatter-add (``index_add_``) over the Eq. (5) tokens.  ``average``
    maintains the §6.3 ASGD iterate average.  Updates ``state`` in place
    (see the module docstring) and returns it.
    """
    feats, fkind = _as_hashed(feats, feature_kind, b, k, sentinel)
    model = state.model
    eta = eta0 / (1.0 + lam * eta0 * state.t)

    m = _margin(model, feats, fkind, b)
    if kind == "svm":
        coef = torch.where(y * m < 1.0, -y, torch.zeros_like(y))
    else:
        coef = -y * torch.sigmoid(-y * m)
    coef = coef / y.shape[0]
    if fkind == "hashed":
        tok, valid = _valid_tokens(feats, b)
        scale = _scale(feats.shape[-1], model.w.device)
        upd = torch.where(valid, (coef[:, None] * scale).expand(tok.shape), 0.0)
        gw = torch.zeros_like(model.w).index_add_(0, tok.reshape(-1),
                                                  upd.reshape(-1))
    else:
        gw = feats.T @ coef
    gb = coef.sum()

    model.w.sub_(eta * (lam * model.w + gw))
    model.bias.sub_(eta * gb)
    state.t.add_(1.0)
    if average:
        # polynomial-decay averaging from avg_start onwards
        mu = 1.0 / torch.clamp(state.t - state.avg_start, min=1.0)
        take = (state.t > state.avg_start).to(torch.float32)
        state.avg_w.add_(take * mu * (model.w - state.avg_w))
        state.avg_bias.add_(take * mu * (model.bias - state.avg_bias))
    return state


def asgd_model(state: SGDState) -> LinearModel:
    """The averaged iterate (the last iterate before averaging starts)."""
    started = state.t > state.avg_start
    return LinearModel(w=torch.where(started, state.avg_w, state.model.w),
                       bias=torch.where(started, state.avg_bias,
                                        state.model.bias))


def calibrate_eta0(loss_at_eta: Callable[[float], float],
                   etas: Iterable[float] = (2.0 ** p for p in range(-8, 4))
                   ) -> float:
    """Bottou-style eta0 calibration on a small data subset: the eta with
    the lowest one-pass loss."""
    best, best_loss = None, float("inf")
    for eta in etas:
        loss = float(loss_at_eta(float(eta)))
        if loss < best_loss:
            best, best_loss = float(eta), loss
    return best
