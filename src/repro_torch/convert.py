"""Carry hash families, SGD state and recsys weights from the JAX package
into the port.

Nothing here imports ``jax`` or ``repro``: a JAX object is read through
its attributes with ``np.asarray`` (which any array-like supports), so
the conversion needs only the values.  The tests use it to make both
packages compute the same thing: ``jax.random.bits`` cannot be reproduced
in PyTorch, so the coefficients are handed over.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.hashing import Hash2U, Hash4U, PermutationFamily
from repro_torch.core.oph import OPH
from repro_torch.core.u32 import from_numpy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.linear import LinearModel, SGDState
from repro_torch.models.recsys import RecsysConfig, RecsysModel


def family_from_jax(family, device: DeviceLike = None):
    """A reference ``Hash2U`` / ``Hash4U`` / ``PermutationFamily`` /
    ``OPH`` -> the port's family with the same coefficients."""
    dev = resolve_device(device)
    if hasattr(family, "densify") and hasattr(family, "base"):
        return OPH(family_from_jax(family.base, dev), family.k,
                   family.densify)
    if hasattr(family, "perms"):
        return PermutationFamily.from_numpy(np.asarray(family.perms), dev)
    if hasattr(family, "a1") and hasattr(family, "a2"):
        return Hash2U.from_numpy(np.asarray(family.a1), np.asarray(family.a2),
                                 family.s, family.variant, dev)
    if hasattr(family, "a"):
        if not getattr(family, "use_bitmod", True):
            raise ValueError("the port's Hash4U always reduces with BitMod")
        return Hash4U.from_numpy(np.asarray(family.a), family.s, dev)
    raise TypeError(f"not a hash family: {type(family)}")


def coefficients_of(family) -> Dict[str, np.ndarray]:
    """The ``make_family(coefficients=...)`` dict of a 2U/4U family or of
    an OPH scheme's base (JAX, or the port's on the CPU)."""
    base = getattr(family, "base", family)
    names = ("a1", "a2") if hasattr(base, "a1") else ("a",)
    return {n: np.asarray(getattr(base, n)).astype(np.uint32) for n in names}


def sgd_state_from_jax(state, device: DeviceLike = None) -> SGDState:
    """A reference ``SGDState`` -> the port's, float32 on ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return SGDState(model=LinearModel(w=t(state.model.w), bias=t(state.model.bias)),
                    t=t(state.t), avg_w=t(state.avg_w),
                    avg_bias=t(state.avg_bias),
                    avg_start=float(state.avg_start))


def sgd_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Either package's ``SGDState`` as a dict of float32 numpy arrays."""
    def a(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    return {"w": a(state.model.w), "bias": a(state.model.bias),
            "t": a(state.t), "avg_w": a(state.avg_w),
            "avg_bias": a(state.avg_bias)}


def recsys_params_from_jax(params, cfg: RecsysConfig, a1=None, a2=None,
                           device: DeviceLike = None) -> RecsysModel:
    """A reference recsys param dict, and its frontend's 2U coefficients
    (uint32 arrays; the reference draws them per process, so they are
    handed over), -> the port's model with the same values on ``device``.
    ``cfg`` is the port's config of the same arch."""
    dev = resolve_device(device)

    def t(x):
        # through float32: numpy has no bfloat16 torch can read
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=dev, dtype=cfg.param_dtype)

    p = {"tables": t(params["tables"]), "wide": t(params["wide"]),
         "deep": {"w": [t(w) for w in params["deep"]["w"]],
                  "b": [t(b) for b in params["deep"]["b"]]}}
    if cfg.use_minhash_frontend:
        p["minhash_table"] = t(params["minhash_table"])
        a1, a2 = from_numpy(a1, dev), from_numpy(a2, dev)
    return RecsysModel(cfg, p, a1, a2)
