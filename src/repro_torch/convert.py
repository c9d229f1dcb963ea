"""Carry hash families, VW hashers, linear models, SGD and training state,
recsys, LM and GNN weights, LM caches and Adafactor states from the JAX
package into the port.

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
from repro_torch.core.vw import VWHasher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import GNNConfig, GNNModel
from repro_torch.models.linear import LinearModel, SGDState
from repro_torch.models.recsys import RecsysConfig, RecsysModel
from repro_torch.models.transformer import TransformerConfig, TransformerModel
from repro_torch.train.trainer import TrainState


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
        return Hash4U.from_numpy(np.asarray(family.a), family.s, dev,
                                 use_bitmod=family.use_bitmod)
    raise TypeError(f"not a hash family: {type(family)}")


def coefficients_of(family) -> Dict[str, np.ndarray]:
    """The ``make_family(coefficients=...)`` dict of a 2U/4U family or of
    an OPH scheme's base (JAX, or the port's on the CPU)."""
    base = getattr(family, "base", family)
    names = ("a1", "a2") if hasattr(base, "a1") else ("a",)
    return {n: np.asarray(getattr(base, n)).astype(np.uint32) for n in names}


def vw_from_jax(vw, device: DeviceLike = None) -> VWHasher:
    """A reference ``VWHasher`` (``full`` or ``u2``) -> the port's, with
    the same tables or coefficients."""
    if vw.mode == "full":
        return VWHasher.from_numpy(vw.m_bits, "full",
                                   bin_table=np.asarray(vw.bin_table),
                                   sign_table=np.asarray(vw.sign_table),
                                   device=device)
    return VWHasher.from_numpy(vw.m_bits, vw.mode,
                               **{n: np.asarray(getattr(vw, n))
                                  for n in ("a1", "a2", "s1", "s2")},
                               device=device)


def linear_model_from_jax(model, device: DeviceLike = None) -> LinearModel:
    """A reference ``LinearModel`` -> the port's, float32 on ``device``."""
    dev = resolve_device(device)
    return LinearModel(w=_tensor(model.w, dev, np.float32),
                       bias=_tensor(model.bias, dev, np.float32))


def train_state_from_jax(state, device: DeviceLike = None) -> TrainState:
    """A reference ``TrainState`` -> the port's: ``LinearModel`` params,
    the ``adamw`` / ``sgd`` state dict (``count`` int32; ``m`` / ``v`` /
    ``mu`` trees of the params' shape) and the int32 ``step``."""
    dev = resolve_device(device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(tree(v) for v in x)
        if hasattr(x, "w") and hasattr(x, "bias"):
            return linear_model_from_jax(x, dev)
        return _tensor(x, dev)

    return TrainState(params=tree(state.params),
                      opt_state=tree(state.opt_state),
                      step=_tensor(state.step, dev, np.int32))


def _tensor(x, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype)).to(dev)


def sgd_state_from_jax(state, device: DeviceLike = None) -> SGDState:
    """A reference ``SGDState`` -> the port's, float32 on ``device``."""
    dev = resolve_device(device)
    t = lambda x: _tensor(x, dev, np.float32)
    return SGDState(model=linear_model_from_jax(state.model, dev), t=t(state.t),
                    avg_w=t(state.avg_w), avg_bias=t(state.avg_bias),
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


def _map_nested(fn, x):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _map_nested(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_nested(fn, v) for v in x)
    return fn(x)


def tree_from_numpy(tree, device: DeviceLike = None, float_dtype=None):
    """A tree of dicts and lists of array-likes (a reference param dict or
    optimizer state, or numpy) -> the same tree of tensors on ``device``.
    Integer leaves keep their type; bfloat16 leaves (numpy's ml_dtypes
    type) stay bfloat16, read through float32; other float leaves become
    ``float_dtype`` (float32 by default)."""
    dev = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(np.array(a)).to(dev)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=float_dtype or torch.float32)

    return _map_nested(leaf, tree)


def tree_to_numpy(tree):
    """Either package's tree of dicts and lists of arrays -> numpy, with
    bfloat16 leaves as float32 (numpy has no bfloat16 of its own)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    return _map_nested(leaf, tree)


def adafactor_state_from_numpy(state, device: DeviceLike = None) -> Dict:
    """An ``adafactor`` / ``adafactor_fused`` state of either package, or
    its ``tree_to_numpy`` form (``m`` there float32), -> the port's:
    ``count`` int32, ``v`` a tree of ``{"vr", "vc"}`` / ``{"v"}`` float32
    dicts, ``m`` bfloat16 (``momentum_dtype``) where there is momentum."""
    out = tree_from_numpy({k: v for k, v in state.items() if k != "m"},
                          device)
    out["count"] = out["count"].to(torch.int32)
    if "m" in state:
        out["m"] = tree_from_numpy(state["m"], device,
                                   float_dtype=torch.bfloat16)
    return out


def recsys_params_from_jax(params, cfg: RecsysConfig, a1=None, a2=None,
                           device: DeviceLike = None) -> RecsysModel:
    """A reference recsys param dict of any interaction (``tables``,
    ``wide``, ``deep``, ``attn_layers`` as a list of dicts, ``item_table``,
    ``attn_mlp``, ``S``, ``head``, ``minhash_table``), and its frontend's
    2U coefficients (uint32 arrays; the reference draws them per process,
    so they are handed over), -> the port's model with the same values on
    ``device``.  ``cfg`` is the port's config of the same arch."""
    dev = resolve_device(device)
    p = tree_from_numpy(params, dev, float_dtype=cfg.param_dtype)
    if cfg.use_minhash_frontend:
        a1, a2 = from_numpy(a1, dev), from_numpy(a2, dev)
    return RecsysModel(cfg, p, a1, a2)


def lm_params_from_jax(params, cfg: TransformerConfig,
                       device: DeviceLike = None) -> TransformerModel:
    """A reference LM parameter tree (``embed``, ``out``, ``final_norm``,
    ``layers`` and ``dense_layers`` stacked along axis 0; numpy arrays or
    anything ``np.asarray`` reads) -> the port's model with the same
    values on ``device``.  Each leaf keeps its type: bfloat16 (numpy's
    ``ml_dtypes`` type) bit for bit, float32 (the MoE router of a
    bfloat16 model) as float32.  ``cfg`` is the port's config of the same
    arch."""
    return TransformerModel(cfg, tree_from_numpy(params, device))


def lm_cache_from_jax(cache, device: DeviceLike = None) -> Dict:
    """A reference KV cache tree (``layers`` / ``dense_layers`` of ``k``,
    ``v`` or MLA's ``ckv``, ``kr``) -> the port's, each leaf in its own
    type on ``device``."""
    return tree_from_numpy(cache, device)


def gnn_params_from_jax(params, cfg: GNNConfig,
                        device: DeviceLike = None) -> GNNModel:
    """A reference GNN parameter tree (``embed_in``, ``embed_edge``,
    ``layers`` stacked along axis 0, ``out``; numpy arrays or anything
    ``np.asarray`` reads) -> the port's model with the same values on
    ``device``, in ``cfg.param_dtype``.  ``cfg`` is the port's config of
    the same arch and cell."""
    return GNNModel(cfg, tree_from_numpy(params, device,
                                         float_dtype=cfg.param_dtype))
