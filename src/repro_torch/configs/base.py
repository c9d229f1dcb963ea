"""Architecture / shape registry (port of the recsys part of
``repro.configs.base``).

Each arch module registers an ``ArchSpec``: ``family``, the published
``config``, a reduced ``smoke`` config of the same family for CPU runs, and
its ``source``.  The family's shape cells are the reference's.
``input_specs(arch, cell, smoke)`` gives each step input's shape and
``torch.dtype`` (an ``InputSpec``); nothing is allocated.

Only the recsys family is ported, and of it Wide & Deep with its serving
cells; every other arch or cell of the reference raises ``KeyError``
(``ROADMAP.md`` queue 1 lists them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                       # step kind, see launch/steps.py
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    config: Any
    smoke: Any
    source: str


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Shape and type of one step input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not in the port, which has "
                       f"{sorted(_REGISTRY)}; ROADMAP.md queue 1 lists the "
                       "models still to port")
    return _REGISTRY[arch_id]


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import wide_deep  # noqa: F401


# ---------------------------------------------------------------------------
# Family shape tables (the reference's, for the ported cells)
# ---------------------------------------------------------------------------

RECSYS_CELLS = [
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
]

SMOKE_RECSYS = {"batch": 32}


def get_cell(arch_id: str, cell_name: str) -> ShapeCell:
    get_arch(arch_id)                      # every ported arch is recsys
    for c in RECSYS_CELLS:
        if c.name == cell_name:
            return c
    raise KeyError(f"{arch_id} has no ported cell {cell_name!r} (ported: "
                   f"{[c.name for c in RECSYS_CELLS]}); ROADMAP.md queue 1, "
                   "'Recsys, the rest', lists the rest")


def get_config(arch_id: str, smoke: bool = False):
    """The arch's published config, or its smoke config (a recsys config
    does not depend on the cell)."""
    spec = get_arch(arch_id)
    return spec.smoke if smoke else spec.config


def input_specs(arch_id: str, cell_name: str,
                smoke: bool = False) -> Dict[str, InputSpec]:
    """Each step input's ``InputSpec``."""
    cell = get_cell(arch_id, cell_name)
    cfg = get_config(arch_id, smoke)
    B = SMOKE_RECSYS["batch"] if smoke else cell.dims["batch"]
    out = {"field_ids": InputSpec((B, cfg.n_fields), torch.int32)}
    if cfg.use_minhash_frontend:
        out["set_ids"] = InputSpec((B, cfg.set_nnz), torch.int32)
        out["set_counts"] = InputSpec((B,), torch.int32)
    return out
