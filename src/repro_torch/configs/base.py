"""Architecture / shape registry (port of the recsys part of
``repro.configs.base``).

Each arch module registers an ``ArchSpec``: ``family``, the published
``config``, a reduced ``smoke`` config of the same family for CPU runs, and
its ``source``.  The family's shape cells are the reference's.
``input_specs(arch, cell, smoke)`` gives each step input's shape and
``torch.dtype`` (an ``InputSpec``), and ``n_candidates`` as an int for
the retrieval cell; nothing is allocated.

Only the recsys family is ported: Wide & Deep, AutoInt, DIN and MIND in
their four cells.  The LM and GNN archs of the reference raise
``KeyError`` (``ROADMAP.md`` queue 1, "The rest of the repository").
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
    from repro_torch.configs import autoint, din, mind, wide_deep  # noqa: F401


# ---------------------------------------------------------------------------
# Family shape table (the reference's)
# ---------------------------------------------------------------------------

RECSYS_CELLS = [
    ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
]

FAMILY_CELLS = {"recsys": RECSYS_CELLS}

SMOKE_RECSYS = {"batch": 32, "n_candidates": 128}


def cells_for(arch_id: str):
    return FAMILY_CELLS[get_arch(arch_id).family]


def get_cell(arch_id: str, cell_name: str) -> ShapeCell:
    for c in cells_for(arch_id):
        if c.name == cell_name:
            return c
    raise KeyError(f"{arch_id} has no cell {cell_name!r}")


def get_config(arch_id: str, smoke: bool = False):
    """The arch's published config, or its smoke config (a recsys config
    does not depend on the cell)."""
    spec = get_arch(arch_id)
    return spec.smoke if smoke else spec.config


def input_specs(arch_id: str, cell_name: str,
                smoke: bool = False) -> Dict[str, Any]:
    """Each step input's ``InputSpec``; ``n_candidates`` (an int) for the
    retrieval cell, whose batch is always one query."""
    cell = get_cell(arch_id, cell_name)
    cfg = get_config(arch_id, smoke)
    if cell.kind == "recsys_retrieval":
        B = cell.dims["batch"]
    else:
        B = SMOKE_RECSYS["batch"] if smoke else cell.dims["batch"]
    i32, f32 = torch.int32, torch.float32
    out: Dict[str, Any] = {}
    if cfg.interaction in ("concat", "self-attn"):
        out["field_ids"] = InputSpec((B, cfg.n_fields), i32)
    else:
        out["hist_ids"] = InputSpec((B, cfg.seq_len), i32)
        out["hist_mask"] = InputSpec((B, cfg.seq_len), f32)
        out["target_id"] = InputSpec((B,), i32)
    if cfg.use_minhash_frontend:
        out["set_ids"] = InputSpec((B, cfg.set_nnz), i32)
        out["set_counts"] = InputSpec((B,), i32)
    if cell.kind == "recsys_train":
        out["labels"] = InputSpec((B,), f32)
    if cell.kind == "recsys_retrieval":
        out["n_candidates"] = (SMOKE_RECSYS["n_candidates"] if smoke
                               else cell.dims["n_candidates"])
    return out
