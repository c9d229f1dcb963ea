"""Architecture / shape registry (port of the recsys and LM parts of
``repro.configs.base``).

Each arch module registers an ``ArchSpec``: ``family``, the published
``config``, a reduced ``smoke`` config of the same family for CPU runs, and
its ``source``, and the cells it skips (``skip_cells``, cell -> reason).
The family's shape cells are the reference's.  ``input_specs(arch, cell,
smoke)`` gives each step input's shape and ``torch.dtype`` (an
``InputSpec``; a decode cell's ``cache`` a tree of them), and
``n_candidates`` as an int for the retrieval cell; nothing is allocated.

Ported: the recsys family (Wide & Deep, AutoInt, DIN and MIND in their
four cells) and the five LM archs (deepseek-7b, yi-34b,
mistral-large-123b, llama4-scout-17b-a16e, deepseek-v3-671b).  The GNN
arch of the reference raises ``KeyError`` (``ROADMAP.md`` queue 1,
"GNN").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                       # step kind, see launch/steps.py
    dims: Dict[str, int]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    config: Any
    smoke: Any
    source: str
    skip_cells: Dict[str, str] = dataclasses.field(default_factory=dict)


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


def all_archs() -> Dict[str, ArchSpec]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (autoint, deepseek_7b,  # noqa: F401
                                     deepseek_v3_671b, din, llama4_scout,
                                     mind, mistral_large_123b, wide_deep,
                                     yi_34b)


# ---------------------------------------------------------------------------
# Family shape tables (the reference's)
# ---------------------------------------------------------------------------

LM_CELLS = [
    ShapeCell("train_4k", "lm_train", {"batch": 256, "seq": 4096}),
    ShapeCell("prefill_32k", "lm_prefill", {"batch": 32, "seq": 32768}),
    ShapeCell("decode_32k", "lm_decode", {"batch": 128, "seq": 32768}),
    ShapeCell("long_500k", "lm_decode", {"batch": 1, "seq": 524288},
              note="sub-quadratic attention required"),
]

RECSYS_CELLS = [
    ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
]

FAMILY_CELLS = {"lm": LM_CELLS, "recsys": RECSYS_CELLS}

SMOKE_LM = {"batch": 2, "seq": 64, "decode_len": 64}
SMOKE_RECSYS = {"batch": 32, "n_candidates": 128}


def cells_for(arch_id: str):
    return FAMILY_CELLS[get_arch(arch_id).family]


def get_cell(arch_id: str, cell_name: str) -> ShapeCell:
    for c in cells_for(arch_id):
        if c.name == cell_name:
            return c
    raise KeyError(f"{arch_id} has no cell {cell_name!r}")


def get_config(arch_id: str, smoke: bool = False):
    """The arch's published config, or its smoke config (an LM or recsys
    config does not depend on the cell)."""
    spec = get_arch(arch_id)
    return spec.smoke if smoke else spec.config


def input_specs(arch_id: str, cell_name: str,
                smoke: bool = False) -> Dict[str, Any]:
    """Each step input's ``InputSpec`` (a decode cell's ``cache``: the
    tree of ``init_cache``); ``n_candidates`` (an int) for the recsys
    retrieval cell, whose batch is always one query."""
    cell = get_cell(arch_id, cell_name)
    cfg = get_config(arch_id, smoke)
    i32, f32 = torch.int32, torch.float32
    if get_arch(arch_id).family == "lm":
        B = SMOKE_LM["batch"] if smoke else cell.dims["batch"]
        S = SMOKE_LM["seq"] if smoke else cell.dims["seq"]
        if cell.kind == "lm_train":
            return {"tokens": InputSpec((B, S), i32),
                    "labels": InputSpec((B, S), i32)}
        if cell.kind == "lm_prefill":
            return {"tokens": InputSpec((B, S), i32)}
        from repro_torch.models.transformer import cache_shapes
        cache = tree_map(lambda t: InputSpec(tuple(t.shape), t.dtype),
                         cache_shapes(cfg, B, S))
        return {"cache": cache, "tokens": InputSpec((B,), i32),
                "pos": InputSpec((), i32)}
    if cell.kind == "recsys_retrieval":
        B = cell.dims["batch"]
    else:
        B = SMOKE_RECSYS["batch"] if smoke else cell.dims["batch"]
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


def is_skipped(arch_id: str, cell_name: str) -> Optional[str]:
    """The reason the arch skips the cell, or None if the cell runs."""
    return get_arch(arch_id).skip_cells.get(cell_name)
