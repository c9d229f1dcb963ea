"""Architecture / shape registry (port of ``repro.configs.base``).

Each arch module registers an ``ArchSpec``: ``family``, the published
``config``, a reduced ``smoke`` config of the same family for CPU runs, and
its ``source``, and the cells it skips (``skip_cells``, cell -> reason).
The family's shape cells are the reference's.  ``config_for_cell(arch,
cell, smoke)`` is the model config a cell runs (a GNN's ``d_in``,
``n_classes`` and ``readout`` are the cell's); ``input_specs(arch, cell,
smoke)`` gives each step input's shape and ``torch.dtype`` (an
``InputSpec``; a decode cell's ``cache`` a tree of them), and
``n_candidates`` as an int for the retrieval cell; nothing is allocated.

Every arch of the reference is here: the recsys family (Wide & Deep,
AutoInt, DIN and MIND in their four cells), the five LM archs
(deepseek-7b, yi-34b, mistral-large-123b, llama4-scout-17b-a16e,
deepseek-v3-671b) and GatedGCN in the four GNN cells.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.gnn import subgraph_sizes
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
                       f"{sorted(_REGISTRY)}, every arch of the reference")
    return _REGISTRY[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (autoint, deepseek_7b,  # noqa: F401
                                     deepseek_v3_671b, din, gatedgcn,
                                     llama4_scout, mind, mistral_large_123b,
                                     wide_deep, yi_34b)


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

GNN_CELLS = [
    ShapeCell("full_graph_sm", "gnn_train_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_classes": 7}),
    ShapeCell("minibatch_lg", "gnn_train_sampled",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout1": 15, "fanout2": 10, "d_feat": 602, "n_classes": 41}),
    ShapeCell("ogb_products", "gnn_train_full",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_classes": 47}),
    ShapeCell("molecule", "gnn_train_graphs",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 28,
               "n_classes": 2}),
]

RECSYS_CELLS = [
    ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
]

FAMILY_CELLS = {"lm": LM_CELLS, "gnn": GNN_CELLS, "recsys": RECSYS_CELLS}

SMOKE_LM = {"batch": 2, "seq": 64, "decode_len": 64}
SMOKE_GNN = {"n_nodes": 64, "n_edges": 256, "d_feat": 16, "n_classes": 4,
             "batch_nodes": 8, "fanout1": 3, "fanout2": 2, "batch": 4}
SMOKE_RECSYS = {"batch": 32, "n_candidates": 128}


def cells_for(arch_id: str):
    return FAMILY_CELLS[get_arch(arch_id).family]


def get_cell(arch_id: str, cell_name: str) -> ShapeCell:
    for c in cells_for(arch_id):
        if c.name == cell_name:
            return c
    raise KeyError(f"{arch_id} has no cell {cell_name!r}")


def config_for_cell(arch_id: str, cell: ShapeCell, smoke: bool = False):
    """The arch's published config, or its smoke config, for ``cell``: a
    GNN's ``d_in``, ``n_classes`` and ``readout`` are the cell's (an LM or
    recsys config does not depend on the cell)."""
    spec = get_arch(arch_id)
    cfg = spec.smoke if smoke else spec.config
    if spec.family == "gnn":
        dims = SMOKE_GNN if smoke else cell.dims
        cfg = dataclasses.replace(
            cfg, d_in=dims["d_feat"], n_classes=dims["n_classes"],
            readout="graph" if cell.kind == "gnn_train_graphs" else "node")
    return cfg


def _pad512(n: int) -> int:
    """Edge arrays are padded (mask-valid) to a 512 multiple so they tile
    and shard evenly; the data loader pads identically."""
    return ((n + 511) // 512) * 512


def _gnn_specs(kind: str, dims: Dict[str, int]) -> Dict[str, InputSpec]:
    i32, f32 = torch.int32, torch.float32
    if kind == "gnn_train_full":
        N, E = _pad512(dims["n_nodes"]), _pad512(dims["n_edges"])
    elif kind == "gnn_train_sampled":
        N, E = map(_pad512, subgraph_sizes(
            dims["batch_nodes"], (dims["fanout1"], dims["fanout2"])))
    else:                                       # gnn_train_graphs
        N = dims["batch"] * dims["n_nodes"]
        E = _pad512(dims["batch"] * dims["n_edges"])
    out = {"node_feats": InputSpec((N, dims["d_feat"]), f32),
           "edge_index": InputSpec((2, E), i32),
           "edge_mask": InputSpec((E,), f32),
           "labels": InputSpec((dims["batch"] if kind == "gnn_train_graphs"
                                else N,), i32),
           "node_mask": InputSpec((N,), f32)}
    if kind == "gnn_train_graphs":
        out["graph_ids"] = InputSpec((N,), i32)
    return out


def input_specs(arch_id: str, cell_name: str,
                smoke: bool = False) -> Dict[str, Any]:
    """Each step input's ``InputSpec`` (a decode cell's ``cache``: the
    tree of ``init_cache``); ``n_candidates`` (an int) for the recsys
    retrieval cell, whose batch is always one query."""
    cell = get_cell(arch_id, cell_name)
    cfg = config_for_cell(arch_id, cell, smoke)
    family = get_arch(arch_id).family
    i32, f32 = torch.int32, torch.float32
    if family == "gnn":
        return _gnn_specs(cell.kind, SMOKE_GNN if smoke else cell.dims)
    if family == "lm":
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
