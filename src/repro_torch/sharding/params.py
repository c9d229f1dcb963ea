"""Parameter / optimizer-state ``PartitionSpec`` trees per architecture
family (port of ``repro.sharding.params``).

LMs use FSDP+TP: the tensor-parallel ("model") axis shards heads / d_ff /
vocab / experts; the FSDP ("data") axis shards the complementary matrix
dim (ZeRO-3 -- optimizer state shards identically since it mirrors the
param tree).  GNN params are tiny -> replicated.  RecSys embedding tables
are row-sharded over "model".

Specs come from *path and shape rules* over a parameter tree -- the
port's trees on the meta device (``transformer.param_shapes``,
``gnn.gnn_param_shapes``, ``recsys.recsys_param_shapes``), so nothing is
allocated -- and so always match the real tree.  Axis names are literal
(``"data"`` is the "data" axis only); placing a tensor under a spec
(``rules.NamedSharding(..., greedy=True)``) drops, within a tuple, the
axes that do not divide.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.tree import map_with_path, path_leaves


def _keys(path: str) -> Tuple[str, ...]:
    return tuple(path.split("/")) if path else ()


def _norm_spec(spec: P, rank: int) -> Tuple:
    t = tuple(spec) + (None,) * (rank - len(tuple(spec)))
    return t[:rank]


# -- LM rules ---------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "wdq", "wuq", "wdkv", "wukv", "wkr",
                 "w_gate", "w_up"}          # (.., in, out): out -> model
_ROW_PARALLEL = {"wo", "w_down"}            # (.., in, out): in -> model


def lm_param_specs(shapes: Any) -> Any:
    def rule(path, leaf):
        keys = _keys(path)
        name = keys[-1]
        rank = leaf.dim()
        in_layer_stack = any(k in ("layers", "dense_layers") for k in keys)
        lead = (None,) if in_layer_stack else ()
        if name == "embed":
            # vocab FSDP'd over the data axes only (the reference's
            # partitioned-gather constraint)
            return P("data", None)
        if name == "out":
            return P(None, "model")     # vocab-parallel logits
        if name == "final_norm":
            return P()
        if name == "router":
            return P()           # replicated: expert parallelism needs it whole
        in_moe_experts = rank == 4 or (rank == 3 and not in_layer_stack)
        if in_moe_experts and name in (_COL_PARALLEL | _ROW_PARALLEL):
            # the EP group spans as many mesh axes as E divides into
            # (models.moe.ep_layout): 256-expert models cover the whole
            # ("model", "data") pod, "model" major, d_ff FSDP'd over
            # "pod"; small-E models keep E on "model" and FSDP d_ff over
            # ("data", "pod")
            E = leaf.shape[1] if rank == 4 else leaf.shape[0]
            if E % 256 == 0:
                e_ax, f_ax = ("model", "data"), ("pod",)
            else:
                e_ax, f_ax = ("model",), ("data", "pod")
            if name in _COL_PARALLEL:    # (L, E, d, f)
                return P(None, e_ax, None, f_ax) if rank == 4 \
                    else P(e_ax, None, f_ax)
            return P(None, e_ax, f_ax, None) if rank == 4 \
                else P(e_ax, f_ax, None)
        if name in _COL_PARALLEL:
            return P(*lead, "data", "model")
        if name in _ROW_PARALLEL:
            return P(*lead, "model", "data")
        return P()               # norms and other vectors: replicated

    return map_with_path(rule, shapes)


# -- GNN rules --------------------------------------------------------------

def gnn_param_specs(shapes: Any) -> Any:
    return map_with_path(lambda path, leaf: P(), shapes)


# -- RecSys rules -----------------------------------------------------------

def recsys_param_specs(shapes: Any) -> Any:
    def rule(path, leaf):
        name = _keys(path)[-1]
        if name in ("tables", "wide", "minhash_table"):
            return P(None, "model", None)
        if name == "item_table":
            return P("model", None)
        return P()

    return map_with_path(rule, shapes)


def param_specs_for(family: str, shapes: Any) -> Any:
    return {"lm": lm_param_specs, "gnn": gnn_param_specs,
            "recsys": recsys_param_specs}[family](shapes)


# -- optimizer-state specs (mirror the param tree) ---------------------------

def opt_state_specs(param_specs: Any, param_shapes: Any,
                    opt_shapes: Any) -> Any:
    """Opt-state specs: moments mirror their parameter's spec;
    Adafactor's factored stats drop the corresponding dim (``vr`` the last,
    ``vc`` the one before); scalars replicate."""
    spec_of = dict(path_leaves(param_specs))
    spec_by_path: Dict[Tuple[str, ...], Tuple] = {
        _keys(path): _norm_spec(spec_of[path], leaf.dim())
        for path, leaf in path_leaves(param_shapes)}

    def rule(path, leaf):
        keys = _keys(path)
        if keys and keys[0] in ("m", "v", "mu"):
            rest = keys[1:]
            if rest in spec_by_path:
                return P(*spec_by_path[rest])
            if rest and rest[-1] == "vr" and rest[:-1] in spec_by_path:
                s = spec_by_path[rest[:-1]]
                return P(*s[:-1])
            if rest and rest[-1] == "vc" and rest[:-1] in spec_by_path:
                s = spec_by_path[rest[:-1]]
                return P(*(s[:-2] + s[-1:]))
        return P()

    return map_with_path(rule, opt_shapes)
