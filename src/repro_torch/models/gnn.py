"""GatedGCN (Bresson & Laurent, arXiv:1711.07553; benchmark config
arXiv:2003.00982) with edge gates (port of ``repro.models.gnn``), by
gather / scatter-add message passing.

Per-edge messages are gathered with ``index_select`` and summed into
their destination nodes with ``index_add`` (the reference's
``jax.ops.segment_sum``): on the card the scatter adds atomically, so its
sums round in an order that changes from run to run unless
``torch.use_deterministic_algorithms(True)`` is set.

Layer (residual, batch-norm-free, RMS norm):
    e'_ij = A h_i + B h_j + C e_ij
    eta_ij = sigmoid(e'_ij) / (sum_j' sigmoid(e'_ij') + eps)
    h'_i  = h_i + ReLU(norm(U h_i + sum_j eta_ij * (V h_j)))
    e_ij  <- e_ij + ReLU(norm(e'_ij))

Full-batch graphs, batches of small graphs (a mean-pooled readout per
graph) and subgraphs from the fanout sampler ``neighbor_sample``.  Edges
are padded to a fixed count with a validity mask, as the reference pads
them.  Parameters keep the reference's tree (``embed_in``, ``embed_edge``,
``layers`` with each leaf stacked along axis 0, ``out``); ``GNNModel``
holds it.  The reference's ``constrain`` calls are the mesh path's
sharding hints and are left out; ``ROADMAP.md`` queue 1, "The multi-GPU
mesh path", brings them back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import TreeModel, normal_init, rms_norm
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch_id: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    aggregator: str = "gated"
    readout: str = "node"        # "node" | "graph" (mean-pool per graph id)
    param_dtype: torch.dtype = torch.float32
    remat: bool = False


class GNNModel(TreeModel):
    """A GNN's parameters under the reference's names (``embed_in``,
    ``layers.A`` ...), taken as they are, not copied."""


def _param_tree(cfg: GNNConfig, draw, ones) -> Dict:
    d, L, dt = cfg.d_hidden, cfg.n_layers, cfg.param_dtype
    s = d ** -0.5
    return {
        "embed_in": draw((cfg.d_in, d), cfg.d_in ** -0.5, dt),
        "embed_edge": draw((1, d), 1.0, dt),
        "layers": {**{k: draw((L, d, d), s, dt) for k in "ABCUV"},
                   "ln_h": ones((L, d), dt), "ln_e": ones((L, d), dt)},
        "out": draw((d, cfg.n_classes), s, dt),
    }


def init_gnn_params(cfg: GNNConfig, generator: torch.Generator) -> GNNModel:
    """Fresh weights at the reference's shapes and scales, drawn from
    ``generator`` on its device; each layer leaf stacked (L, ...) as the
    reference's ``vmap`` lays it out; norm weights ones."""
    dev = generator.device
    draw = lambda shape, s, dt: normal_init(generator, shape, s, dt)
    ones = lambda shape, dt: torch.ones(shape, dtype=dt, device=dev)
    return GNNModel(cfg, _param_tree(cfg, draw, ones))


def gnn_param_shapes(cfg: GNNConfig) -> Dict:
    """The parameter tree on the meta device: shapes and types only."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    return _param_tree(cfg, lambda shape, s, dt: meta(shape, dt), meta)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, ids, num_segments=n)``: rows of ``x``
    added into zeros of (n, ...) at ``ids``."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, ids, x)


def gatedgcn_layer(p: Dict, h: torch.Tensor, e: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor,
                   edge_mask: torch.Tensor, n_nodes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GatedGCN layer. h: (N, d); e: (E, d); src / dst: (E,) int32."""
    h_src = h.index_select(0, src)
    h_dst = h.index_select(0, dst)
    e_new = h_dst @ p["A"] + h_src @ p["B"] + e @ p["C"]       # (E, d)
    gate = torch.sigmoid(e_new) * edge_mask[:, None]
    gate_sum = _segment_sum(gate, dst, n_nodes)
    eta = gate / (gate_sum.index_select(0, dst) + 1e-6)         # (E, d)
    msg = eta * (h_src @ p["V"]) * edge_mask[:, None]
    agg = _segment_sum(msg, dst, n_nodes)                       # (N, d)
    h = h + torch.relu(rms_norm(h @ p["U"] + agg, p["ln_h"]))
    e = e + torch.relu(rms_norm(e_new, p["ln_e"]))
    return h, e


def gnn_forward(params: Dict, batch: Dict, cfg: GNNConfig) -> torch.Tensor:
    """batch: node_feats (N, d_in), edge_index (2, E) int32, edge_mask (E,)
    float, [node_mask (N,), graph_ids (N,), labels].  Returns logits
    (N, classes), or (graphs, classes) with the graph readout.  With
    ``cfg.remat`` each layer's activations are recomputed in the backward
    instead of kept, as the reference's ``jax.checkpoint`` does."""
    h = batch["node_feats"] @ params["embed_in"]
    E = batch["edge_index"].shape[1]
    e = params["embed_edge"].expand(E, cfg.d_hidden)
    src, dst = batch["edge_index"][0], batch["edge_index"][1]
    edge_mask = batch["edge_mask"].to(h.dtype)
    n_nodes = h.shape[0]
    stack = params["layers"]
    for i in range(cfg.n_layers):
        args = (tree_map(lambda t: t[i], stack), h, e, src, dst, edge_mask,
                n_nodes)
        if cfg.remat and torch.is_grad_enabled():
            h, e = torch.utils.checkpoint.checkpoint(
                gatedgcn_layer, *args, use_reentrant=False)
        else:
            h, e = gatedgcn_layer(*args)
    if cfg.readout == "graph":
        # mean-pool nodes into per-graph embeddings (batched small graphs)
        gids = batch["graph_ids"]
        n_graphs = batch["labels"].shape[0]
        nm = batch["node_mask"].to(h.dtype)
        sums = _segment_sum(h * nm[:, None], gids, n_graphs)
        cnt = _segment_sum(nm, gids, n_graphs)
        h = sums / torch.clamp(cnt, min=1.0)[:, None]
    return h @ params["out"]


def gnn_loss(params: Dict, batch: Dict, cfg: GNNConfig) -> torch.Tensor:
    """Cross-entropy: masked node classification, or per-graph readout."""
    logits = gnn_forward(params, batch, cfg).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, batch["labels"].long()[:, None])[:, 0]
    if cfg.readout == "graph":
        return nll.mean()
    mask = batch["node_mask"].float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Fanout neighbor sampler (GraphSAGE-style, for minibatch_lg)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed neighbor lists on the device."""
    indptr: torch.Tensor     # (N+1,) int32
    indices: torch.Tensor    # (nnz,) int32


def neighbor_sample(generator: Optional[torch.Generator], graph: CSRGraph,
                    seeds: torch.Tensor, fanouts: Sequence[int],
                    draws: Optional[Sequence[torch.Tensor]] = None) -> Dict:
    """Layer-wise uniform fanout sampling (with replacement).

    Returns a fixed-shape padded subgraph:
      nodes   (n_sub,) int32 -- [seeds, hop-1 samples, hop-2 samples, ...]
      edge_index (2, n_edges) int32 indices into ``nodes``
      edge_mask  (n_edges,) bool (False where the frontier node has no
      neighbor)
    Hop k draws an (F, fanout) int tensor in [0, 2^30) from ``generator``
    (on the graph's device); ``draws`` hands those tensors over instead,
    one per hop (the reference's ``jax.random.randint`` draws, which torch
    cannot reproduce).  A pick is the draw mod the node's degree, read
    from ``indices`` at an offset clamped to [0, nnz - 1] (the reference's
    ``mode="clip"``, which a zero-degree last node reaches).
    """
    dev = graph.indices.device
    nnz = graph.indices.shape[0]
    frontier = seeds
    all_nodes = [seeds]
    srcs, dsts, masks = [], [], []
    offset = 0
    for hop, fanout in enumerate(fanouts):
        F = frontier.shape[0]
        start = graph.indptr[frontier.long()].long()
        deg = graph.indptr[frontier.long() + 1].long() - start
        if draws is None:
            r = torch.randint(0, 1 << 30, (F, fanout), generator=generator,
                              device=dev)
        else:
            r = torch.as_tensor(draws[hop], device=dev).long()
            if tuple(r.shape) != (F, fanout):
                raise ValueError(f"hop {hop}: draws {tuple(r.shape)}, "
                                 f"want {(F, fanout)}")
        pick = r % torch.clamp(deg[:, None], min=1)
        at = torch.clamp(start[:, None] + pick, 0, nnz - 1)
        nbr = graph.indices[at]                                  # (F, fanout)
        valid = (deg > 0)[:, None].expand(F, fanout)
        new_offset = offset + F
        # edges: sampled neighbor (src) -> frontier node (dst)
        srcs.append(new_offset + torch.arange(F * fanout, device=dev))
        dsts.append((offset + torch.arange(F, device=dev))
                    .repeat_interleave(fanout))
        masks.append(valid.reshape(-1))
        all_nodes.append(nbr.reshape(-1))
        frontier = nbr.reshape(-1)
        offset = new_offset
    return {
        "nodes": torch.cat(all_nodes),
        "edge_index": torch.stack([torch.cat(srcs),
                                   torch.cat(dsts)]).to(torch.int32),
        "edge_mask": torch.cat(masks),
    }


def subgraph_sizes(n_seeds: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """(n_sub_nodes, n_sub_edges) for the fixed-shape sampled subgraph."""
    n_nodes, n_edges, frontier = n_seeds, 0, n_seeds
    for f in fanouts:
        n_edges += frontier * f
        frontier *= f
        n_nodes += frontier
    return n_nodes, n_edges
