"""Analytic per-GPU FLOPs / HBM bytes / collective bytes (port of
``repro.roofline.analytic``): the reference's napkin-math estimators, the
same formulas on the same integers, over a ``launch.steps.CellProgram``
and any mesh with ``axis_names`` and ``shape`` (a shape-only
``launch.mesh.abstract_mesh`` in the dry run).

The reference records these beside the numbers XLA's compiled HLO gives
and takes them for its roofline terms, since XLA:CPU counts a scanned
layer stack once.  Torch emits no compiled artifact to read, so here they
are the only source (``roofline.analysis.analyze``).

Conventions (per GPU, per step):
  dp   = product of data-parallel axes (pod * data)
  tp   = model axis size
  AR(x)= ring all-reduce traffic  ~ 2 x bytes
  AG/RS of a tensor of full size x over an axis of size n ~ x (n-1)/n ~ x
Weights are re-gathered per microbatch (the FSDP cost of accumulation).
"""

from __future__ import annotations

import math
from typing import Dict

from repro_torch.launch.steps import (ADAFACTOR_THRESHOLD,
                                      MOMENTUM_FREE_THRESHOLD)
from repro_torch.models.moe import ep_layout
from repro_torch.models.transformer import count_active_params, count_params
from repro_torch.roofline.analysis import first_leaf, recsys_model_flops
from repro_torch.tree import tree_leaves


def _mesh_sizes(mesh):
    tp = mesh.shape.get("model", 1)
    dp = math.prod(s for n, s in mesh.shape.items() if n != "model")
    return dp, tp


def lm_train(cfg, B: int, S: int, n_params: int, n_active: int, mesh
             ) -> Dict[str, float]:
    dp, tp = _mesh_sizes(mesh)
    chips = dp * tp
    T = B * S
    m = max(1, cfg.microbatch)
    L = cfg.n_layers
    d = cfg.d_model
    pbytes = 2.0 * n_params                      # bf16
    pbytes_chip = pbytes / chips

    # -- FLOPs: 2N fwd + 4N bwd + 2N remat-refwd = 8N per token ----------
    mat = 8.0 * n_active * T / chips
    # attention: causal 0.5 factor; llama4 chunked-local: 3/4 of layers see
    # only their window
    if cfg.local_window > 0:
        frac = 0.25 + 0.75 * min(cfg.local_window, S) / S
    else:
        frac = 1.0
    attn_fwd = 2.0 * 2.0 * B * S * S * 0.5 * frac * cfg.n_heads \
        * cfg.head_dim * L
    attn = attn_fwd * 4.0 / chips                # fwd + refwd + 2x bwd
    flops = mat + attn

    # -- HBM bytes --------------------------------------------------------
    opt_bytes_chip = _opt_bytes(n_params) / chips
    weights = pbytes_chip * (3.0 * m + 2.0) + 2.0 * opt_bytes_chip
    stash = L * (T / dp / m) * (d / tp) * 2.0    # sharded stash, 1 µbatch
    acts = 6.0 * stash * m                       # write+read+transients
    kv_write = L * (T / dp) * 2 * cfg.n_kv * cfg.head_dim * 2.0 / tp
    byts = weights + acts + kv_write

    # -- collectives ------------------------------------------------------
    x_chip = (T / dp / m) * d * 2.0              # one µbatch's activations
    expert_bytes = 0.0
    n_moe = 0
    if cfg.is_moe:
        n_moe = L - cfg.n_dense_layers
        expert_bytes = 2.0 * n_moe * cfg.moe.n_experts * 3 * d * cfg.moe.d_ff
    dense_bytes = pbytes - expert_bytes
    fsdp_ag = 3.0 * m * (dense_bytes / tp)       # weight AG fwd/refwd/bwd
    grad_rs = dense_bytes / tp
    tp_ar = 12.0 * x_chip * L * m                # row-parallel AR + x AGs
    coll = fsdp_ag + grad_rs + tp_ar
    breakdown = {"fsdp_weight_allgather": fsdp_ag, "grad_reduce_scatter":
                 grad_rs, "tp_activation_allreduce": tp_ar}
    if cfg.is_moe:
        E = cfg.moe.n_experts
        ep_axes, ffn_axes, _ = ep_layout(mesh, E)
        n_ep = 1
        for nm in ep_axes:
            n_ep *= mesh.shape[nm]
        if ffn_axes:
            # d_ff FSDP'd over the leftover axes: gathered per pass
            exp_ag = 3.0 * m * (expert_bytes / max(n_ep, 1))
        else:
            exp_ag = 0.0          # whole experts resident: no gathering
        a2a = 3.0 * n_moe * 4.0 * (T / chips) * cfg.moe.top_k * d * 2.0
        coll += a2a + exp_ag
        breakdown["moe_all_to_all"] = a2a
        breakdown["moe_weight_allgather"] = exp_ag
    return {"flops": flops, "bytes": byts, "coll": coll,
            "coll_breakdown": breakdown}


def lm_prefill(cfg, B: int, S: int, n_params: int, n_active: int, mesh):
    dp, tp = _mesh_sizes(mesh)
    chips = dp * tp
    T = B * S
    L, d = cfg.n_layers, cfg.d_model
    if cfg.local_window > 0:
        frac = 0.25 + 0.75 * min(cfg.local_window, S) / S
    else:
        frac = 1.0
    attn = 2.0 * 2.0 * B * S * S * 0.5 * frac * cfg.n_heads * cfg.head_dim \
        * L / chips
    flops = 2.0 * n_active * T / chips + attn
    pbytes = 2.0 * n_params
    byts = pbytes / chips + 4.0 * L * (T / dp) * (d / tp) * 2.0
    x_chip = (T / dp) * d * 2.0
    coll = pbytes / tp + 4.0 * x_chip * L
    return {"flops": flops, "bytes": byts, "coll": coll,
            "coll_breakdown": {"fsdp_weight_allgather": pbytes / tp,
                               "tp_activation_allreduce": 4.0 * x_chip * L}}


def lm_decode(cfg, B: int, L_cache: int, n_params: int, n_active: int, mesh):
    dp, tp = _mesh_sizes(mesh)
    chips = dp * tp
    L, d = cfg.n_layers, cfg.d_model
    flops = 2.0 * n_active * B / chips
    if cfg.attention == "mla":
        row = cfg.kv_lora + cfg.qk_rope
        # absorbed decode: scores + output both against the compressed cache
        flops += 2.0 * 2.0 * B * L_cache * cfg.n_heads * cfg.kv_lora / chips
        cache_bytes = L * B * L_cache * row * 2.0
    else:
        if cfg.local_window > 0:
            eff = 0.25 * L_cache + 0.75 * min(cfg.local_window, L_cache)
        else:
            eff = L_cache
        flops += 2.0 * 2.0 * B * eff * cfg.n_heads * cfg.head_dim * L / chips
        cache_bytes = L * B * L_cache * 2 * cfg.n_kv * cfg.head_dim * 2.0
    byts = 2.0 * n_active / chips + cache_bytes / chips
    # TP ARs of the (B, d) residual per layer + cache-shard softmax stats
    x_chip = (B / dp) * d * 2.0
    coll = 4.0 * x_chip * L + 2.0 * (B / dp) * cfg.n_heads * 4.0 * L
    return {"flops": flops, "bytes": byts, "coll": coll,
            "coll_breakdown": {"tp_activation_allreduce": coll}}


def _opt_bytes(n_params: int) -> float:
    if n_params > MOMENTUM_FREE_THRESHOLD:
        return 0.1 * n_params            # factored stats only
    if n_params > ADAFACTOR_THRESHOLD:
        return 2.0 * n_params + 0.1 * n_params   # bf16 momentum + stats
    return 8.0 * n_params                # adamw fp32 m+v


def gnn_train(cfg, N: int, E: int, mesh, d_in: int,
              shard_nodes: bool = True):
    """Node tensors sharded over the data axes; ``shard_nodes=False``
    models the replicated-node baseline where every GPU runs the full node
    matmuls and psums whole node tables."""
    dp, tp = _mesh_sizes(mesh)
    chips = dp * tp
    d, L = cfg.d_hidden, cfg.n_layers
    node_div = dp if shard_nodes else 1.0
    edge_div = chips if shard_nodes else dp      # edges over ALL axes
    node_mm = 2.0 * 5 * N * d * d * L / node_div
    edge_ops = 2.0 * 2 * E * d * L / edge_div
    flops = 3.0 * (node_mm + edge_ops) + 2.0 * N * d_in * d / node_div
    byts = 3.0 * L * (8.0 * (N / node_div) * d * 4.0
                      + 6.0 * (E / edge_div) * d * 4.0) \
        + (N / node_div) * d_in * 4.0
    if shard_nodes:
        # per layer: gather h at remote edge endpoints + scatter partial
        # aggregates home: ~4 (N, d) fp32 exchanges, x3 passes
        coll = 3.0 * L * 4.0 * N * d * 4.0 / dp
        label = "node_halo_exchange"
    else:
        # gate_sum + agg psums of the full (N, d) fp32 table per layer
        coll = 3.0 * L * 2.0 * 2.0 * N * d * 4.0
        label = "node_psum_allreduce"
    return {"flops": flops, "bytes": byts, "coll": coll,
            "coll_breakdown": {label: coll}}


def recsys_step(cfg, B: int, model_flops_total: float, n_params: int, mesh,
                training: bool):
    dp, tp = _mesh_sizes(mesh)
    d = cfg.embed_dim
    flops = model_flops_total / dp               # batch sharded over dp
    n_lookups = (cfg.n_fields if cfg.n_fields else cfg.seq_len + 1)
    emb_read = (B / dp) * n_lookups * d * 4.0
    if cfg.use_minhash_frontend:
        emb_read += (B / dp) * cfg.minhash_k * d * 4.0
    table_params = n_params                      # tables dominate
    if training:
        # factored momentum-free optimizer: grads read + params read/write
        # + O(V+d) stats vs AdamW's 6 fp32-table passes
        opt_traffic = (table_params / tp) * 4.0 * 3.0
        byts = emb_read * 3.0 + opt_traffic
        grad_ar = 2.0 * (table_params / tp) * 4.0   # AR of dense table grads
        gather = 2.0 * emb_read
        coll = grad_ar + gather
        breakdown = {"table_grad_allreduce": grad_ar,
                     "embedding_gather": gather}
    else:
        byts = emb_read + (table_params / tp) * 0.0 + emb_read
        coll = emb_read
        breakdown = {"embedding_gather": coll}
    return {"flops": max(flops, 1.0), "bytes": byts, "coll": coll,
            "coll_breakdown": breakdown}


def estimate(program, mesh) -> Dict[str, float]:
    """Dispatch on (family, kind): ``{"flops", "bytes", "coll",
    "coll_breakdown"}`` per GPU for one step of ``program``."""
    cfg = program.config
    av = program.input_specs
    if program.family == "lm":
        n, na = count_params(cfg), count_active_params(cfg)
        if program.kind == "lm_train":
            B, S = av["tokens"].shape
            return lm_train(cfg, B, S, n, na, mesh)
        if program.kind == "lm_prefill":
            B, S = av["tokens"].shape
            return lm_prefill(cfg, B, S, n, na, mesh)
        B = av["tokens"].shape[0]
        return lm_decode(cfg, B, first_leaf(av["cache"]).shape[2], n, na,
                         mesh)
    if program.family == "gnn":
        N = av["node_feats"].shape[0]
        E = av["edge_index"].shape[1]
        return gnn_train(cfg, N, E, mesh, av["node_feats"].shape[1])
    # recsys
    n_params = sum(t.numel() for t in tree_leaves(program.param_shapes()))
    if program.kind == "recsys_retrieval":
        B = 1_000_000
        fl = recsys_model_flops(cfg, B, training=False)
        return recsys_step(cfg, B, fl, n_params, mesh, training=False)
    some = av.get("field_ids", av.get("hist_ids"))
    B = some.shape[0]
    training = program.kind == "recsys_train"
    fl = recsys_model_flops(cfg, B, training=training)
    return recsys_step(cfg, B, fl, n_params, mesh, training=training)
