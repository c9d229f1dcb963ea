"""Model FLOPs per step (port of the model-FLOP part of
``repro.roofline.analysis``): ``lm_model_flops``, ``gnn_model_flops``,
``recsys_model_flops`` and ``model_flops_for(program)`` over a
``launch.steps.CellProgram``, with the reference's formulas as they are.

``gnn_model_flops`` counts the layer's five d x d products on the N node
rows; ``models.gnn.gatedgcn_layer`` runs four of them (A, B, C, V) on the E
edge rows, so for a graph of mean degree E / N it undercounts the
products by (4E + N) / 5N (~20x at ogbn-products' 25.3).  The port
keeps the count the reference reports; ``chip_smoke.py`` bounds a GNN step
by the products the layer runs.

The reference's ``Roofline`` and ``analyze`` read XLA's compiled cost and
memory analysis; their counterpart waits for ``ROADMAP.md`` queue 1,
"``launch/dryrun.py`` and the rest of ``roofline/``".
"""

from __future__ import annotations

from repro_torch.models.transformer import count_active_params


def lm_model_flops(cfg, batch: int, seq: int, training: bool = True) -> float:
    """6*N_active*D (training) or 2*N_active*D (inference forward)."""
    n_active = count_active_params(cfg)
    mult = 6.0 if training else 2.0
    return mult * n_active * batch * seq


def gnn_model_flops(cfg, n_nodes: int, n_edges: int, training: bool = True
                    ) -> float:
    """GatedGCN: 5 dense d^2 matmuls per node + 2 d-muls per edge, x layers
    (the reference's count; see the module docstring)."""
    d = cfg.d_hidden
    per_layer = 2.0 * (5 * n_nodes * d * d + 2 * n_edges * d)
    total = cfg.n_layers * per_layer
    return (3.0 if training else 1.0) * total


def recsys_model_flops(cfg, batch: int, training: bool = True) -> float:
    """Dense interaction+MLP FLOPs per example (lookup is memory-bound)."""
    d = cfg.embed_dim
    fl = 0.0
    if cfg.interaction == "self-attn":
        F = cfg.n_fields + (1 if cfg.use_minhash_frontend else 0)
        d_in = d
        for _ in range(cfg.n_attn_layers):
            h = cfg.n_attn_heads * cfg.d_attn
            fl += 2.0 * F * d_in * h * 4          # q,k,v,res projections
            fl += 2.0 * F * F * h * 2             # scores + weighted sum
            d_in = h
        fl += 2.0 * F * d_in * 1
    elif cfg.interaction == "concat":
        dims = (cfg.n_fields * d + (d if cfg.use_minhash_frontend else 0),) \
            + tuple(cfg.mlp_dims) + (1,)
        for a, b in zip(dims[:-1], dims[1:]):
            fl += 2.0 * a * b
    elif cfg.interaction == "target-attn":
        L = cfg.seq_len
        dims = (4 * d,) + tuple(cfg.attn_mlp_dims) + (1,)
        per_step = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
        fl += L * per_step + 2.0 * L * d
        head = (3 * d,) + tuple(cfg.mlp_dims) + (1,)
        fl += sum(2.0 * a * b for a, b in zip(head[:-1], head[1:]))
    else:   # multi-interest
        L, K = cfg.seq_len, cfg.n_interests
        fl += 2.0 * L * d * d                      # h @ S
        fl += cfg.capsule_iters * (2.0 * L * K * d * 2)
        fl += 2.0 * K * d * d + 2.0 * K * d
    if cfg.use_minhash_frontend:
        fl += 2.0 * cfg.minhash_k * d              # signature bag adds
    return (3.0 if training else 1.0) * fl * batch


def model_flops_for(program, smoke: bool = False) -> float:
    """Model FLOPs of one step of ``program`` (a ``CellProgram``, or
    anything with its ``config``, ``family``, ``kind`` and
    ``input_specs``)."""
    cfg = program.config
    av = program.input_specs
    if program.family == "lm":
        if program.kind == "lm_train":
            B, S = av["tokens"].shape
            return lm_model_flops(cfg, B, S, training=True)
        if program.kind == "lm_prefill":
            B, S = av["tokens"].shape
            return lm_model_flops(cfg, B, S, training=False)
        # decode: one token over a cache of length L (attention reads the
        # cache; matmul flops are 2*N_active*B plus attention 2*B*L*H*hd*2)
        B = av["tokens"].shape[0]
        leaf = av["cache"]                # a tree of InputSpecs
        while isinstance(leaf, dict):
            leaf = leaf[min(leaf)]
        L = leaf.shape[2]
        base = 2.0 * count_active_params(cfg) * B
        if cfg.attention == "mla":
            attn = (2.0 * B * L * cfg.n_heads * (cfg.kv_lora + cfg.qk_rope)
                    * 2 * cfg.n_layers)
        else:
            attn = (2.0 * B * L * cfg.n_kv * cfg.head_dim * 2 * cfg.n_layers)
        return base + attn
    if program.family == "gnn":
        N = av["node_feats"].shape[0]
        E = av["edge_index"].shape[1]
        return gnn_model_flops(cfg, N, E, training=True)
    # recsys
    some = av.get("field_ids", av.get("hist_ids"))
    B = some.shape[0]
    if program.kind == "recsys_retrieval":
        B = 1_000_000 if not smoke else 128
        return recsys_model_flops(cfg, B, training=False)
    return recsys_model_flops(cfg, B,
                              training=program.kind == "recsys_train")
