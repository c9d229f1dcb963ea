"""Model FLOPs per step and the three-term roofline (port of
``repro.roofline.analysis``).

``lm_model_flops``, ``gnn_model_flops``, ``recsys_model_flops`` and
``model_flops_for(program)`` over a ``launch.steps.CellProgram`` keep the
reference's formulas as they are.  ``gnn_model_flops`` counts the layer's
five d x d products on the N node rows; ``models.gnn.gatedgcn_layer``
runs four of them (A, B, C, V) on the E edge rows, so for a graph of mean
degree E / N it undercounts the products by (4E + N) / 5N (~20x at
ogbn-products' 25.3).  The port keeps the count the reference reports;
``chip_smoke.py`` bounds a GNN step by the products the layer runs.

``Roofline`` / ``analyze`` give a step's three terms on H100 constants
(``roofline.hardware``):

    compute term    = FLOPs per GPU / peak FLOP/s
    memory term     = HBM bytes per GPU / HBM bandwidth
    collective term = collective bytes per GPU / link bandwidth

The peak is bfloat16's for the LM family and float32's for GNN and
recsys cells, which the port runs in float32 with TF32 off.  The link is
``hardware.link_for(chips)``'s: InfiniBand past one node, NVLink within
one, none for one GPU (the term is then 0).  The reference reads its
counts from XLA's compiled cost analysis and HLO text and takes the
larger of those and its analytic estimates; ``analyze`` does the same
with the counts of a traced step (``roofline.traced``), given one, and
otherwise takes ``roofline.analytic.estimate``'s alone, recording the HLO
entries of ``coll_breakdown`` as ``None``.  The fields keep the
reference's names (``hlo_flops_per_chip`` ...) so that the dry run's
records keep its schema.  The dominant term is the projected step
time; MODEL_FLOPS / FLOPs is the share of the work that is "useful".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.models.transformer import count_active_params
from repro_torch.roofline import hardware as hw


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, Any]
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flop_frac: float = 0.0
    peak_fraction: float = 0.0
    memory_per_chip_bytes: float = 0.0
    family: str = "lm"            # "lm": bfloat16 peak; else float32's
    link: str = ""                # the link the collective term crosses
    link_bw: Optional[float] = None

    def finalize(self) -> "Roofline":
        peak = (hw.PEAK_FLOPS_BF16 if self.family == "lm"
                else hw.PEAK_FLOPS_F32)
        self.link, self.link_bw = hw.link_for(self.chips)
        self.compute_s = self.hlo_flops_per_chip / peak
        self.memory_s = self.hlo_bytes_per_chip / hw.HBM_BW
        self.collective_s = (self.coll_bytes_per_chip / self.link_bw
                             if self.link_bw else 0.0)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total_hlo = self.hlo_flops_per_chip * self.chips
        self.useful_flop_frac = (self.model_flops / total_hlo
                                 if total_hlo else 0.0)
        # roofline fraction: useful model FLOPs per GPU over the time the
        # dominant term implies, normalized by peak
        step_s = max(terms.values())
        if step_s > 0:
            achieved = self.model_flops / self.chips / step_s
            self.peak_fraction = achieved / peak
        return self

    @property
    def step_s(self) -> float:
        """The projected step: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> str:
        return (f"| {self.arch} | {self.cell} | {self.mesh} | "
                f"{self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} | "
                f"{self.collective_s*1e3:.2f} | {self.bottleneck} | "
                f"{self.useful_flop_frac:.2f} | {self.peak_fraction:.3f} |")


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


def first_leaf(tree):
    """The first leaf, in flattening order, of a tree of dicts (a decode
    cache's ``InputSpec``s)."""
    while isinstance(tree, dict):
        tree = tree[min(tree)]
    return tree


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
        L = first_leaf(av["cache"]).shape[2]
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


def analyze(program, mesh, smoke: bool = False,
            memory_bytes: float = 0.0, traced=None) -> Roofline:
    """The roofline of one step of ``program`` on ``mesh`` (anything with
    ``shape`` and ``size``: a shape-only ``launch.mesh.abstract_mesh``);
    ``memory_bytes`` is the per-GPU footprint the caller measured or
    placed.  ``traced``, a ``roofline.traced.TraceCounts`` of the step
    on that mesh, gives the counts the reference reads from XLA: each term
    takes the larger of it and ``roofline.analytic.estimate``'s, and
    ``coll_breakdown`` keeps the traced collectives by kind
    (``parsed_hlo_once_per_loop``: the reference's name; the trace counts
    every layer) and the traced totals (``raw_hlo``)."""
    from repro_torch.roofline.analytic import estimate
    est = estimate(program, mesh)
    flops, nbytes, coll = est["flops"], est["bytes"], est["coll"]
    breakdown = {"analytic": est["coll_breakdown"],
                 "parsed_hlo_once_per_loop": None, "raw_hlo": None}
    if traced is not None:
        raw = (float(traced.flops), float(traced.bytes_accessed),
               float(traced.coll_total))
        breakdown["parsed_hlo_once_per_loop"] = traced.breakdown()
        breakdown["raw_hlo"] = {"flops_per_chip": raw[0],
                                "bytes_per_chip": raw[1],
                                "coll_bytes_per_chip": raw[2]}
        flops, nbytes, coll = (max(flops, raw[0]), max(nbytes, raw[1]),
                               max(coll, raw[2]))
    return Roofline(
        arch=program.arch_id, cell=program.cell_name,
        mesh="x".join(str(n) for n in mesh.shape.values()), chips=mesh.size,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=nbytes,
        coll_bytes_per_chip=coll, coll_breakdown=breakdown,
        model_flops=model_flops_for(program, smoke),
        memory_per_chip_bytes=memory_bytes, family=program.family,
    ).finalize()
