"""Recsys models with the b-bit minhash frontend (port of
``repro.models.recsys``): Wide & Deep (interaction ``concat``), AutoInt
(``self-attn``), DIN (``target-attn``) and MIND (``multi-interest``),
served, scored against candidates and trained.

The hashed frontend is the paper's technique applied to embeddings: a
large sparse binary set (user behaviour, n-grams) is minhashed into k b-bit
signatures and embedded by the Eq. (5) signature embedding-bag
``sum_j Table[j, z_j]`` with ``Table`` of shape (k, 2^b, d) -- O(k 2^b d)
storage and an O(k) lookup in place of an O(D d) table and an O(nnz) bag.
On the card both steps are hand-written kernels, ``minhash2u``
(csrc/minhash.cu) and ``sigbag`` (csrc/sigbag.cu); on the CPU their plain
versions.  ``sigbag``'s table gradient is a scatter-add in plain PyTorch
(``kernels/sigbag.py``); the signatures are integers and need none.

The model is an ``nn.Module`` whose parameters keep the reference's names
(``tables``, ``wide``, ``deep.w.<i>``, ``attn_layers.<i>.wq``,
``item_table``, ``attn_mlp.b.<i>``, ``S``, ``head.w.<i>``,
``minhash_table``) and which holds the frontend's 2U coefficients ``a1``,
``a2`` as int32 bit-pattern buffers.  Unlike the reference, whose
coefficients come from numpy seeded with Python's per-process string
hash, they are drawn from the generator that draws every weight, so a
seed gives the same model in every process.

Every forward takes an optional ``params``, the reference's parameter
dict (``model.params()`` by default): training differentiates that tree
(``torch.autograd.grad``), with the model supplying the config, the
coefficients and the frontend's two calls.  The reference's
``sharding.rules.constrain`` calls are no-ops without a mesh and are left
out (``ROADMAP.md`` queue 1, "The multi-GPU mesh path").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.u32 import narrow
from repro_torch.kernels.minhash import minhash2u
from repro_torch.kernels.sigbag import sigbag
from repro_torch.models.layers import TreeModel, init_mlp, mlp, normal_init

# candidates scored at once by ``retrieval_scores``: at 65,536 the widest
# intermediate (DIN's 72-wide attention input over 100 steps, AutoInt's
# q/k/v) stays near 2 GB where 1,000,000 at once would need 50-84 GB
RETRIEVAL_CHUNK = 65_536


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    arch_id: str
    interaction: str             # "concat" | "self-attn" | "target-attn" | "multi-interest"
    n_fields: int                # single-valued categorical fields
    vocab: int                   # rows per field table
    embed_dim: int
    mlp_dims: Tuple[int, ...] = ()
    # AutoInt
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # DIN / MIND (behavior-sequence models)
    seq_len: int = 0
    attn_mlp_dims: Tuple[int, ...] = ()
    n_interests: int = 0
    capsule_iters: int = 0
    item_vocab: int = 0
    # paper integration: minhash-hashed set-valued feature
    use_minhash_frontend: bool = False
    minhash_k: int = 64
    minhash_b: int = 8
    minhash_s: int = 24          # original set universe D = 2^s
    set_nnz: int = 128           # padded nnz of the raw sparse set
    param_dtype: torch.dtype = torch.float32


INTERACTIONS = ("concat", "self-attn", "target-attn", "multi-interest")
SEQUENCE_INTERACTIONS = ("target-attn", "multi-interest")


def _check_interaction(cfg: RecsysConfig) -> None:
    if cfg.interaction not in INTERACTIONS:
        raise ValueError(f"unknown interaction {cfg.interaction!r} "
                         f"({cfg.arch_id}); have {INTERACTIONS}")


# ---------------------------------------------------------------------------
# Embedding lookups
# ---------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot per-field lookup: table (F, V, d), ids (B, F) -> (B, F, d).

    Rows are addressed as ``f * V + id`` in int64: a full-width table holds
    more elements than int32 can count.
    """
    n_f, vocab, d = table.shape
    offsets = torch.arange(n_f, dtype=torch.int64, device=ids.device) * vocab
    rows = (ids.to(torch.int64) + offsets).reshape(-1)
    return table.reshape(n_f * vocab, d).index_select(0, rows).reshape(
        ids.shape[0], n_f, d)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """Multi-hot bag over one table: table (V, d), ids / mask (B, L) ->
    (B, d); ``combiner`` "sum" or "mean" (over the mask, at least 1)."""
    gathered = embedding_bag_seq(table, ids)                  # (B, L, d)
    gathered = gathered * mask[..., None].to(gathered.dtype)
    out = gathered.sum(1)
    if combiner == "mean":
        out = out / torch.clamp(mask.sum(1, keepdim=True).to(out.dtype),
                                min=1.0)
    return out


def embedding_bag_seq(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, d) x (B, L) -> (B, L, d) gather (the per-step bag)."""
    return table.index_select(0, ids.reshape(-1).to(torch.int64)).reshape(
        *ids.shape, table.shape[1])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def minhash_coeffs(generator: torch.Generator,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frontend's 2U coefficients, (k,) int32 bit patterns each (a2
    odd), drawn from ``generator`` on its device."""
    draw = lambda: torch.randint(0, 2**32, (k,), dtype=torch.int64,
                                 generator=generator,
                                 device=generator.device)
    a1 = draw()
    a2 = draw() | 1
    return narrow(a1), narrow(a2)


class RecsysModel(TreeModel):
    """A recsys model's parameters and frontend coefficients.

    ``params`` is the reference's parameter dict (for Wide & Deep
    ``tables``, ``wide``, ``deep: {"w": [...], "b": [...]}``,
    ``minhash_table``; for AutoInt ``attn_layers``, a list of ``{"wq",
    "wk", "wv", "wres"}``); the tensors are taken as they are, not copied.
    ``signatures`` and ``signature_bag`` are the frontend's two kernel
    calls, one method each so that a subclass can route them elsewhere
    (``chip_smoke.py`` scores through the plain versions that way).
    """

    def __init__(self, cfg: RecsysConfig, params: Dict,
                 a1: Optional[torch.Tensor] = None,
                 a2: Optional[torch.Tensor] = None):
        _check_interaction(cfg)
        super().__init__(cfg, params)
        if cfg.use_minhash_frontend:
            self.register_buffer("a1", a1)
            self.register_buffer("a2", a2)

    def signatures(self, set_ids: torch.Tensor,
                   set_counts: torch.Tensor) -> torch.Tensor:
        """(B, k) int32 b-bit minhash values of the raw sets."""
        cfg = self.cfg
        return minhash2u(set_ids, set_counts.reshape(-1), self.a1, self.a2,
                         s=cfg.minhash_s, b=cfg.minhash_b)

    def signature_bag(self, sig: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
        """(B, d) Eq. (5) embedding of the signatures in ``table``."""
        return sigbag(sig, table)


def init_recsys_params(cfg: RecsysConfig,
                       generator: torch.Generator) -> RecsysModel:
    """A model with fresh weights and coefficients drawn from
    ``generator``, on its device; the reference's scales and shapes."""
    _check_interaction(cfg)
    dtype, d = cfg.param_dtype, cfg.embed_dim
    normal = lambda shape, scale: normal_init(generator, shape, scale, dtype)
    p: Dict = {}
    if cfg.n_fields:
        p["tables"] = normal((cfg.n_fields, cfg.vocab, d), 0.01)
    d_extra = d if cfg.use_minhash_frontend else 0
    if cfg.interaction == "concat":                     # wide & deep
        p["wide"] = normal((cfg.n_fields, cfg.vocab, 1), 0.01)
        p["deep"] = init_mlp(generator, (cfg.n_fields * d + d_extra,)
                             + tuple(cfg.mlp_dims) + (1,), dtype)
    elif cfg.interaction == "self-attn":                # autoint
        n_f = cfg.n_fields + (1 if cfg.use_minhash_frontend else 0)
        width = cfg.n_attn_heads * cfg.d_attn
        layers, d_in = [], d
        for _ in range(cfg.n_attn_layers):
            layers.append({name: normal((d_in, width), d_in ** -0.5)
                           for name in ("wq", "wk", "wv", "wres")})
            d_in = width
        p["attn_layers"] = layers
        p["head"] = init_mlp(generator, (n_f * d_in, 1), dtype)
    elif cfg.interaction == "target-attn":              # din
        p["item_table"] = normal((cfg.item_vocab, d), 0.01)
        p["attn_mlp"] = init_mlp(generator, (4 * d,)
                                 + tuple(cfg.attn_mlp_dims) + (1,), dtype)
        p["head"] = init_mlp(generator, (3 * d + d_extra,)
                             + tuple(cfg.mlp_dims) + (1,), dtype)
    else:                                               # mind
        p["item_table"] = normal((cfg.item_vocab, d), 0.01)
        p["S"] = normal((d, d), d ** -0.5)
        p["head"] = init_mlp(generator, (d, d), dtype)
    a1 = a2 = None
    if cfg.use_minhash_frontend:
        p["minhash_table"] = normal(
            (cfg.minhash_k, 1 << cfg.minhash_b, d), 0.01)
        a1, a2 = minhash_coeffs(generator, cfg.minhash_k)
    return RecsysModel(cfg, p, a1, a2)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def minhash_frontend(model: RecsysModel, set_ids: torch.Tensor,
                     set_counts: torch.Tensor,
                     params: Optional[Dict] = None) -> torch.Tensor:
    """Sparse set -> k b-bit signatures -> signature embedding-bag (B, d)."""
    p = model.params() if params is None else params
    return model.signature_bag(model.signatures(set_ids, set_counts),
                               p["minhash_table"])


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.square(x).sum(dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def recsys_logits(model: RecsysModel, batch: Dict[str, torch.Tensor],
                  params: Optional[Dict] = None) -> torch.Tensor:
    """(B,) logits of ``model`` under its own config, with ``params`` (the
    model's own by default).  batch keys by interaction:
      all:          ``set_ids (B, nnz)``, ``set_counts (B,)`` with the
                    frontend
      concat / self-attn: ``field_ids (B, F)``
      target-attn / multi-interest: ``hist_ids (B, L)``, ``hist_mask (B,
                    L)``, ``target_id (B,)``
    """
    cfg = model.cfg
    p = model.params() if params is None else params
    extra = None
    if cfg.use_minhash_frontend:
        extra = minhash_frontend(model, batch["set_ids"],
                                 batch["set_counts"], p)       # (B, d)

    if cfg.interaction == "concat":
        ids = batch["field_ids"]
        emb = embedding_lookup(p["tables"], ids)                # (B, F, d)
        wide = embedding_lookup(p["wide"], ids)[..., 0].sum(1)
        deep_in = emb.reshape(emb.shape[0], -1)
        if extra is not None:
            deep_in = torch.cat([deep_in, extra], dim=-1)
        return wide + mlp(deep_in, p["deep"]["w"], p["deep"]["b"])[:, 0]

    if cfg.interaction == "self-attn":
        x = embedding_lookup(p["tables"], batch["field_ids"])   # (B, F, d)
        if extra is not None:
            x = torch.cat([x, extra[:, None, :]], dim=1)
        h, da = cfg.n_attn_heads, cfg.d_attn
        for lp in p["attn_layers"]:
            B, F, _ = x.shape
            q = (x @ lp["wq"]).reshape(B, F, h, da)
            k = (x @ lp["wk"]).reshape(B, F, h, da)
            v = (x @ lp["wv"]).reshape(B, F, h, da)
            s = torch.einsum("bfhd,bghd->bhfg", q, k) / (float(da) ** 0.5)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F, h * da)
            x = torch.relu(o + x @ lp["wres"])
        flat = x.reshape(x.shape[0], -1)
        return mlp(flat, p["head"]["w"], p["head"]["b"])[:, 0]

    if cfg.interaction == "target-attn":
        hist = embedding_bag_seq(p["item_table"], batch["hist_ids"])
        tgt = p["item_table"].index_select(
            0, batch["target_id"].to(torch.int64))
        t = tgt[:, None, :].expand_as(hist)
        att_in = torch.cat([hist, t, hist - t, hist * t], dim=-1)
        scores = mlp(att_in, p["attn_mlp"]["w"],
                     p["attn_mlp"]["b"])[..., 0]                # (B, L)
        scores = torch.where(batch["hist_mask"] > 0, scores,
                             torch.full_like(scores, -1e9))
        w = torch.softmax(scores, dim=-1)
        user = torch.einsum("bl,bld->bd", w, hist)
        head_in = [user, tgt, user * tgt]
        if extra is not None:
            head_in.append(extra)
        return mlp(torch.cat(head_in, dim=-1), p["head"]["w"],
                   p["head"]["b"])[:, 0]

    # multi-interest
    hist = embedding_bag_seq(p["item_table"], batch["hist_ids"])
    tgt = p["item_table"].index_select(0, batch["target_id"].to(torch.int64))
    B, L, _ = hist.shape
    hS = hist @ p["S"]                                          # (B, L, d)
    # the routing logits and mask take the parameters' type (float32 as
    # in the reference; a float64 copy of the model stays in float64)
    blog = torch.zeros((B, L, cfg.n_interests), dtype=hS.dtype,
                       device=hist.device)
    mask = batch["hist_mask"].to(hS.dtype)
    interests = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=-1) * mask[..., None]
        z = torch.einsum("blk,bld->bkd", w, hS)
        interests = _squash(z)
        blog = blog + torch.einsum("bld,bkd->blk", hS, interests)
    interests = mlp(interests, p["head"]["w"], p["head"]["b"],
                    act=torch.relu, final_act=False)
    la = torch.softmax(torch.einsum("bkd,bd->bk", interests, tgt) * 2.0,
                       dim=-1)
    user = torch.einsum("bk,bkd->bd", la, interests)
    return torch.einsum("bd,bd->b", user, tgt)


def recsys_loss(model: RecsysModel, batch: Dict[str, torch.Tensor],
                params: Optional[Dict] = None) -> torch.Tensor:
    """Binary logistic loss on {0, 1} ``labels``: the mean of
    ``softplus(-z) + (1 - y) z``, softplus as ``logaddexp(x, 0)``, the
    reference's ``jax.nn.softplus`` (``F.softplus`` turns linear above
    20)."""
    z = recsys_logits(model, batch, params).to(torch.float32)
    y = batch["labels"].to(torch.float32)
    return torch.mean(torch.logaddexp(-z, torch.zeros_like(z))
                      + (1.0 - y) * z)


@torch.inference_mode()
def serve_scores(model: RecsysModel,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Online / offline scoring: sigmoid(logits), (B,)."""
    return torch.sigmoid(recsys_logits(model, batch))


@torch.inference_mode()
def retrieval_scores(model: RecsysModel, batch: Dict[str, torch.Tensor],
                     n_candidates: int) -> torch.Tensor:
    """Score one query context against ``n_candidates`` items
    (``retrieval_cand``): (n_candidates,) logits.

    Candidate c is item ``c % item_vocab`` as the target of a sequence
    model (DIN, MIND) and id ``c % vocab`` in the last field of a field
    model (Wide & Deep, AutoInt), whose other inputs repeat the query's,
    as in the reference.  Candidates are scored ``RETRIEVAL_CHUNK`` at a
    time; each row's logit does not depend on the others.
    """
    cfg = model.cfg
    if any(v.shape[0] != 1 for v in batch.values()):
        raise ValueError("retrieval_scores scores one query: every input "
                         "needs batch 1")
    dev = next(iter(batch.values())).device
    seq = cfg.interaction in SEQUENCE_INTERACTIONS
    vocab = cfg.item_vocab if seq else cfg.vocab
    chunk, out = RETRIEVAL_CHUNK, []
    for lo in range(0, n_candidates, chunk):
        m = min(chunk, n_candidates - lo)
        cand = torch.arange(lo, lo + m, dtype=torch.int32, device=dev) % vocab
        rep = {key: v.expand(m, *v.shape[1:]).contiguous()
               for key, v in batch.items() if key != "target_id"}
        if seq:
            rep["target_id"] = cand
        else:
            rep["field_ids"] = torch.cat([rep["field_ids"][:, :-1],
                                          cand[:, None]], dim=1)
        out.append(recsys_logits(model, rep))
    return torch.cat(out)
