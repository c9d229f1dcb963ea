"""Recsys models with the b-bit minhash frontend (port of
``repro.models.recsys``): so far Wide & Deep (interaction ``concat``),
served.

The hashed frontend is the paper's technique applied to embeddings: a
large sparse binary set (user behaviour, n-grams) is minhashed into k b-bit
signatures and embedded by the Eq. (5) signature embedding-bag
``sum_j Table[j, z_j]`` with ``Table`` of shape (k, 2^b, d) -- O(k 2^b d)
storage and an O(k) lookup in place of an O(D d) table and an O(nnz) bag.
On the card both steps are hand-written kernels, ``minhash2u``
(csrc/minhash.cu) and ``sigbag`` (csrc/sigbag.cu); on the CPU their plain
versions.

The model is an ``nn.Module`` whose parameters keep the reference's names
(``tables``, ``wide``, ``deep.w.<i>`` / ``deep.b.<i>``, ``minhash_table``)
and which holds the frontend's 2U coefficients ``a1``, ``a2`` as int32
bit-pattern buffers.  Unlike the reference, whose coefficients come from
numpy seeded with Python's per-process string hash, they are drawn from
the generator that draws every weight, so a seed gives the same model in
every process.  Not ported yet (``ROADMAP.md`` queue 1, "Recsys, the
rest"): the ``self-attn``, ``target-attn`` and ``multi-interest``
interactions, ``recsys_loss`` and ``retrieval_scores``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.u32 import narrow
from repro_torch.kernels.minhash import minhash2u
from repro_torch.kernels.sigbag import sigbag
from repro_torch.models.layers import init_mlp, mlp, normal_init

_TODO = "is not ported yet (ROADMAP.md queue 1, 'Recsys, the rest')"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """The reference's ``RecsysConfig`` less the fields of the interactions
    not ported yet (AutoInt's attention, DIN / MIND's behaviour sequence)."""

    arch_id: str
    interaction: str             # "concat" | "self-attn" | "target-attn" | "multi-interest"
    n_fields: int                # single-valued categorical fields
    vocab: int                   # rows per field table
    embed_dim: int
    mlp_dims: Tuple[int, ...] = ()
    # paper integration: minhash-hashed set-valued feature
    use_minhash_frontend: bool = False
    minhash_k: int = 64
    minhash_b: int = 8
    minhash_s: int = 24          # original set universe D = 2^s
    set_nnz: int = 128           # padded nnz of the raw sparse set
    param_dtype: torch.dtype = torch.float32


def _require_concat(cfg: RecsysConfig) -> None:
    if cfg.interaction != "concat":
        raise NotImplementedError(
            f"interaction {cfg.interaction!r} ({cfg.arch_id}) {_TODO}")


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


class RecsysModel(nn.Module):
    """A recsys model's parameters and frontend coefficients.

    ``params`` is the reference's parameter dict (``tables``, ``wide``,
    ``deep: {"w": [...], "b": [...]}``, ``minhash_table``); the tensors
    are taken as they are, not copied.  ``signatures`` and
    ``signature_bag`` are the frontend's two kernel calls, one method each
    so that a subclass can route them elsewhere (``chip_smoke.py`` scores
    through the plain versions that way).
    """

    def __init__(self, cfg: RecsysConfig, params: Dict,
                 a1: Optional[torch.Tensor] = None,
                 a2: Optional[torch.Tensor] = None):
        super().__init__()
        _require_concat(cfg)
        self.cfg = cfg
        frozen = lambda t: nn.Parameter(t, requires_grad=False)
        self.tables = frozen(params["tables"])
        self.wide = frozen(params["wide"])
        self.deep = nn.Module()
        self.deep.w = nn.ParameterList(map(frozen, params["deep"]["w"]))
        self.deep.b = nn.ParameterList(map(frozen, params["deep"]["b"]))
        if cfg.use_minhash_frontend:
            self.minhash_table = frozen(params["minhash_table"])
            self.register_buffer("a1", a1)
            self.register_buffer("a2", a2)

    def params(self) -> Dict:
        """The reference's parameter dict, sharing this model's storage."""
        p = {"tables": self.tables, "wide": self.wide,
             "deep": {"w": list(self.deep.w), "b": list(self.deep.b)}}
        if self.cfg.use_minhash_frontend:
            p["minhash_table"] = self.minhash_table
        return p

    def signatures(self, set_ids: torch.Tensor,
                   set_counts: torch.Tensor) -> torch.Tensor:
        """(B, k) int32 b-bit minhash values of the raw sets."""
        cfg = self.cfg
        return minhash2u(set_ids, set_counts.reshape(-1), self.a1, self.a2,
                         s=cfg.minhash_s, b=cfg.minhash_b)

    def signature_bag(self, sig: torch.Tensor) -> torch.Tensor:
        """(B, d) Eq. (5) embedding of the signatures."""
        return sigbag(sig, self.minhash_table)


def init_recsys_params(cfg: RecsysConfig,
                       generator: torch.Generator) -> RecsysModel:
    """A model with fresh weights and coefficients drawn from
    ``generator``, on its device; the reference's scales and shapes."""
    _require_concat(cfg)
    dtype, d = cfg.param_dtype, cfg.embed_dim
    p: Dict = {
        "tables": normal_init(generator, (cfg.n_fields, cfg.vocab, d), 0.01,
                              dtype),
        "wide": normal_init(generator, (cfg.n_fields, cfg.vocab, 1), 0.01,
                            dtype),
        "deep": init_mlp(generator,
                         (cfg.n_fields * d
                          + (d if cfg.use_minhash_frontend else 0),)
                         + tuple(cfg.mlp_dims) + (1,), dtype),
    }
    a1 = a2 = None
    if cfg.use_minhash_frontend:
        p["minhash_table"] = normal_init(
            generator, (cfg.minhash_k, 1 << cfg.minhash_b, d), 0.01, dtype)
        a1, a2 = minhash_coeffs(generator, cfg.minhash_k)
    return RecsysModel(cfg, p, a1, a2)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def minhash_frontend(model: RecsysModel, set_ids: torch.Tensor,
                     set_counts: torch.Tensor) -> torch.Tensor:
    """Sparse set -> k b-bit signatures -> signature embedding-bag (B, d)."""
    return model.signature_bag(model.signatures(set_ids, set_counts))


def recsys_logits(model: RecsysModel,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,) logits of ``model`` under its own config.  batch: ``field_ids
    (B, F)``, and ``set_ids (B, nnz)`` with ``set_counts (B,)`` when the
    frontend is on."""
    ids = batch["field_ids"]
    emb = embedding_lookup(model.tables, ids)                  # (B, F, d)
    wide = embedding_lookup(model.wide, ids)[..., 0].sum(1)
    deep_in = emb.reshape(emb.shape[0], -1)
    if model.cfg.use_minhash_frontend:
        extra = minhash_frontend(model, batch["set_ids"],
                                 batch["set_counts"])          # (B, d)
        deep_in = torch.cat([deep_in, extra], dim=-1)
    deep = mlp(deep_in, model.deep.w, model.deep.b)[:, 0]
    return wide + deep


@torch.inference_mode()
def serve_scores(model: RecsysModel,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Online / offline scoring: sigmoid(logits), (B,)."""
    return torch.sigmoid(recsys_logits(model, batch))


def recsys_loss(model, batch):
    raise NotImplementedError("recsys_loss (recsys training) " + _TODO)


def retrieval_scores(model, batch, n_candidates):
    raise NotImplementedError("retrieval_scores (recsys_retrieval) " + _TODO)
