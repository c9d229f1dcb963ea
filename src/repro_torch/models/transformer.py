"""Decoder-only LM family (port of ``repro.models.transformer``): dense
GQA, chunked-local (llama4-style), MLA and MoE variants, for the five LM
archs.

Three entry points:

  * ``train_loss(params, batch, cfg)`` -- next-token cross-entropy,
    ``chunked_ce_loss`` over ``forward``: float32 logits one (B, chunk, V)
    slice at a time, recomputed in the backward, so a float32 (B, S, V)
    tensor is never held;
  * ``forward(params, tokens, cfg)`` -- prefill, tokens (B, S) -> final
    hidden states (B, S, D); with ``cfg.remat`` each layer's activations
    are recomputed in the backward instead of kept, as the reference's
    ``jax.checkpoint`` does;
  * ``serve_step(params, cache, tokens, pos, cfg)`` -- one greedy decode
    step over a KV cache (GQA cache or compressed MLA cache), written in
    place at ``pos - 1`` and returned, so the decode loop owns one buffer.

Parameters keep the reference's tree: ``embed``, ``out``, ``final_norm``,
``layers`` (and ``dense_layers`` for the leading dense-FFN layers of an
MoE arch), each layer leaf stacked along axis 0 as the reference's
``vmap`` lays it out, so a layer is a view ``leaf[i]``.  ``TransformerModel``
holds the tree as frozen parameters; the functions take the tree
(``model.params()``).  Serving runs them under ``torch.inference_mode``;
training differentiates ``train_loss`` with respect to a tree of leaves
that require a gradient.

On a process mesh, ``forward`` / ``train_loss`` / ``serve_step`` take a
shard context (``sharding.spmd.Shards``) and each leaf's per-dim axes
(``sharding.params.lm_param_specs``) and run the same body on each rank's
local shards, with explicit collectives: FSDP weights gathered just in
time over "data", column-parallel (``wq`` ... ``w_up``) and row-parallel
(``wo``, ``w_down``) products over "model" with one psum a block, the
embedding table gathered over "data", the output head vocab-parallel over
"model" (the loss's log-sum-exp summed across the vocab shards), and the
MoE FFN expert-parallel (``moe._moe_ep_local``).  The reference's
``constrain`` points are explicit there: the layer boundary keeps d_model
split over "model" (the remat stash), gathered at the layer's start.
Heads split over "model" where they divide; an indivisible axis is
dropped, as ``constrain`` drops it, and the block then runs whole on
every rank.  Decode keeps its cache's length split over "model"
(``serve_step``): each rank scores its chunk of positions for every head
and a split softmax combines them.  Without a mesh every collective is
the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (whole_cols, blockwise_attention,
                                          decode_attention, mla_decode,
                                          mla_prefill, out_proj, write_at)
from repro_torch.models.layers import (TreeModel, apply_rope, normal_init,
                                       rms_norm)
from repro_torch.models.moe import (MoEConfig, init_moe_params, moe_ffn,
                                   swiglu_tp)
from repro_torch.sharding import spmd
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    attention: str = "gqa"            # "gqa" | "mla"
    local_window: int = 0             # >0: chunked-local attention window
    global_every: int = 4             # every Nth layer stays global
    rope_theta: float = 10000.0
    n_dense_layers: int = 0           # leading dense-FFN layers (MoE archs)
    d_ff_dense: int = 0
    moe: Optional[MoEConfig] = None
    # MLA dims (attention == "mla")
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    ce_chunk: int = 2048
    attn_blk: int = 1024
    microbatch: int = 1          # gradient-accumulation splits per step

    @property
    def is_moe(self) -> bool:
        return self.moe is not None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attn_tree(draw: Callable, ones: Callable, cfg: TransformerConfig,
               n: int, dtype) -> Dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = d ** -0.5
    if cfg.attention == "mla":
        return {
            "wdq": draw((n, d, cfg.q_lora), s, dtype),
            "wuq": draw((n, cfg.q_lora, H * (cfg.qk_nope + cfg.qk_rope)),
                        cfg.q_lora ** -0.5, dtype),
            "wdkv": draw((n, d, cfg.kv_lora), s, dtype),
            "wukv": draw((n, cfg.kv_lora, H * (cfg.qk_nope + cfg.v_head)),
                         cfg.kv_lora ** -0.5, dtype),
            "wkr": draw((n, d, cfg.qk_rope), s, dtype),
            "wo": draw((n, H * cfg.v_head, d), (H * cfg.v_head) ** -0.5,
                       dtype),
            "q_norm": ones((n, cfg.q_lora), dtype),
            "kv_norm": ones((n, cfg.kv_lora), dtype),
        }
    return {"wq": draw((n, d, H * hd), s, dtype),
            "wk": draw((n, d, Hkv * hd), s, dtype),
            "wv": draw((n, d, Hkv * hd), s, dtype),
            "wo": draw((n, H * hd, d), (H * hd) ** -0.5, dtype)}


def _stack_tree(draw: Callable, ones: Callable, cfg: TransformerConfig,
                n: int, moe_layer: bool, dtype) -> Dict:
    """``n`` layers, every leaf stacked along axis 0."""
    d = cfg.d_model
    if moe_layer:
        ffn = init_moe_params(lambda shape, s, dt: draw((n, *shape), s, dt),
                              d, cfg.moe, dtype)
    else:
        f = cfg.d_ff_dense or cfg.d_ff
        ffn = {"w_gate": draw((n, d, f), d ** -0.5, dtype),
               "w_up": draw((n, d, f), d ** -0.5, dtype),
               "w_down": draw((n, f, d), f ** -0.5, dtype)}
    return {"attn": _attn_tree(draw, ones, cfg, n, dtype), "ffn": ffn,
            "ln1": ones((n, d), dtype), "ln2": ones((n, d), dtype)}


def _param_tree(cfg: TransformerConfig, draw: Callable,
                ones: Callable) -> Dict:
    """The reference's parameter tree, each normal leaf made by
    ``draw(shape, scale, dtype)`` and each norm weight by
    ``ones(shape, dtype)``."""
    dtype = cfg.param_dtype
    params = {
        "embed": draw((cfg.vocab, cfg.d_model), 0.02, dtype),
        "out": draw((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dtype),
        "final_norm": ones((cfg.d_model,), dtype),
        "layers": _stack_tree(draw, ones, cfg,
                              cfg.n_layers - cfg.n_dense_layers, cfg.is_moe,
                              dtype),
    }
    if cfg.n_dense_layers:
        params["dense_layers"] = _stack_tree(draw, ones, cfg,
                                             cfg.n_dense_layers, False, dtype)
    return params


class TransformerModel(TreeModel):
    """An LM's parameters under the reference's names (``embed``,
    ``layers.attn.wq``, ``layers.ffn.w_gate``, ``dense_layers.ln1`` ...),
    taken as they are, not copied."""


def init_params(cfg: TransformerConfig,
                generator: torch.Generator) -> TransformerModel:
    """Fresh weights at the reference's shapes and scales, drawn from
    ``generator`` on its device (a large bfloat16 leaf through a bounded
    float32 slice, ``layers.normal_init``); norm weights ones."""
    dev = generator.device
    draw = lambda shape, s, dt: normal_init(generator, shape, s, dt)
    ones = lambda shape, dt: torch.ones(shape, dtype=dt, device=dev)
    return TransformerModel(cfg, _param_tree(cfg, draw, ones))


def param_shapes(cfg: TransformerConfig) -> Dict:
    """The parameter tree on the meta device: shapes and types, nothing
    allocated."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    return _param_tree(cfg, lambda shape, s, dt: meta(shape, dt), meta)


def count_params(cfg: TransformerConfig) -> int:
    return sum(t.numel() for t in tree_leaves(param_shapes(cfg)))


def count_active_params(cfg: TransformerConfig) -> int:
    """Active params per token (MoE: top_k of n_experts routed)."""
    total = count_params(cfg)
    if not cfg.is_moe:
        return total
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    n_moe_layers = cfg.n_layers - cfg.n_dense_layers
    return total - n_moe_layers * (E - k) * 3 * cfg.d_model * cfg.moe.d_ff


def _layer(stack, i: int) -> Dict:
    """Layer ``i`` of a stack: views of its stacked leaves, or the ``i``-th
    tree of a stack ``per_layer`` split."""
    if isinstance(stack, list):
        return stack[i]
    return tree_map(lambda t: t[i], stack)


def per_layer(params: Dict) -> Dict:
    """``params`` with each layer stack a list of its layers' trees, views
    of the stacked leaves; ``forward`` and ``train_loss`` take either form.
    Training makes those views leaves of autograd, so that a layer's
    products use its weights directly and the backward adds each weight's
    gradient into its ``.grad`` as soon as it is made: a view taken inside
    the graph holds it until the view's own node runs, after the products
    below it (for deepseek-v3, three 7.5 GB expert-stack gradients at
    once)."""
    out = dict(params)
    for key in ("dense_layers", "layers"):
        if key in params:
            n = tree_leaves(params[key])[0].shape[0]
            out[key] = [_layer(params[key], i) for i in range(n)]
    return out


def _stacks(cfg: TransformerConfig):
    """(stack key, number of layers, MoE FFN?, index of its first layer),
    the dense-FFN stack first."""
    out = []
    if cfg.n_dense_layers:
        out.append(("dense_layers", cfg.n_dense_layers, False, 0))
    out.append(("layers", cfg.n_layers - cfg.n_dense_layers, cfg.is_moe,
                cfg.n_dense_layers))
    return out


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _layer_window(cfg: TransformerConfig, idx: int) -> int:
    """Per-layer attention window: 0 = full causal; chunked-local layers
    but every ``global_every``-th."""
    if cfg.local_window <= 0:
        return 0
    is_global = idx % cfg.global_every == cfg.global_every - 1
    return 0 if is_global else cfg.local_window


def _kv(sh: spmd.Shards, x, w, ent, cfg: TransformerConfig,
        heads_split: bool) -> torch.Tensor:
    """K or V for the rank's query heads: (B, S, n_kv here, hd).  Where
    the query heads split over "model" and the kv heads do not divide
    there, each rank selects the kv heads its query heads read."""
    B, S = x.shape[:2]
    n_kv, hd = cfg.n_kv, cfg.head_dim
    if not heads_split:
        return (x @ sh.use(w, ent)).reshape(B, S, n_kv, hd)
    if n_kv % sh.tp == 0 and sh.model_split(ent):
        return sh.col(x, w, ent)[0].reshape(B, S, n_kv // sh.tp, hd)
    G = cfg.n_heads // n_kv
    h_loc = cfg.n_heads // sh.tp
    j = sh.index("model")
    full = spmd.enter(x @ sh.use(w, ent), sh.mesh, ("model",))
    full = full.reshape(B, S, n_kv, hd)
    if h_loc >= G and h_loc % G == 0:
        return full[:, :, j * h_loc // G:(j + 1) * h_loc // G]
    if G % h_loc == 0:
        kv = j * h_loc // G
        return full[:, :, kv:kv + 1]
    raise ValueError(f"{cfg.n_heads} query heads over {sh.tp} ranks do not "
                     f"group onto {n_kv} kv heads")


def _attn_block(sh: spmd.Shards, p: Dict, e, x: torch.Tensor,
                cfg: TransformerConfig, positions: torch.Tensor,
                window: int) -> torch.Tensor:
    B, S, _ = x.shape
    if cfg.attention == "mla":         # MLA takes no window
        return mla_prefill(x, p, n_heads=cfg.n_heads, d_nope=cfg.qk_nope,
                           d_rope=cfg.qk_rope, d_v=cfg.v_head,
                           positions=positions, rope_theta=cfg.rope_theta,
                           blk=cfg.attn_blk, shards=sh, ents=e)
    # the reference constrains q, k, v to ("batch", None, "model"): heads
    # over "model" where they divide
    split = sh.heads_split(cfg.n_heads, e["wq"], e["wo"])
    mt = ("model",) if split else ()
    H = cfg.n_heads // sh.tp if split else cfg.n_heads
    q = (sh.col(x, p["wq"], e["wq"])[0] if split
         else x @ sh.use(p["wq"], e["wq"])).reshape(B, S, H, cfg.head_dim)
    k = _kv(sh, x, p["wk"], e["wk"], cfg, split)
    v = _kv(sh, x, p["wv"], e["wv"], cfg, split)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = blockwise_attention(q, k, v, window=window, blk_q=cfg.attn_blk,
                              blk_kv=cfg.attn_blk)
    out = out.reshape(B, S, H * cfg.head_dim) @ sh.use(p["wo"], e["wo"], mt)
    return spmd.psum(out, sh.mesh, mt)


def _ffn_block(sh: spmd.Shards, p: Dict, e, x: torch.Tensor,
               cfg: TransformerConfig, moe_layer: bool) -> torch.Tensor:
    B, S, D = x.shape
    if moe_layer:
        return moe_ffn(p, x.reshape(B * S, D), cfg.moe, shards=sh,
                       ents=e).reshape(B, S, D)
    return swiglu_tp(x, p, e, sh)


def _recomputed(fn: Callable, *args):
    """``fn(*args)``; where a gradient is wanted, its activations are
    recomputed in the backward instead of kept (the reference's
    ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _d_split(sh: spmd.Shards, cfg: TransformerConfig) -> Tuple[str, ...]:
    """The axes the layer boundary splits d_model over: "model" where it
    divides (the reference's constrain of the remat stash), else none."""
    return ("model",) if sh.tp > 1 and cfg.d_model % sh.tp == 0 else ()


def _layer_fn(x: torch.Tensor, p: Dict, e, sh: spmd.Shards,
              cfg: TransformerConfig, positions: torch.Tensor, window: int,
              moe_layer: bool) -> torch.Tensor:
    """One layer; x (B, S, D) split along D as ``_d_split`` says, gathered
    whole here and split again at the end."""
    m = _d_split(sh, cfg)
    x = spmd.gather(x, -1, sh.mesh, m)
    x = x + _attn_block(sh, p["attn"], e["attn"],
                        rms_norm(x, sh.use(p["ln1"], e["ln1"])), cfg,
                        positions, window)
    x = x + _ffn_block(sh, p["ffn"], e["ffn"],
                       rms_norm(x, sh.use(p["ln2"], e["ln2"])), cfg,
                       moe_layer)
    return spmd.scatter(x, -1, sh.mesh, m)


def forward(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            shards: Optional[spmd.Shards] = None,
            ents=spmd.WHOLE) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, D): the dense-FFN
    layers, then the rest, each ``x + attn(norm(x))``, ``x +
    ffn(norm(x))``, each recomputed in the backward with ``cfg.remat``.

    On a process mesh (``shards``; ``params`` the rank's shards of the
    stacked tree or its ``per_layer`` form, ``ents`` each stacked leaf's
    per-dim axes, ``tokens`` the rank's rows) the weights' FSDP shards are
    gathered just in time, the products column- and row-parallel over
    "model" and the MoE FFN expert-parallel."""
    sh = shards or spmd.Shards()
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    # the table gathered over "data" (FSDP); the lookup output
    # unconstrained on d, as the reference leaves it
    x = sh.use(params["embed"], ents["embed"])[tokens.long()]
    m = _d_split(sh, cfg)
    x = spmd.scatter(x, -1, sh.mesh, m)
    for key, n, moe_layer, first in _stacks(cfg):
        e = tree_map(lambda t: t[1:], ents[key])     # without the layer dim
        for i in range(n):
            args = (x, _layer(params[key], i), e, sh, cfg, positions,
                    _layer_window(cfg, first + i), moe_layer)
            x = _recomputed(_layer_fn, *args) if cfg.remat else _layer_fn(
                *args)
    x = spmd.gather(x, -1, sh.mesh, m)
    return rms_norm(x, sh.use(params["final_norm"], ents["final_norm"]))


def _chunk_ce(x: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor,
              mesh, vocab: Tuple[str, ...], lo: int) -> torch.Tensor:
    """Summed cross-entropy of one (B, chunk) slice, its logits float32;
    with the head's columns split over ``vocab`` (from column ``lo``), the
    log-sum-exp and the label's logit summed across the shards."""
    logits = (x @ w_out).float()
    m = spmd.pmax(logits.amax(-1, keepdim=True), mesh, vocab)
    lse = torch.log(spmd.psum(torch.exp(logits - m).sum(-1), mesh, vocab)
                    ) + m[..., 0]
    local = labels.long() - lo
    V = logits.shape[-1]
    mine = (local >= 0) & (local < V)
    correct = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None]
                           )[..., 0] * mine
    return (lse - spmd.psum(correct, mesh, vocab)).sum()


def chunked_ce_loss(x: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, chunk: int,
                    shards: Optional[spmd.Shards] = None,
                    ent=spmd.WHOLE) -> torch.Tensor:
    """Mean next-token cross-entropy of x (B, S, D) through ``w_out`` (D,
    V) against labels (B, S), ``chunk`` positions at a time: each (B,
    chunk, V) float32 logits slice is made, reduced and dropped, and made
    again in the backward.  On a process mesh (``shards``, ``ent`` the
    head's per-dim axes) the head is vocab-parallel over "model" where its
    columns are split there, and the mean is over every rank's rows."""
    sh = shards or spmd.Shards()
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")
    vocab = ("model",) if sh.model_split(ent) else ()
    xt = spmd.enter(x, sh.mesh, vocab)
    w = sh.use(w_out, ent, vocab)
    lo = sh.index(vocab) * w.shape[-1]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + _recomputed(_chunk_ce, xt[:, sl], w, labels[:, sl],
                                    sh.mesh, vocab, lo)
    return spmd.psum(total / (B * sh.extent(sh.rows) * S), sh.mesh, sh.rows)


def train_loss(params: Dict, batch: Dict, cfg: TransformerConfig,
               shards: Optional[spmd.Shards] = None,
               ents=spmd.WHOLE) -> torch.Tensor:
    """batch: {"tokens": (B, S) int32, "labels": (B, S) int32} -> the
    0-d float32 mean loss (on a process mesh: ``forward``'s arguments,
    ``batch`` the rank's rows; the global mean, on every rank)."""
    x = forward(params, batch["tokens"], cfg, shards, ents)
    return chunked_ce_loss(x, params["out"], batch["labels"], cfg.ce_chunk,
                           shards, ents["out"])


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def _cache_tree(cfg: TransformerConfig, batch: int, max_len: int, dtype,
                device) -> Dict:
    def mk(n):
        if cfg.attention == "mla":
            return {"ckv": torch.zeros((n, batch, max_len, cfg.kv_lora),
                                       dtype=dtype, device=device),
                    "kr": torch.zeros((n, batch, max_len, cfg.qk_rope),
                                      dtype=dtype, device=device)}
        shape = (n, batch, max_len, cfg.n_kv, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache = {"layers": mk(cfg.n_layers - cfg.n_dense_layers)}
    if cfg.n_dense_layers:
        cache["dense_layers"] = mk(cfg.n_dense_layers)
    return cache


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Dict:
    """A zero KV cache on ``device`` (the card by default), every layer's
    stacked along axis 0: ``k`` / ``v`` (n, B, L, n_kv, head_dim), or
    MLA's ``ckv`` (n, B, L, kv_lora) and ``kr`` (n, B, L, qk_rope)."""
    return _cache_tree(cfg, batch, max_len, dtype or cfg.param_dtype,
                       resolve_device(device))


def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int,
                 dtype: Optional[torch.dtype] = None) -> Dict:
    """``init_cache``'s tree on the meta device."""
    return _cache_tree(cfg, batch, max_len, dtype or cfg.param_dtype, "meta")


def _decode_attn(sh: spmd.Shards, p: Dict, e, x: torch.Tensor,
                 cache_l: Dict, pos: torch.Tensor, cfg: TransformerConfig,
                 window: int, seq: Tuple[str, ...]) -> torch.Tensor:
    """x: (B, D); ``cache_l``: this layer's cache views, written at
    pos - 1 (on a mesh: the rank's chunk of positions along ``seq``)."""
    B, _ = x.shape
    if cfg.attention == "mla":
        out, _, _ = mla_decode(x, p, cache_l["ckv"], cache_l["kr"], pos,
                               n_heads=cfg.n_heads, d_nope=cfg.qk_nope,
                               d_rope=cfg.qk_rope, d_v=cfg.v_head,
                               rope_theta=cfg.rope_theta, shards=sh, ents=e,
                               seq=seq)
        return out
    at = (pos - 1).reshape(1)
    # every head on every rank: each rank scores its chunk of positions
    q = whole_cols(sh, x, p["wq"], e["wq"]).reshape(B, 1, cfg.n_heads,
                                                     cfg.head_dim)
    k = whole_cols(sh, x, p["wk"], e["wk"]).reshape(B, 1, cfg.n_kv,
                                                     cfg.head_dim)
    v = whole_cols(sh, x, p["wv"], e["wv"]).reshape(B, 1, cfg.n_kv,
                                                     cfg.head_dim)
    q = apply_rope(q, at, cfg.rope_theta)[:, 0]
    k = apply_rope(k, at, cfg.rope_theta)
    write_at(cache_l["k"], at, k, sh, seq)
    write_at(cache_l["v"], at, v, sh, seq)
    out = decode_attention(q, cache_l["k"], cache_l["v"], pos, window=window,
                           shards=sh, seq=seq)
    return out_proj(sh, out.reshape(B, cfg.n_heads * cfg.head_dim), p["wo"],
                    e["wo"], cfg.n_heads)


def _greedy(sh: spmd.Shards, x: torch.Tensor, w_out: torch.Tensor,
            ent) -> torch.Tensor:
    """argmax over the vocab of ``x @ w_out``, (B,) int32; with the head's
    columns split over "model" (vocab-parallel), each shard's best value
    and first index combined: the largest value, the smallest index among
    the shards that hold it (``torch.argmax``'s first maximum)."""
    vocab = ("model",) if sh.model_split(ent) else ()
    logits = x @ sh.use(w_out, ent, vocab)
    if not vocab:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    best, idx = logits.float().max(dim=-1)
    lo = sh.index(vocab) * logits.shape[-1]
    top = spmd.pmax(best, sh.mesh, vocab)
    total = logits.shape[-1] * sh.extent(vocab)
    first = torch.where(best == top, idx + lo, total)
    return (-spmd.pmax(-first, sh.mesh, vocab)).to(torch.int32)


def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor, pos,
               cfg: TransformerConfig, shards: Optional[spmd.Shards] = None,
               ents=spmd.WHOLE, seq=()) -> Tuple[torch.Tensor, Dict]:
    """One greedy decode step.

    tokens: (B,) current tokens; pos: () int (a tensor, or an int) --
    the sequence position of the new token + 1, so cache entries [0, pos)
    are valid after this step.  Writes each layer's cache at pos - 1 in
    place and returns (next_tokens (B,) int32, cache).

    On a process mesh (``shards``; ``params`` the rank's shards, ``ents``
    their per-dim axes, ``tokens`` and the cache's batch the rank's rows,
    the cache's length split over ``seq``): weights gathered just in time
    as ``forward`` gathers them, the projections column-parallel and
    gathered, attention a split softmax over the rank's chunk of
    positions, the entry at pos - 1 written on the rank that holds it, the
    FFN as ``forward``'s (``swiglu_tp``, or ``moe_ffn``'s expert
    parallelism), the head vocab-parallel.
    """
    sh = shards or spmd.Shards()
    seq = spmd._axes(seq)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    x = sh.use(params["embed"], ents["embed"])[tokens.long()]
    for key, n, moe_layer, first in _stacks(cfg):
        e = tree_map(lambda t: t[1:], ents[key])     # without the layer dim
        for i in range(n):
            p = _layer(params[key], i)
            h = rms_norm(x, sh.use(p["ln1"], e["ln1"]))
            x = x + _decode_attn(sh, p["attn"], e["attn"], h,
                                 _layer(cache[key], i), pos, cfg,
                                 _layer_window(cfg, first + i), seq)
            h = rms_norm(x, sh.use(p["ln2"], e["ln2"]))
            x = x + (moe_ffn(p["ffn"], h, cfg.moe, shards=sh, ents=e["ffn"])
                     if moe_layer else swiglu_tp(h, p["ffn"], e["ffn"], sh))
    x = rms_norm(x, sh.use(params["final_norm"], ents["final_norm"]))
    return _greedy(sh, x, params["out"], ents["out"]), cache
