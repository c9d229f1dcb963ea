"""Attention variants (port of ``repro.models.attention``): GQA (full
causal), chunked-local (llama4-style), MLA (DeepSeek multi-head latent),
and their single-token decode paths.

Prefill attention is blockwise, an online softmax over KV blocks, so a
score matrix never grows beyond ``(B * Hkv, G * blk_q, blk_kv)``; the
mask (causal or chunked-local) is made from indices per block, never at
(S, S).  As in the reference, every KV block of every Q block is computed
and masked with ``NEG_INF``: skipping fully masked blocks is a later
lever (``ROADMAP.md``).

Every score and probability-times-value product returns float32, as the
reference's ``preferred_element_type=jnp.float32`` does; probabilities
are cast to the values' type before that product, and MLA's compressed
output to the activations' type before ``W_uv``, as there.  The per-layer
``window`` is a Python int (0 or None: full causal).

``blockwise_attention`` and ``mla_prefill`` are differentiable (LM
training); ``decode_attention`` and ``mla_decode`` are inference only.

On a process mesh the decode cache's length is split over "model" (the
reference's decode sequence parallelism): each rank holds a contiguous
chunk of positions.  ``decode_attention`` and ``mla_decode`` given the
shard context and those axes (``seq``) then score the rank's chunk, mask
it by global position, and combine a split softmax across the chunks (a
``spmd.pmax`` of the maxima, a ``psum`` of the sums, the probabilities
normalised, a ``psum`` of the weighted values); ``write_at`` writes the
new token's entry on the rank that holds ``pos - 1`` only, a masked write
of static shape.  Over one rank they run the single-device arithmetic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.sharding import spmd

NEG_INF = -1e30


def _bmm_out_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS's bfloat16 product with float32 accumulation and a float32
    output (``aten::bmm.dtype``), which has no derivative of its own."""
    return torch.bmm(a, b, out_dtype=torch.float32)


class MatmulF32(torch.autograd.Function):
    """``product(a, b)``, a float32 result from operands of another type,
    and its gradient: the float32 cotangent rounded to the operands' type,
    ``dA = product(dC, Bᵀ)`` and ``dB = product(Aᵀ, dC)``, each float32
    result cast to its operand's type.  Both backward products stay on the
    tensor cores; the reference's gradient multiplies the float32
    cotangent unrounded and casts the same way.  ``product`` is a
    parameter so that the CPU tests can run this backward with a product
    the CPU has."""

    @staticmethod
    def forward(ctx, a, b, product):
        ctx.save_for_backward(a, b)
        ctx.product = product
        return product(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        g = dc.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ctx.product(g, b.transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = ctx.product(a.transpose(1, 2), g).to(b.dtype)
        return da, db, None


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (3-D operands, any strides cuBLAS takes) with a
    float32 result.  Which product runs follows the operands' type and
    device: float32 operands multiply as they are; bfloat16 on CUDA runs
    cuBLAS's bfloat16 product with float32 accumulation and a float32
    output (``aten::bmm.dtype``), through ``MatmulF32`` where a gradient
    is wanted; bfloat16 on the CPU, which has no ``bmm.dtype`` kernel,
    widens both operands to float32 first -- exact, since a product of two
    bfloat16 values is exact in float32.  Meta operands (a dry-run trace,
    ``roofline.traced``) take the card's product."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda or a.is_meta:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return MatmulF32.apply(a, b, _bmm_out_f32)
        return _bmm_out_f32(a, b)
    return torch.bmm(a.float(), b.float())


def _block_mask(q_idx: torch.Tensor, k_idx: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """(q_blk, kv_blk) validity.  window 0 / None: causal; w > 0: causal
    within the chunk ``idx // w`` (llama4 chunked-local)."""
    causal = k_idx[None, :] <= q_idx[:, None]
    if not window:
        return causal
    return causal & ((k_idx[None, :] // window) == (q_idx[:, None] // window))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None, q_offset: int = 0,
                        blk_q: int = 1024, blk_kv: int = 1024) -> torch.Tensor:
    """Causal (optionally chunked-local) attention with an online softmax.

    q: (B, Sq, Hq, hd); k: (B, Skv, Hkv, hd); v: (B, Skv, Hkv, hd_v) with
    Hq % Hkv == 0 (GQA; MLA's d_v may differ from d_qk).  Returns (B, Sq,
    Hq, hd_v) in q's type.  Heads are laid out (B * Hkv, Sq * G, hd), rows
    ordered (position, group member), so that a Q block is one slab and a
    KV block a view; the reference's (B, Hkv, G, q) rows, in another order.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    hd_v = v.shape[-1]
    G = Hq // Hkv
    scale = hd ** -0.5
    blk_q, blk_kv = min(blk_q, Sq), min(blk_kv, Skv)
    if Sq % blk_q or Skv % blk_kv:
        raise ValueError(f"sequence lengths {Sq}, {Skv} are not multiples "
                         f"of the blocks {blk_q}, {blk_kv}")
    BH, rows = B * Hkv, blk_q * G
    qh = q.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4).reshape(
        BH, Sq * G, hd)
    kh = k.permute(0, 2, 1, 3).reshape(BH, Skv, hd)
    vh = v.permute(0, 2, 1, 3).reshape(BH, Skv, hd_v)
    dev = q.device
    # under autograd the loop runs out of place (its backward needs every
    # block's scores); in inference the same arithmetic runs in place
    train = torch.is_grad_enabled()
    outs = []
    for qi in range(Sq // blk_q):
        q_i = qh[:, qi * rows:(qi + 1) * rows]
        q_idx = q_offset + qi * blk_q + torch.arange(blk_q, device=dev)
        m = torch.full((BH, rows), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((BH, rows), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, rows, hd_v), dtype=torch.float32, device=dev)
        for ki in range(Skv // blk_kv):
            ks = slice(ki * blk_kv, (ki + 1) * blk_kv)
            k_idx = ki * blk_kv + torch.arange(blk_kv, device=dev)
            s = matmul_f32(q_i, kh[:, ks].transpose(1, 2))
            valid = _block_mask(q_idx, k_idx, window)[None, :, None, :]
            if train:
                s = torch.where(valid, (s * scale).view(BH, blk_q, G, blk_kv),
                                NEG_INF).view(BH, rows, blk_kv)
            else:
                s.mul_(scale).view(BH, blk_q, G, blk_kv).masked_fill_(
                    ~valid, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = (torch.exp(s - m_new[..., None]) if train
                 else s.sub_(m_new[..., None]).exp_())
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = matmul_f32(p.to(v.dtype), vh[:, ks])
            acc = (acc * corr[..., None] + pv if train
                   else acc.mul_(corr[..., None]).add_(pv))
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(B, Hkv, Sq, G, hd_v)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, hd_v)


def write_at(cache: torch.Tensor, at: torch.Tensor, new: torch.Tensor,
             shards: Optional[spmd.Shards] = None,
             seq: spmd.Axes = ()) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, L, ...) at position
    ``at`` (a (1,) tensor).  With the length split over ``seq`` the cache
    holds this rank's chunk of positions: the rank holding ``at`` writes
    ``new``, the others write back what they hold (no host sync)."""
    sh = shards or spmd.Shards()
    if sh.extent(seq) == 1:
        cache.index_copy_(1, at.long(), new)
        return
    L = cache.shape[1]
    local = at.long() - sh.index(seq) * L
    idx = local.clamp(0, L - 1)
    inside = (local >= 0) & (local < L)
    cache.index_copy_(1, idx, torch.where(inside, new,
                                          cache.index_select(1, idx)))


def _positions(L: int, pos: torch.Tensor, window: Optional[int], lo: int,
               device) -> torch.Tensor:
    """Validity of cache positions lo .. lo + L - 1 after a write at
    pos - 1: filled, and in the current chunk where ``window`` > 0."""
    idx = torch.arange(L, device=device)
    if lo:
        idx = idx + lo
    valid = idx < pos
    if window:
        valid = valid & ((idx // window) == ((pos - 1) // window))
    return valid


def _split_softmax(s: torch.Tensor, sh: spmd.Shards,
                   seq: Tuple[str, ...]) -> torch.Tensor:
    """softmax over the last dim of scores split over ``seq`` (masked
    entries at ``NEG_INF``): the maxima and the sums combined across the
    chunks, each chunk's probabilities normalised by the global sum."""
    p = torch.exp(s - spmd.pmax(s.amax(-1, keepdim=True), sh.mesh, seq))
    return p / spmd.psum(p.sum(-1, keepdim=True), sh.mesh, seq)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     shards: Optional[spmd.Shards] = None,
                     seq: spmd.Axes = ()) -> torch.Tensor:
    """One-token attention over a KV cache.

    q: (B, Hq, hd); caches: (B, L, Hkv, hd); pos: () int -- the number of
    valid cache entries (the new token's K/V already written at pos - 1).
    ``window`` > 0 restricts attention to the current length-``window``
    chunk; 0 / None is full causal.  The whole cache is scored and masked,
    as in the reference.  Returns (B, Hq, hd) in q's type.  With the
    length split over ``seq`` (``shards`` a process mesh's), the caches
    are this rank's chunk and the softmax is split (module docstring); the
    result is whole on every rank of ``seq``.
    """
    B, L, Hkv, hd = k_cache.shape
    G = q.shape[1] // Hkv
    qg = q.reshape(B, Hkv, G, hd)
    sh = shards or spmd.Shards()
    seq = spmd._axes(seq)
    split = sh.extent(seq) > 1
    valid = _positions(L, pos, window, sh.index(seq) * L if split else 0,
                       q.device)
    outs = []
    if not split:
        for b in range(B):   # a cache row's (Hkv, hd, L) view needs no copy
            s = matmul_f32(qg[b], k_cache[b].permute(1, 2, 0)).mul_(
                hd ** -0.5)
            p = torch.softmax(s.masked_fill_(~valid, NEG_INF), dim=-1)
            outs.append(matmul_f32(p.to(v_cache.dtype),
                                   v_cache[b].transpose(0, 1)))
        return torch.stack(outs).reshape(B, Hkv * G, hd).to(q.dtype)
    s = torch.stack([matmul_f32(qg[b], k_cache[b].permute(1, 2, 0))
                     for b in range(B)]).mul_(hd ** -0.5)
    p = _split_softmax(s.masked_fill_(~valid, NEG_INF), sh, seq)
    for b in range(B):
        outs.append(matmul_f32(p[b].to(v_cache.dtype),
                               v_cache[b].transpose(0, 1)))
    out = spmd.psum(torch.stack(outs), sh.mesh, seq)
    return out.reshape(B, Hkv * G, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2/V3)
# ---------------------------------------------------------------------------

def mla_prefill(x: torch.Tensor, p: dict, *, n_heads: int, d_nope: int,
                d_rope: int, d_v: int, positions: torch.Tensor,
                rope_theta: float, blk: int = 1024,
                shards: Optional[spmd.Shards] = None,
                ents=spmd.WHOLE) -> torch.Tensor:
    """MLA forward for prefill (decompressed K/V).

    Params p: wdq (d, q_lora), wuq (q_lora, H*(d_nope+d_rope)),
    wdkv (d, kv_lora), wukv (kv_lora, H*(d_nope+d_v)), wkr (d, d_rope),
    q_norm (q_lora,), kv_norm (kv_lora,), wo (H*d_v, d).

    On a process mesh (``shards``, ``ents`` the leaves' per-dim axes) ``p``
    holds the rank's shards and ``x`` its rows: a latent's down-projection
    column-parallel over "model" and gathered whole before its norm, the
    heads split over "model" where they divide (``wuq`` / ``wukv``
    column-parallel, ``wo`` row-parallel, one psum), the shared rope key
    whole on every rank.
    """
    sh = shards or spmd.Shards()
    e = ents
    B, S, _ = x.shape
    split = (sh.heads_split(n_heads, e["wuq"], e["wo"])
             and sh.heads_split(n_heads, e["wukv"], e["wo"]))
    H = n_heads // sh.tp if split else n_heads
    mt = ("model",) if split else ()

    def latent(wd, norm, wu):
        c, c_split = sh.col(x, p[wd], e[wd])
        if c_split:                    # the latent whole before its norm
            c = spmd.gather(c, -1, sh.mesh, ("model",))
        c = spmd.enter(rms_norm(c, sh.use(p[norm], e[norm])), sh.mesh, mt)
        return c @ sh.use(p[wu], e[wu], mt)

    q = latent("wdq", "q_norm", "wuq").reshape(B, S, H, d_nope + d_rope)
    q_rope = apply_rope(q[..., d_nope:], positions, rope_theta)
    kv = latent("wdkv", "kv_norm", "wukv").reshape(B, S, H, d_nope + d_v)
    kr, kr_split = sh.col(x, p["wkr"], e["wkr"])
    if kr_split:
        kr = spmd.gather(kr, -1, sh.mesh, ("model",),
                         "sum" if split else "slice")
    elif split:
        kr = spmd.enter(kr, sh.mesh, ("model",))
    k_rope = apply_rope(kr[:, :, None, :], positions, rope_theta)
    qc = torch.cat([q[..., :d_nope], q_rope], dim=-1)
    kc = torch.cat([kv[..., :d_nope], k_rope.expand(B, S, H, d_rope)], dim=-1)
    out = blockwise_attention(qc, kc, kv[..., d_nope:], blk_q=blk, blk_kv=blk)
    out = out.reshape(B, S, H * d_v) @ sh.use(p["wo"], e["wo"], mt)
    return spmd.psum(out, sh.mesh, mt)


def whole_cols(sh: spmd.Shards, x: torch.Tensor, w: torch.Tensor,
               ent) -> torch.Tensor:
    """``x @ w`` with every column on every rank: column-parallel over
    "model" where ``w``'s columns are split there, then gathered."""
    y, split = sh.col(x, w, ent)
    return spmd.gather(y, -1, sh.mesh, ("model",)) if split else y


def out_proj(sh: spmd.Shards, o: torch.Tensor, w: torch.Tensor, ent,
             n_heads: int) -> torch.Tensor:
    """``o @ w`` for ``o`` (B, H * d) whole on every rank: row-parallel
    over "model" (the rank's heads of ``o``, one psum) where ``w``'s rows
    are split there and the heads divide, else ``w`` gathered whole."""
    if sh.model_split(ent, 0) and n_heads % sh.tp == 0:
        mt = ("model",)
        return spmd.psum(spmd.scatter(o, -1, sh.mesh, mt)
                         @ sh.use(w, ent, mt), sh.mesh, mt)
    return o @ sh.use(w, ent)


def mla_decode(x: torch.Tensor, p: dict, ckv_cache: torch.Tensor,
               kr_cache: torch.Tensor, pos: torch.Tensor, *, n_heads: int,
               d_nope: int, d_rope: int, d_v: int, rope_theta: float,
               shards: Optional[spmd.Shards] = None, ents=spmd.WHOLE,
               seq: spmd.Axes = ()
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-weight MLA decode: attention runs in the compressed space.

    The cache holds only (kv_lora + d_rope) per token.  W_uk is absorbed
    into the query, W_uv into the output:
        score_h = (q_nope_h W_uk_h) . c_kv + q_rope_h . k_rope
        out_h   = (sum_t a_t c_kv_t) W_uv_h
    x: (B, D) one token; caches (B, L, kv_lora), (B, L, d_rope), written
    in place at pos - 1.  Returns (attn_out (B, D), ckv_cache, kr_cache).

    On a process mesh (``shards``, ``ents`` the leaves' per-dim axes,
    ``p`` the rank's shards, ``x`` its rows, the caches its chunk of
    positions along ``seq``): the projections column-parallel and gathered
    (every head on every rank, whose chunk of positions they all read),
    ``wukv`` gathered whole, the softmax split over ``seq``, ``wo``
    row-parallel over "model".
    """
    sh = shards or spmd.Shards()
    e = ents
    B, _ = x.shape
    H = n_heads
    L, kv_lora = ckv_cache.shape[1], ckv_cache.shape[2]
    seq = spmd._axes(seq)
    split = sh.extent(seq) > 1
    at = (pos - 1).reshape(1)
    cq = rms_norm(whole_cols(sh, x, p["wdq"], e["wdq"]),
                  sh.use(p["q_norm"], e["q_norm"]))
    q = whole_cols(sh, cq, p["wuq"], e["wuq"]).reshape(B, H,
                                                        d_nope + d_rope)
    q_rope = apply_rope(q[:, None, :, d_nope:], at, rope_theta)[:, 0]
    ckv_new = rms_norm(whole_cols(sh, x, p["wdkv"], e["wdkv"]),
                       sh.use(p["kv_norm"], e["kv_norm"]))
    kr_new = apply_rope(whole_cols(sh, x, p["wkr"], e["wkr"])[
        :, None, None, :], at, rope_theta)[:, 0, 0]
    write_at(ckv_cache, at, ckv_new[:, None], sh, seq)
    write_at(kr_cache, at, kr_new[:, None], sh, seq)

    wukv = sh.use(p["wukv"], e["wukv"]).reshape(kv_lora, H, d_nope + d_v)
    q_c = torch.einsum("bhn,chn->bhc", q[..., :d_nope], wukv[:, :, :d_nope])
    s = (matmul_f32(q_c, ckv_cache.transpose(1, 2))
         + matmul_f32(q_rope, kr_cache.transpose(1, 2))) * (
             (d_nope + d_rope) ** -0.5)
    valid = _positions(L, pos, None, sh.index(seq) * L if split else 0,
                       x.device)
    s = s.masked_fill_(~valid, NEG_INF)
    if split:
        a = _split_softmax(s, sh, seq)
        o_c = spmd.psum(matmul_f32(a.to(ckv_cache.dtype), ckv_cache),
                        sh.mesh, seq)
    else:
        a = torch.softmax(s, dim=-1)
        o_c = matmul_f32(a.to(ckv_cache.dtype), ckv_cache)  # (B, H, kv_lora)
    o = torch.einsum("bhc,chv->bhv", o_c.to(x.dtype), wukv[:, :, d_nope:])
    return (out_proj(sh, o.reshape(B, H * d_v), p["wo"], e["wo"], H),
            ckv_cache, kr_cache)
