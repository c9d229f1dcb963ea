"""Port parity for the LM building blocks: ``rms_norm``, ``layer_norm``,
``swiglu``, ``apply_rope`` (``models/layers.py``) and the attention
variants of ``models/attention.py`` -- blockwise prefill attention (full
causal, chunked-local, GQA, d_v != d_qk, a Q offset), decode attention
with and without a window (across a chunk boundary), and MLA prefill and
absorbed decode -- against ``repro.models`` on the same numpy inputs.

Tolerances: float32 throughout, products and softmaxes rounding in
another order in each package: 1e-5 absolute (and relative) on values of
order 1.  The bfloat16 cases run with scores of order 100, where a score
rounded to bfloat16 (an ulp of 0.5-1) moves the softmax by O(1): they are
held to 2e-2 absolute, a few bfloat16 ulps of the outputs, which a score
product that lost its float32 result cannot meet.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = RTOL = 1e-5
BF16_ATOL = 2e-2


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)   # a copy


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_norms_swiglu_and_rope():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 32), _rand(rng, 32), _rand(rng, 32)
    _close(t_layers.rms_norm(_t(x), _t(w)), j_layers.rms_norm(_j(x), _j(w)))
    _close(t_layers.layer_norm(_t(x), _t(w), _t(b)),
           j_layers.layer_norm(_j(x), _j(w), _j(b)))
    wg, wu, wd = _rand(rng, 32, 48), _rand(rng, 32, 48), _rand(rng, 48, 32)
    _close(t_layers.swiglu(*map(_t, (x, wg, wu, wd))),
           j_layers.swiglu(*map(_j, (x, wg, wu, wd))), atol=1e-4)
    q = _rand(rng, 2, 7, 3, 16)
    for pos, theta in ((np.arange(7), 10000.0),
                       (np.arange(7) + 4090, 500000.0)):
        _close(t_layers.apply_rope(_t(q), torch.from_numpy(pos), theta),
               j_layers.apply_rope(_j(q), jnp.asarray(pos), theta),
               atol=1e-4)
    # rms_norm keeps bfloat16 in, bfloat16 out, normalised in float32
    xb = t_layers.rms_norm(_t(x, torch.bfloat16), _t(w, torch.bfloat16))
    wantb = j_layers.rms_norm(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16))
    assert xb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        xb.float().numpy(), np.asarray(wantb.astype(jnp.float32)))


# (B, S, Hq, Hkv, hd, hd_v, window, blk, q_offset)
ATTN_CASES = [
    pytest.param(2, 32, 4, 4, 16, 16, 0, 8, 0, id="causal-mha"),
    pytest.param(2, 32, 6, 2, 16, 16, 0, 8, 0, id="causal-gqa-g3"),
    pytest.param(1, 48, 4, 1, 8, 8, 16, 8, 0, id="window-16-mqa"),
    pytest.param(2, 32, 4, 2, 16, 16, 8, 16, 0, id="window-8-blk16"),
    pytest.param(2, 32, 4, 4, 24, 16, 0, 8, 0, id="dv-ne-dqk"),
    pytest.param(1, 16, 4, 2, 16, 16, 0, 8, 16, id="q-offset"),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,hd_v,window,blk,q_offset",
                         ATTN_CASES)
def test_blockwise_attention(B, S, Hq, Hkv, hd, hd_v, window, blk,
                             q_offset):
    rng = np.random.default_rng(S + Hq + window)
    Skv = S + q_offset
    q = _rand(rng, B, S, Hq, hd)
    k = _rand(rng, B, Skv, Hkv, hd)
    v = _rand(rng, B, Skv, Hkv, hd_v)
    got = t_attn.blockwise_attention(_t(q), _t(k), _t(v), window=window,
                                     q_offset=q_offset, blk_q=blk,
                                     blk_kv=blk)
    want = j_attn.blockwise_attention(_j(q), _j(k), _j(v), window=window,
                                      q_offset=q_offset, blk_q=blk,
                                      blk_kv=blk)
    assert got.shape == (B, S, Hq, hd_v)
    _close(got, want)


def test_chunked_local_first_token_of_a_chunk_sees_itself():
    """As tests/test_archs.py: under window 8, the first token of a chunk
    attends to itself only."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(_rand(rng, 1, 32, 2, 8)) for _ in range(3))
    local = t_attn.blockwise_attention(q, k, v, window=8, blk_q=8, blk_kv=8)
    full = t_attn.blockwise_attention(q, k, v, window=0, blk_q=8, blk_kv=8)
    _close(local[0, 8], v[0, 8])
    assert not np.allclose(local[0, 8].numpy(), full[0, 8].numpy())


# (Hq, Hkv, L, window, pos): pos 17 and 33 are the first tokens of chunks
# 1 and 2 under window 16, pos 16 the last of chunk 0
@pytest.mark.parametrize("Hq,Hkv,L,window,pos", [
    (4, 4, 40, None, 1), (4, 4, 40, None, 40), (6, 2, 40, None, 23),
    (4, 2, 40, 16, 16), (4, 2, 40, 16, 17), (4, 2, 40, 16, 33),
    (4, 2, 40, 0, 33)])
def test_decode_attention(Hq, Hkv, L, window, pos):
    rng = np.random.default_rng(pos)
    B, hd = 2, 16
    q = _rand(rng, B, Hq, hd)
    kc, vc = _rand(rng, B, L, Hkv, hd), _rand(rng, B, L, Hkv, hd)
    got = t_attn.decode_attention(_t(q), _t(kc), _t(vc), torch.tensor(pos),
                                  window=window)
    want = j_attn.decode_attention(_j(q), _j(kc), _j(vc), jnp.int32(pos),
                                   window=window)
    _close(got, want)
    if window and (pos - 1) % window == 0:        # first token of a chunk
        G = Hq // Hkv
        _close(got.reshape(B, Hkv, G, hd),
               np.broadcast_to(vc[:, pos - 1, :, None], (B, Hkv, G, hd)))


MLA = dict(n_heads=4, d_nope=16, d_rope=8, d_v=12, rope_theta=10000.0)


def _mla_params(rng, d=32, q_lora=24, kv_lora=16):
    H, dn, dr, dv = (MLA[k] for k in ("n_heads", "d_nope", "d_rope", "d_v"))
    return {"wdq": _rand(rng, d, q_lora, scale=d ** -0.5),
            "wuq": _rand(rng, q_lora, H * (dn + dr), scale=q_lora ** -0.5),
            "wdkv": _rand(rng, d, kv_lora, scale=d ** -0.5),
            "wukv": _rand(rng, kv_lora, H * (dn + dv), scale=kv_lora ** -0.5),
            "wkr": _rand(rng, d, dr, scale=d ** -0.5),
            "wo": _rand(rng, H * dv, d, scale=(H * dv) ** -0.5),
            "q_norm": 1 + 0.1 * _rand(rng, q_lora),
            "kv_norm": 1 + 0.1 * _rand(rng, kv_lora)}


def test_mla_prefill():
    rng = np.random.default_rng(5)
    p = _mla_params(rng)
    x = _rand(rng, 2, 32, 32)
    pos = np.arange(32)
    got = t_attn.mla_prefill(_t(x), {k: _t(v) for k, v in p.items()},
                             positions=torch.from_numpy(pos), blk=8, **MLA)
    want = j_attn.mla_prefill(_j(x), {k: _j(v) for k, v in p.items()},
                              positions=jnp.asarray(pos), blk=8, **MLA)
    _close(got, want)


def test_mla_decode_writes_pos_minus_one_and_matches():
    rng = np.random.default_rng(6)
    p = _mla_params(rng)
    B, L = 2, 24
    ckv, kr = _rand(rng, B, L, 16), _rand(rng, B, L, 8)
    for pos in (1, 9, 24):
        x = _rand(rng, B, 32)
        t_ckv, t_kr = _t(ckv), _t(kr)
        out, c2, r2 = t_attn.mla_decode(
            _t(x), {k: _t(v) for k, v in p.items()}, t_ckv, t_kr,
            torch.tensor(pos), **MLA)
        w_out, w_c, w_r = j_attn.mla_decode(
            _j(x), {k: _j(v) for k, v in p.items()}, _j(ckv), _j(kr),
            jnp.int32(pos), **MLA)
        assert c2 is t_ckv and r2 is t_kr          # written in place
        _close(out, w_out)
        _close(c2, w_c)
        _close(r2, w_r)
        changed = (c2.numpy() != ckv).any(axis=(0, 2))
        assert changed.nonzero()[0].tolist() == [pos - 1]


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def test_bfloat16_scores_stay_float32():
    """Scores of order 100 in bfloat16: held to a few bfloat16 ulps of
    the reference, whose score products return float32."""
    rng = np.random.default_rng(7)
    q = _bf16(_rand(rng, 1, 32, 4, 16, scale=4.0))
    k = _bf16(_rand(rng, 1, 32, 2, 16, scale=4.0))
    v = _bf16(_rand(rng, 1, 32, 2, 16))
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                  for a in (q, k, v))
    got = t_attn.blockwise_attention(tq, tk, tv, window=0, blk_q=8, blk_kv=8)
    want = j_attn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=0, blk_q=8,
                                      blk_kv=8)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), atol=BF16_ATOL,
           rtol=0)
    kc = _bf16(_rand(rng, 1, 32, 2, 16, scale=4.0))
    vc = _bf16(_rand(rng, 1, 32, 2, 16))
    qd = _bf16(_rand(rng, 1, 4, 16, scale=4.0))
    got = t_attn.decode_attention(
        *(torch.from_numpy(a.astype(np.float32)).bfloat16()
          for a in (qd, kc, vc)), torch.tensor(20))
    want = j_attn.decode_attention(jnp.asarray(qd), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.int32(20))
    _close(got, np.asarray(want.astype(jnp.float32)), atol=BF16_ATOL,
           rtol=0)


def test_matmul_f32_follows_type_and_device():
    a = torch.randn(2, 3, 4).bfloat16()
    b = torch.randn(2, 4, 5).bfloat16()
    got = t_attn.matmul_f32(a, b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), (a.double() @ b.double()).numpy(), rtol=1e-6, atol=1e-6)
    assert t_attn.matmul_f32(a.float(), b.float()).dtype == torch.float32
