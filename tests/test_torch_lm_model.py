"""Port parity for the LM family's serving path (``models/transformer.py``)
against ``repro.models.transformer`` on every LM arch's smoke config: the
reference's weights carried over (``convert.lm_params_from_jax``), the
same numpy tokens, ``forward`` (prefill) and 64 teacher-forced
``serve_step`` decode steps from a zero cache.  llama4-scout's smoke
config (window 16, every 4th layer global) decodes across three chunk
boundaries; deepseek-v3's runs MLA with a dense layer before two MoE
layers.  A bfloat16 case runs one smoke config in bfloat16.

Tolerances (float32): 1e-4 absolute on the rms-normed hidden states (order
1, after 2-4 layers of float32 products rounded in another order); 1e-5
absolute and relative on the caches.  Next tokens are identical wherever
the reference's top-2 logit margin exceeds 1e-3 (below it, rounding may
swap the two).  The bfloat16 case: hidden states within 0.1 absolute (a
few bfloat16 ulps of order-1 values, after two layers of bfloat16
products) and a mean difference under 1e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as j_tfm
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_cache_from_jax, lm_params_from_jax,
                                 tree_to_numpy)
from repro_torch.models import transformer as t_tfm
from repro_torch.tree import path_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LM_ARCHS = ("deepseek-7b", "yi-34b", "mistral-large-123b",
            "llama4-scout-17b-a16e", "deepseek-v3-671b")
B, S = 2, 64          # SMOKE_LM batch and seq
MARGIN = 1e-3


@functools.lru_cache(maxsize=None)
def _models(arch, j_cfg=None, t_cfg=None):
    """The reference's smoke config (or ``j_cfg``), its weights (a jitted
    init: the same draws as the eager one, in half the time) and the
    port's model holding them."""
    j_cfg = j_cfg or j_get_arch(arch).smoke
    t_cfg = t_cfg or get_arch(arch).smoke
    params = jax.jit(functools.partial(j_tfm.init_params, j_cfg))(
        jax.random.PRNGKey(0))
    return j_cfg, params, lm_params_from_jax(params, t_cfg, "cpu")


def _j_forward(j_cfg):
    return jax.jit(functools.partial(j_tfm.forward, cfg=j_cfg))


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_serve_step_match_reference(arch):
    j_cfg, params, model = _models(arch)
    cfg = model.cfg
    tokens = _tokens(cfg)
    want_h = np.asarray(_j_forward(j_cfg)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_h = t_tfm.forward(model.params(), torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-4, rtol=0)

    # a decode step routes B = 2 tokens, which never fill an expert; the
    # prefill that decode must agree with drops none either: capacity
    # factor n_experts / top_k (only here)
    nodrop = j_cfg
    if j_cfg.moe is not None:
        nodrop = dataclasses.replace(j_cfg, moe=dataclasses.replace(
            j_cfg.moe, capacity_factor=j_cfg.moe.n_experts / j_cfg.moe.top_k))
    logits = np.asarray(_j_forward(nodrop)(params, jnp.asarray(tokens))
                        ) @ np.asarray(params["out"])    # (B, S, V)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN

    j_step = jax.jit(functools.partial(j_tfm.serve_step, cfg=j_cfg))
    j_cache = j_tfm.init_cache(j_cfg, B, S)
    t_cache = t_tfm.init_cache(cfg, B, S, device="cpu")
    got_next, want_next = [], []
    with torch.inference_mode():
        for t in range(S):
            nxt, j_cache = j_step(params, j_cache, jnp.asarray(tokens[:, t]),
                                  jnp.int32(t + 1))
            want_next.append(np.asarray(nxt))
            tn, out_cache = t_tfm.serve_step(
                model.params(), t_cache, torch.from_numpy(tokens[:, t]),
                torch.tensor(t + 1, dtype=torch.int32), cfg)
            assert out_cache is t_cache and tn.dtype == torch.int32
            got_next.append(tn.numpy())
    got_next, want_next = np.stack(got_next, 1), np.stack(want_next, 1)
    np.testing.assert_array_equal(got_next[clear], want_next[clear])
    # decode agrees with prefill: step t's token is argmax of position t
    np.testing.assert_array_equal(got_next[clear], logits.argmax(-1)[clear])
    assert clear.mean() > 0.9
    want_cache = dict(path_leaves(tree_to_numpy(j_cache)))
    for path, leaf in path_leaves(tree_to_numpy(t_cache)):
        np.testing.assert_allclose(leaf, want_cache[path], atol=1e-5,
                                   rtol=1e-5, err_msg=path)
    assert sorted(want_cache) == sorted(p for p, _ in path_leaves(t_cache))


def test_serve_step_from_a_reference_cache():
    """A mid-sequence reference cache carried over (``lm_cache_from_jax``)
    decodes on as the reference does: llama4-scout at pos 17, the first
    token of its second chunk."""
    arch = "llama4-scout-17b-a16e"
    j_cfg, params, model = _models(arch)
    tokens = _tokens(model.cfg, seed=1)
    j_step = jax.jit(functools.partial(j_tfm.serve_step, cfg=j_cfg))
    cache = j_tfm.init_cache(j_cfg, B, S)
    for t in range(16):
        _, cache = j_step(params, cache, jnp.asarray(tokens[:, t]),
                          jnp.int32(t + 1))
    t_cache = lm_cache_from_jax(jax.device_get(cache), "cpu")
    want, cache = j_step(params, cache, jnp.asarray(tokens[:, 16]),
                         jnp.int32(17))
    with torch.inference_mode():
        got, t_cache = t_tfm.serve_step(model.params(), t_cache,
                                        torch.from_numpy(tokens[:, 16]), 17,
                                        model.cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = t_cache["layers"]["k"].numpy()
    np.testing.assert_allclose(k, np.asarray(cache["layers"]["k"]),
                               atol=1e-5, rtol=1e-5)


def test_bfloat16_smoke_forward():
    """yi-34b's smoke config in bfloat16: weights carried bit for bit."""
    arch = "yi-34b"
    j_cfg = dataclasses.replace(j_get_arch(arch).smoke,
                                param_dtype=jnp.bfloat16)
    t_cfg = dataclasses.replace(get_arch(arch).smoke,
                                param_dtype=torch.bfloat16)
    _, params, model = _models(arch, j_cfg, t_cfg)
    wq = model.params()["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(params["layers"]["attn"]["wq"]).astype(np.float32))
    tokens = _tokens(t_cfg, seed=2)
    want = np.asarray(_j_forward(j_cfg)(params, jnp.asarray(tokens))
                      .astype(jnp.float32))
    with torch.inference_mode():
        got = t_tfm.forward(model.params(), torch.from_numpy(tokens), t_cfg)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() < 0.1 and diff.mean() < 1e-2, (diff.max(), diff.mean())


def test_init_params_draws_the_reference_tree():
    """The port's own init: the reference's paths, shapes, types and
    scales (std within 10% of the reference's, norms ones), drawn
    reproducibly from a seed."""
    arch = "deepseek-v3-671b"
    j_cfg, params, _ = _models(arch)
    t_cfg = get_arch(arch).smoke
    gen = lambda: torch.Generator().manual_seed(0)
    m1, m2 = t_tfm.init_params(t_cfg, gen()), t_tfm.init_params(t_cfg, gen())
    want = dict(path_leaves(tree_to_numpy(params)))
    got = dict(path_leaves(m1.params()))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        ref = want[path]
        assert tuple(leaf.shape) == ref.shape and leaf.dtype == torch.float32
        if "norm" in path or path.endswith(("ln1", "ln2")):
            assert bool((leaf == 1).all()), path
        elif leaf.numel() > 256:
            ratio = float(leaf.std()) / float(ref.std())
            assert 0.9 < ratio < 1.1, (path, ratio)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
