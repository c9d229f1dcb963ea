"""Port parity for LM training (``models/transformer.py`` ``train_loss`` /
``chunked_ce_loss``, ``launch/steps.py`` ``_pick_optimizer`` /
``_make_train_step`` and ``launch/train.py``) against
``repro.models.transformer`` and ``repro.launch.steps`` on every LM arch's
smoke config: the reference's weights carried over
(``convert.lm_params_from_jax``), the same numpy tokens and labels.

Tolerances (float32): the loss to rtol 1e-6 (two to four layers of float32
products summed in another order: ~1e-7 measured).  Each gradient leaf to
rtol 1e-4 and an atol of 1e-5 of that leaf's largest |gradient|, floored
at 1e-8: llama4-scout routes top-1, so its normalised routing weight is
exactly 1 and its router's true gradient is 0; both packages hold ~1e-9
of rounding there.  Optimizer states to the same bounds.  Parameters after
an AdamW step to 1e-6 absolute wherever the reference's gradient exceeds
1e-5 of its leaf's largest: AdamW's first update is ~lr * sign(g), so an
element whose gradient is rounding noise may step the other way (there,
at most the two steps' distance).  After an Adafactor step (bfloat16
momentum) the parameters to rtol 1e-5 / atol 1e-6, as
``test_torch_adafactor.py`` holds them, and the momentum to one bfloat16
ulp (rtol 2^-7) and, like the gradient it scales, an atol of 1e-5 of its
leaf's largest.
"""

import dataclasses
import functools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as j_steps
from repro.models import transformer as j_tfm
from repro_torch.configs import cells_for, get_arch
from repro_torch.convert import (adafactor_state_from_numpy,
                                 lm_params_from_jax, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tfm
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import checkpoint
from repro_torch.tree import path_leaves, tree_map


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
PEAK_COUNT = 200      # the schedule's peak, 3e-4


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's smoke weights (a jitted init: the same draws as the
    eager one), as numpy."""
    cfg = j_get_arch(arch).smoke
    return jax.device_get(jax.jit(functools.partial(j_tfm.init_params, cfg))(
        jax.random.PRNGKey(0)))


def _configs(arch, remat=False):
    return (dataclasses.replace(j_get_arch(arch).smoke, remat=remat),
            dataclasses.replace(get_arch(arch).smoke, remat=remat))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, path, rtol=1e-4, share=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=max(share * float(np.abs(want).max()), 1e-8), err_msg=path)


# -- the loss -----------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 16, 8])
def test_chunked_ce_loss_matches_reference_and_unchunked(chunk):
    rng = np.random.default_rng(chunk)
    D, V = 16, 50
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    j_loss, (j_gx, j_gw) = jax.value_and_grad(
        lambda x, w: j_tfm.chunked_ce_loss(x, w, jnp.asarray(labels), chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = t_tfm.chunked_ce_loss(tx, tw, torch.from_numpy(labels), chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(j_loss), rtol=1e-6)
    _close(tx.grad.numpy(), np.asarray(j_gx), "x")
    _close(tw.grad.numpy(), np.asarray(j_gw), "w_out")
    plain = torch.nn.functional.cross_entropy(
        (torch.from_numpy(x) @ torch.from_numpy(w)).reshape(-1, V),
        torch.from_numpy(labels).reshape(-1).long())
    np.testing.assert_allclose(float(got.detach()), float(plain), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        t_tfm.chunked_ce_loss(tx, tw, torch.from_numpy(labels), 24)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_loss_and_gradients_match_reference(arch, remat):
    j_cfg, t_cfg = _configs(arch, remat)
    params = _params(arch)
    j_b, t_b = _both(_batch(t_cfg, 1))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        functools.partial(j_steps._lm_loss, cfg=j_cfg)))(params, j_b)
    live = tree_map(lambda t: t.requires_grad_(True),
                    tree_from_numpy(params, "cpu"))
    loss = t_tfm.train_loss(live, t_b, t_cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    want = dict(path_leaves(tree_to_numpy(j_grads)))
    got = path_leaves(live)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, leaf in got:
        _close(leaf.grad.numpy(), want[path], path)


# -- the attention backward --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 8])
def test_blockwise_attention_grad_branch_equals_inference(dtype, window):
    """The out-of-place loop autograd runs computes the in-place loop's
    values bit for bit (GQA, 2 x 2 blocks, chunked-local or causal)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 32, 4, 8), generator=g).to(dtype)
    k = torch.randn((2, 32, 2, 8), generator=g).to(dtype)
    v = torch.randn((2, 32, 2, 8), generator=g).to(dtype)
    kw = dict(window=window, blk_q=16, blk_kv=16)
    with torch.inference_mode():
        want = t_attn.blockwise_attention(q, k, v, **kw)
    qg = q.clone().requires_grad_(True)
    got = t_attn.blockwise_attention(qg, k, v, **kw)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)
    got.float().square().sum().backward()
    assert qg.grad.dtype == dtype and bool(torch.isfinite(qg.grad).all())


def test_matmul_f32_backward_against_widened_autograd():
    """``MatmulF32``'s backward (the CUDA route's) run with the CPU's
    product: dA = bf16(dC) @ Bᵀ and dB = Aᵀ @ bf16(dC), each cast to
    bfloat16, against autograd through float32-widened operands (the
    cotangent unrounded).  Rounding dC changes each term by at most 2^-9
    of it, and each result is rounded to bfloat16 once on either side:
    |got - want| <= 3 * 2^-9 * (|dC| @ |B|ᵀ) elementwise (likewise dB)."""
    g = torch.Generator().manual_seed(4)
    a = torch.randn((3, 40, 24), generator=g).to(torch.bfloat16)
    b = torch.randn((3, 24, 56), generator=g).to(torch.bfloat16)
    dc = torch.randn((3, 40, 56), generator=g) * 100
    widened = lambda x, y: torch.bmm(x.float(), y.float())
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = t_attn.MatmulF32.apply(a1, b1, widened)
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ref = widened(a2, b2)
    assert out.dtype == torch.float32 and torch.equal(out.detach(), ref)
    out.backward(dc)
    ref.backward(dc)
    assert a1.grad.dtype == b1.grad.dtype == torch.bfloat16
    bound_a = 3 * 2**-9 * torch.bmm(dc.abs(), b.float().abs().transpose(1, 2))
    bound_b = 3 * 2**-9 * torch.bmm(a.float().abs().transpose(1, 2), dc.abs())
    assert bool(((a1.grad.float() - a2.grad.float()).abs() <= bound_a).all())
    assert bool(((b1.grad.float() - b2.grad.float()).abs() <= bound_b).all())
    assert not torch.equal(a1.grad, a2.grad)     # the cotangent was rounded


# -- the optimizers and the step -----------------------------------------------

def _tiny():
    """A parameter tree and gradients to see an optimizer's choice by."""
    p = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
         "b": np.linspace(0.5, 1, 4, dtype=np.float32)}
    g = {"w": np.cos(np.arange(12, dtype=np.float32)).reshape(3, 4),
         "b": np.sin(np.arange(4, dtype=np.float32))}
    return p, g


@pytest.mark.parametrize("n_params", [7e9, 60e9, 400e9, "published"])
def test_pick_optimizer_matches_reference(n_params):
    if n_params == "published":
        counts = {a: t_tfm.count_params(get_arch(a).config) for a in LM_ARCHS}
        for arch, n in counts.items():
            assert n == j_tfm.count_params(j_get_arch(arch).config), arch
        cases = list(counts.values())
    else:
        cases = [n_params]
    for n in cases:
        (j_o, j_fused), (t_o, t_fused) = (j_steps._pick_optimizer(n),
                                          t_steps._pick_optimizer(n))
        assert j_fused == t_fused, n
        p, g = _tiny()
        j_s, t_s = j_o.init(p), t_o.init(tree_from_numpy(p, "cpu"))
        assert sorted(j_s) == sorted(t_s), n
        for _ in range(2):
            if j_fused:
                j_p, j_s = j_o.update(g, j_s, p)
                t_p, t_s = t_o.update(tree_from_numpy(g, "cpu"), t_s,
                                      tree_from_numpy(p, "cpu"))
            else:
                u, j_s = j_o.update(g, j_s, p)
                j_p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
                u, t_s = t_o.update(tree_from_numpy(g, "cpu"), t_s,
                                    tree_from_numpy(p, "cpu"))
                t_p = tree_map(lambda a, b: a + b, tree_from_numpy(p, "cpu"),
                               u)
            for key in p:
                np.testing.assert_allclose(t_p[key].numpy(),
                                           np.asarray(j_p[key]), rtol=1e-6,
                                           atol=1e-9, err_msg=f"{n} {key}")
        if "m" in j_s:
            assert str(t_s["m"]["w"].dtype)[6:] == str(j_s["m"]["w"].dtype)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, optimizer_n, microbatch):
    """The reference's ``_make_train_step`` (jitted) with its
    ``_pick_optimizer(optimizer_n)``, one step from count ``PEAK_COUNT``:
    (its state before, params and state after, loss), as numpy."""
    j_cfg, t_cfg = _configs(arch)
    params = _params(arch)
    j_o, fused = j_steps._pick_optimizer(optimizer_n)
    j_state = j_o.init(params)
    j_state["count"] = jnp.int32(PEAK_COUNT)
    j_step = jax.jit(j_steps._make_train_step(
        functools.partial(j_steps._lm_loss, cfg=j_cfg), j_o,
        microbatch=microbatch, fused=fused))
    j_b, _ = _both(_batch(t_cfg, 2))
    j_p, j_after, j_loss = j_step(params, j_state, j_b)
    return jax.device_get((j_state, (j_p, j_after), j_loss))


def _train_pair(arch, optimizer_n, microbatch=1):
    """One train step of both packages from the same state (count
    ``PEAK_COUNT``): the reference's and the port's ``_make_train_step``,
    each with its ``_pick_optimizer(optimizer_n)``."""
    _, t_cfg = _configs(arch)
    params = _params(arch)
    j_state, j_after, j_loss = _reference_step(arch, optimizer_n, microbatch)
    t_o, fused = t_steps._pick_optimizer(optimizer_n)
    t_step = t_steps._make_train_step(
        lambda p, x: t_tfm.train_loss(p, x, t_cfg), t_o,
        microbatch=microbatch, fused=fused, split=t_tfm.per_layer)
    t_params = lm_params_from_jax(params, t_cfg, "cpu").params()
    if fused:
        t_state = adafactor_state_from_numpy(tree_to_numpy(j_state), "cpu")
    else:
        t_state = tree_from_numpy(tree_to_numpy(j_state), "cpu")
    _, t_b = _both(_batch(t_cfg, 2))
    t_p, t_state, t_loss = t_step(t_params, t_state, t_b)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    assert int(t_state["count"]) == int(j_after[1]["count"]) == PEAK_COUNT + 1
    return params, j_after, (t_p, t_state)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_adamw_step_matches_reference(microbatch):
    """deepseek-7b's smoke config (AdamW, unfused), one step; microbatch 2
    == the reference's scan over two slices of one row."""
    before, (j_p, j_s), (t_p, t_s) = _train_pair("deepseek-7b", 7e9,
                                                 microbatch)
    j_m = dict(path_leaves(j_s["m"]))
    j_v = dict(path_leaves(j_s["v"]))
    for (path, m), (_, v) in zip(path_leaves(t_s["m"]), path_leaves(t_s["v"])):
        _close(m.numpy(), j_m[path], path)
        _close(v.numpy(), j_v[path], path, share=1e-9)
    start = dict(path_leaves(before))
    lr = 3e-4
    for path, p in path_leaves(t_p):
        want = np.asarray(dict(path_leaves(j_p))[path])
        clear = np.abs(j_m[path]) > 1e-5 * np.abs(j_m[path]).max()
        diff = np.abs(p.numpy() - want)
        assert float(diff[clear].max()) <= 1e-6, path
        assert float(diff.max()) <= 2 * 1.5 * lr, path
        assert not np.array_equal(p.numpy(), start[path]), path


@pytest.mark.parametrize("chunk", ["whole", "chunked"])
def test_adafactor_step_matches_reference(chunk, monkeypatch):
    """deepseek-v3's smoke config (MLA, two MoE layers) under the LM's
    Adafactor with momentum 0.9, fused and in place.  "chunked" shrinks
    ``UPDATE_CHUNK`` to three expert matrices, so the (2, 8, 64, 32) expert
    stacks go through the two-pass chunked update."""
    if chunk == "chunked":
        monkeypatch.setattr(t_opt, "UPDATE_CHUNK", 3 * 64 * 32)
    before, (j_p, j_s), (t_p, t_s) = _train_pair("deepseek-v3-671b", 60e9)
    assert sorted(t_s) == ["count", "m", "v"]
    j_m = dict(path_leaves(j_s["m"]))
    for path, m in path_leaves(tree_to_numpy(t_s["m"])):
        _close(m, np.asarray(j_m[path], np.float32), path, rtol=2**-7)
    j_v = dict(path_leaves(j_s["v"]))
    for path, v in path_leaves(tree_to_numpy(t_s["v"])):
        _close(v, j_v[path], path, share=1e-9)
    start = dict(path_leaves(before))
    for path, p in path_leaves(t_p):
        want = np.asarray(dict(path_leaves(j_p))[path])
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=path)
        assert not np.array_equal(p.numpy(), start[path]), path


# -- the cell and the launcher --------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_cell_train_4k_steps(arch):
    prog = t_steps.build_cell(arch, "train_4k", smoke=True, device="cpu")
    assert (prog.kind, prog.family, prog.microbatch, prog.fused) == (
        "lm_train", "lm", 1, False)
    full = t_steps.build_cell(arch, "train_4k", device="cpu")
    assert full.microbatch == get_arch(arch).config.microbatch > 1
    gen = torch.Generator().manual_seed(0)
    model = prog.init_params(gen)
    inputs = t_steps.init_inputs(prog, gen)
    assert sorted(inputs) == ["labels", "tokens"]
    for t in inputs.values():
        assert t.shape == (B, S) and t.dtype == torch.int32
        assert 0 <= int(t.min()) and int(t.max()) < prog.config.vocab
    params = model.params()
    before = {p: t.clone() for p, t in path_leaves(params)}
    new_p, state, loss = prog.step(model, params, prog.optimizer.init(params),
                                   inputs)
    assert math.isfinite(float(loss)) and int(state["count"]) == 1
    # unit-scale logits: ln V plus about half the logits' variance
    assert abs(float(loss) - math.log(prog.config.vocab) - 0.5) < 1.0
    for path, t in path_leaves(new_p):
        assert t.dtype == before[path].dtype
        assert not torch.equal(t, before[path]), path


def _final_params(ckpt_dir):
    step = checkpoint.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        return step, {k: z[k] for k in z.files}


def test_train_launcher_resumes_an_lm(tmp_path, capsys):
    common = ["--arch", "yi-34b", "--device", "cpu", "--ckpt-every", "2",
              "--seed", "5"]
    straight = str(tmp_path / "straight")
    t_train.main(common + ["--steps", "4", "--ckpt-dir", straight])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"yi-34b/train_4k: [\d,]+ params, "
                        r"optimizer=fused-adafactor", out[0]), out[0]
    assert re.fullmatch(r"loss: first=\d+\.\d{4} last=\d+\.\d{4} \(4 steps "
                        r"from step 0, \d+ stragglers\)", out[-1]), out[-1]
    resumed = str(tmp_path / "resumed")
    t_train.main(common + ["--steps", "2", "--ckpt-dir", resumed])
    state = t_train.main(common + ["--steps", "4", "--ckpt-dir", resumed])
    assert "(2 steps from step 2" in capsys.readouterr().out
    assert int(state.step) == 4
    s1, a = _final_params(straight)
    s2, b = _final_params(resumed)
    assert s1 == s2 == 4 and sorted(a) == sorted(b)
    assert any(k.startswith("opt_state/m/") for k in a)       # AdamW's
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert [c.name for c in cells_for("yi-34b") if "train" in c.kind] == [
        "train_4k"]
