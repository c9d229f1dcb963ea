"""Port parity for recsys training: ``recsys_loss`` and its gradient for
each arch against ``jax.grad`` of the reference, the ``sigbag`` autograd
backward against autograd through ``sigbag_plain``, the fused Adafactor
train step of each arch (and a microbatched one) against the reference's
``launch.steps._make_train_step``, and ``launch/train.py`` on the CPU
with a resume.  Smoke configs, the reference's weights and frontend
coefficients handed over (``convert.recsys_params_from_jax``), inputs made
with numpy.

Tolerances: the loss to rtol 1e-6.  Each gradient leaf to rtol 1e-5 and
an atol of 1e-5 of that leaf's largest |gradient|, floored at 1e-10:
DIN's last attention bias has a true gradient of 0 (a softmax does not
see a shift), so both packages hold only rounding, ~1e-12.  After a
train step the parameters agree to rtol 1e-5 / atol 3e-7, 1e-3 of a
3e-4 step: Adafactor scales each element of a vector by its own gradient
history, so an element whose gradient is small against its leaf's carries
that gradient's rounding into its step at full size (measured: 9.5e-8 in
a DIN head bias, 3e-8 elsewhere).  That DIN attention bias is held only to at most the clipped step
(3e-4) a step, since Adafactor scales its rounding noise up to a full
step of either sign, and the logits after the steps (which it cannot
move) to rtol 1e-5.
The second-moment statistics are means of squared gradients: rtol 1e-4
and an atol of 1e-4 of the leaf's largest (that DIN bias's: below 1e-20,
squared rounding, in both).
The ``sigbag`` backward equals autograd through ``sigbag_plain`` bit for
bit in float32 (the same sums in the same order); in bfloat16 to one
bfloat16 ulp.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as j_steps
from repro.models import recsys as j_recsys
from repro_torch.configs import get_arch
from repro_torch.convert import (adafactor_state_from_numpy,
                                 recsys_params_from_jax, tree_to_numpy)
from repro_torch.kernels.sigbag import sigbag, sigbag_plain
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import recsys as t_recsys
from repro_torch.train import checkpoint
from repro_torch.tree import (path_leaves, tree_leaves, tree_map,
                              unflatten_like)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ("wide-deep", "autoint", "din", "mind")
B = 32
SHIFT_FREE = "attn_mlp/b/2"      # DIN's last attention bias (see above)


def _smoke(arch):
    j_cfg = j_get_arch(arch).smoke
    params = j_recsys.init_recsys_params(j_cfg, jax.random.PRNGKey(0))
    a1 = a2 = None
    if j_cfg.use_minhash_frontend:
        a1, a2 = j_recsys._minhash_coeffs(j_cfg.arch_id, j_cfg.minhash_k)
    model = recsys_params_from_jax(params, get_arch(arch).smoke, a1, a2,
                                   device="cpu")
    return j_cfg, params, model


def _batch(cfg, seed, n=B):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.interaction in ("concat", "self-attn"):
        out["field_ids"] = rng.integers(0, cfg.vocab, (n, cfg.n_fields))
    else:
        out["hist_ids"] = rng.integers(0, cfg.item_vocab, (n, cfg.seq_len))
        mask = (rng.random((n, cfg.seq_len)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
        out["hist_mask"] = mask
        out["target_id"] = rng.integers(0, cfg.item_vocab, (n,))
    if cfg.use_minhash_frontend:
        out["set_ids"] = rng.integers(0, 1 << cfg.minhash_s, (n, cfg.set_nnz))
        out["set_counts"] = rng.integers(1, cfg.set_nnz, (n,))
    out["labels"] = rng.integers(0, 2, (n,)).astype(np.float32)
    return out


def _both(batch):
    def cast(v):
        return v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
    return ({k: jnp.asarray(cast(v)) for k, v in batch.items()},
            {k: torch.from_numpy(cast(v)) for k, v in batch.items()})


def _j_paths(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _check_grads(t_grads, j_grads):
    got = path_leaves(t_grads)
    want = _j_paths(j_grads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        atol = max(1e-5 * float(np.abs(w).max()), 1e-10)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    j_cfg, params, model = _smoke(arch)
    j_batch, t_batch = _both(_batch(model.cfg, 1))
    j_loss, j_grads = jax.value_and_grad(j_recsys.recsys_loss)(
        params, j_batch, j_cfg)
    live = tree_map(lambda t: t.detach().requires_grad_(True), model.params())
    loss = t_recsys.recsys_loss(model, t_batch, live)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-6)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    _check_grads(unflatten_like(live, list(grads)), j_grads)


def test_loss_is_softplus_without_a_threshold(monkeypatch):
    """Logits far past F.softplus's linear threshold (20) keep the exact
    loss, as jax.nn.softplus does."""
    z = torch.tensor([-60.0, -25.0, 0.0, 25.0, 60.0])
    y = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
    want = jnp.mean(jax.nn.softplus(-jnp.asarray(z.numpy()))
                    + (1.0 - jnp.asarray(y.numpy())) * jnp.asarray(z.numpy()))

    _, _, model = _smoke("din")
    monkeypatch.setattr(t_recsys, "recsys_logits",
                        lambda m, batch, params=None, *shards: z)
    got = t_recsys.recsys_loss(model, {"labels": y})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sigbag_backward_matches_autograd_through_plain(dtype):
    rng = np.random.default_rng(7)
    k, two_b, d, n = 9, 16, 5, 40
    table = torch.from_numpy(rng.standard_normal((k, two_b, d)).astype(
        np.float32)).to(dtype)
    tok = rng.integers(0, two_b, (n, k)).astype(np.int32)
    tok[3, 2], tok[5, 0], tok[6, 8] = -1, two_b, 2**31 - 1   # dropped
    tok = torch.from_numpy(tok)
    g_out = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(dtype)

    t1 = table.clone().requires_grad_(True)
    out = sigbag(tok, t1)
    assert out.grad_fn is not None and torch.equal(out, sigbag_plain(tok, table))
    (got,) = torch.autograd.grad(out, t1, g_out)
    t2 = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(sigbag_plain(tok, t2), t2, g_out)
    assert got.dtype == dtype and got.shape == table.shape
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                                   atol=0)
    with torch.no_grad():
        assert sigbag(tok, t1).grad_fn is None


def test_frontend_gradient_through_the_bag_function():
    """AutoInt's minhash_table gradient through ``sigbag`` == through
    ``sigbag_plain`` (the check chip_smoke.py makes on the card)."""

    class PlainBag(t_recsys.RecsysModel):
        def signature_bag(self, sig, table, row0=0):
            return sigbag_plain(sig, table, row0)

    _, _, model = _smoke("autoint")
    plain = PlainBag(model.cfg, model.params(), model.a1, model.a2)
    _, t_batch = _both(_batch(model.cfg, 5))
    grads = []
    for m in (model, plain):
        live = tree_map(lambda t: t.detach().requires_grad_(True), m.params())
        loss = t_recsys.recsys_loss(m, t_batch, live)
        (g,) = torch.autograd.grad(loss, [live["minhash_table"]])
        grads.append(g)
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])


def _train_pair(arch, microbatch=1, steps=2):
    j_cfg, params, model = _smoke(arch)
    j_prog = j_steps.build_cell(arch, "train_batch", smoke=True)
    t_prog = t_steps.build_cell(arch, "train_batch", smoke=True, device="cpu")
    assert t_prog.kind == "recsys_train"
    j_state = j_prog.optimizer.init(params)
    j_state["count"] = jnp.int32(200)     # the schedule's peak, 3e-4
    t_state = adafactor_state_from_numpy(tree_to_numpy(j_state), "cpu")
    j_step = j_steps._make_train_step(
        lambda p, x: j_recsys.recsys_loss(p, x, j_cfg), j_prog.optimizer,
        microbatch=microbatch, fused=True)
    if microbatch == 1:
        t_step = lambda p, s, x: t_prog.step(model, p, s, x)
    else:
        t_step = t_steps._make_train_step(
            lambda p, x: t_recsys.recsys_loss(model, x, p), t_prog.optimizer,
            microbatch=microbatch)
    j_p, t_p = params, model.params()
    for i in range(steps):
        j_b, t_b = _both(_batch(model.cfg, 10 + i))
        j_p, j_state, j_loss = j_step(j_p, j_state, j_b)
        t_p, t_state, t_loss = t_step(t_p, t_state, t_b)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    return j_cfg, model, params, (j_p, j_state), (t_p, t_state)


def _check_step(arch, model, params, j_after, t_after, j_cfg):
    (j_p, j_state), (t_p, t_state) = j_after, t_after
    assert int(t_state["count"]) == int(j_state["count"]) == 202
    start = dict(_j_paths(params))
    for (path, t), (_, j) in zip(path_leaves(t_p), _j_paths(j_p)):
        t = t.detach().numpy()
        if arch == "din" and path == SHIFT_FREE:
            # at most the schedule's 3e-4 (the RMS clip) a step, either way
            for moved in (t, j):
                assert float(np.abs(moved - start[path]).max()) <= 2 * 3e-4 * (1 + 1e-5)
            continue
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=3e-7, err_msg=path)
        assert not np.array_equal(t, start[path]) or not np.any(j != start[path])
    for (path, t), (_, j) in zip(path_leaves(tree_to_numpy(t_state["v"])),
                                 _j_paths(j_state["v"])):
        if arch == "din" and path.startswith(SHIFT_FREE):
            # squared rounding noise in both, far below any true gradient's
            assert max(float(t.max()), float(j.max())) < 1e-20
            continue
        np.testing.assert_allclose(t, j, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(j).max()),
                                   err_msg=path)
    j_b, t_b = _both(_batch(model.cfg, 99))
    after = t_recsys.recsys_logits(model, t_b, t_p).detach().numpy()
    want = np.asarray(j_recsys.recsys_logits(j_p, j_b, j_cfg))
    np.testing.assert_allclose(after, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_train_step_matches_reference(arch):
    j_cfg, model, params, j_after, t_after = _train_pair(arch)
    _check_step(arch, model, params, j_after, t_after, j_cfg)


def test_microbatched_train_step_matches_reference():
    j_cfg, model, params, j_after, t_after = _train_pair("din", microbatch=2)
    _check_step("din", model, params, j_after, t_after, j_cfg)


def _final_params(ckpt_dir):
    step = checkpoint.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        return step, {k: z[k] for k in z.files}


def test_train_launcher_resumes(tmp_path, capsys):
    common = ["--arch", "autoint", "--smoke", "--device", "cpu",
              "--ckpt-every", "2", "--seed", "3"]
    straight = str(tmp_path / "straight")
    t_train.main(common + ["--steps", "6", "--ckpt-dir", straight])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"autoint/train_batch: [\d,]+ params, "
                        r"optimizer=fused-adafactor", out[0]), out[0]
    assert re.fullmatch(r"loss: first=\d+\.\d{4} last=\d+\.\d{4} \(6 steps "
                        r"from step 0, \d+ stragglers\)", out[-1]), out[-1]
    resumed = str(tmp_path / "resumed")
    t_train.main(common + ["--steps", "4", "--ckpt-dir", resumed])
    state = t_train.main(common + ["--steps", "6", "--ckpt-dir", resumed])
    assert "(2 steps from step 4" in capsys.readouterr().out
    assert int(state.step) == 6
    s1, a = _final_params(straight)
    s2, b = _final_params(resumed)
    assert s1 == s2 == 6 and sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_launcher_refuses_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        t_train.main(["--arch", "graphsage", "--device", "cpu"])
    assert "not in the port" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_train.main(["--arch", "gatedgcn", "--cell", "serve_p99",
                      "--device", "cpu"])
    assert "no cell 'serve_p99'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_train.main(["--arch", "din", "--cell", "serve_p99", "--device",
                      "cpu"])
