"""Port parity: the batch-learning path -- ``make_loss_fn`` and its
gradients (rtol 1e-5), ``adamw`` / ``sgd`` and the schedules (20 steps,
rtol 1e-4 / atol 1e-6), ``Trainer`` with checkpoints, an injected failure
and a resume, checkpoints crossing between the packages in both
directions, ``online_epochs``, and ``examples/quickstart.py``'s sequence
at ``TINY`` (per-family accuracies equal to 1e-6) -- against the JAX
package."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import Hash2U, Hash4U, PermutationFamily, lowest_bits
from repro.core import minhash_signatures as j_minhash
from repro.core.bbit import pack_codes
from repro.data import TINY, generate
from repro.models import linear as jlin
from repro.train import TrainState as JTrainState
from repro.train import Trainer as JTrainer
from repro.train import checkpoint as jckpt
from repro.train import make_train_step as j_make_train_step
from repro.train import online_epochs as j_online_epochs
from repro_torch import optim as toptim
from repro_torch.convert import (family_from_jax, linear_model_from_jax,
                                 train_state_from_jax)
from repro_torch.core.bbit import lowest_bits as t_lowest_bits
from repro_torch.core.minhash import minhash_signatures as t_minhash
from repro_torch.core.u32 import from_numpy
from repro_torch.data.synthetic import generate as t_generate
from repro_torch.models import linear as tlin
from repro_torch.train import (Heartbeat, TrainState, Trainer, checkpoint,
                               make_train_step, online_epochs,
                               run_with_restarts)
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


RTOL, ATOL = 1e-4, 1e-6      # optimizer trajectories (the slice-1 tolerance)
K, B = 16, 4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _model(dim, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(dim).astype(np.float32) * 0.3
    return (jlin.LinearModel(w=jnp.asarray(w), bias=jnp.float32(0.2)),
            tlin.LinearModel(w=torch.from_numpy(w.copy()),
                             bias=torch.tensor(0.2)))


def _features(kind, rng, n=24):
    if kind == "dense":
        x = rng.standard_normal((n, 32)).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x), 32, {}
    sig = rng.integers(0, 2**B, (n, K)).astype(np.uint32)
    sig[0, 3] = 2**B                        # an EMPTY-coded bin: zero-coded
    if kind == "hashed":
        return jnp.asarray(sig), from_numpy(sig, "cpu"), K << B, {}
    words = np.asarray(pack_codes(jnp.asarray(sig), B + 1))
    return (jnp.asarray(words), from_numpy(words, "cpu"), K << B,
            {"k": K, "sentinel": True})


@pytest.mark.parametrize("fkind", ["hashed", "packed", "dense"])
@pytest.mark.parametrize("kind", ["svm", "logistic"])
def test_loss_and_gradients(kind, fkind):
    rng = np.random.default_rng(7)
    jx, tx, dim, kw = _features(fkind, rng)
    y = np.where(rng.random(jx.shape[0]) < 0.5, -1.0, 1.0).astype(np.float32)
    jm, tm = _model(dim, 1)
    b = 0 if fkind == "dense" else B
    jloss = jlin.make_loss_fn(kind, fkind, b, C=1.3, **kw)
    tloss = tlin.make_loss_fn(kind, fkind, b, C=1.3, **kw)
    jv, jg = jax.value_and_grad(jloss)(jm, jx, jnp.asarray(y))
    tm.w.requires_grad_(True)
    tm.bias.requires_grad_(True)
    tv = tloss(tm, tx, torch.from_numpy(y))
    gw, gb = torch.autograd.grad(tv, [tm.w, tm.bias])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg.w), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(gb), float(jg.bias), rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tlin.accuracy(tm, tx, torch.from_numpy(y), feature_kind=fkind,
                                b=b, **kw)),
            float(jlin.accuracy(jm, jx, jnp.asarray(y), feature_kind=fkind,
                                b=b, **kw)), rtol=0, atol=1e-6)


def _optimizers(lib):
    return {
        "adamw": lib.adamw(lib.constant(0.05)),
        "adamw-wd-cosine": lib.adamw(lib.warmup_cosine(0.1, 5, 20),
                                     weight_decay=0.01),
        "sgd": lib.sgd(lib.inverse_time(0.5, 1e-2)),
        "sgd-momentum": lib.sgd(0.05, momentum=0.9),
        "chain": lib.chain(lib.clip_by_global_norm(1.0),
                           lib.add_decayed_weights(0.1),
                           lib.scale_by_schedule(lib.constant(0.1))),
    }


@pytest.mark.parametrize("name", list(_optimizers(joptim)))
def test_optimizer_trajectories(name):
    jopt, topt = _optimizers(joptim)[name], _optimizers(toptim)[name]
    rng = np.random.default_rng(3)
    jp, tp = _model(40, 5)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(20):
        g = rng.standard_normal(40).astype(np.float32)
        gb = np.float32(rng.standard_normal())
        ju, js = jopt.update(jlin.LinearModel(w=jnp.asarray(g), bias=jnp.asarray(gb)),
                             js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(tlin.LinearModel(w=torch.from_numpy(g),
                                              bias=torch.tensor(gb)), ts, tp)
        tp = toptim.apply_updates(tp, tu)
    np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tp.bias), float(jp.bias), rtol=RTOL, atol=ATOL)
    jl = jax.tree_util.tree_leaves(js)
    tl = [leaf for _, leaf in path_leaves(ts)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_schedules():
    for c in (0, 1, 4, 5, 12, 30):
        jc, tc = jnp.int32(c), torch.tensor(c, dtype=torch.int32)
        for jf, tf in [(joptim.constant(0.3), toptim.constant(0.3)),
                       (joptim.inverse_time(0.5, 1e-3), toptim.inverse_time(0.5, 1e-3)),
                       (joptim.warmup_cosine(1.0, 5, 20), toptim.warmup_cosine(1.0, 5, 20))]:
            np.testing.assert_allclose(float(tf(tc)), float(jf(jc)), rtol=1e-5)


def _hashed_problem(seed=0, n=48):
    rng = np.random.default_rng(seed)
    sig = rng.integers(0, 2**B, (n, K)).astype(np.uint32)
    y = np.where(sig[:, 0] < 2**(B - 1), -1.0, 1.0).astype(np.float32)
    return sig, y


def _fit_pair(sig, y, n_steps, ckpt=None, fail_at=None):
    """The same adamw fit in both packages; returns (jax state, port
    state, the port's trainer)."""
    jloss = jlin.make_loss_fn("svm", "hashed", B, C=1.0)
    tloss = tlin.make_loss_fn("svm", "hashed", B, C=1.0)
    jopt, topt = joptim.adamw(joptim.constant(0.05)), toptim.adamw(toptim.constant(0.05))
    jstate = JTrainState.create(jlin.LinearModel.create(K << B), jopt)
    tstate = TrainState.create(tlin.LinearModel.create(K << B, "cpu"), topt)
    jstep = j_make_train_step(lambda p, bt: jloss(p, *bt), jopt)
    tstep = make_train_step(lambda p, bt: tloss(p, *bt), topt)
    if fail_at is not None:
        armed = {"on": True}
        inner = tstep

        def tstep(st, batch):
            if armed["on"] and int(st.step) == fail_at:
                armed["on"] = False
                raise RuntimeError("injected node failure")
            return inner(st, batch)

    jb = (jnp.asarray(sig), jnp.asarray(y))
    tb = (from_numpy(sig, "cpu"), torch.from_numpy(y))
    jfinal = JTrainer(jstep).fit(jstate, lambda: iter([jb] * n_steps), n_steps)
    trainer = Trainer(tstep, ckpt_dir=ckpt, ckpt_every=5, max_failures=1)
    tfinal = trainer.fit(tstate, lambda: iter([tb] * n_steps), n_steps)
    return jfinal, tfinal, trainer


def test_trainer_matches_and_restarts_to_the_same_weights(tmp_path):
    sig, y = _hashed_problem()
    jfinal, plain, tr0 = _fit_pair(sig, y, 20)
    _, restarted, tr = _fit_pair(sig, y, 20, ckpt=str(tmp_path / "ck"),
                                 fail_at=12)
    np.testing.assert_allclose(plain.params.w.numpy(), np.asarray(jfinal.params.w),
                               rtol=RTOL, atol=ATOL)
    assert int(restarted.step) == 20 and restarted.step.dtype == torch.int32
    assert torch.equal(restarted.params.w, plain.params.w)     # CPU: exact
    assert torch.equal(restarted.opt_state["v"].w, plain.opt_state["v"].w)
    assert len(tr0.metrics_log) == 20 and len(tr.metrics_log) == 20 + 2
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 20
    resumed = tr.maybe_resume(TrainState.create(
        tlin.LinearModel.create(K << B, "cpu"), toptim.adamw(toptim.constant(0.05))))
    assert int(resumed.step) == 20 and torch.equal(resumed.params.w, plain.params.w)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_00000010", "step_00000015", "step_00000020"]


def test_checkpoints_cross_both_ways(tmp_path):
    sig, y = _hashed_problem(1)
    jfinal, tfinal, _ = _fit_pair(sig, y, 7)
    # JAX writes, the port restores
    jckpt.save(str(tmp_path / "j"), 7, jfinal)
    template = train_state_from_jax(
        JTrainState.create(jlin.LinearModel.create(K << B),
                           joptim.adamw(joptim.constant(0.05))), "cpu")
    got, step = checkpoint.restore(str(tmp_path / "j"), template)
    want = train_state_from_jax(jfinal, "cpu")
    assert step == 7
    for (ka, a), (kb, b) in zip(path_leaves(got), path_leaves(want)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b)
    # the port writes, JAX restores
    checkpoint.save(str(tmp_path / "t"), 7, tfinal)
    jtemplate = JTrainState.create(jlin.LinearModel.create(K << B),
                                   joptim.adamw(joptim.constant(0.05)))
    jgot, jstep = jckpt.restore(str(tmp_path / "t"), jtemplate)
    assert jstep == 7
    tl = [leaf for _, leaf in path_leaves(tfinal)]
    for a, b in zip(jax.tree_util.tree_leaves(jgot), tl):
        assert a.dtype == _np(b).dtype
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    # bfloat16 leaves travel as uint16 both ways
    tree = {"b": torch.arange(5, dtype=torch.float32).to(torch.bfloat16)}
    checkpoint.save(str(tmp_path / "bf"), 1, tree)
    jtree, _ = jckpt.restore(str(tmp_path / "bf"), {"b": jnp.zeros(5, jnp.bfloat16)})
    assert jtree["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jtree["b"], np.float32), np.arange(5))
    back, _ = checkpoint.restore(str(tmp_path / "bf"), {"b": torch.zeros(5)})
    assert back["b"].dtype == torch.bfloat16
    t = checkpoint.save_async(str(tmp_path / "async"), 2, tfinal)
    t.join(timeout=30)
    assert not t.is_alive() and checkpoint.latest_step(str(tmp_path / "async")) == 2


def test_online_epochs_matches_reference():
    sig, y = _hashed_problem(2, n=64)
    chunks = [(sig[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    jstep = jax.jit(functools.partial(jlin.sgd_svm_step, lam=1e-3, eta0=0.5,
                                      b=B, average=True))
    jfinal, jtimes, _ = j_online_epochs(
        lambda st, bt: jstep(st, jnp.asarray(bt[0]), jnp.asarray(bt[1])),
        jlin.sgd_svm_init(K << B, avg_start=5.0), lambda: iter(chunks), 3)

    def tstep(st, bt):
        return tlin.sgd_svm_step(st, from_numpy(bt[0], "cpu"),
                                 torch.from_numpy(bt[1]), lam=1e-3, eta0=0.5,
                                 b=B, average=True)

    tfinal, times, evals = online_epochs(
        tstep, tlin.sgd_svm_init(K << B, avg_start=5.0, device="cpu"),
        lambda: iter(chunks), 3, eval_fn=lambda st: float(st.t))
    assert len(times) == len(jtimes) == 3 and evals == [4.0, 8.0, 12.0]
    assert all(t.train_s > 0 and t.load_s >= 0 for t in times)
    np.testing.assert_allclose(tfinal.model.w.numpy(), np.asarray(jfinal.model.w),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tfinal.avg_w.numpy(), np.asarray(jfinal.avg_w),
                               rtol=RTOL, atol=ATOL)


def test_sgd_svm_step_on_dense_features():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    y = np.where(rng.random(16) < 0.5, -1.0, 1.0).astype(np.float32)
    js = jlin.sgd_svm_init(32)
    ts = tlin.sgd_svm_init(32, device="cpu")
    for _ in range(5):
        js = jlin.sgd_svm_step(js, jnp.asarray(x), jnp.asarray(y), lam=1e-2,
                               eta0=0.3, b=0, feature_kind="dense", kind="logistic")
        tlin.sgd_svm_step(ts, torch.from_numpy(x), torch.from_numpy(y), lam=1e-2,
                          eta0=0.3, b=0, feature_kind="dense", kind="logistic")
    np.testing.assert_allclose(ts.model.w.numpy(), np.asarray(js.model.w),
                               rtol=RTOL, atol=ATOL)


def test_calibrate_eta0_and_converters():
    losses = {2.0 ** p: (p + 3) ** 2 for p in range(-8, 4)}
    assert tlin.calibrate_eta0(lambda e: losses[e]) == \
        jlin.calibrate_eta0(lambda e: losses[e]) == 2.0 ** -3
    jm, _ = _model(12, 9)
    tm = linear_model_from_jax(jm, "cpu")
    np.testing.assert_array_equal(tm.w.numpy(), np.asarray(jm.w))
    st = train_state_from_jax(JTrainState.create(jm, joptim.sgd(0.1, momentum=0.9)), "cpu")
    assert [k for k, _ in path_leaves(st)] == [
        "params/w", "params/bias", "opt_state/count", "opt_state/mu/w",
        "opt_state/mu/bias", "step"]
    assert st.step.dtype == torch.int32 and st.opt_state["count"].dtype == torch.int32


def test_fault_control_plane():
    hb = Heartbeat(deadline_s=0.1)
    assert not hb.observe(0.05) and hb.observe(0.5) and hb.stragglers == 1
    for _ in range(10):
        hb.observe(0.01)
    assert hb.adaptive_deadline(factor=3.0) == pytest.approx(0.03, rel=0.5)

    def always_fails(state, step):
        raise ValueError("dead")

    with pytest.raises(ValueError):
        run_with_restarts(init_state=0, init_step=0, run_steps=always_fails,
                          restore_fn=lambda: (0, 0), max_failures=2)


def test_quickstart_sequence_at_tiny():
    """``examples/quickstart.py`` (k = 128, b = 8, D = 2^16, 120 adamw
    steps) in both packages over the same families: per-family test
    accuracies equal to within 1e-6."""
    k, b, s = 128, 8, 16
    jtrain, jtest = generate(TINY)
    ttrain, ttest = t_generate(TINY, device="cpu")
    key = jax.random.PRNGKey(0)
    fams = {"permutations": PermutationFamily.create(key, k, 1 << s),
            "2U": Hash2U.create(key, k, s), "4U": Hash4U.create(key, k, s)}
    for name, fam in fams.items():
        port = family_from_jax(fam, "cpu")
        jsig = [lowest_bits(j_minhash(bt.indices, bt.mask, fam), b)
                for bt in (jtrain, jtest)]
        tsig = [t_lowest_bits(t_minhash(bt.indices, bt.mask, port), b)
                for bt in (ttrain, ttest)]
        jloss = jlin.make_loss_fn("svm", "hashed", b, C=1.0)
        jopt = joptim.adamw(joptim.constant(0.05))
        jstate = JTrainer(j_make_train_step(lambda p, bt: jloss(p, *bt), jopt)).fit(
            JTrainState.create(jlin.LinearModel.create(k << b), jopt),
            lambda: iter([(jsig[0], jtrain.labels)] * 120), 120)
        tloss = tlin.make_loss_fn("svm", "hashed", b, C=1.0)
        topt = toptim.adamw(toptim.constant(0.05))
        tstate = Trainer(make_train_step(lambda p, bt: tloss(p, *bt), topt)).fit(
            TrainState.create(tlin.LinearModel.create(k << b, "cpu"), topt),
            lambda: iter([(tsig[0], ttrain.labels)] * 120), 120)
        jacc = float(jlin.accuracy(jstate.params, jsig[1], jtest.labels,
                                   feature_kind="hashed", b=b))
        tacc = float(tlin.accuracy(tstate.params, tsig[1], ttest.labels,
                                   feature_kind="hashed", b=b))
        assert abs(tacc - jacc) <= 1e-6, (name, tacc, jacc)
        assert tacc > 0.9, (name, tacc)
