"""Port parity for Adafactor: ``repro_torch.optim.adafactor_fused`` and
``adafactor`` against ``repro.optim.optimizers``, three steps from one
state on a leaf of each path -- a stack of >= 8 slices (the fused
update's slice loop, one RMS clip a slice), a stack of fewer (the whole
leaf), a matrix (factored) and a vector (a full second moment) -- with
and without bfloat16 momentum.  The state is carried over through numpy
(``convert.adafactor_state_from_numpy``) after one reference step, so
every statistic starts nonzero.

Tolerances: the factored statistics are float32 means over rows and
columns, free to sum in another order: rtol 1e-5 on ``vr`` / ``vc`` /
``v`` and on the parameters (atol 1e-7 at a 0.1-scale init).  bfloat16
momentum rounds the float32 direction to 8 bits, so an input one float32
ulp apart can land one bfloat16 ulp away: ``m`` is held to rtol 2^-7 (one
bfloat16 ulp) and the parameters it moves to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.base import apply_updates as j_apply_updates
from repro_torch import optim as topt
from repro_torch.convert import (adafactor_state_from_numpy,
                                 tree_from_numpy, tree_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"stack": (10, 6, 5), "short_stack": (3, 6, 5), "mat": (7, 4),
          "vec": (9,)}
STEPS = 3


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {name: (0.1 * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in SHAPES.items()}


def _grads(step):
    """Per-slice scales from 0.01 to 100, so some slices clip and some
    do not."""
    rng = np.random.default_rng(100 + step)
    out = {}
    for name, shape in SHAPES.items():
        g = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 3:
            g *= np.logspace(-2, 2, shape[0], dtype=np.float32)[:, None, None]
        out[name] = g
    return out


def _run_both(fused, momentum):
    lr_j = j_warmup_cosine(3e-2, 2, 10)
    lr_t = topt.warmup_cosine(3e-2, 2, 10)
    kw = dict(momentum=momentum)
    if fused:
        j_o, t_o = jopt.adafactor_fused(lr_j, **kw), topt.adafactor_fused(lr_t, **kw)
    else:
        j_o, t_o = jopt.adafactor(lr_j, **kw), topt.adafactor(lr_t, **kw)

    def j_step(p, s, g):
        if fused:
            return j_o.update(g, s, p)
        u, s = j_o.update(g, s, p)
        return j_apply_updates(p, u), s

    def t_step(p, s, g):
        if fused:
            return t_o.update(g, s, p)
        u, s = t_o.update(g, s, p)
        return topt.apply_updates(p, u), s

    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    js = j_o.init(jp)
    jp, js = j_step(jp, js, {k: jnp.asarray(v) for k, v in _grads(0).items()})
    tp = tree_from_numpy(tree_to_numpy(jp), "cpu")
    ts = adafactor_state_from_numpy(tree_to_numpy(js), "cpu")
    trail = []
    for step in range(1, STEPS + 1):
        g = _grads(step)
        jp, js = j_step(jp, js, {k: jnp.asarray(v) for k, v in g.items()})
        tp, ts = t_step(tp, ts, {k: torch.from_numpy(v) for k, v in g.items()})
        trail.append((tree_to_numpy(jp), tree_to_numpy(js),
                      tree_to_numpy(tp), tree_to_numpy(ts)))
    return trail, ts


@pytest.mark.parametrize("momentum", [None, 0.9])
@pytest.mark.parametrize("fused", [True, False])
def test_three_steps_match_reference(fused, momentum):
    trail, ts = _run_both(fused, momentum)
    p_atol = 1e-7 if momentum is None else 1e-6
    for jp, js, tp, t_s in trail:
        assert int(t_s["count"]) == int(js["count"])
        for name in SHAPES:
            np.testing.assert_allclose(tp[name], jp[name], rtol=1e-5,
                                       atol=p_atol, err_msg=name)
            for key, want in js["v"][name].items():
                np.testing.assert_allclose(t_s["v"][name][key], want,
                                           rtol=1e-5, atol=0,
                                           err_msg=f"{name}/{key}")
            if momentum is not None:
                np.testing.assert_allclose(t_s["m"][name], js["m"][name],
                                           rtol=2**-7, atol=1e-9,
                                           err_msg=f"{name}/m")
    assert ts["count"].dtype == torch.int32
    if momentum is not None:
        assert all(m.dtype == torch.bfloat16 for m in ts["m"].values())
    assert sorted(ts["v"]["stack"]) == ["vc", "vr"]
    assert sorted(ts["v"]["vec"]) == ["v"]


def test_fused_clips_each_slice_of_a_long_stack():
    """A stack of >= 8 slices is clipped slice by slice: an outlier in
    slice 0 clips that slice's step to RMS 1 and leaves the others at 1.
    Below 8 slices the leaf clips as a whole and every other slice's step
    shrinks with slice 0's, as ``adafactor`` does."""
    opt = topt.adafactor_fused(1.0)
    plain = topt.adafactor(1.0, momentum=None)
    for lead, per_slice in ((8, True), (7, False)):
        p = {"w": torch.zeros((lead, 4, 4))}
        g = {"w": torch.ones((lead, 4, 4))}
        g["w"][0, 0, 0] = 100.0
        new_p, _ = opt.update(g, opt.init(p), p)
        rms = new_p["w"].square().mean((1, 2)).sqrt()     # of each slice
        whole, _ = plain.update(g, plain.init(p), p)
        if per_slice:
            torch.testing.assert_close(rms, torch.ones(lead))
            assert not torch.allclose(new_p["w"], whole["w"])
        else:
            assert float(rms[1:].max()) < 0.9
            torch.testing.assert_close(new_p["w"], whole["w"])


def test_state_round_trips_through_numpy():
    opt = topt.adafactor(0.1, momentum=0.9)
    p = tree_from_numpy(_params(), "cpu")
    g = tree_from_numpy(_grads(1), "cpu")
    _, s = opt.update(g, opt.init(p), p)
    back = adafactor_state_from_numpy(tree_to_numpy(s), "cpu")
    assert int(back["count"]) == 1
    for name in SHAPES:
        assert torch.equal(back["m"][name], s["m"][name])
        for key in s["v"][name]:
            assert torch.equal(back["v"][name][key], s["v"][name][key])
