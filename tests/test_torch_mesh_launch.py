"""Port parity for training GatedGCN on a mesh and for the mesh
launcher (``gnn.gnn_loss`` on local shards, ``launch.steps._mesh_step``,
``launch/train.py --mesh``), on four gloo ranks
(``torch_spawn.RankPool``) over ("data", "model") meshes (2, 2) and
(1, 4).

GatedGCN ``full_graph_sm`` at smoke size: two steps (the second from the
meshed reference's state after the first), each against the reference's
jitted step under ``set_mesh`` of a ``jax.sharding.Mesh`` of the same
shape and against the port's unmeshed step, to
``test_torch_gnn_train.py``'s tolerances for one step: the loss and every
parameter to rtol 1e-5 (atol 1e-7), AdamW's ``m`` to rtol 1e-5 and ``v``
to 1e-4, each with an atol of 1e-5 of the leaf's largest value.

``launch/train.py --mesh debug`` under ``torchrun`` (2 ranks, gloo)
prints the parameter-count line the reference's ``--smoke --mesh debug``
prints on 2 host devices, and the losses the port's own unmeshed run of
the same command prints (the launcher draws its weights from a torch
generator, so losses compare to the port); ``--mesh single-pod`` at a
world of 2 is refused, naming 256.

deepseek-v3 (MLA, a dense layer and two MoE layers) also takes
``test_torch_mesh_train.py``'s two checked steps on a (2, 1, 2) ("pod",
"data", "model") mesh.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as j_steps
from repro.sharding.rules import set_mesh as j_set_mesh
from repro_torch.convert import (gnn_params_from_jax, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.tree import path_leaves
from test_torch_mesh_train import (PEAK_COUNT, ROOT, SHAPES, _close, _jmesh,
                                   _starts, check_lm_case)
from torch_spawn import RankPool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


# -- GatedGCN --------------------------------------------------------------------

def _gnn_start(cell):
    prog = j_steps.build_cell("gatedgcn", cell, smoke=True)
    params = jax.tree_util.tree_map(np.array,
                                    prog.init_params(jax.random.PRNGKey(0)))
    state = prog.optimizer.init(params)
    state["count"] = jnp.int32(PEAK_COUNT)
    rng = np.random.default_rng(3)
    n = prog.input_avals["node_feats"].shape[0]
    batches = []
    for _ in range(2):
        b = {}
        for name, aval in prog.input_avals.items():
            shape = tuple(aval.shape)
            if name == "node_feats":
                b[name] = rng.standard_normal(shape).astype(np.float32)
            elif name == "edge_index":
                b[name] = rng.integers(0, n, shape).astype(np.int32)
            elif name in ("edge_mask", "node_mask"):
                b[name] = (rng.random(shape) < 0.8).astype(np.float32)
            elif name == "labels":
                b[name] = rng.integers(0, prog.config.n_classes,
                                       shape).astype(np.int32)
        batches.append(b)
    return params, tree_to_numpy(jax.device_get(state)), batches


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_gatedgcn_steps_match_reference_and_unmeshed(shape, pool,
                                                     host_devices):
    cell = "full_graph_sm"
    params, state, batches = _gnn_start(cell)
    step = jax.jit(j_steps.build_cell("gatedgcn", cell, smoke=True).step)
    p, s = params, jax.tree_util.tree_map(jnp.asarray, state)
    want = []
    with j_set_mesh(_jmesh(shape, host_devices)):
        for b in batches:
            p, s, loss = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            want.append((float(loss), tree_to_numpy(jax.device_get(p)),
                         tree_to_numpy(jax.device_get(s))))
    starts = _starts((params, state), want[0], batches)
    got = pool.run("mesh_checks:train_steps", shape, "gatedgcn", cell,
                   starts, None, 1)[0]
    prog = t_steps.build_cell("gatedgcn", cell, smoke=True, device="cpu")
    plain = []
    for sp, ss, b in starts:
        tp = gnn_params_from_jax(sp, prog.config, "cpu").params()
        tp, ts, loss = prog.step(None, tp, tree_from_numpy(ss, "cpu"),
                                 tree_from_numpy(b, "cpu"))
        plain.append((float(loss), tree_to_numpy(tp), tree_to_numpy(ts)))
    for ref in (want, plain):
        for (sp, _, _), g, w in zip(starts, got, ref):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
            w_p, s_p = dict(path_leaves(w[1])), dict(path_leaves(sp))
            for path, a in path_leaves(g[1]):
                np.testing.assert_allclose(a, w_p[path], rtol=1e-5,
                                           atol=1e-7, err_msg=path)
                assert not np.array_equal(a, s_p[path]), path
            w_s = dict(path_leaves(w[2]))
            for path, a in path_leaves(g[2]):
                if path != "count":
                    _close(a, w_s[path], path,
                           rtol=1e-4 if path.startswith("v/") else 1e-5)
    assert int(dict(path_leaves(got[1][2]))["count"]) == PEAK_COUNT + 2


# -- a multi-pod mesh ------------------------------------------------------------

def test_deepseek_v3_steps_on_a_multi_pod_mesh(pool, host_devices):
    """(2, 1, 2) over ("pod", "data", "model"): the batch split over
    ("pod", "data"), the parameters' literal "data" leaving "pod"
    replicated (their gradients summed there), the experts' d_ff FSDP over
    "pod" and the tokens' EP group within a pod.  Not llama4-scout: from
    the step-1 state the reference reaches on this mesh, one of its top-1
    routing choices sits within float32 rounding of a tie, so the two
    packages' forwards from the same weights pick different experts
    (losses 6.76907 and 6.76466, on either mesh shape)."""
    check_lm_case("deepseek-v3-671b", (2, 1, 2), pool, host_devices)


# -- the launcher under torchrun -------------------------------------------------

def _torchrun(args, nproc=2, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
         *args], env=env, capture_output=True, text=True, timeout=timeout)


def _reference_count_line(arch, extra):
    """The first line the reference's ``--smoke --mesh debug`` launcher
    prints on 2 host devices (its parameter count)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro.launch.train as t\n"
         f"sys.argv = ['train', '--arch', '{arch}', *{extra!r}, '--smoke', "
         "'--mesh', 'debug', '--steps', '0']\n"
         "t.main()"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()[0]


@pytest.mark.parametrize("arch,extra", [("deepseek-7b", []),
                                        ("gatedgcn", ["--cell", "molecule"])])
def test_train_launcher_under_torchrun(arch, extra, capsys):
    args = ["--arch", arch, *extra, "--steps", "2", "--device", "cpu"]
    out = _torchrun(args + ["--mesh", "debug"])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    t_train.main(args)
    plain = capsys.readouterr().out.splitlines()
    assert lines == plain, (lines, plain)
    assert lines[0] == _reference_count_line(arch, extra)
    assert re.match(r"loss: first=[\d.]+ last=[\d.]+ \(2 steps", lines[-1])


def test_train_launcher_mesh_refusals():
    out = _torchrun(["--arch", "deepseek-7b", "--mesh", "single-pod",
                     "--device", "cpu", "--steps", "1"])
    assert out.returncode != 0
    assert "needs 256 devices" in out.stderr and "the world has 2" in \
        out.stderr
