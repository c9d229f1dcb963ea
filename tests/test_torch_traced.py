"""The dry run's traced step (``repro_torch.roofline.traced``,
``launch.dryrun.trace_counts`` / ``trace_cell``, ``launch.mesh.fake_world``)
and the LM serving steps on a process mesh (``transformer.serve_step`` /
``forward`` given a shard context, ``launch.steps._mesh_lm_serve``):

  * collectives: a smoke step traced on rank 0 of a fake (2, 2) world ==
    the same ``StepTrace`` on rank 0 of a real gloo world of 4, by kind,
    count and bytes (an LM, a GatedGCN and a recsys train step with the
    frontend on, LM prefill and decode);
  * FLOPs: a traced unmeshed smoke step == ``FlopCounterMode`` on the
    real CPU step; on a fake (2, 2) world a prefill's rank 0 does a
    quarter of them;
  * the peak: traced on meta tensors == the same tracker on real CPU
    tensors, to the byte; a hand-written two-layer MLP step's temp == its
    hand count;
  * meshed prefill and decode on gloo worlds of 2 and 4 == the unmeshed
    port and == the reference's jitted ``forward`` / ``serve_step`` on a
    ``jax.sharding.Mesh`` of the same shape over forced host devices,
    within rtol 1e-5 and an atol of 1e-5 of each output's largest
    magnitude (float32), next tokens equal, the cache written at pos - 1
    only: an MHA arch, MLA with MoE (nothing dropped), llama4-scout's
    windowed layers;
  * the kernels' operators on meta and fake tensors: the results' shapes,
    no library, no launch, their operands and results counted;
  * every ok record of ``run_all`` carries an integer ``temp_bytes`` and
    a float ``compile_s``, counted in the total.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as j_steps
from repro.models import transformer as j_tfm
from repro.sharding import rules as j_rules
from repro.sharding.rules import set_mesh as j_set_mesh
from repro_torch.configs import all_archs, cells_for
from repro_torch.convert import (lm_params_from_jax, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.kernels import build
from repro_torch.kernels import minhash as kmin
from repro_torch.kernels import oph as koph
from repro_torch.kernels import sigbag as ksig
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_cell, init_inputs
from repro_torch.roofline import traced
from repro_torch.roofline.analytic import estimate
from repro_torch.tree import tree_leaves
from test_torch_mesh_train import _capacity, _jmesh
from torch_spawn import RankPool

ROOT = Path(__file__).resolve().parents[1]
SQUARE = (2, 2)
AXES = ("data", "model")
NO_DROP = 16.0          # an MoE capacity factor at which nothing drops
POS = 37                # decode: the new token at 36, in chunk 2 of 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool4():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool2():
    p = RankPool(2)
    yield p
    p.close()


def _fake_counts(arch, cell, shape=SQUARE):
    return dryrun._trace_here(arch, cell, True, shape, AXES)


# -- collectives -------------------------------------------------------------

@pytest.mark.parametrize("arch,cell", [
    ("deepseek-7b", "train_4k"), ("gatedgcn", "full_graph_sm"),
    ("autoint", "train_batch"), ("deepseek-7b", "prefill_32k"),
    ("deepseek-v3-671b", "decode_32k")])
def test_fake_world_collectives_equal_a_gloo_world(arch, cell, pool4):
    got = _fake_counts(arch, cell)
    want = pool4.run("mesh_checks:traced_collectives", SQUARE, arch, cell)
    assert got.breakdown() == want[0]
    assert got.coll_counts and all(n > 0 for n in got.coll_counts.values())
    assert set(got.coll_bytes) <= set(traced.KINDS)
    assert not torch.distributed.is_initialized()


# -- FLOPs -------------------------------------------------------------------

def _meta_args(prog):
    """(model, args) of an unmeshed step on meta tensors."""
    params = prog.param_shapes()
    inputs = dryrun._meta(prog.input_specs)
    model = dryrun._traced_model(prog)
    if prog.optimizer is not None:
        return model, (params, prog.optimizer.init(params), inputs)
    return model, (params, inputs)


def _real_args(prog, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = prog.init_params(gen)
    inputs = init_inputs(prog, gen)
    params = model.params()
    shell = model.without_weights() if prog.family == "recsys" else model
    if prog.optimizer is not None:
        return shell, (params, prog.optimizer.init(params), inputs)
    return shell, (params, inputs)


FLOP_CELLS = [("deepseek-7b", "train_4k"), ("deepseek-v3-671b", "prefill_32k"),
              ("llama4-scout-17b-a16e", "decode_32k"),
              ("gatedgcn", "molecule"), ("din", "train_batch"),
              ("autoint", "serve_p99")]


@pytest.mark.parametrize("arch,cell", FLOP_CELLS)
def test_traced_flops_equal_flop_counter(arch, cell):
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    model, args = _meta_args(prog)
    _, counts = traced.trace_step(lambda *a: prog.step(model, *a), args)
    shell, real = _real_args(prog)
    with FlopCounterMode(display=False) as fc:
        prog.step(shell, *real)
    assert counts.flops == fc.get_total_flops() > 0


def test_a_rank_of_four_does_a_quarter_of_a_prefill():
    """deepseek-7b's smoke prefill on (2, 2): rows over "data", heads and
    d_ff over "model", every split even."""
    prog = build_cell("deepseek-7b", "prefill_32k", smoke=True, device="cpu")
    model, args = _meta_args(prog)
    _, whole = traced.trace_step(lambda *a: prog.step(model, *a), args)
    got = _fake_counts("deepseek-7b", "prefill_32k")
    assert got.flops * 4 == whole.flops


# -- the peak ----------------------------------------------------------------

@pytest.mark.parametrize("arch,cell", [
    ("deepseek-7b", "train_4k"), ("deepseek-7b", "decode_32k"),
    ("din", "train_batch"), ("gatedgcn", "full_graph_sm"),
    ("mind", "serve_p99")])
def test_meta_peak_equals_real_peak(arch, cell):
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    model, args = _meta_args(prog)
    _, meta = traced.trace_step(lambda *a: prog.step(model, *a), args)
    shell, real = _real_args(prog)
    extra = list(shell.buffers()) if prog.family == "recsys" else []
    _, got = traced.trace_step(lambda *a: prog.step(shell, *a), real, extra)
    for f in ("args_bytes", "output_bytes", "alias_bytes", "peak_bytes"):
        assert getattr(meta, f) == getattr(got, f), f
    assert meta.temp_bytes == got.temp_bytes > 0


def test_mlp_step_temp_is_the_hand_count():
    """A two-layer MLP step written out (forward, backward, an in-place
    SGD update): its temp counted by hand, every tensor a multiple of
    512 B.  x (128, 64), w1 (64, 32), w2 (32, 8), y (128, 8) float32."""
    B, D, H, O = 128, 64, 32, 8
    f = 4

    def step(w1, w2, x, y):
        h = x @ w1                         # B*H
        r = h.relu()                       # B*H
        o = r @ w2                         # B*O
        g_o = (o - y) * (2.0 / (B * O))    # B*O twice (o - y dies)
        loss = ((o - y) ** 2).mean()       # B*O twice, then 4 B
        del o
        gw2 = r.t() @ g_o                  # H*O
        g_r = g_o @ w2.t()                 # B*H
        del r, g_o
        g_h = g_r * (h > 0)                # bool B*H, then B*H
        del g_r, h
        gw1 = x.t() @ g_h                  # D*H
        del g_h
        w1.sub_(gw1 * 0.1)                 # D*H
        w2.sub_(gw2 * 0.1)
        return w1, w2, loss

    args = tuple(torch.empty(s, device="meta") for s in
                 ((D, H), (H, O), (B, D), (B, O)))
    _, c = traced.trace_step(step, args)
    weights = (D * H + H * O) * f
    # the largest moment, reached twice: h, r, g_o, the loss (4 B in a
    # 512 B block), gw2 and g_r; later h, the loss, gw2, g_r, g_r's bool
    # mask and g_h.  The forward's h, r, o, g_o, o - y and its square stay
    # below it.
    peak = 2 * B * H * f + B * O * f + 512 + H * O * f + B * H * f
    assert peak == 3 * B * H * f + 512 + H * O * f + B * H
    assert peak > 2 * B * H * f + 4 * B * O * f
    assert c.args_bytes == weights + (B * D + B * O) * f
    assert c.output_bytes == weights + 512 and c.alias_bytes == weights
    assert c.peak_bytes == c.args_bytes + peak
    assert c.temp_bytes == peak - 512


# -- meshed serving ----------------------------------------------------------

SERVE_ARCHS = ("deepseek-7b", "deepseek-v3-671b", "llama4-scout-17b-a16e")


@functools.lru_cache(maxsize=None)
def _serve_start(arch, cell):
    """The reference's smoke weights (float32) and the cell's inputs:
    tokens, and for decode a random cache, ``pos`` = ``POS``."""
    cfg = _capacity(j_get_arch(arch).smoke, NO_DROP)
    params = tree_to_numpy(jax.device_get(jax.jit(functools.partial(
        j_tfm.init_params, cfg))(jax.random.PRNGKey(0))))
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    rng = np.random.default_rng(3)
    specs = prog.input_specs
    if cell == "prefill_32k":
        inputs = {"tokens": rng.integers(0, cfg.vocab, specs["tokens"].shape
                                         ).astype(np.int32)}
    else:
        cache = {k: {n: rng.standard_normal(leaf.shape).astype(np.float32)
                     for n, leaf in stack.items()}
                 for k, stack in specs["cache"].items()}
        inputs = {"cache": cache,
                  "tokens": rng.integers(0, cfg.vocab, specs["tokens"].shape
                                         ).astype(np.int32),
                  "pos": np.int32(POS)}
    return cfg, params, inputs


def _unmeshed(arch, cell):
    cfg, params, inputs = _serve_start(arch, cell)
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    prog.config = _capacity(prog.config, NO_DROP)
    model = lm_params_from_jax(params, prog.config, "cpu")
    out = prog.step(model, tree_from_numpy(inputs, "cpu"))
    return tree_to_numpy(out)


def _reference(arch, cell, jmesh):
    """The reference's jitted step under ``set_mesh(jmesh)`` (its
    ``constrain`` points and the EP MoE's ``shard_map`` shard it), the
    inputs placed by the cell's specs (whole where the mesh does not
    divide them)."""
    cfg, params, inputs = _serve_start(arch, cell)
    prog = j_steps.build_cell(arch, cell, smoke=True)
    with j_set_mesh(jmesh):
        def place(v, spec):
            if isinstance(v, dict):
                return {k: place(v[k], spec[k]) for k in v}
            where = j_rules.named_sharding(*spec)
            try:
                where.shard_shape(np.shape(v))
            except ValueError:
                where = JNamed(jmesh, JP())
            return jax.device_put(v, where)

        p = jax.tree_util.tree_map(jnp.asarray, params)
        x = place(inputs, prog.input_specs_tree)
        if cell == "prefill_32k":
            out = jax.jit(functools.partial(j_tfm.forward, cfg=cfg))(
                p, x["tokens"])
        else:
            out = jax.jit(functools.partial(j_tfm.serve_step, cfg=cfg))(
                p, x["cache"], x["tokens"], x["pos"])
        return tree_to_numpy(jax.device_get(out))


def _close(got, want, what, atol=1e-5):
    """rtol 1e-5 and an atol of ``atol`` of the leaf's largest magnitude:
    a row-parallel psum adds its partial sums in another order, and XLA
    sums in its own (the unmeshed port holds its hidden states to the
    reference's within 1e-4, ``test_torch_lm_model.py``)."""
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        scale = max(1.0, float(np.max(np.abs(b))))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol * scale,
                                   err_msg=what)


@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_serving_matches_unmeshed_and_reference(arch, cell, pool2,
                                                       pool4, host_devices):
    _, params, inputs = _serve_start(arch, cell)
    want = _unmeshed(arch, cell)
    for shape, pool in (((1, 2), pool2), ((2, 2), pool4), ((1, 4), pool4)):
        got = pool.run("mesh_checks:lm_serving", shape, arch, cell, NO_DROP,
                       params, inputs)[0]
        ref = _reference(arch, cell, _jmesh(shape, host_devices))
        if cell == "decode_32k":
            np.testing.assert_array_equal(got[0], want[0], err_msg=str(shape))
            np.testing.assert_array_equal(got[0], ref[0], err_msg=str(shape))
            # the cache: written at POS - 1 only, on the rank holding it
            for a, b in zip(tree_leaves(got[1]), tree_leaves(inputs["cache"])):
                diff = np.any(a != b, axis=tuple(i for i in range(a.ndim)
                                                if i != 2))
                assert np.flatnonzero(diff).tolist() == [POS - 1]
        _close(got, want, f"unmeshed {shape}")
        _close(got, ref, f"reference {shape}")


# -- the kernels' operators on shapes alone ----------------------------------

@pytest.fixture
def no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded the {name} library")

    monkeypatch.setattr(build, "library", refuse)


def _frontend_operands(n=16, nnz=24, k=64, two_b=256, d=8):
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 1 << 20, (n, nnz)).astype(np.int32))
    cnt = torch.from_numpy(rng.integers(1, nnz, n).astype(np.int32))
    a = torch.from_numpy(rng.integers(0, 2**31, k).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, two_b, (n, k)).astype(np.int32))
    table = torch.randn(k, two_b, d)
    return idx, cnt, a, tok, table


@pytest.mark.parametrize("kind", ["meta", "fake"])
def test_kernel_ops_on_meta_and_fake_tensors(kind, no_library):
    from torch._subclasses.fake_tensor import FakeTensorMode
    idx, cnt, a, tok, table = _frontend_operands()
    want_sig = kmin.minhash2u_plain(idx, cnt, a, a | 1, s=24, b=8)
    want_bag = ksig.sigbag_plain(tok, table)
    before = (kmin.minhash2u_cuda.launches, ksig.sigbag_cuda.launches)
    if kind == "meta":
        mode = traced.StepTrace()
        ins = [t.to("meta") for t in (idx, cnt, a, tok, table)]
    else:                    # torch's fake CUDA tensors
        mode = FakeTensorMode()
        with mode:
            ins = [torch.empty(t.shape, dtype=t.dtype, device="cuda")
                   for t in (idx, cnt, a, tok, table)]
    i, c, aa, tk, tb = ins
    with mode:
        sig = kmin.minhash2u_cuda(i, c, aa, aa, s=24, b=8)
        bag = ksig.sigbag_cuda(tk, tb)
        via = ksig.sigbag(tk, tb) if kind == "meta" else bag
    for got, want in ((sig, want_sig), (bag, want_bag), (via, want_bag)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.device.type == ("meta" if kind == "meta" else "cuda")
    assert (kmin.minhash2u_cuda.launches, ksig.sigbag_cuda.launches) == before
    if kind == "meta":       # three operations: operands + results
        nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        assert mode.ops == 3
        assert mode.bytes_accessed == (nb(idx, cnt, a, a, want_sig)
                                       + 2 * nb(tok, table, want_bag))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksig.sigbag_cuda(tok, table)


def _kernel_calls(idx, cnt, a, tok, table):
    """name -> (wrapper, plain version, arguments, keywords) of each of
    the five kernel operators, and of ``minhash4u`` packing a ragged
    k = 50 (ceil(50 * 4 / 32) = 7 words a row)."""
    a4 = torch.stack([a, a | 1, a ^ 5, a + 7])
    return {
        "minhash2u": (kmin.minhash2u_cuda, kmin.minhash2u_plain,
                      (idx, cnt, a, a | 1), dict(s=24, b=8, pack=True)),
        "minhash4u": (kmin.minhash4u_cuda, kmin.minhash4u_plain,
                      (idx, cnt, a4), dict(s=24, b=4)),
        "minhash4u-ragged-pack": (kmin.minhash4u_cuda, kmin.minhash4u_plain,
                                  (idx, cnt, a4[:, :50].contiguous()),
                                  dict(s=24, b=4, pack=True)),
        "oph2u": (koph.oph2u_cuda, koph.oph2u_plain,
                  (idx, cnt, a[:1], a[1:2] | 1), dict(s=24, bin_bits=5)),
        "oph4u": (koph.oph4u_cuda, koph.oph4u_plain,
                  (idx, cnt, a4[:, :1].contiguous()),
                  dict(s=24, bin_bits=5, code_b=8)),
        "sigbag": (ksig.sigbag_cuda, ksig.sigbag_plain, (tok, table),
                   dict(row0=3)),
    }


@pytest.mark.parametrize("name", ["minhash2u", "minhash4u", "oph2u",
                                  "oph4u", "sigbag", "minhash4u-ragged-pack"])
def test_each_kernel_op_on_meta_tensors(name, no_library):
    """One operation under a ``StepTrace``: the plain version's shapes
    and types, its operands and results counted, no launch."""
    wrapper, plain, args, kw = _kernel_calls(*_frontend_operands())[name]
    want = plain(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    meta = [t.to("meta") for t in args]
    before = wrapper.launches
    with traced.StepTrace() as mode:
        got = wrapper(*meta, **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                  for t in want]
    assert all(t.is_meta for t in got) and wrapper.launches == before
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    assert mode.ops == 1 and mode.bytes_accessed == nb(args) + nb(want)


# -- the dry run's records ---------------------------------------------------

def test_run_all_records_carry_the_traced_temp():
    cells = [(a, c.name) for a in sorted(all_archs()) for c in cells_for(a)]
    recs = list(dryrun.run_all(cells, [False, True], smoke=True))
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 72 and all(r["status"] in ("ok", "skipped")
                                 for r in recs)
    for r in ok:
        m = r["memory"]
        assert isinstance(m["temp_bytes"], int) and m["temp_bytes"] >= 0
        assert isinstance(r["compile_s"], float)
        assert m["total_per_chip_bytes"] == (m["args_bytes"]
                                             + m["output_bytes"]
                                             - m["alias_bytes"]
                                             + m["temp_bytes"])
        b = r["cost"]["collective_breakdown"]
        assert b["raw_hlo"] is not None and "_counts" in \
            b["parsed_hlo_once_per_loop"]
        assert r["cost"]["hlo_flops_per_chip"] == max(
            b["raw_hlo"]["flops_per_chip"],
            estimate(build_cell(r["arch"], r["cell"], smoke=True,
                                       device="cpu"),
                            dryrun.production_mesh(r["chips"] == 512)
                            )["flops"])
    assert not torch.distributed.is_initialized()


def test_a_caller_with_a_process_group_keeps_it():
    """``trace_cell`` in a process that has joined a group traces in a
    child process; the caller's group is the one it had."""
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import abstract_mesh\n"
        "dist.init_process_group('gloo', store=dist.HashStore(), rank=0,"
        " world_size=1)\n"
        "g = dist.group.WORLD\n"
        "c = dryrun.trace_cell('din', 'serve_p99',"
        " abstract_mesh((2, 2)), smoke=True)\n"
        "assert dist.is_initialized() and dist.group.WORLD is g\n"
        "assert dist.get_backend() == 'gloo' and dist.get_world_size() == 1\n"
        "assert c.coll_counts == {'all-reduce': 2}, c.coll_counts\n"
        "print('kept', c.temp_bytes >= 0)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith("kept True")
