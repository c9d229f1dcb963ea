"""The LM family's configs, cells and entry points in the port against the
reference's constants: config copies, ``input_specs`` of every LM cell,
``is_skipped``, published parameter counts from ``count_params`` on the
meta device, the parameter tree's shapes, ``build_cell`` / ``init_inputs``
/ the decode step's cache write (as ``tests/test_archs.py``), what
``build_cell`` refuses, and ``launch/serve.py --arch`` against the
reference's line format.  Counts and shapes are exact.
"""

import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import cells_for as j_cells_for
from repro.configs import get_arch as j_get_arch
from repro.configs import input_specs as j_input_specs
from repro.configs import is_skipped as j_is_skipped
from repro.launch import serve as j_serve
from repro.models import transformer as j_tfm
from repro_torch.configs import (all_archs, cells_for, get_arch, input_specs,
                                 is_skipped)
from repro_torch.launch import serve
from repro_torch.launch.steps import build_cell, init_inputs
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
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_copies(arch):
    j_spec, t_spec = j_get_arch(arch), get_arch(arch)
    assert (t_spec.family, t_spec.source, t_spec.skip_cells) == (
        j_spec.family, j_spec.source, j_spec.skip_cells)
    for j_cfg, t_cfg in ((j_spec.config, t_spec.config),
                         (j_spec.smoke, t_spec.smoke)):
        want = dataclasses.asdict(j_cfg)
        got = dataclasses.asdict(t_cfg)
        assert got.pop("param_dtype") == DTYPES[want.pop("param_dtype")]
        assert got == want


def test_lm_cells_and_skips():
    lm = sorted(a for a, s in all_archs().items() if s.family == "lm")
    assert lm == sorted(LM_ARCHS)
    for arch in LM_ARCHS:
        assert ([dataclasses.astuple(c) for c in cells_for(arch)]
                == [dataclasses.astuple(c) for c in j_cells_for(arch)])
        for cell in cells_for(arch):
            assert is_skipped(arch, cell.name) == j_is_skipped(arch, cell.name)
    skipped = sorted((a, c.name) for a in LM_ARCHS for c in cells_for(a)
                     if is_skipped(a, c.name))
    assert skipped == [("deepseek-7b", "long_500k"),
                       ("deepseek-v3-671b", "long_500k"),
                       ("mistral-large-123b", "long_500k"),
                       ("yi-34b", "long_500k")]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_match_reference(arch, smoke):
    for cell in j_cells_for(arch):
        want = j_input_specs(arch, cell.name, smoke)
        got = input_specs(arch, cell.name, smoke)
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            if key == "cache":
                w, g = _jax_paths(spec), _dict_leaves(got["cache"])
                assert sorted(g) == sorted(w)
                for path, leaf in w.items():
                    assert g[path].shape == leaf.shape, path
                    assert g[path].dtype == DTYPES[leaf.dtype.type], path
                continue
            assert got[key].shape == tuple(spec.shape), (cell.name, key)
            assert got[key].dtype == DTYPES.get(spec.dtype.type, torch.int32)


def _dict_leaves(tree, prefix=""):
    """{path: leaf} of nested dicts (an ``InputSpec`` is a leaf)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key, value in tree.items():
        out.update(_dict_leaves(value, f"{prefix}/{key}" if prefix else key))
    return out


def test_param_counts_match_published_and_reference():
    """As tests/test_archs.py, on the meta device: nothing allocated."""
    expect = {"deepseek-7b": (6.9e9, 0.1), "yi-34b": (34.4e9, 0.1),
              "mistral-large-123b": (122.6e9, 0.1),
              "deepseek-v3-671b": (671e9, 0.02),
              "llama4-scout-17b-a16e": (108e9, 0.1)}
    for arch, (n, tol) in expect.items():
        cfg = get_arch(arch).config
        got = t_tfm.count_params(cfg)
        assert abs(got - n) / n < tol, (arch, got, n)
        assert got == j_tfm.count_params(j_get_arch(arch).config)
        assert t_tfm.count_active_params(cfg) == j_tfm.count_active_params(
            j_get_arch(arch).config)
    active = t_tfm.count_active_params(get_arch("deepseek-v3-671b").config)
    assert abs(active - 37e9) / 37e9 < 0.1, active
    shapes = t_tfm.param_shapes(get_arch("deepseek-v3-671b").config)
    assert all(t.device.type == "meta" for _, t in path_leaves(shapes))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_tree_matches_reference(arch):
    want = _jax_paths(j_tfm.param_shapes(j_get_arch(arch).config))
    got = dict(path_leaves(t_tfm.param_shapes(get_arch(arch).config)))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].dtype == DTYPES[leaf.dtype.type], path


def test_build_cell_and_init_inputs():
    for arch in LM_ARCHS:
        for cell in cells_for(arch):
            if is_skipped(arch, cell.name):
                with pytest.raises(ValueError, match="skips"):
                    build_cell(arch, cell.name, smoke=True, device="cpu")
            elif cell.kind == "lm_train":
                prog = build_cell(arch, cell.name, smoke=True, device="cpu")
                assert (prog.kind, prog.family) == ("lm_train", "lm")
                assert prog.optimizer is not None
            else:
                prog = build_cell(arch, cell.name, smoke=True, device="cpu")
                assert (prog.kind, prog.family) == (cell.kind, "lm")
    prog = build_cell("llama4-scout-17b-a16e", "long_500k", smoke=True,
                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = prog.init_params(gen)
    inputs = init_inputs(prog, gen)
    cfg = prog.config
    assert inputs["tokens"].shape == (2,) and inputs["tokens"].dtype == \
        torch.int32
    assert 0 <= int(inputs["tokens"].min()) and \
        int(inputs["tokens"].max()) < cfg.vocab
    assert int(inputs["pos"]) == 2 and inputs["pos"].dtype == torch.int32
    specs = _dict_leaves(prog.input_specs["cache"])
    for path, leaf in path_leaves(inputs["cache"]):
        assert tuple(leaf.shape) == specs[path].shape
        assert leaf.dtype == specs[path].dtype and not leaf.any()
    nxt, cache = prog.step(model, inputs)
    assert nxt.shape == (2,) and cache is inputs["cache"]
    prefill = build_cell("deepseek-v3-671b", "prefill_32k", smoke=True,
                         device="cpu")
    h = prefill.step(prefill.init_params(gen), init_inputs(prefill, gen))
    assert h.shape == (2, 64, 64) and bool(torch.isfinite(h).all())


@pytest.mark.parametrize("arch", ["yi-34b", "deepseek-v3-671b"])
def test_decode_cache_is_updated(arch):
    """As tests/test_archs.py: the step writes K/V (MLA: c_kv and k_rope)
    at pos - 1 == 1 only, in every layer."""
    prog = build_cell(arch, "decode_32k", smoke=True, device="cpu")
    gen = torch.Generator().manual_seed(1)
    model = prog.init_params(gen)
    inputs = init_inputs(prog, gen)
    before = {p: t.clone() for p, t in path_leaves(inputs["cache"])}
    toks, new_cache = prog.step(model, inputs)
    assert toks.shape == inputs["tokens"].shape
    for path, after in path_leaves(new_cache):
        diff = (before[path] != after).flatten(3).any(-1).any(1)  # (n, L)
        assert bool(diff[:, 1].all()), path
        assert not bool(diff[:, 2:].any()) and not bool(diff[:, 0].any())


def test_serve_lm_line_matches_reference(capsys, monkeypatch):
    pattern = (r"decoded 16 tokens x batch 2 in \d+\.\d\ds \(\d+\.\d tok/s\);"
               r" first sequence: \[(\d+, ){7}\d+\]")
    serve.main(["--arch", "yi-34b", "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "yi-34b"])
    j_serve.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(pattern, want), want
    assert re.fullmatch(pattern, got), got
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gatedgcn", "--device", "cpu"])
    assert "the GNN family has no serving cell" in capsys.readouterr().err
