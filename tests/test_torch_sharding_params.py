"""Port parity for the sharding specs of training on a mesh
(``repro_torch.sharding.params``, ``launch.steps.CellProgram``'s
``param_specs`` / ``opt_specs`` / ``input_specs_tree`` / ``arg_specs``,
``models.moe.ep_layout``) against ``repro.sharding.params`` and
``repro.launch.steps``:

  * every arch's parameter spec tree, at its published config and at
    smoke, leaf for leaf (path and spec) -- the reference's shapes from
    ``jax.eval_shape``, the port's from the meta device;
  * the optimizer-state spec tree under the optimizer ``_pick_optimizer``
    picks (AdamW, momentum Adafactor, momentum-free Adafactor and the
    E % 256 expert branch among them);
  * every cell's input spec tree;
  * ``ep_layout`` on the reference's cases.

Specs compare as tuples: a one-axis tuple is stored as the axis name in
both packages.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.launch import steps as j_steps
from repro.models import moe as j_moe
from repro_torch.configs import all_archs, cells_for, is_skipped
from repro_torch.launch import steps as t_steps
from repro_torch.models import moe as t_moe
from repro_torch.tree import path_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every port test module runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = sorted(all_archs())
CELLS = [(a, c.name) for a in ARCHS for c in cells_for(a)
         if not is_skipped(a, c.name)]


def _key(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return str(p.idx)
    return str(p)


def _j_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return [("/".join(_key(k) for k in path), tuple(s)) for path, s in flat]


def _t_flat(specs):
    return [(path, tuple(s)) for path, s in path_leaves(specs)]


def _train_cell(arch):
    return next(c.name for c in cells_for(arch) if "train" in c.kind)


_PROGS = {}


def _progs(arch, cell, smoke):
    key = (arch, cell, smoke)
    if key not in _PROGS:
        _PROGS[key] = (j_steps.build_cell(arch, cell, smoke=smoke),
                       t_steps.build_cell(arch, cell, smoke=smoke,
                                          device="cpu"))
    return _PROGS[key]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, smoke):
    jp, tp = _progs(arch, _train_cell(arch), smoke)
    want, got = _j_flat(jp.param_specs), _t_flat(tp.param_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got == want
    shapes = dict(path_leaves(tp.param_shapes()))
    assert all(t.device.type == "meta" for t in shapes.values())


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_reference(arch, smoke):
    jp, tp = _progs(arch, _train_cell(arch), smoke)
    want, got = _j_flat(jp.opt_specs), _t_flat(tp.opt_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got == want
    assert tp.arg_specs()[1] is not None and len(tp.arg_specs()) == 3


def test_opt_state_specs_cover_every_optimizer_branch():
    """The published configs reach AdamW (deepseek-7b), momentum
    Adafactor (yi-34b), momentum-free Adafactor with 256 experts over
    ("model", "data") (deepseek-v3) and the recsys Adafactor."""
    seen = {}
    for arch in ("deepseek-7b", "yi-34b", "deepseek-v3-671b", "din"):
        _, tp = _progs(arch, _train_cell(arch), False)
        seen[arch] = sorted(tp.opt_shapes())
        specs = dict(_t_flat(tp.opt_specs))
        if arch == "deepseek-v3-671b":
            assert specs["v/layers/ffn/w_gate/vr"] == (
                None, ("model", "data"), None)
            assert specs["v/layers/ffn/w_gate/vc"] == (
                None, ("model", "data"), "pod")
    assert seen == {"deepseek-7b": ["count", "m", "v"],
                    "yi-34b": ["count", "m", "v"],
                    "deepseek-v3-671b": ["count", "v"],
                    "din": ["count", "v"]}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch,cell", CELLS)
def test_input_spec_trees_match_reference(arch, cell, smoke):
    jp, tp = _progs(arch, cell, smoke)
    want = _j_flat(jp.input_specs_tree)
    got = _t_flat(tp.input_specs_tree)
    assert got == want
    assert len(tp.arg_specs()) == (3 if tp.optimizer is not None else 2)


class _M:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"data": 1, "model": 4},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"data": 16, "model": 16}])
@pytest.mark.parametrize("E", [4, 8, 16, 256, 6])
def test_ep_layout_matches_reference(shape, E):
    assert t_moe.ep_layout(_M(shape), E) == j_moe.ep_layout(_M(shape), E)
