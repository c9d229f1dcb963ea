"""Port parity for the model-FLOP counts (``repro_torch.roofline.analysis``)
against ``repro.roofline.analysis``: ``model_flops_for`` on every arch x
cell, smoke and published, exactly (the same formulas on the same
integers, the GNN undercount included), and the H100 constants of
``roofline/hardware.py``."""

import types

import pytest

from repro.configs import all_archs as j_all_archs
from repro.configs import cells_for as j_cells_for
from repro.launch import steps as j_steps
from repro.roofline import analysis as j_analysis
from repro_torch.configs import (config_for_cell, get_arch, get_cell,
                                 input_specs, is_skipped)
from repro_torch.launch.steps import build_cell
from repro_torch.roofline import analysis, hardware

ARCHS = sorted(j_all_archs())


def _program(arch, cell, smoke):
    """The port's ``CellProgram``, or for a cell the arch skips (which
    ``build_cell`` refuses) the parts of one ``model_flops_for`` reads."""
    if not is_skipped(arch, cell):
        return build_cell(arch, cell, smoke=smoke, device="cpu")
    c = get_cell(arch, cell)
    return types.SimpleNamespace(
        config=config_for_cell(arch, c, smoke), family=get_arch(arch).family,
        kind=c.kind, input_specs=input_specs(arch, cell, smoke))


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_matches_reference(arch, smoke):
    cells = [c.name for c in j_cells_for(arch)]
    assert len(cells) == 4
    for cell in cells:
        want = j_analysis.model_flops_for(
            j_steps.build_cell(arch, cell, smoke=smoke), smoke)
        got = analysis.model_flops_for(_program(arch, cell, smoke), smoke)
        assert got == want and want > 0, (arch, cell)


def test_gnn_model_flops_undercounts_the_edge_products():
    """The reference's count for ogb_products, and the layer's own
    products (four d x d on the E edge rows, one on the N node rows):
    (4E + N) / 5N, ~20x the reference's 5 N d^2 at a mean degree of
    25.3."""
    prog = build_cell("gatedgcn", "ogb_products", device="cpu")
    cfg = prog.config
    N = prog.input_specs["node_feats"].shape[0]
    E = prog.input_specs["edge_index"].shape[1]
    want = j_analysis.gnn_model_flops(cfg, N, E)
    assert analysis.gnn_model_flops(cfg, N, E) == want
    layer_products = 3 * cfg.n_layers * 2 * cfg.d_hidden ** 2 * (4 * E + N)
    assert 20 < layer_products / (3 * cfg.n_layers * 2 * 5 * N
                                  * cfg.d_hidden ** 2) < 21
    assert analysis.gnn_model_flops(cfg, N, E, training=False) == want / 3


def test_h100_constants():
    assert hardware.HBM_BW == 3.35e12
    assert hardware.PEAK_FLOPS_BF16 == 989e12
    assert hardware.PEAK_FLOPS_F32 == 67e12
    assert hardware.HBM_BYTES == 80e9
    # the reference's TPU constants are not carried over
    assert hardware.PEAK_FLOPS_BF16 != 197e12
