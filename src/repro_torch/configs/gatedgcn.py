"""gatedgcn: 16-layer GatedGCN, d_hidden=70 [arXiv:2003.00982].

d_in / n_classes / readout are per-shape-cell (cora-, reddit-,
ogbn-products- and molecule-scale); see configs/base.py GNN_CELLS.
"""

import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    arch_id="gatedgcn", n_layers=16, d_hidden=70, d_in=100, n_classes=47,
    aggregator="gated", param_dtype=torch.float32, remat=True)

SMOKE = GNNConfig(
    arch_id="gatedgcn-smoke", n_layers=2, d_hidden=16, d_in=16, n_classes=4,
    aggregator="gated", param_dtype=torch.float32)

register(ArchSpec(arch_id="gatedgcn", family="gnn", config=CONFIG,
                  smoke=SMOKE, source="arXiv:2003.00982; paper"))
