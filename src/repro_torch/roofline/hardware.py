"""NVIDIA H100 constants for the roofline model.

Published H100 SXM rates (NVIDIA data sheet, dense rates without
sparsity, full 700 W power limit), the constants ``chip_smoke.py`` bounds
its kernels and steps with.  A card set below 700 W (``nvidia-smi
--query-gpu=power.limit``) runs slower under load; pass ``bw=`` to
re-anchor.

Links.  Eight H100 SXM cards share a node over NVLink 4 (900 GB/s
bidirectional a card, ``NVLINK_BW`` each way); nodes talk over one
400 Gb/s NDR InfiniBand port a card (DGX H100 data sheet, ``NET_BW``).
A mesh of more than ``NODE_GPUS`` ranks crosses nodes -- both production
meshes do, 256 and 512 ranks on 32 and 64 nodes -- so its collective term
divides by ``NET_BW``; a mesh of 2 to 8 ranks divides by ``NVLINK_BW``;
a mesh of one rank crosses no link at all (``link_for``).
"""

from typing import Optional, Tuple

HBM_BW = 3.35e12                # bytes/s, H100 SXM HBM3
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bfloat16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 FMA on the CUDA cores
                                # (TF32 off: no tensor core)
HBM_BYTES = 80e9                # bytes of HBM3
NVLINK_BW = 450e9               # bytes/s a card, each way (NVLink 4)
NET_BW = 50e9                   # bytes/s a card (400 Gb/s NDR InfiniBand)
NODE_GPUS = 8                   # cards on one NVLink domain


def link_for(ranks: int) -> Tuple[str, Optional[float]]:
    """(name, bytes/s) of the link a mesh of ``ranks`` ranks crosses:
    ``("net", NET_BW)`` past one node, ``("nvlink", NVLINK_BW)`` within
    one, ``("none", None)`` for a single rank."""
    if ranks > NODE_GPUS:
        return "net", NET_BW
    if ranks > 1:
        return "nvlink", NVLINK_BW
    return "none", None
