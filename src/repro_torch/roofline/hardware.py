"""NVIDIA H100 constants for the roofline model.

Published H100 SXM rates (NVIDIA data sheet, dense rates without
sparsity, full 700 W power limit), the constants ``chip_smoke.py`` bounds
its kernels and steps with.  A card set below 700 W (``nvidia-smi
--query-gpu=power.limit``) runs slower under load; pass ``bw=`` to
re-anchor.
"""

HBM_BW = 3.35e12                # bytes/s, H100 SXM HBM3
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bfloat16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 FMA on the CUDA cores
                                # (TF32 off: no tensor core)
HBM_BYTES = 80e9                # bytes of HBM3
