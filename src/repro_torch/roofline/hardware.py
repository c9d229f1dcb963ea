"""NVIDIA H100 constants for the roofline model.

Published H100 SXM rate (NVIDIA data sheet, full 700 W power limit): HBM3
at 3.35 TB/s, the constant ``chip_smoke.py`` bounds its kernels with.  A
card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs slower
under load; pass ``bw=`` to re-anchor.
"""

HBM_BW = 3.35e12                # bytes/s, H100 SXM HBM3
