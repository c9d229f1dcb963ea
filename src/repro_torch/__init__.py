"""PyTorch/CUDA port of ``repro`` (b-bit minwise hashing in practice).

The package mirrors ``repro``'s layout module by module.  It imports
``torch`` and numpy only -- never ``jax`` and nothing of ``repro`` -- so it
runs on a machine that has neither.  Every entry point runs on ``cuda``
unless the caller passes ``device="cpu"``; there the kernels' plain
PyTorch versions run in their place (``repro_torch.device``).

The hand-written Hopper kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``repro_torch.kernels.build``); importing any module
of this package builds nothing.
"""
