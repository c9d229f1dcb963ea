"""The signature and retrieval kernels (port of ``repro.kernels``).

  oph.py      -- One Permutation Hashing bin minima: CUDA kernels
                 (csrc/oph.cu) + plain versions.
  minhash.py  -- 2U / 4U minwise-hash kernels with the fused b-bit mask and
                 pack epilogue (csrc/minhash.cu) + plain versions.
  hamming.py  -- packed-signature match counts for retrieval
                 (csrc/hamming.cu) + plain version.
  sigbag.py   -- the Eq. (5) signature embedding-bag of the recsys
                 frontend (csrc/sigbag.cu) + plain version.
  pack.py     -- the packed b-bit wire format.
  engine.py   -- SignaturePlan / SignatureEngine, backends, PackedSignatures,
                 the TuningTable of launch shapes and tune().
  build.py    -- nvcc build of csrc/*.cu and ctypes loading.
  ref.py      -- the plain versions in one place.

Importing this package builds nothing; a kernel is built at its first
launch (or by ``build.build_all``).
"""

from repro_torch.kernels.engine import (BACKENDS, Backend, PackedSignatures,
                                        SignatureEngine, SignaturePlan,
                                        TuningTable, backend_for,
                                        batch_signatures,
                                        default_tuning_table, tune)
from repro_torch.kernels.pack import PackSpec

__all__ = ["BACKENDS", "Backend", "PackSpec", "PackedSignatures",
           "SignatureEngine", "SignaturePlan", "TuningTable", "backend_for",
           "batch_signatures", "default_tuning_table", "tune"]
