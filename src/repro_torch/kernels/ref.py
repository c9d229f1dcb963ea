"""Plain PyTorch versions of every ported kernel, in one place (the
counterpart of ``repro.kernels.ref``).  Each is defined beside its kernel;
the tests and ``chip_smoke.py`` hold the kernels against these."""

from repro_torch.kernels.hamming import packed_match_plain
from repro_torch.kernels.minhash import minhash2u_plain, minhash4u_plain
from repro_torch.kernels.oph import oph2u_plain, oph4u_plain
from repro_torch.kernels.pack import pack_block
from repro_torch.kernels.sigbag import sigbag_plain

__all__ = ["minhash2u_plain", "minhash4u_plain", "oph2u_plain",
           "oph4u_plain", "pack_block", "packed_match_plain",
           "sigbag_plain"]
