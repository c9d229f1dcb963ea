"""Raw mmap-able ``.sig`` signature-shard format (header + payload).

A copy of ``repro.data.sigshard`` (numpy only): both packages write the
same bytes, so a shard written by either loads in the other.  The
paper's accounting (§6, Table 2) is k*b bits per example; this format
stores exactly that plus a fixed 64-byte header and the float32 labels,
with the payload 64-byte aligned so it can be ``np.memmap``'d straight
off disk -- no zip/npz decode on the replay path.

Layout (little-endian):

    0   magic   b"RSIG"
    4   u32     version (1)
    8   u32     n            examples
    12  u32     k            values per example
    16  u32     b            b-bit width of genuine values
    20  u32     code_bits    b, or b+1 for sentinel schemes
    24  u32     words        uint32 words per example
    28  u32     flags        bit 0: sentinel (EMPTY coded as 2^b)
    32  ..64    reserved (zero)
    64  f32[n]  labels
    pad to 64-byte boundary
    u32[n * words]  row-major packed payload

Codes follow ``repro_torch.core.bbit.pack_codes``: value j occupies bits
[j*code_bits, (j+1)*code_bits) of its row's bitstream.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

MAGIC = b"RSIG"
VERSION = 1
HEADER_BYTES = 64
_ALIGN = 64
_FLAG_SENTINEL = 1


@dataclasses.dataclass(frozen=True)
class SigShardMeta:
    """Decoded ``.sig`` header."""

    n: int
    k: int
    b: int
    code_bits: int
    words: int
    sentinel: bool

    @property
    def payload_bytes(self) -> int:
        """Signature payload only -- the paper's wire accounting."""
        return 4 * self.n * self.words

    @property
    def payload_offset(self) -> int:
        labels_end = HEADER_BYTES + 4 * self.n
        return ((labels_end + _ALIGN - 1) // _ALIGN) * _ALIGN


def write_sig_shard(path: str, words: np.ndarray, labels: np.ndarray, *,
                    k: int, b: int, code_bits: int,
                    sentinel: bool = False) -> SigShardMeta:
    """Write one packed shard; ``words`` is (n, words_per_row) uint32.

    The write is atomic: bytes land in a same-directory temp file that is
    ``os.replace``'d over ``path`` only once complete, so a concurrent
    reader (or a TTL sweep in a shared ``SignatureCache`` dir) can never
    observe a truncated shard -- a crash mid-write leaves no ``path`` at
    all, and the temp file is unlinked on failure.
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    labels = np.ascontiguousarray(labels, dtype=np.float32)
    n, wpr = words.shape
    if labels.shape != (n,):
        raise ValueError(f"labels shape {labels.shape} != ({n},)")
    meta = SigShardMeta(n=n, k=k, b=b, code_bits=code_bits, words=wpr,
                        sentinel=sentinel)
    header = MAGIC + struct.pack(
        "<7I", VERSION, n, k, b, code_bits, wpr,
        _FLAG_SENTINEL if sentinel else 0)
    header = header.ljust(HEADER_BYTES, b"\0")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(labels.tobytes())
            f.write(b"\0" * (meta.payload_offset - HEADER_BYTES - 4 * n))
            f.write(words.tobytes())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return meta


def read_sig_meta(path: str) -> SigShardMeta:
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if len(head) < HEADER_BYTES or head[:4] != MAGIC:
        raise ValueError(f"{path}: not a .sig shard (bad magic)")
    version, n, k, b, code_bits, words, flags = struct.unpack(
        "<7I", head[4:32])
    if version != VERSION:
        raise ValueError(f"{path}: unsupported .sig version {version} "
                         f"(this build reads version {VERSION})")
    return SigShardMeta(n=n, k=k, b=b, code_bits=code_bits, words=words,
                        sentinel=bool(flags & _FLAG_SENTINEL))


def read_sig_shard(path: str, *, mmap: bool = False):
    """Read a shard back: ``(words, labels, meta)``.

    ``mmap=True`` maps the payload straight off disk (zero-copy until the
    device transfer); the plain path reads with ``np.fromfile``.
    """
    meta = read_sig_meta(path)
    if mmap:
        labels = np.array(np.memmap(path, np.float32, "r",
                                    offset=HEADER_BYTES, shape=(meta.n,)))
        words = np.memmap(path, np.uint32, "r", offset=meta.payload_offset,
                          shape=(meta.n, meta.words))
        return words, labels, meta
    with open(path, "rb") as f:
        f.seek(HEADER_BYTES)
        labels = np.fromfile(f, np.float32, meta.n)
        f.seek(meta.payload_offset)
        words = np.fromfile(f, np.uint32, meta.n * meta.words)
    if labels.size != meta.n or words.size != meta.n * meta.words:
        raise OSError(f"{path}: truncated .sig shard")
    return words.reshape(meta.n, meta.words), labels, meta
