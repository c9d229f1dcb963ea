"""Build and load the raw mmap-able ``.idx`` similarity-search index
(port of ``repro.index.builder``; the files are byte-identical).

``build_index`` turns packed ``.sig`` signature shards
(``repro_torch.data.sigshard``) into one index file without unpacking a
signature on the host: the packed payload is copied through verbatim,
and the banded bucket tables come from band keys computed on the device
(``repro_torch.index.banding.band_keys_packed``).

Layout (little-endian; every section 64-byte aligned):

    0   magic   b"RIDX"
    4   u32     version (1)
    8   u32     n              documents
    12  u32     k              signature values per document
    16  u32     b              b-bit width of genuine values
    20  u32     code_bits      b, or b+1 for sentinel wires
    24  u32     words          uint32 words per packed row
    28  u32     flags          bit 0: sentinel; bit 1: set sizes present
    32  u32     n_bands
    36  u32     rows_per_band
    40  u32     n_keys         total distinct (band, key) buckets
    44  u32     s              universe bits (0 = unknown)
    48  ..64    reserved (zero)

    f32[n]                 labels (carried from the .sig shards)
    u32[n]                 set sizes            (iff flag bit 1)
    i64[n_bands + 1]       band_offsets         (into keys / bucket_offsets)
    i64[n_keys]            keys                 (sorted within each band)
    i64[n_keys + 1]        bucket_offsets       (into postings, global)
    u32[n_bands * n]       postings             (doc ids per bucket)
    u32[n * words]         packed signature payload (row-major)

``load_index`` maps the file back (``SigIndex``); the packed payload
uploads once to the index's device (``SigIndex.corpus``) for kernel
scoring.  ``build_sharded`` splits a corpus into S contiguous-doc-range
``.idx`` shards plus a ``manifest.json``.  ``append_index`` extends an
``.idx`` with new documents without a rebuild (``merge_band_tables``),
under the destination's lock file; ``sharded_lock`` is the writer lock of
a sharded directory, and the manifest's ``generation`` counts its live
appends.  Host numpy and file I/O throughout, except the new documents'
band keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.data.lockfile import FileLock
from repro_torch.data.sigshard import read_sig_meta, read_sig_shard
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index.banding import BandingConfig, band_keys_packed
from repro_torch.kernels.pack import PackSpec

MAGIC = b"RIDX"
VERSION = 1
HEADER_BYTES = 64
_ALIGN = 64
_FLAG_SENTINEL = 1
_FLAG_SET_SIZES = 2


@dataclasses.dataclass(frozen=True)
class IndexMeta:
    """Decoded ``.idx`` header."""

    n: int
    k: int
    b: int
    code_bits: int
    words: int
    sentinel: bool
    has_set_sizes: bool
    n_bands: int
    rows_per_band: int
    n_keys: int
    s: int = 0

    @property
    def spec(self) -> PackSpec:
        return PackSpec(self.k, self.b, self.sentinel)

    @property
    def banding(self) -> BandingConfig:
        return BandingConfig(self.n_bands, self.rows_per_band, self.code_bits)

    @property
    def payload_bytes(self) -> int:
        """Packed signature payload only -- the paper's wire accounting."""
        return 4 * self.n * self.words


def _align(offset: int) -> int:
    return ((offset + _ALIGN - 1) // _ALIGN) * _ALIGN


def _sections(meta: IndexMeta) -> List[Tuple[str, np.dtype, int]]:
    """(name, dtype, count) in file order."""
    out = [("labels", np.dtype(np.float32), meta.n)]
    if meta.has_set_sizes:
        out.append(("set_sizes", np.dtype(np.uint32), meta.n))
    out += [
        ("band_offsets", np.dtype(np.int64), meta.n_bands + 1),
        ("keys", np.dtype(np.int64), meta.n_keys),
        ("bucket_offsets", np.dtype(np.int64), meta.n_keys + 1),
        ("postings", np.dtype(np.uint32), meta.n_bands * meta.n),
        ("payload", np.dtype(np.uint32), meta.n * meta.words),
    ]
    return out


def _section_offsets(meta: IndexMeta) -> dict:
    offsets, pos = {}, HEADER_BYTES
    for name, dtype, count in _sections(meta):
        pos = _align(pos)
        offsets[name] = pos
        pos += dtype.itemsize * count
    offsets["__end__"] = pos
    return offsets


def build_band_tables(keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """(n, n_bands) uint32 band keys -> flat sorted bucket tables.

    Returns ``(band_offsets, sorted_keys, bucket_offsets, postings)``: per
    band, the distinct keys in sorted order and each key's posting list
    of doc ids (ascending) -- exactly what ``.idx`` persists.
    """
    keys = np.asarray(keys)
    n, n_bands = keys.shape
    band_offsets = np.zeros(n_bands + 1, np.int64)
    all_keys, bucket_sizes, postings = [], [], []
    for band in range(n_bands):
        col = keys[:, band]
        order = np.argsort(col, kind="stable")       # doc ids stay ascending
        uniq, counts = np.unique(col, return_counts=True)
        all_keys.append(uniq.astype(np.int64))
        bucket_sizes.append(counts.astype(np.int64))
        postings.append(order.astype(np.uint32))
        band_offsets[band + 1] = band_offsets[band] + uniq.size
    sorted_keys = (np.concatenate(all_keys) if all_keys
                   else np.zeros(0, np.int64))
    sizes = (np.concatenate(bucket_sizes) if bucket_sizes
             else np.zeros(0, np.int64))
    bucket_offsets = np.zeros(sorted_keys.size + 1, np.int64)
    np.cumsum(sizes, out=bucket_offsets[1:])
    return (band_offsets, sorted_keys, bucket_offsets,
            np.concatenate(postings) if postings else np.zeros(0, np.uint32))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _read_sig_group(sig_paths: Sequence[str], cfg: BandingConfig,
                    device: torch.device,
                    expect: Optional[IndexMeta] = None):
    """Read + validate a group of ``.sig`` shards (payloads stay mmap'd).

    Returns ``(shard_words, labels, band_keys, first_shard_meta)``; the
    band keys of each shard are computed on ``device``.  ``expect`` (an
    ``IndexMeta``) pins the wire format when appending to an index.
    """
    if not sig_paths:
        raise ValueError("need at least one .sig shard")
    shard_words, label_parts, key_parts = [], [], []
    meta0 = None
    for path in sig_paths:
        words, labels, sm = read_sig_shard(path, mmap=True)
        if meta0 is None:
            meta0 = sm
            if not 1 <= meta0.b <= 16:
                raise ValueError(
                    f"index needs the packed wire format (1 <= b <= 16), "
                    f"shards carry b={meta0.b}")
            if cfg.code_bits != meta0.code_bits:
                raise ValueError(
                    f"banding over {cfg.code_bits}-bit values, shards "
                    f"carry {meta0.code_bits}-bit codes")
            if expect is not None and \
                    (sm.k, sm.b, sm.code_bits, sm.words, sm.sentinel) != \
                    (expect.k, expect.b, expect.code_bits, expect.words,
                     expect.sentinel):
                raise ValueError(f"{path}: wire format {sm} != index "
                                 f"{expect}")
        elif (sm.k, sm.b, sm.code_bits, sm.words, sm.sentinel) != \
                (meta0.k, meta0.b, meta0.code_bits, meta0.words,
                 meta0.sentinel):
            raise ValueError(f"{path}: wire format {sm} != first shard "
                             f"{meta0}")
        shard_words.append(words)
        label_parts.append(labels)
        spec = PackSpec(sm.k, sm.b, sm.sentinel)
        key_parts.append(u32.to_numpy(band_keys_packed(
            u32.from_numpy(words, device), spec, cfg)))
    return (shard_words, np.concatenate(label_parts),
            np.concatenate(key_parts), meta0)


_WRITE_CHUNK_ROWS = 1 << 16


def _write_index(out_path: str, meta: IndexMeta, arrays: dict,
                 payload_parts) -> None:
    """Serialize one ``.idx``; ``payload_parts`` is an iterable of
    (rows, words) uint32 arrays streamed through in bounded row chunks."""
    flags = ((_FLAG_SENTINEL if meta.sentinel else 0)
             | (_FLAG_SET_SIZES if meta.has_set_sizes else 0))
    header = MAGIC + struct.pack(
        "<11I", VERSION, meta.n, meta.k, meta.b, meta.code_bits, meta.words,
        flags, meta.n_bands, meta.rows_per_band, meta.n_keys, meta.s)
    header = header.ljust(HEADER_BYTES, b"\0")
    offsets = _section_offsets(meta)
    with open(out_path, "wb") as f:
        f.write(header)
        pos = HEADER_BYTES
        for name, dtype, count in _sections(meta):
            f.write(b"\0" * (offsets[name] - pos))
            if name == "payload":
                written = 0
                for words in payload_parts:        # stream off the mmaps
                    for off in range(0, words.shape[0], _WRITE_CHUNK_ROWS):
                        chunk = np.ascontiguousarray(
                            words[off:off + _WRITE_CHUNK_ROWS], dtype)
                        f.write(chunk.tobytes())
                        written += chunk.size
                if written != count:
                    raise AssertionError(f"payload: {written} != {count}")
                pos = offsets[name] + 4 * written
                continue
            arr = np.ascontiguousarray(arrays[name], dtype)
            if arr.size != count:
                raise AssertionError(f"{name}: {arr.size} != {count}")
            f.write(arr.tobytes())
            pos = offsets[name] + arr.nbytes


def _check_set_sizes(set_sizes, n: int) -> Optional[np.ndarray]:
    if set_sizes is None:
        return None
    set_sizes = np.ascontiguousarray(set_sizes, np.uint32)
    if set_sizes.shape != (n,):
        raise ValueError(f"set_sizes shape {set_sizes.shape} != ({n},)")
    return set_sizes


def build_index(sig_paths: Sequence[str], out_path: str, cfg: BandingConfig,
                *, set_sizes: Optional[np.ndarray] = None, s: int = 0,
                atomic: bool = False, device: DeviceLike = None) -> IndexMeta:
    """Packed ``.sig`` shards -> one ``.idx`` file.

    Shard payloads stay memory-mapped and are streamed into the file as
    they are; band keys are computed shard by shard on ``device`` (the
    card unless ``device="cpu"``).  ``set_sizes`` (nonzeros per document,
    in shard order) and ``s`` (universe bits) let queries use the exact
    Theorem-1 constants.  ``atomic`` writes a same-directory temp file and
    ``os.replace``s it over ``out_path`` when complete (how
    ``ShardedIndex.append`` publishes a spilled shard under live readers).
    """
    dev = resolve_device(device)
    shard_words, labels, keys, meta0 = _read_sig_group(sig_paths, cfg, dev)
    n = int(labels.shape[0])
    set_sizes = _check_set_sizes(set_sizes, n)

    band_offsets, sorted_keys, bucket_offsets, postings = \
        build_band_tables(keys)
    meta = IndexMeta(n=n, k=meta0.k, b=meta0.b, code_bits=meta0.code_bits,
                     words=meta0.words, sentinel=meta0.sentinel,
                     has_set_sizes=set_sizes is not None,
                     n_bands=cfg.n_bands, rows_per_band=cfg.rows_per_band,
                     n_keys=int(sorted_keys.size), s=s)
    arrays = {"labels": labels.astype(np.float32),
              "band_offsets": band_offsets, "keys": sorted_keys,
              "bucket_offsets": bucket_offsets, "postings": postings}
    if set_sizes is not None:
        arrays["set_sizes"] = set_sizes
    dest = out_path
    if atomic:
        out_path = f"{dest}.tmp.{os.getpid()}"
    _write_index(out_path, meta, arrays, shard_words)
    if atomic:
        os.replace(out_path, dest)
    return meta


# ---------------------------------------------------------------------------
# Incremental append
# ---------------------------------------------------------------------------

Tables = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def merge_band_tables(old: Tables, new: Tables, id_offset: int) -> Tables:
    """Merge two band bucket tables; ``new``'s doc ids shift by
    ``id_offset``.

    Both operands are ``(band_offsets, keys, bucket_offsets, postings)``
    as built by ``build_band_tables``.  Per band, the postings of both
    sides are re-grouped by key with a *stable* sort, so old docs keep
    their ascending order and precede the (larger-id) new docs inside
    every bucket -- the merged table is bit-identical to one built from
    scratch over the combined corpus, without touching the old payload
    or re-deriving its band keys.
    """
    bo_o, k_o, off_o, p_o = old
    bo_n, k_n, off_n, p_n = new
    n_bands = len(bo_o) - 1
    if len(bo_n) - 1 != n_bands:
        raise ValueError(f"band count mismatch: {n_bands} != {len(bo_n) - 1}")
    band_offsets = np.zeros(n_bands + 1, np.int64)
    key_parts, size_parts, post_parts = [], [], []
    for band in range(n_bands):
        lo, hi = int(bo_o[band]), int(bo_o[band + 1])
        ln, hn = int(bo_n[band]), int(bo_n[band + 1])
        sizes_o = np.asarray(off_o[lo + 1:hi + 1]) - np.asarray(off_o[lo:hi])
        sizes_n = np.asarray(off_n[ln + 1:hn + 1]) - np.asarray(off_n[ln:hn])
        keys_rep = np.concatenate([np.repeat(k_o[lo:hi], sizes_o),
                                   np.repeat(k_n[ln:hn], sizes_n)])
        posts = np.concatenate([
            np.asarray(p_o[off_o[lo]:off_o[hi]], np.int64),
            np.asarray(p_n[off_n[ln]:off_n[hn]], np.int64) + id_offset])
        order = np.argsort(keys_rep, kind="stable")
        keys_m, sizes_m = np.unique(keys_rep, return_counts=True)
        key_parts.append(keys_m.astype(np.int64))
        size_parts.append(sizes_m.astype(np.int64))
        post_parts.append(posts[order].astype(np.uint32))
        band_offsets[band + 1] = band_offsets[band] + keys_m.size
    keys = (np.concatenate(key_parts) if key_parts
            else np.zeros(0, np.int64))
    sizes = (np.concatenate(size_parts) if size_parts
             else np.zeros(0, np.int64))
    bucket_offsets = np.zeros(keys.size + 1, np.int64)
    np.cumsum(sizes, out=bucket_offsets[1:])
    return (band_offsets, keys, bucket_offsets,
            np.concatenate(post_parts) if post_parts
            else np.zeros(0, np.uint32))


def append_index(idx_path: str, sig_paths: Sequence[str], *,
                 set_sizes: Optional[np.ndarray] = None,
                 out_path: Optional[str] = None,
                 device: DeviceLike = None) -> IndexMeta:
    """Extend an existing ``.idx`` with new documents -- no full rebuild.

    Only the *new* shards' band keys are computed (on ``device``, the
    card unless ``device="cpu"``); the bucket tables merge via
    ``merge_band_tables`` and the old packed payload streams through
    verbatim from the mmap.  New docs get ids ``[old_n, old_n + new_n)``;
    the file is byte-identical to ``build_index`` over old + new shards.
    Writes atomically (temp file + ``os.replace``) to ``out_path``
    (default: in place), under the destination's lock file
    (``<dest>.lock``) so two appenders cannot interleave; readers stay
    lock-free -- an open mmap keeps the pre-append inode alive.
    """
    dest = out_path or idx_path
    dev = resolve_device(device)
    with FileLock(dest + ".lock"):
        return _append_index_locked(idx_path, sig_paths,
                                    set_sizes=set_sizes, dest=dest,
                                    device=dev)


def _append_index_locked(idx_path: str, sig_paths: Sequence[str], *,
                         set_sizes: Optional[np.ndarray], dest: str,
                         device: torch.device) -> IndexMeta:
    old = load_index(idx_path, device=device)
    om = old.meta
    shard_words, new_labels, new_keys, _ = _read_sig_group(
        sig_paths, om.banding, device, expect=om)
    n_new = int(new_labels.shape[0])
    set_sizes = _check_set_sizes(set_sizes, n_new)
    if om.has_set_sizes and set_sizes is None:
        raise ValueError("index stores set sizes; append needs set_sizes "
                         "for the new documents")
    if not om.has_set_sizes and set_sizes is not None:
        raise ValueError("index has no set sizes; cannot add them on append")

    band_offsets, keys, bucket_offsets, postings = merge_band_tables(
        (old.band_offsets, old.keys, old.bucket_offsets, old.postings),
        build_band_tables(new_keys), om.n)
    meta = dataclasses.replace(om, n=om.n + n_new, n_keys=int(keys.size))
    arrays = {"labels": np.concatenate([old.labels,
                                        new_labels.astype(np.float32)]),
              "band_offsets": band_offsets, "keys": keys,
              "bucket_offsets": bucket_offsets, "postings": postings}
    if om.has_set_sizes:
        arrays["set_sizes"] = np.concatenate([old.set_sizes, set_sizes])
    tmp = dest + ".tmp"
    _write_index(tmp, meta, arrays, [old.words_host] + shard_words)
    os.replace(tmp, dest)
    return meta


# ---------------------------------------------------------------------------
# Sharded build + manifest
# ---------------------------------------------------------------------------

MANIFEST_NAME = "manifest.json"
LOCK_NAME = ".lock"


def sharded_lock(shard_dir: str, **kwargs) -> FileLock:
    """The writer lock of a sharded-index directory -- taken by every
    mutation (``ShardedIndex.append``); readers never take it (manifest
    and shard replacements are atomic)."""
    return FileLock(os.path.join(shard_dir, LOCK_NAME), **kwargs)


def write_manifest(out_dir: str, paths: Sequence[str],
                   counts: Sequence[int], *, generation: int = 0) -> None:
    """Write the shard manifest (names, doc-id offsets, total n) that
    ``repro_torch.index.router.load_sharded`` reads -- the one serializer,
    shared by ``build_sharded`` and ``ShardedIndex.append``.

    ``generation`` is a monotone mutation counter: every live append bumps
    it, and readers (``ShardedIndex.refresh``) reload only when it moved.
    The write is atomic (same-directory temp + ``os.replace``), so a
    reader never parses a torn manifest.
    """
    offsets = np.cumsum([0] + list(counts))
    manifest = {"version": 1,
                "generation": int(generation),
                "shards": [os.path.basename(p) for p in paths],
                "offsets": [int(o) for o in offsets[:-1]],
                "n": int(offsets[-1])}
    dest = os.path.join(out_dir, MANIFEST_NAME)
    tmp = f"{dest}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, dest)


def read_manifest(shard_dir: str) -> dict:
    """Read + validate ``manifest.json`` (``generation`` defaults to 0)."""
    man_path = os.path.join(shard_dir, MANIFEST_NAME)
    with open(man_path) as f:
        manifest = json.load(f)
    if manifest.get("version") != 1:
        raise ValueError(f"{man_path}: unsupported manifest version "
                         f"{manifest.get('version')}")
    manifest.setdefault("generation", 0)
    return manifest


def build_sharded(sig_paths: Sequence[str], out_dir: str, cfg: BandingConfig,
                  *, n_shards: int, set_sizes: Optional[np.ndarray] = None,
                  s: int = 0, device: DeviceLike = None
                  ) -> List[Tuple[str, IndexMeta]]:
    """Split ``.sig`` shards into ``n_shards`` contiguous ``.idx`` files.

    Shard i holds the doc-id range ``[offsets[i], offsets[i+1])``; writes
    ``shard_%05d.idx`` plus ``manifest.json``.  Splits at ``.sig``-file
    granularity, balancing document counts.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > len(sig_paths):
        raise ValueError(f"n_shards={n_shards} > {len(sig_paths)} .sig "
                         "shards (splits are at .sig-file granularity)")
    dev = resolve_device(device)
    counts = [read_sig_meta(p).n for p in sig_paths]
    total = sum(counts)
    # contiguous near-even split by document count: each group takes
    # files until the cumulative count reaches its share, leaving at
    # least one file for every later group
    groups: List[List[str]] = []
    group_counts: List[int] = []
    i = cum = 0
    for g in range(n_shards):
        take_max = (len(sig_paths) - i) - (n_shards - g - 1)
        target_cum = total * (g + 1) / n_shards
        cur: List[str] = []
        cur_n = 0
        while len(cur) < take_max and (not cur or cum + cur_n < target_cum):
            cur.append(sig_paths[i])
            cur_n += counts[i]
            i += 1
        groups.append(cur)
        group_counts.append(cur_n)
        cum += cur_n

    os.makedirs(out_dir, exist_ok=True)
    out: List[Tuple[str, IndexMeta]] = []
    doc0 = 0
    for g, group in enumerate(groups):
        path = os.path.join(out_dir, f"shard_{g:05d}.idx")
        n_g = group_counts[g]
        sizes_g = (None if set_sizes is None
                   else np.asarray(set_sizes)[doc0:doc0 + n_g])
        out.append((path, build_index(group, path, cfg, set_sizes=sizes_g,
                                      s=s, device=dev)))
        doc0 += n_g
    write_manifest(out_dir, [p for p, _ in out], group_counts)
    return out


# ---------------------------------------------------------------------------
# Load / query-side container
# ---------------------------------------------------------------------------

def read_index_meta(path: str) -> IndexMeta:
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if len(head) < HEADER_BYTES or head[:4] != MAGIC:
        raise ValueError(f"{path}: not a .idx index (bad magic)")
    (version, n, k, b, code_bits, words, flags, n_bands, rows_per_band,
     n_keys, s) = struct.unpack("<11I", head[4:48])
    if version != VERSION:
        raise ValueError(f"{path}: unsupported .idx version {version} "
                         f"(this build reads version {VERSION})")
    return IndexMeta(n=n, k=k, b=b, code_bits=code_bits, words=words,
                     sentinel=bool(flags & _FLAG_SENTINEL),
                     has_set_sizes=bool(flags & _FLAG_SET_SIZES),
                     n_bands=n_bands, rows_per_band=rows_per_band,
                     n_keys=n_keys, s=s)


_UPLOAD_LOCK = threading.Lock()


@dataclasses.dataclass
class SigIndex:
    """A loaded ``.idx``: mmap'd bucket tables + packed corpus payload.

    ``words_host`` stays packed ((n, words) uint32); ``corpus`` uploads it
    to ``device`` once, on first use, as one int32 tensor.
    """

    meta: IndexMeta
    labels: np.ndarray
    set_sizes: Optional[np.ndarray]
    band_offsets: np.ndarray
    keys: np.ndarray
    bucket_offsets: np.ndarray
    postings: np.ndarray
    words_host: np.ndarray
    device: torch.device
    _corpus: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def spec(self) -> PackSpec:
        return self.meta.spec

    @property
    def banding(self) -> BandingConfig:
        return self.meta.banding

    @property
    def n(self) -> int:
        return self.meta.n

    @property
    def corpus(self) -> torch.Tensor:
        """Device-resident packed signature matrix (uploaded once).

        Dispatch threads reach the first use together: the upload runs
        once, under a lock, and is a blocking copy (PyTorch synchronizes
        the uploading stream before it returns), so the published tensor
        is complete for every stream that reads it.
        """
        if self._corpus is None:
            with _UPLOAD_LOCK:
                if self._corpus is None:
                    self._corpus = u32.from_numpy(self.words_host,
                                                  self.device)
        return self._corpus

    def candidates(self, query_keys: np.ndarray) -> np.ndarray:
        """Union of posting lists over all bands for one query's keys."""
        return self.candidates_batch(np.asarray(query_keys)[None, :])[0]

    def candidates_batch(self, query_keys: np.ndarray) -> List[np.ndarray]:
        """Per-query candidate unions (ascending int64 doc ids) for a
        (Q, n_bands) uint32 key batch: one ``np.searchsorted`` per band
        over the whole batch, then per-query posting-list unions."""
        query_keys = np.asarray(query_keys)
        q = query_keys.shape[0]
        hits: List[List[np.ndarray]] = [[] for _ in range(q)]
        for band in range(self.meta.n_bands):
            lo, hi = int(self.band_offsets[band]), \
                int(self.band_offsets[band + 1])
            band_keys = self.keys[lo:hi]
            if band_keys.size == 0:
                continue
            pos = np.searchsorted(band_keys, query_keys[:, band])
            found = pos < band_keys.size
            found[found] = (band_keys[pos[found]]
                            == query_keys[found, band])
            for qi in np.nonzero(found)[0]:
                t = lo + pos[qi]
                hits[qi].append(self.postings[
                    self.bucket_offsets[t]:self.bucket_offsets[t + 1]])
        return [np.unique(np.concatenate(h)).astype(np.int64) if h
                else np.zeros(0, np.int64) for h in hits]


def load_index(path: str, *, device: DeviceLike = None) -> SigIndex:
    """Map a ``.idx`` back (every section serves straight off disk); the
    corpus uploads to ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    meta = read_index_meta(path)
    offsets = _section_offsets(meta)
    out = {name: np.memmap(path, dtype, "r", offset=offsets[name],
                           shape=(count,))
           for name, dtype, count in _sections(meta)}
    return SigIndex(
        meta=meta, labels=np.asarray(out["labels"]),
        set_sizes=(np.asarray(out["set_sizes"])
                   if meta.has_set_sizes else None),
        band_offsets=np.asarray(out["band_offsets"]),
        keys=np.asarray(out["keys"]),
        bucket_offsets=np.asarray(out["bucket_offsets"]),
        postings=np.asarray(out["postings"]),
        words_host=out["payload"].reshape(meta.n, meta.words), device=dev)
