"""Query paths over a loaded ``.idx``: exact top-k and LSH + rerank (port
of ``repro.index.query``).

One searcher, two serving paths sharing the scoring kernel and the
estimator rerank:

  * ``mode="exact"`` -- brute force over the device-resident packed
    corpus: a Python loop over blocks of ``corpus_block`` rows runs the
    packed-match kernel (``repro_torch.kernels.hamming.packed_match``),
    debiases the counts into resemblance estimates (Theorem 1) and merges
    them into a running top-k.  The launches are queued on the stream;
    only the harvest waits for them.
  * ``mode="lsh"`` -- candidates from the banded bucket tables (one
    batched ``np.searchsorted`` per band, ``SigIndex.candidates_batch``),
    then one kernel launch over the batch's candidate union (padded to a
    power of two >= 128) with non-candidates masked out, then the same
    rerank.

Top-k order is the reference's ``lax.top_k`` rule: descending score,
ties toward the earlier position (the lower doc id).  ``torch.topk``
promises no order among ties, so every top-k here is a stable descending
``torch.sort``.

``submit`` queues single queries and ``flush`` runs them as one batch --
the entry point of ``repro_torch.launch.serve --index``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.estimator import bbit_constants
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index.banding import band_keys_packed
from repro_torch.index.builder import SigIndex
from repro_torch.kernels.engine import PackedSignatures
from repro_torch.kernels.hamming import packed_match
from repro_torch.kernels.pack import PackSpec

Queries = Union[PackedSignatures, torch.Tensor, np.ndarray]


def resemblance_scores(matches: torch.Tensor,
                       both_empty: Optional[torch.Tensor], k: int, b: int, *,
                       query_sizes: Optional[torch.Tensor] = None,
                       doc_sizes: Optional[torch.Tensor] = None,
                       D: int = 0) -> torch.Tensor:
    """(Q, N) match counts -> (Q, N) float32 resemblance estimates.

    ``both_empty`` applies the Li-Owen-Zhang denominator for sentinel
    wires; the Theorem-1 debias uses exact (C1, C2) when set sizes and the
    universe size are known, the sparse-limit constants 2^-b otherwise.
    The operations and their order are the reference's, in float32
    (constant divisions as multiplies by the float32 reciprocal).
    """
    p = matches.to(torch.float32)
    if both_empty is not None:
        p = p / torch.clamp(k - both_empty.to(torch.float32), min=1.0)
    else:
        p = p * (1.0 / k)
    if query_sizes is not None and doc_sizes is not None and D:
        c = bbit_constants(query_sizes[:, None], doc_sizes[None, :], D, b)
        return (p - c.C1) / (1.0 - c.C2)
    c1 = 2.0 ** -b
    return (p - c1) * (1.0 / (1.0 - c1))


@dataclasses.dataclass
class SearchResult:
    """Top-k per query: global doc ids (-1 past the candidate count) and
    their resemblance estimates (-inf where the id is -1)."""

    indices: np.ndarray          # (Q, topk) int64
    scores: np.ndarray           # (Q, topk) float32
    n_candidates: Optional[np.ndarray] = None    # (Q,) for the LSH path


def query_words(queries: Queries, spec: PackSpec,
                device: torch.device) -> torch.Tensor:
    """A query batch as (Q, words) int32 words on ``device``: a
    ``PackedSignatures`` batch in the index's wire format, an int32
    tensor of bit patterns, or a uint32 numpy array."""
    if isinstance(queries, PackedSignatures):
        if (queries.k, queries.b, queries.sentinel) != \
                (spec.k, spec.b, spec.sentinel):
            raise ValueError(
                f"query wire (k={queries.k}, b={queries.b}, "
                f"sentinel={queries.sentinel}) != index wire (k={spec.k}, "
                f"b={spec.b}, sentinel={spec.sentinel})")
        words = queries.data
    elif isinstance(queries, torch.Tensor):
        if queries.dtype != torch.int32:
            raise TypeError(f"query words must be int32 bit patterns, got "
                            f"{queries.dtype}")
        words = queries
    else:
        words = u32.from_numpy(np.asarray(queries), "cpu")
    if words.ndim != 2 or words.shape[1] != spec.words:
        raise ValueError(f"raw queries must be (Q, {spec.words}) packed "
                         f"words, got {tuple(words.shape)}")
    return words.to(device)


def topk_desc(scores: torch.Tensor, kk: int):
    """(values, positions) of the kk largest per row; ties toward the
    lower position, as ``lax.top_k``."""
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :kk], order[:, :kk]


def topk_merge(best_s, best_i, sc, ids):
    """Running top-k merge: [best so far || block scores] -> new best;
    ties go to the earlier concatenation position (the lower doc id)."""
    cat_s = torch.cat([best_s, sc], dim=1)
    cat_i = torch.cat([best_i, ids.expand(sc.shape[0], -1)], dim=1)
    new_s, sel = topk_desc(cat_s, best_s.shape[1])
    return new_s, torch.gather(cat_i, 1, sel)


def pad_result(best_i: torch.Tensor, best_s: torch.Tensor, q: int, topk: int,
               kk: int, n_candidates=None) -> SearchResult:
    """Pad to the requested width so every mode returns (Q, topk)."""
    out_i = np.full((q, topk), -1, np.int64)
    out_s = np.full((q, topk), -np.inf, np.float32)
    out_i[:, :kk] = best_i[:, :topk].cpu().numpy()
    out_s[:, :kk] = best_s[:, :topk].cpu().numpy()
    return SearchResult(out_i, out_s, n_candidates)


class BatchedAdmission:
    """The submit/flush protocol shared by ``IndexSearcher`` and the
    sharded router: hosts provide ``spec``, ``device`` and ``search``."""

    def _admission_init(self) -> None:
        self._pending: List[Tuple[int, torch.Tensor, Optional[int]]] = []
        self._next_ticket = 0

    def submit(self, query: Queries, *,
               query_size: Optional[int] = None) -> int:
        """Queue one query (a single packed row); returns its ticket.
        Host rows stay on the host until ``flush`` copies the batch."""
        if isinstance(query, PackedSignatures):
            dev = query.data.device
        elif isinstance(query, torch.Tensor):
            query, dev = query.reshape(1, -1), query.device
        else:
            query, dev = np.asarray(query).reshape(1, -1), torch.device("cpu")
        words = query_words(query, self.spec, dev)
        if words.shape[0] != 1:
            raise ValueError("submit() takes exactly one query row")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, words, query_size))
        return ticket

    def flush(self, topk: int = 10, *,
              mode: str = "exact") -> Dict[int, SearchResult]:
        """Run all queued queries as ONE batch; per-ticket results."""
        if not self._pending:
            return {}
        tickets = [t for t, _, _ in self._pending]
        rows = [w for _, w, _ in self._pending]
        sizes = [sz for _, _, sz in self._pending]
        self._pending = []
        if all(r.device.type == "cpu" for r in rows):
            batch = torch.cat(rows).to(self.device)       # one copy
        else:
            batch = torch.cat([r.to(self.device) for r in rows])
        qsizes = None
        if any(sz is not None for sz in sizes):
            if any(sz is None for sz in sizes):
                raise ValueError("either every submitted query carries a "
                                 "query_size or none does")
            qsizes = np.asarray(sizes, np.uint32)
        res = self.search(batch, topk, mode=mode, query_sizes=qsizes)
        return {t: SearchResult(res.indices[i:i + 1], res.scores[i:i + 1],
                                None if res.n_candidates is None
                                else res.n_candidates[i:i + 1])
                for i, t in enumerate(tickets)}


class IndexSearcher(BatchedAdmission):
    """Serving front end over one ``SigIndex`` on ``device`` (the card
    unless ``device="cpu"``; it must be the index's).  ``corpus_block`` is
    the exact scan's block height.

    Match counts come from ``match_counts``, the packed-match dispatcher;
    a subclass may score through another function of the same contract
    (``chip_smoke.py`` scores one through the plain version on the card).
    """

    def __init__(self, index: SigIndex, *, device: DeviceLike = None,
                 corpus_block: int = 4096):
        self.device = resolve_device(device)
        if self.device.type != index.device.type:
            raise ValueError(f"index lives on {index.device}, searcher on "
                             f"{self.device}; load it with device="
                             f"'{self.device.type}'")
        if corpus_block < 1:
            raise ValueError(f"corpus_block must be >= 1, got {corpus_block}")
        self.index = index
        self.corpus_block = min(corpus_block, max(index.n, 1))
        self._doc_sizes = None
        self._admission_init()

    @property
    def spec(self) -> PackSpec:
        return self.index.spec

    def match_counts(self, qwords: torch.Tensor, cwords: torch.Tensor):
        return packed_match(qwords, cwords, self.index.spec)

    # -- scoring ---------------------------------------------------------
    def _rerank_sizes(self, q_sizes) -> Optional[torch.Tensor]:
        """Query sizes on the device for the Theorem-1 rerank, or None on
        indexes without set sizes (sparse-limit constants)."""
        meta = self.index.meta
        if self.index.set_sizes is None or not meta.s:
            return None
        if q_sizes is None:
            raise ValueError("index stores set sizes; pass query_sizes "
                             "to search() for the exact Theorem-1 rerank")
        if self._doc_sizes is None:
            self._doc_sizes = torch.from_numpy(
                self.index.set_sizes.astype(np.int64)).to(self.device)
        return torch.from_numpy(
            np.asarray(q_sizes).astype(np.int64)).to(self.device)

    def _score(self, qwords, cwords, doc_ids, q_sizes):
        """Kernel match counts -> resemblance estimates for the docs
        ``doc_ids`` (a slice or an index tensor) of the corpus."""
        meta = self.index.meta
        out = self.match_counts(qwords, cwords)
        matches, both_empty = out if meta.sentinel else (out, None)
        if q_sizes is None:
            return resemblance_scores(matches, both_empty, meta.k, meta.b)
        return resemblance_scores(matches, both_empty, meta.k, meta.b,
                                  query_sizes=q_sizes,
                                  doc_sizes=self._doc_sizes[doc_ids],
                                  D=1 << meta.s)

    # -- exact brute force ------------------------------------------------
    def _exact(self, qwords, topk: int, q_sizes):
        n, q = self.index.n, qwords.shape[0]
        kk = min(topk, n)
        corpus = self.index.corpus
        best_s = torch.full((q, kk), -torch.inf, device=self.device)
        best_i = torch.full((q, kk), -1, dtype=torch.int64,
                            device=self.device)
        for start in range(0, n, self.corpus_block):
            stop = min(start + self.corpus_block, n)
            sc = self._score(qwords, corpus[start:stop], slice(start, stop),
                             q_sizes)
            ids = torch.arange(start, stop, device=self.device)
            best_s, best_i = topk_merge(best_s, best_i, sc, ids)
        return lambda: pad_result(best_i, best_s, q, topk, kk)

    # -- LSH candidates + rerank ------------------------------------------
    def _lsh(self, qwords, topk: int, q_sizes, qkeys=None):
        q = qwords.shape[0]
        if qkeys is None:
            qkeys = u32.to_numpy(band_keys_packed(qwords, self.index.spec,
                                                  self.index.banding))
        cand = self.index.candidates_batch(qkeys)
        n_cand = np.array([c.size for c in cand], np.int64)
        if not n_cand.any():
            res = SearchResult(np.full((q, topk), -1, np.int64),
                               np.full((q, topk), -np.inf, np.float32),
                               n_cand)
            return lambda: res
        union = np.unique(np.concatenate(cand))
        # pad the union to a power of two >= 128, as the reference buckets
        # candidate widths; padding slots point at row 0, not members
        c_pad = max(128, 1 << int(union.size - 1).bit_length())
        ids = np.zeros(c_pad, np.int64)
        ids[:union.size] = union
        member = np.zeros((q, c_pad), bool)
        for i, c in enumerate(cand):
            member[i, np.searchsorted(union, c)] = True
        ids_dev = torch.from_numpy(ids).to(self.device)
        cwords = self.index.corpus.index_select(0, ids_dev)
        sc = self._score(qwords, cwords, ids_dev, q_sizes)
        sc = torch.where(torch.from_numpy(member).to(self.device), sc,
                         -torch.inf)
        kk = min(topk, c_pad)
        top_s, sel = topk_desc(sc, kk)
        top_i = torch.where(torch.isneginf(top_s), -1, ids_dev[sel])
        return lambda: pad_result(top_i, top_s, q, topk, kk, n_cand)

    # -- public API -------------------------------------------------------
    def dispatch(self, queries: Queries, topk: int = 10, *,
                 mode: str = "exact",
                 query_sizes: Optional[np.ndarray] = None,
                 qkeys: Optional[np.ndarray] = None
                 ) -> Callable[[], SearchResult]:
        """Queue a batch's device work now; the returned harvest callable
        waits for it and builds the ``SearchResult``.  ``qkeys`` passes
        band keys the caller already computed (the router computes them
        once per batch, not once per shard)."""
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        qwords = query_words(queries, self.index.spec, self.device)
        q_sizes = self._rerank_sizes(query_sizes)
        if mode == "exact":
            return self._exact(qwords, topk, q_sizes)
        if mode == "lsh":
            return self._lsh(qwords, topk, q_sizes, qkeys)
        raise ValueError(f"mode must be 'exact' or 'lsh', got {mode!r}")

    def search(self, queries: Queries, topk: int = 10, *,
               mode: str = "exact",
               query_sizes: Optional[np.ndarray] = None) -> SearchResult:
        """Top-k most resembling documents for a batch of packed queries
        (``"exact"`` brute force or ``"lsh"`` banded candidates + rerank);
        ``query_sizes`` feeds the exact Theorem-1 debias when the index
        stores set sizes."""
        return self.dispatch(queries, topk, mode=mode,
                             query_sizes=query_sizes)()
