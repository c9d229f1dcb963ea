"""Analytic roofline terms for the packed-Hamming retrieval scan (port of
``repro.roofline.search``, against the H100's bandwidth).

A server measures wall clock per flush; this module supplies the
napkin-math counterpart -- how many HBM bytes and popcount FLOPs ONE
exact-scan flush must move -- so a *roofline gap* (measured time over
memory-bound predicted time) can be tracked per offered load.  Block
sizes and dispatch changes should move it toward 1, and regressions show
up as a widening ratio even when absolute q/s still looks fine.

The exact scan is memory-bound: every flush streams the whole packed
corpus once past ``q`` resident query rows (PAPER.md §6's preprocessing
arithmetic -- b-bit codes exist precisely to shrink this stream), then
materializes a (q, n) score panel that the top-k reduction re-reads.

The bandwidth is the H100's (``repro_torch.roofline.hardware``); on the
CPU the gap is large and means nothing about the card.  Pass ``bw=`` to
re-anchor (a card below its 700 W limit, another part).

These terms feed the LIVE ``serve_roofline_*`` gauges:
``repro_torch.launch.server.SearchServer`` calls ``exact_scan_cost`` /
``roofline_gap`` after every un-degraded exact flush and publishes
predicted bytes/seconds, measured seconds, the gap ratio, and achieved
GB/s through ``repro_torch.obs.metrics`` (scrape via ``--metrics-port``).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.roofline.hardware import HBM_BW


def exact_scan_cost(n_docs: int, words: int, n_queries: int, *,
                    topk: int = 10, word_bytes: int = 4
                    ) -> Dict[str, float]:
    """Per-flush HBM bytes + FLOPs for one exact packed-Hamming scan.

    ``words`` is the packed signature width in ``word_bytes``-byte words
    (``IndexMeta`` stores uint32 words).  Terms, per flush of
    ``n_queries`` rows over an ``n_docs`` corpus:

      * corpus stream: ``n_docs * words * word_bytes`` -- read once,
        shared by every query row in the flush (the whole point of
        micro-batching: this dominant term amortizes over the batch),
      * query rows: ``n_queries * words * word_bytes``,
      * score panel: ``(q, n)`` float32 written by the scan and re-read
        by the top-k reduction, plus the ``(q, topk)`` result pair.

    FLOPs count xor+popcount+accumulate as 3 ops per packed word pair
    (scalar equivalent; vector ISAs fuse these, which the roofline's
    memory bound makes irrelevant).
    """
    if n_docs < 1 or words < 1 or n_queries < 1:
        raise ValueError(f"n_docs, words, n_queries must be >= 1, got "
                         f"({n_docs}, {words}, {n_queries})")
    corpus = float(n_docs) * words * word_bytes
    queries = float(n_queries) * words * word_bytes
    scores = 2.0 * n_queries * n_docs * 4.0          # write + top-k re-read
    out = float(n_queries) * topk * (8.0 + 4.0)      # int64 ids + f32 scores
    flops = 3.0 * n_queries * n_docs * words
    byts = corpus + queries + scores + out
    return {"bytes": byts, "flops": flops,
            "corpus_bytes": corpus,
            "bytes_per_query": byts / n_queries}


def roofline_gap(bytes_per_flush: float, flush_s: float, *,
                 bw: float = HBM_BW) -> Dict[str, float]:
    """Measured flush time against the memory-bound prediction.

    ``gap`` = measured / predicted (>= 1 on any real host; 1.0 means the
    scan runs at the roofline's bandwidth ``bw``).  ``achieved_gbps`` is
    the effective streaming bandwidth the flush actually sustained.
    """
    if bytes_per_flush <= 0 or flush_s <= 0:
        raise ValueError(f"bytes_per_flush and flush_s must be > 0, got "
                         f"({bytes_per_flush}, {flush_s})")
    predicted_s = bytes_per_flush / bw
    return {"predicted_s": predicted_s,
            "gap": flush_s / predicted_s,
            "achieved_gbps": bytes_per_flush / flush_s / 1e9}
