"""Synthetic sparse binary datasets (a copy of ``repro.data.synthetic``'s
generator): the same numpy draws, so both packages make the same data from
the same ``DatasetSpec``.

Each class owns ``n_prototypes`` topic sets; an example copies a fraction
``overlap`` of one prototype and adds fresh random features, so same-class
examples have high resemblance and cross-class examples low.  Also the
Appendix-A word-pair sets (two sets with a prescribed exact resemblance).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.data.sparse import SparseBatch, from_lists
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    D: int
    avg_nnz: int
    n_classes: int = 2
    n_prototypes: int = 8        # topics per class
    overlap: float = 0.7         # fraction of an example copied from its prototype
    seed: int = 0


WEBSPAM_LIKE = DatasetSpec("webspam_like", n=4096, D=2**24, avg_nnz=512,
                           n_prototypes=6, overlap=0.7, seed=7)
RCV1_LIKE = DatasetSpec("rcv1_like", n=4096, D=2**30, avg_nnz=1024,
                        n_prototypes=8, overlap=0.65, seed=11)
TINY = DatasetSpec("tiny", n=256, D=2**16, avg_nnz=64, n_prototypes=3, seed=3)


def generate_sets(spec: DatasetSpec, n: Optional[int] = None
                  ) -> Tuple[Tuple[List[np.ndarray], np.ndarray],
                             Tuple[List[np.ndarray], np.ndarray]]:
    """((train sets, labels), (test sets, labels)): an 80/20 split."""
    n = n or spec.n
    rng = np.random.default_rng(spec.seed)
    protos = []
    for c in range(spec.n_classes):
        for _ in range(spec.n_prototypes):
            size = max(8, int(spec.avg_nnz))
            protos.append((c, rng.choice(spec.D, size=size, replace=False)))

    def make(n_rows, seed_off):
        r = np.random.default_rng(spec.seed + seed_off)
        sets, labels = [], []
        for _ in range(n_rows):
            c, proto = protos[r.integers(len(protos))]
            keep = r.random(len(proto)) < spec.overlap
            kept = proto[keep]
            n_new = max(1, int(len(proto) * (1.0 - spec.overlap)))
            fresh = r.integers(0, spec.D, size=n_new)
            sets.append(np.unique(np.concatenate([kept, fresh])).astype(np.int64))
            labels.append(1.0 if c == 1 else -1.0)
        return sets, np.asarray(labels, np.float32)

    n_train = int(n * 0.8)
    return make(n_train, 1), make(n - n_train, 2)


def generate(spec: DatasetSpec, n: Optional[int] = None, *,
             device: DeviceLike = None) -> Tuple[SparseBatch, SparseBatch]:
    """(train, test) SparseBatches with labels in {-1, +1}."""
    (tr, ytr), (te, yte) = generate_sets(spec, n)
    return (from_lists(tr, ytr, device=device),
            from_lists(te, yte, device=device))


def word_pair_sets(D: int, f1: int, f2: int, R: float, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Two sets over [0, D) with |S1|=f1, |S2|=f2 and resemblance ~= R:
    |S1 ∩ S2| = a from R = a / (f1 + f2 - a), i.e. a = R(f1+f2)/(1+R).
    Mirrors the Appendix-A word-pair data (Table 5)."""
    a = int(round(R * (f1 + f2) / (1.0 + R)))
    a = min(a, f1, f2)
    rng = np.random.default_rng(seed)
    universe = rng.choice(D, size=f1 + f2 - a, replace=False)
    shared = universe[:a]
    only1 = universe[a:f1]
    only2 = universe[f1:f1 + f2 - a]
    s1 = np.sort(np.concatenate([shared, only1]))
    s2 = np.sort(np.concatenate([shared, only2]))
    return s1.astype(np.int64), s2.astype(np.int64)


# Appendix-A Table 5 word pairs: (name, f1, f2, R)
TABLE5_PAIRS = [
    ("KONG-HONG", 948, 940, 0.925),
    ("RIGHTS-RESERVED", 12234, 11272, 0.877),
    ("OF-AND", 37339, 36289, 0.771),
    ("GAMBIA-KIRIBATI", 206, 186, 0.712),
    ("SAN-FRANCISCO", 3194, 1651, 0.476),
    ("CREDIT-CARD", 2999, 2697, 0.285),
    ("TIME-JOB", 37339, 36289, 0.128),
    ("LOW-PAY", 2936, 2828, 0.112),
    ("A-TEST", 39063, 2278, 0.052),
]
