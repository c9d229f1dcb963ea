"""Theorem-1 estimator for b-bit minwise hashing (Li & König; port of
``repro.core.estimator``).

    P_b = Pr[z1^(b) == z2^(b)] = C_{1,b} + (1 - C_{2,b}) R

with, for r1 = f1/D, r2 = f2/D (f = set size):

    A_{i,b} = r_i (1 - r_i)^(2^b - 1) / (1 - (1 - r_i)^(2^b))
    C_{1,b} = A_{1,b} r2/(r1+r2) + A_{2,b} r1/(r1+r2)
    C_{2,b} = A_{1,b} r1/(r1+r2) + A_{2,b} r2/(r1+r2)

and the unbiased estimator R̂_b = (P̂_b - C_{1,b}) / (1 - C_{2,b}).

Everything is float32, as the reference computes without x64, with the
same operations in the same order; Python scalars enter as float32 (the
reference's weak types).  ``log1p`` / ``exp`` / ``expm1`` come from
PyTorch's math library, so a constant may differ from the reference's in
the last bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BBitConstants(NamedTuple):
    C1: torch.Tensor
    C2: torch.Tensor


def bbit_constants(f1, f2, D, b) -> BBitConstants:
    """C_{1,b}, C_{2,b} from set sizes f1, f2 and universe size D."""
    r1 = torch.as_tensor(f1).to(torch.float32) / D
    r2 = torch.as_tensor(f2).to(torch.float32) / D
    two_b = 2.0 ** b

    def A(r):
        # numerically stable via log1p/expm1 (r can be ~1e-9 in float32):
        #   A = r (1-r)^(2^b - 1) / (1 - (1-r)^(2^b))
        r = torch.clamp(r, 1e-35, 1.0 - 1e-7)
        log1m = torch.log1p(-r)
        num = r * torch.exp((two_b - 1.0) * log1m)
        denom = -torch.expm1(two_b * log1m)
        return num / torch.clamp(denom, min=1e-35)

    A1, A2 = A(r1), A(r2)
    rs = torch.clamp(r1 + r2, min=1e-30)
    C1 = A1 * r2 / rs + A2 * r1 / rs
    C2 = A1 * r1 / rs + A2 * r2 / rs
    return BBitConstants(C1=C1, C2=C2)


def collision_prob(R, f1, f2, D, b):
    """Theorem 1 forward direction: P_b from resemblance R."""
    c = bbit_constants(f1, f2, D, b)
    return c.C1 + (1.0 - c.C2) * R


def estimate_resemblance(p_hat, f1, f2, D, b):
    """Unbiased R̂_b from the empirical collision fraction P̂_b (Eq. 4)."""
    c = bbit_constants(f1, f2, D, b)
    return (p_hat - c.C1) / (1.0 - c.C2)
