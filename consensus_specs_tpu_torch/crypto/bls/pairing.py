"""Optimal ate pairing on BLS12-381.

Implementation strategy: untwist G2 points into E(Fq12) and run the
Miller loop with generic affine chord-tangent line functions — the
least-fragile formulation (no sparse-line index bookkeeping), at oracle
speed.  Pairing-product form `prod e(Pi, Qi) == 1` shares one final
exponentiation across all pairs, which is what Verify/FastAggregateVerify
need (reference behavior: eth2spec/utils/bls.py:47-74 via py_ecc).
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from .fields import (
    FQ12_ONE,
    FQ12_W2_INV,
    FQ12_W3_INV,
    Fq,
    Fq2,
    Fq12,
    P,
    R,
    X_PARAM,
    fq12_from_fq,
    fq12_from_fq2,
)

_ATE_LOOP = -X_PARAM  # 0xd201000000010000 (|x|; x itself is negative)
_ATE_BITS = bin(_ATE_LOOP)[3:]  # skip leading '0b1'

# hard part exponent of the final exponentiation: (p^4 - p^2 + 1) / r
_HARD_EXP = (P**4 - P**2 + 1) // R


AffFq12 = Tuple[Fq12, Fq12]


def _untwist(q_affine: Tuple[Fq2, Fq2]) -> AffFq12:
    """E'(Fq2) -> E(Fq12): (x, y) -> (x / w^2, y / w^3)."""
    x, y = q_affine
    return (fq12_from_fq2(x) * FQ12_W2_INV, fq12_from_fq2(y) * FQ12_W3_INV)


def _embed_g1(p_affine: Tuple[Fq, Fq]) -> AffFq12:
    x, y = p_affine
    return (fq12_from_fq(x.n), fq12_from_fq(y.n))


def _line(p1: AffFq12, p2: AffFq12, t: AffFq12) -> Fq12:
    """Evaluate the line through p1,p2 (tangent if equal) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        three = fq12_from_fq(3)
        two = fq12_from_fq(2)
        m = three * x1.square() * (two * y1).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _add_aff(p1: AffFq12, p2: AffFq12) -> Optional[AffFq12]:
    """Affine addition in E(Fq12); None = infinity."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _double_aff(p1)
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    x3 = m.square() - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _double_aff(p: AffFq12) -> AffFq12:
    x, y = p
    m = fq12_from_fq(3) * x.square() * (fq12_from_fq(2) * y).inv()
    x3 = m.square() - x - x
    y3 = m * (x - x3) - y
    return (x3, y3)


def miller_loop(p: Point, q: Point) -> Fq12:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter."""
    if p.is_infinity() or q.is_infinity():
        return FQ12_ONE
    p12 = _embed_g1(p.to_affine())
    q12 = _untwist(q.to_affine())
    t = q12
    f = FQ12_ONE
    for bit in _ATE_BITS:
        f = f.square() * _line(t, t, p12)
        t = _double_aff(t)
        if bit == "1":
            f = f * _line(t, q12, p12)
            t = _add_aff(t, q12)
    # x < 0: conjugate (inverse up to factors killed by the final exponentiation)
    return f.conjugate()


def final_exponentiation(f: Fq12) -> Fq12:
    easy = f.conjugate() * f.inv()          # f^(p^6 - 1)
    easy = easy.pow(P * P) * easy           # ^(p^2 + 1)
    return easy.pow(_HARD_EXP)


def pairing(p: Point, q: Point) -> Fq12:
    """e(P, Q) with P in G1, Q in G2."""
    return final_exponentiation(miller_loop(p, q))


def pairings_are_identity(pairs: Iterable[Tuple[Point, Point]]) -> bool:
    """prod e(Pi, Qi) == 1, sharing a single final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f) == FQ12_ONE
