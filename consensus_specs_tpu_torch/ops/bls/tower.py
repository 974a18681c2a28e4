"""Fq2 / Fq6 / Fq12 extension arithmetic on lazy-reduction limb lanes, in torch.

Port of ``consensus_specs_tpu/ops/bls_jax/tower.py``; the layouts are the
reference's (leading axes are free batch axes everywhere):
  * Fq2  = ``[..., 2, 16]``  (c0 + c1*u, u^2 = -1)
  * Fq6  = ``[..., 3, 2, 16]`` (over Fq2, v^3 = xi = 1+u) — used by the
    tower inversion and the Fq12 squaring
  * Fq12 = ``[..., 6, 2, 16]`` — SIX Fq2 coefficients in the **w-power
    basis** {1, w, ..., w^5} with w^6 = xi.  This flat basis is isomorphic
    to the tower Fq6[w]/(w^2-v) via the slot permutation
    {1,v,v^2,w,vw,v^2w} = {w^0,w^2,w^4,w^1,w^3,w^5}; it lets a full Fq12
    multiplication run as ONE batched limb multiplication over 108 lanes
    (36 Fq2 products x Karatsuba 3).

Reduction discipline (see limbs.py): adds/subs/negs are single elementwise
ops on signed limbs; every public multiplying op here ends with
``limbs.renorm`` so its output has canonical digits, keeping all
accumulations inside the ``limbs.mul`` operand envelope.  Every product
goes through ``limbs.mul``: K3 on the card, its plain version on the CPU.

Formulas mirror the pure-int oracle (crypto/bls/fields.py); the tests hold
every op against it and against the JAX package's on the same limbs.
"""
from __future__ import annotations

import numpy as np
import torch

from consensus_specs_tpu_torch.crypto.bls import fields as _oracle

from . import limbs

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return a + b


def fq2_sub(a, b):
    return a - b


def fq2_neg(a):
    return -a


def fq2_mul_by_xi(a):
    """Multiply by xi = 1 + u: (c0 - c1, c0 + c1)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([a0 - a1, a0 + a1], dim=-2)


def fq2_conj(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([a0, -a1], dim=-2)


def fq2_mul(a, b):
    """Karatsuba: 3 limb products batched into one call; renormed output."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    lhs = torch.stack([a0, a1, a0 + a1], dim=-2)
    rhs = torch.stack([b0, b1, b0 + b1], dim=-2)
    t = limbs.mul(lhs, rhs)
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return limbs.renorm(torch.stack([t0 - t1, t2 - t0 - t1], dim=-2))


def fq2_square(a):
    """(a0+a1)(a0-a1) and 2*a0*a1 — 2 limb products in one call."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    lhs = torch.stack([a0 + a1, a0], dim=-2)
    rhs = torch.stack([a0 - a1, a1], dim=-2)
    t = limbs.mul(lhs, rhs)
    return limbs.renorm(torch.stack([t[..., 0, :], 2 * t[..., 1, :]], dim=-2))


def fq2_inv(a):
    sq = limbs.mul(a, a)
    norm = sq[..., 0, :] + sq[..., 1, :]
    ninv = limbs.inv(norm)
    pair = limbs.mul(a, ninv[..., None, :])
    return limbs.renorm(
        torch.stack([pair[..., 0, :], -pair[..., 1, :]], dim=-2))


def fq2_scale_fq(a, s):
    """Multiply an Fq2 by an Fq scalar (s: [..., 16])."""
    return limbs.mul(a, s[..., None, :])


def fq2_canonical(a):
    return limbs.canonical(a)


def fq2_eq(a, b):
    """Exact equality; canonicalizes both sides."""
    return torch.all(limbs.canonical(a) == limbs.canonical(b), dim=-1).all(dim=-1)


# ---------------------------------------------------------------------------
# Fq6 (tower layout; used by the Fq12 inversion and squaring)
# ---------------------------------------------------------------------------


def _fq6_parts(a):
    return a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]


def fq6_mul(a, b):
    """Mirror of fields.py Fq6.__mul__ — 6 Fq2 products in one batch."""
    a0, a1, a2 = _fq6_parts(a)
    b0, b1, b2 = _fq6_parts(b)
    lhs = torch.stack([a0, a1, a2, a1 + a2, a0 + a1, a0 + a2], dim=-3)
    rhs = torch.stack([b0, b1, b2, b1 + b2, b0 + b1, b0 + b2], dim=-3)
    t = fq2_mul(lhs, rhs)
    t0, t1, t2 = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    m12, m01, m02 = t[..., 3, :, :], t[..., 4, :, :], t[..., 5, :, :]
    c0 = fq2_mul_by_xi(m12 - t1 - t2) + t0
    c1 = m01 - t0 - t1 + fq2_mul_by_xi(t2)
    c2 = m02 - t0 - t2 + t1
    return limbs.renorm(torch.stack([c0, c1, c2], dim=-3))


def fq6_square(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    a0, a1, a2 = _fq6_parts(a)
    return torch.stack([fq2_mul_by_xi(a2), a0, a1], dim=-3)


def fq6_inv(a):
    """Mirror of fields.py Fq6.inv."""
    a0, a1, a2 = _fq6_parts(a)
    t0 = fq2_square(a0) - fq2_mul_by_xi(fq2_mul(a1, a2))
    t1 = fq2_mul_by_xi(fq2_square(a2)) - fq2_mul(a0, a1)
    t2 = fq2_square(a1) - fq2_mul(a0, a2)
    den = (fq2_mul(a0, t0)
           + fq2_mul_by_xi(fq2_mul(a2, t1))
           + fq2_mul_by_xi(fq2_mul(a1, t2)))
    factor = fq2_inv(limbs.renorm(den))
    stack = torch.stack([t0, t1, t2], dim=-3)
    return fq2_mul(stack, factor[..., None, :, :])


# ---------------------------------------------------------------------------
# Fq12 in the w-power basis
# ---------------------------------------------------------------------------

_I36 = np.repeat(np.arange(6), 6)
_J36 = np.tile(np.arange(6), 6)


def _fold(i, j):
    """For products a_i * b_j: the w-slot each lands in, and 1 where it
    wrapped past w^6 (and so takes a factor xi), else 0."""
    i, j = np.asarray(i), np.asarray(j)
    return (i + j) % 6, (i + j >= 6).astype(np.int64)


_SLOTS36, _WRAP36 = _fold(_I36, _J36)


def _gather(a, index: np.ndarray):
    """a[..., index, :, :] with a host index constant."""
    return a.index_select(-3, limbs.const(index, a))


def _accumulate(terms, slots: np.ndarray, wrap: np.ndarray):
    """Sum sparse products into the 6 w-slots, folding w^6 = xi: the
    wrapped terms times xi, then each term added into its slot."""
    folded = torch.where(limbs.const(wrap, terms)[:, None, None] != 0,
                         fq2_mul_by_xi(terms), terms)
    acc = torch.zeros(terms.shape[:-3] + (6,) + terms.shape[-2:],
                      dtype=terms.dtype, device=terms.device)
    return limbs.renorm(acc.index_add_(-3, limbs.const(slots, terms), folded))


def fq12_mul(a, b):
    """Schoolbook over w-slots: c_k = sum_{i+j==k mod 6} xi^[i+j>=6] a_i b_j.
    All 36 Fq2 products (108 limb lanes) run in one batched call."""
    t = fq2_mul(_gather(a, _I36), _gather(b, _J36))
    return _accumulate(t, _SLOTS36, _WRAP36)


# tower <-> w-slot permutation: (c0.c0, c0.c1, c0.c2) = slots (0, 2, 4),
# (c1.c0, c1.c1, c1.c2) = slots (1, 3, 5)
_TOWER_LO = np.array([0, 2, 4])
_TOWER_HI = np.array([1, 3, 5])
# slot interleave for rebuilding the w-basis from tower halves: the
# concatenated [c0(3), c1(3)] layout maps back to w-slots via this gather
_INTERLEAVE = np.array([0, 3, 1, 4, 2, 5])


def fq12_square(a):
    """Complex squaring via the tower split (mirror of fields.py
    Fq12.square): 2 Fq6 products = 12 Fq2 products — 3x fewer limb lanes
    than schoolbook fq12_mul(a, a)."""
    c0 = _gather(a, _TOWER_LO)
    c1 = _gather(a, _TOWER_HI)
    t0 = fq6_mul(c0, c1)
    m = fq6_mul(limbs.renorm(c0 + c1),
                limbs.renorm(c0 + fq6_mul_by_v(c1)))
    r0 = m - t0 - fq6_mul_by_v(t0)
    r1 = t0 + t0
    out = torch.cat([r0, r1], dim=-3)
    return limbs.renorm(_gather(out, _INTERLEAVE))


_LINE_SLOTS = (0, 3, 5)
_LINE_PAIRS = [(i, j) for j in _LINE_SLOTS for i in range(6)]
_LINE_I = np.array([i for i, _ in _LINE_PAIRS])
_SLOTS_LINE, _WRAP_LINE = _fold(_LINE_I, [j for _, j in _LINE_PAIRS])


def fq12_mul_line(f, l0, l3, l5):
    """Multiply f by a sparse line l = l0 + l3*w^3 + l5*w^5 (the Miller-loop
    line shape; see pairing.py) — 18 Fq2 products in one batch."""
    ls = {0: l0, 3: l3, 5: l5}
    lhs = _gather(f, _LINE_I)
    rhs = torch.stack([ls[j] for _, j in _LINE_PAIRS], dim=-3)
    t = fq2_mul(lhs, rhs)
    return _accumulate(t, _SLOTS_LINE, _WRAP_LINE)


_CONJ_SIGN = np.ones((6, 1, 1), dtype=np.int64)
_CONJ_SIGN[1::2] = -1


def fq12_conj(a):
    """f^(p^6): negate odd w-powers."""
    return a * limbs.const(_CONJ_SIGN, a)


def fq12_inv(a):
    """Tower inversion (mirror of fields.py Fq12.inv)."""
    c0 = _gather(a, _TOWER_LO)
    c1 = _gather(a, _TOWER_HI)
    factor = fq6_inv(
        limbs.renorm(fq6_square(c0) - fq6_mul_by_v(fq6_square(c1))))
    r0 = fq6_mul(c0, factor)
    r1 = -fq6_mul(c1, factor)
    # (r0, r1) are the tower halves: interleave them back into w-slots
    return _gather(torch.cat([r0, r1], dim=-3), _INTERLEAVE)


def fq12_canonical(a):
    return limbs.canonical(a)


def fq12_eq(a, b):
    eq = limbs.canonical(a) == limbs.canonical(b)
    return eq.reshape(eq.shape[:-3] + (-1,)).all(dim=-1)


# ---------------------------------------------------------------------------
# Frobenius maps (coefficient tables computed from the oracle at import)
# ---------------------------------------------------------------------------


def _host_fq2(c0: int, c1: int) -> np.ndarray:
    return np.stack([limbs.host_to_mont(c0), limbs.host_to_mont(c1)])


def _frob_consts(power: int) -> np.ndarray:
    """gamma_k = xi^(k*(p^power - 1)/6) as Montgomery Fq2, k = 0..5."""
    xi = _oracle.Fq2(1, 1)
    e = (_oracle.P ** power - 1) // 6
    out = np.zeros((6, 2, limbs.N_LIMBS), dtype=np.int64)
    for k in range(6):
        g = xi.pow(k * e)
        out[k] = _host_fq2(g.c0, g.c1)
    return out


_FROB1_C = _frob_consts(1)
_FROB2_C = _frob_consts(2)


def fq12_frob1(a):
    """f^p: conjugate each Fq2 slot, multiply slot k by xi^(k(p-1)/6)."""
    return fq2_mul(fq2_conj(a), limbs.const(_FROB1_C, a))


def fq12_frob2(a):
    """f^(p^2): no conjugation (even power)."""
    return fq2_mul(a, limbs.const(_FROB2_C, a))


# ---------------------------------------------------------------------------
# Host conversion (tests + marshalling)
# ---------------------------------------------------------------------------

FQ12_ONE_LIMBS = np.zeros((6, 2, limbs.N_LIMBS), dtype=np.int64)
FQ12_ONE_LIMBS[0, 0] = limbs.MONT_ONE_LIMBS


def host_fq12_from_oracle(x) -> np.ndarray:
    """oracle Fq12 -> [6,2,16] Montgomery limb array (w-slot basis)."""
    slots = [x.c0.c0, x.c1.c0, x.c0.c1, x.c1.c1, x.c0.c2, x.c1.c2]
    out = np.zeros((6, 2, limbs.N_LIMBS), dtype=np.int64)
    for k, s in enumerate(slots):
        out[k] = _host_fq2(s.c0, s.c1)
    return out


def host_fq12_to_oracle(arr):
    """[6,2,16] limb array (any lazy representation) -> oracle Fq12."""
    arr = np.asarray(arr)
    vals = [[_host_from_any(arr[k, c]) for c in range(2)] for k in range(6)]
    f2 = [_oracle.Fq2(v[0], v[1]) for v in vals]
    return _oracle.Fq12(
        _oracle.Fq6(f2[0], f2[2], f2[4]),
        _oracle.Fq6(f2[1], f2[3], f2[5]),
    )


def _host_from_any(a) -> int:
    """Limb array in any lazy signed representation -> int residue,
    un-Montgomeryfied."""
    return (limbs.limbs_to_int(a) * pow(limbs.R_INT, -1, limbs.P_INT)) \
        % limbs.P_INT
