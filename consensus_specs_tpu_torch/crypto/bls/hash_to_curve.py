"""Hash-to-curve for BLS12-381 G2: BLS12381G2_XMD:SHA-256_SSWU_RO
(RFC 9380 / draft-irtf-cfrg-hash-to-curve), the suite the spec's BLS
ciphersuite requires (reference: via py_ecc's hash_to_G2; DST in
eth2spec/utils/bls.py usage of the G2 proof-of-possession scheme).

Pipeline: expand_message_xmd(SHA-256) -> hash_to_field(Fq2, count=2)
-> simplified-SWU on the 3-isogenous curve E2' -> iso_map -> add ->
clear_cofactor(h_eff).  Every stage is internally validated: SSWU output
must lie on E2', the isogeny image on E2, and the cleared point in the
r-subgroup — a wrong constant fails loudly rather than silently.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

from .curve import B_G2, Point
from .fields import FQ2_ONE, Fq2, H_EFF_G2, P

# -- expand_message_xmd (RFC 9380 §5.3.1) -----------------------------------

_B_IN_BYTES = 32  # SHA-256 output
_S_IN_BYTES = 64  # SHA-256 block size


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    assert len(dst) <= 255
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    assert ell <= 255
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _S_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b_0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b_vals = [hashlib.sha256(b_0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        tmp = bytes(a ^ b for a, b in zip(b_0, b_vals[-1]))
        b_vals.append(hashlib.sha256(tmp + bytes([i]) + dst_prime).digest())
    return b"".join(b_vals)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes) -> list:
    """RFC 9380 §5.2 with m=2, L=64."""
    L = 64
    len_in_bytes = count * 2 * L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            offset = L * (j + i * 2)
            coeffs.append(int.from_bytes(uniform[offset : offset + L], "big") % P)
        out.append(Fq2(coeffs[0], coeffs[1]))
    return out


# -- simplified SWU on E2': y^2 = x^3 + A'x + B' (RFC 9380 §6.6.2) ----------

_A_PRIME = Fq2(0, 240)
_B_PRIME = Fq2(1012, 1012)
_Z = Fq2(-2 % P, -1 % P)  # -(2 + u)


def _sswu(u: Fq2) -> Tuple[Fq2, Fq2]:
    """Map a field element to a point on the isogenous curve E2'."""
    z_u2 = _Z * u.square()
    tv = z_u2.square() + z_u2
    if tv.is_zero():
        x1 = _B_PRIME * (_Z * _A_PRIME).inv()
    else:
        x1 = (-_B_PRIME) * _A_PRIME.inv() * (FQ2_ONE + tv.inv())
    gx1 = x1.square() * x1 + _A_PRIME * x1 + _B_PRIME
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = z_u2 * x1
        gx2 = x2.square() * x2 + _A_PRIME * x2 + _B_PRIME
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither gx1 nor gx2 is square (impossible)"
        x, y = x2, y2
    if u.sgn0() != y.sgn0():
        y = -y
    # internal validation: on E2'
    assert y.square() == x.square() * x + _A_PRIME * x + _B_PRIME
    return (x, y)


# -- 3-isogeny E2' -> E2 (RFC 9380 Appendix E.3) ----------------------------

_K1 = (
    Fq2(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    Fq2(
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    Fq2(
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
)
_K2 = (
    Fq2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    Fq2(
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    Fq2(1, 0),
)
_K3 = (
    Fq2(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    Fq2(
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    Fq2(
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
)
_K4 = (
    Fq2(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    Fq2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    Fq2(
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    Fq2(1, 0),
)


def _horner(coeffs, x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def _iso_map(x: Fq2, y: Fq2) -> Tuple[Fq2, Fq2]:
    x_num = _horner(_K1, x)
    x_den = _horner(_K2, x)
    y_num = _horner(_K3, x)
    y_den = _horner(_K4, x)
    xo = x_num * x_den.inv()
    yo = y * y_num * y_den.inv()
    # internal validation: image lies on E2
    assert yo.square() == xo.square() * xo + B_G2, "isogeny image off-curve"
    return (xo, yo)


# -- full hash_to_G2 ---------------------------------------------------------

DST_G2_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


def hash_to_g2(msg: bytes, dst: bytes = DST_G2_POP) -> Point:
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    p0 = _iso_map(*_sswu(u0))
    p1 = _iso_map(*_sswu(u1))
    q0 = Point(p0[0], p0[1], FQ2_ONE, B_G2)
    q1 = Point(p1[0], p1[1], FQ2_ONE, B_G2)
    r = (q0 + q1).mul(H_EFF_G2)
    assert r.in_subgroup(), "cofactor clearing failed"
    return r
