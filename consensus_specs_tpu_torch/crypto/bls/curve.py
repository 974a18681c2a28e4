"""BLS12-381 curve groups G1 (over Fq) and G2 (over Fq2).

Short-Weierstrass y^2 = x^3 + b with a = 0; Jacobian coordinates for
inversion-free adds/doubles; ZCash-format compressed serialization
(48-byte G1 pubkeys / 96-byte G2 signatures as used by the spec's
BLSPubkey/BLSSignature types, phase0/beacon-chain.md:152-170).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

from .fields import Fq, Fq2, FQ2_ONE, P, R

# curve coefficients
B_G1 = Fq(4)
B_G2 = Fq2(4, 4)  # 4 * (1 + u)

# generators
G1_X = Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB)
G1_Y = Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)
G2_X = Fq2(
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = Fq2(
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


class Point:
    """Jacobian point (X, Y, Z); Z == 0 means infinity.  Generic over the
    coordinate field (Fq for G1, Fq2 for G2)."""

    __slots__ = ("x", "y", "z", "b")

    def __init__(self, x, y, z, b):
        self.x = x
        self.y = y
        self.z = z
        self.b = b

    @staticmethod
    def infinity(field_one, b) -> "Point":
        zero = field_one - field_one
        return Point(field_one, field_one, zero, b)

    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def double(self) -> "Point":
        if self.is_infinity():
            return self
        X, Y, Z = self.x, self.y, self.z
        A = X.square()
        Bv = Y.square()
        C = Bv.square()
        D = ((X + Bv).square() - A - C)
        D = D + D
        E = A + A + A
        F = E.square()
        X3 = F - D - D
        eight_c = C + C
        eight_c = eight_c + eight_c
        eight_c = eight_c + eight_c
        Y3 = E * (D - X3) - eight_c
        Z3 = Y * Z
        Z3 = Z3 + Z3
        return Point(X3, Y3, Z3, self.b)

    def __add__(self, other: "Point") -> "Point":
        if self.is_infinity():
            return other
        if other.is_infinity():
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = other.x, other.y, other.z
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        if U1 == U2:
            if S1 == S2:
                return self.double()
            return Point.infinity(_one_like(X1), self.b)
        H = U2 - U1
        I = (H + H).square()
        J = H * I
        rr = S2 - S1
        rr = rr + rr
        V = U1 * I
        X3 = rr.square() - J - V - V
        S1J = S1 * J
        Y3 = rr * (V - X3) - S1J - S1J
        Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
        return Point(X3, Y3, Z3, self.b)

    def __neg__(self) -> "Point":
        return Point(self.x, -self.y, self.z, self.b)

    def __sub__(self, other: "Point") -> "Point":
        return self + (-other)

    def mul(self, k: int) -> "Point":
        if k < 0:
            return (-self).mul(-k)
        result = Point.infinity(_one_like(self.x), self.b)
        addend = self
        while k:
            if k & 1:
                result = result + addend
            addend = addend.double()
            k >>= 1
        return result

    def to_affine(self) -> Optional[Tuple]:
        """(x, y) or None for infinity."""
        if self.is_infinity():
            return None
        zinv = self.z.inv()
        zinv2 = zinv.square()
        return (self.x * zinv2, self.y * zinv2 * zinv)

    def __eq__(self, other):
        if not isinstance(other, Point):
            return NotImplemented
        if self.is_infinity() or other.is_infinity():
            return self.is_infinity() and other.is_infinity()
        # X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3
        Z1Z1 = self.z.square()
        Z2Z2 = other.z.square()
        return (
            self.x * Z2Z2 == other.x * Z1Z1
            and self.y * Z2Z2 * other.z == other.y * Z1Z1 * self.z
        )

    def __hash__(self):
        aff = self.to_affine()
        return hash(aff and (aff[0], aff[1]))

    def on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y = self.to_affine()
        b = self.b
        return y.square() == x * x * x + b

    def in_subgroup(self) -> bool:
        return self.mul(R).is_infinity()


def _one_like(v):
    return Fq(1) if isinstance(v, Fq) else FQ2_ONE


def g1_generator() -> Point:
    return Point(G1_X, G1_Y, Fq(1), B_G1)


def g2_generator() -> Point:
    return Point(G2_X, G2_Y, FQ2_ONE, B_G2)


def g1_infinity() -> Point:
    return Point.infinity(Fq(1), B_G1)


def g2_infinity() -> Point:
    return Point.infinity(FQ2_ONE, B_G2)


# ---------------------------------------------------------------------------
# ZCash compressed serialization
# flags in the top 3 bits of the first byte:
#   bit7 C_flag (always 1: compressed), bit6 I_flag (infinity),
#   bit5 S_flag (sign: y > (p-1)/2 lexicographically)
# ---------------------------------------------------------------------------

_HALF_P = (P - 1) // 2


def g1_to_bytes(pt: Point) -> bytes:
    if pt.is_infinity():
        return bytes([0xC0]) + b"\x00" * 47
    x, y = pt.to_affine()
    flags = 0x80 | (0x20 if y.n > _HALF_P else 0)
    raw = x.n.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g2_to_bytes(pt: Point) -> bytes:
    if pt.is_infinity():
        return bytes([0xC0]) + b"\x00" * 95
    (x, y) = pt.to_affine()
    # sign from y.c1, falling back to y.c0 when c1 == 0
    if y.c1 != 0:
        s = y.c1 > _HALF_P
    else:
        s = y.c0 > _HALF_P
    flags = 0x80 | (0x20 if s else 0)
    raw1 = x.c1.to_bytes(48, "big")
    raw0 = x.c0.to_bytes(48, "big")
    return bytes([raw1[0] | flags]) + raw1[1:] + raw0


class DeserializationError(Exception):
    pass


def g1_from_bytes(data: bytes) -> Point:
    """Decompress + validate on-curve (subgroup check is separate)."""
    if len(data) != 48:
        raise DeserializationError("G1 point must be 48 bytes")
    c_flag = (data[0] >> 7) & 1
    i_flag = (data[0] >> 6) & 1
    s_flag = (data[0] >> 5) & 1
    if c_flag != 1:
        raise DeserializationError("uncompressed G1 not supported")
    if i_flag:
        if any(data[1:]) or (data[0] & 0x3F):
            raise DeserializationError("malformed infinity encoding")
        return g1_infinity()
    xn = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if xn >= P:
        raise DeserializationError("x >= p")
    x = Fq(xn)
    y2 = x * x * x + B_G1
    y = y2.sqrt()
    if y is None:
        raise DeserializationError("x not on curve")
    if (y.n > _HALF_P) != bool(s_flag):
        y = -y
    return Point(x, y, Fq(1), B_G1)


def g2_from_bytes(data: bytes) -> Point:
    if len(data) != 96:
        raise DeserializationError("G2 point must be 96 bytes")
    c_flag = (data[0] >> 7) & 1
    i_flag = (data[0] >> 6) & 1
    s_flag = (data[0] >> 5) & 1
    if c_flag != 1:
        raise DeserializationError("uncompressed G2 not supported")
    if i_flag:
        if any(data[1:]) or (data[0] & 0x3F):
            raise DeserializationError("malformed infinity encoding")
        return g2_infinity()
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise DeserializationError("x >= p")
    x = Fq2(x0, x1)
    y2 = x * x * x + B_G2
    y = y2.sqrt()
    if y is None:
        raise DeserializationError("x not on curve")
    if y.c1 != 0:
        cur_sign = y.c1 > _HALF_P
    else:
        cur_sign = y.c0 > _HALF_P
    if cur_sign != bool(s_flag):
        y = -y
    return Point(x, y, FQ2_ONE, B_G2)


@lru_cache(maxsize=4096)
def pubkey_to_point(pubkey: bytes) -> Point:
    """Deserialize + subgroup-check a 48-byte pubkey (cached: the same
    validator pubkeys recur across every attestation)."""
    pt = g1_from_bytes(bytes(pubkey))
    if not pt.is_infinity() and not pt.in_subgroup():
        raise DeserializationError("pubkey not in subgroup")
    return pt


@lru_cache(maxsize=4096)
def signature_to_point(sig: bytes) -> Point:
    pt = g2_from_bytes(bytes(sig))
    if not pt.is_infinity() and not pt.in_subgroup():
        raise DeserializationError("signature not in subgroup")
    return pt
