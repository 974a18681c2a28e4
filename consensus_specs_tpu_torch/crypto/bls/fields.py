"""BLS12-381 field towers: Fq, Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
Fq12 = Fq6[w]/(w^2 - v), with xi = u + 1.

From-scratch implementation (the reference delegates to py_ecc; see
eth2spec/utils/bls.py:1-2).  Plain-int arithmetic with Karatsuba Fq2
multiplication — this is the host correctness oracle.
"""
from __future__ import annotations

# BLS12-381 parameters
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # subgroup order
X_PARAM = -0xD201000000010000  # BLS parameter x (negative)
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551  # noqa: E501 (RFC 9380 G2 h_eff)


class Fq:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return Fq(self.n + o.n)

    def __sub__(self, o):
        return Fq(self.n - o.n)

    def __mul__(self, o):
        return Fq(self.n * o.n)

    def __neg__(self):
        return Fq(-self.n)

    def square(self):
        return Fq(self.n * self.n)

    def inv(self):
        return Fq(pow(self.n, P - 2, P))

    def pow(self, e: int):
        return Fq(pow(self.n, e, P))

    def is_zero(self) -> bool:
        return self.n == 0

    def __eq__(self, o):
        return isinstance(o, Fq) and self.n == o.n

    def __hash__(self):
        return hash(self.n)

    def __repr__(self):
        return f"Fq(0x{self.n:x})"

    def sqrt(self):
        """Square root for p ≡ 3 (mod 4); None if not a square."""
        c = pow(self.n, (P + 1) // 4, P)
        if c * c % P == self.n:
            return Fq(c)
        return None

    def sgn0(self) -> int:
        return self.n & 1

    @staticmethod
    def zero():
        return Fq(0)

    @staticmethod
    def one():
        return Fq(1)


class Fq2:
    """c0 + c1*u with u^2 = -1.  Coefficients stored as raw ints mod P."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        # karatsuba: c1 = (a0+a1)(b0+b1) - t0 - t1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        a0, a1 = self.c0, self.c1
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def mul_by_xi(self):
        """Multiply by xi = 1 + u."""
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def inv(self):
        a0, a1 = self.c0, self.c1
        norm = (a0 * a0 + a1 * a1) % P
        ninv = pow(norm, P - 2, P)
        return Fq2(a0 * ninv, -a1 * ninv)

    def pow(self, e: int):
        result = FQ2_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2(0x{self.c0:x}, 0x{self.c1:x})"

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for m=2 (sign of the 'least' non-zero coeff)."""
        sign_0 = self.c0 & 1
        zero_0 = self.c0 == 0
        sign_1 = self.c1 & 1
        return sign_0 | (zero_0 & sign_1)

    def sqrt(self):
        """Square root in Fq2 (q = p^2 ≡ 9 mod 16); None if not a square.

        RFC 9380 §I.3: candidate c = a^((q+7)/16); the true root (if any)
        is c times one of {1, sqrt(-1), sqrt(sqrt(-1)), sqrt(-sqrt(-1))}.
        """
        c = self.pow(_SQRT_EXP)
        for zeta in _SQRT_ADJUSTMENTS:
            cand = c * zeta
            if cand.square() == self:
                return cand
        return None

    @staticmethod
    def zero():
        return FQ2_ZERO

    @staticmethod
    def one():
        return FQ2_ONE


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
FQ2_U = Fq2(0, 1)

_SQRT_EXP = (P * P + 7) // 16

# 8th roots of unity needed by Fq2.sqrt: 1, u (= sqrt(-1)), sqrt(u), sqrt(-u).
# sqrt(u) = a(1+u) with a^2 = 1/2, or a(1-u) with a^2 = -1/2, whichever exists.
def _compute_sqrt_u() -> Fq2:
    a = Fq(pow(2, P - 2, P)).sqrt()  # sqrt(1/2)
    if a is not None:
        cand = Fq2(a.n, a.n)
    else:
        a = Fq((P - pow(2, P - 2, P)) % P).sqrt()  # sqrt(-1/2)
        assert a is not None
        cand = Fq2(a.n, (-a.n) % P)
    assert cand.square() == FQ2_U
    return cand


_SQRT_U = _compute_sqrt_u()
_SQRT_NEG_U = _SQRT_U * FQ2_U  # (sqrt(u)*u)^2 = -u
_SQRT_ADJUSTMENTS = (FQ2_ONE, FQ2_U, _SQRT_U, _SQRT_NEG_U)


class Fq6:
    """c0 + c1*v + c2*v^2 over Fq2, v^3 = xi = 1+u."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fq6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_xi()
        t1 = a2.square().mul_by_xi() - a0 * a1
        t2 = a1.square() - a0 * a2
        factor = (a0 * t0 + (a2 * t1).mul_by_xi() + (a1 * t2).mul_by_xi()).inv()
        return Fq6(t0 * factor, t1 * factor, t2 * factor)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))

    @staticmethod
    def zero():
        return FQ6_ZERO

    @staticmethod
    def one():
        return FQ6_ONE


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


class Fq12:
    """c0 + c1*w over Fq6, w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0 = c0
        self.c1 = c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        a0, a1 = self.c0, self.c1
        t0 = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_v()) - t0 - t0.mul_by_v()
        return Fq12(c0, t0 + t0)

    def conjugate(self):
        """f^(p^6): w -> -w."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        a0, a1 = self.c0, self.c1
        factor = (a0.square() - a1.square().mul_by_v()).inv()
        return Fq12(a0 * factor, -a1 * factor)

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        result = FQ12_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    @staticmethod
    def zero():
        return FQ12_ZERO

    @staticmethod
    def one():
        return FQ12_ONE


FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)


def fq12_from_fq2(x: Fq2) -> Fq12:
    """Embed Fq2 scalar into Fq12 (as c0 of c0 of c0... careful: Fq2 sits at
    the bottom of the tower, so the embedding is (x, 0, 0) + 0*w)."""
    return Fq12(Fq6(x, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq12_from_fq(x: int) -> Fq12:
    return fq12_from_fq2(Fq2(x, 0))


# w and its inverse powers, used by the G2 untwist map
# w^2 = v, so as an Fq12 element w = (0, 1·1) i.e. c1 = Fq6.one()
FQ12_W = Fq12(FQ6_ZERO, FQ6_ONE)
FQ12_W2 = FQ12_W.square()           # = v embedded
FQ12_W3 = FQ12_W2 * FQ12_W
FQ12_W2_INV = FQ12_W2.inv()
FQ12_W3_INV = FQ12_W3.inv()
