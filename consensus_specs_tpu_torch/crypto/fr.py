"""BLS12-381 scalar field Fr and its FFT machinery — the polynomial
substrate for KZG commitments (eip4844) and DAS erasure coding.

From-scratch host oracle (reference capability: the field/FFT math the
eip4844/das specs import from research code).  A verbatim copy of
``consensus_specs_tpu/crypto/fr.py``: the port imports nothing of the
reference package.  r - 1 = 2^32 * odd, so
radix-2 FFTs exist for every power-of-two size up to 2^32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

# subgroup order of BLS12-381 (the "BLS_MODULUS" of eip4844)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# 7 generates the multiplicative group of Fr (smallest generator)
_GENERATOR = 7
_TWO_ADICITY = 32
assert (R - 1) % (1 << _TWO_ADICITY) == 0

# primitive 2^32-th root of unity
_ROOT_2_32 = pow(_GENERATOR, (R - 1) >> _TWO_ADICITY, R)


def root_of_unity(order: int) -> int:
    """Primitive ``order``-th root of unity (order a power of two)."""
    assert order & (order - 1) == 0 and 0 < order <= (1 << _TWO_ADICITY)
    return pow(_ROOT_2_32, (1 << _TWO_ADICITY) // order, R)


def fft(values: Sequence[int], inv: bool = False) -> List[int]:
    """Radix-2 NTT over Fr; ``inv`` gives the inverse transform."""
    n = len(values)
    assert n & (n - 1) == 0
    if n == 1:
        return [values[0] % R]
    w = root_of_unity(n)
    if inv:
        w = pow(w, R - 2, R)
    out = _fft_core([v % R for v in values], w)
    if inv:
        n_inv = pow(n, R - 2, R)
        out = [v * n_inv % R for v in out]
    return out


def _fft_core(values: List[int], w: int) -> List[int]:
    n = len(values)
    if n == 1:
        return values
    even = _fft_core(values[0::2], w * w % R)
    odd = _fft_core(values[1::2], w * w % R)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % R
        out[k] = (even[k] + t) % R
        out[k + n // 2] = (even[k] - t) % R
        wk = wk * w % R
    return out


def ifft(values: Sequence[int]) -> List[int]:
    return fft(values, inv=True)


def reverse_bit_order(i: int, order: int) -> int:
    """Bit-reversal permutation index (das-core.md reverse_bit_order)."""
    assert order & (order - 1) == 0
    bits = order.bit_length() - 1
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def reverse_bit_order_list(elements: Sequence) -> list:
    order = len(elements)
    return [elements[reverse_bit_order(i, order)] for i in range(order)]


# --- polynomial helpers ------------------------------------------------------


def poly_mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            out[i + j] = (out[i + j] + ai * bj) % R
    return out


def poly_eval(poly: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(poly):
        acc = (acc * x + c) % R
    return acc


def zero_poly(missing_positions: Sequence[int], order: int) -> List[int]:
    """Vanishing polynomial with roots at w^p for the given positions."""
    w = root_of_unity(order)
    poly = [1]
    for p in missing_positions:
        poly = poly_mul(poly, [(-pow(w, p, R)) % R, 1])
    return poly


def recover_polynomial(samples: Sequence[Optional[int]]) -> List[int]:
    """Erasure recovery: given evaluations of a degree < n/2 polynomial on
    the order-n domain with at most n/2 erased (None) positions, recover
    ALL n evaluations (standard zero-poly method: E = D*Z on the domain,
    deconvolve on a coset).
    """
    n = len(samples)
    assert n & (n - 1) == 0
    missing = [i for i, s in enumerate(samples) if s is None]
    if not missing:
        return [s % R for s in samples]
    assert len(missing) <= n // 2, "too many erasures"

    z = zero_poly(missing, n) + [0] * (n - len(missing) - 1)
    z_evals = fft(z)
    # E(w^i) = D(w^i) * Z(w^i); erased positions contribute 0 = anything*0
    e_evals = [
        (0 if s is None else s) * z_evals[i] % R
        for i, s in enumerate(samples)
    ]
    e_poly = ifft(e_evals)

    # deconvolve on the coset k*w^i where Z never vanishes
    k = 31337 % R
    k_pows = [pow(k, i, R) for i in range(n)]
    e_coset = fft([c * k_pows[i] % R for i, c in enumerate(e_poly)])
    z_coset = fft([c * k_pows[i] % R for i, c in enumerate(z)])
    d_coset = [
        e * pow(zc, R - 2, R) % R for e, zc in zip(e_coset, z_coset)
    ]
    d_poly = ifft(d_coset)
    k_inv = pow(k, R - 2, R)
    d_poly = [c * pow(k_inv, i, R) % R for i, c in enumerate(d_poly)]
    recovered = fft(d_poly)

    for i, s in enumerate(samples):
        if s is not None:
            assert recovered[i] == s % R, "recovery inconsistent with inputs"
    return recovered
