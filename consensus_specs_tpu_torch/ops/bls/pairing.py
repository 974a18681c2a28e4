"""Batched optimal-ate pairing product check on BLS12-381, in torch and CUDA.

Port of ``consensus_specs_tpu/ops/bls_jax/pairing.py``.  The verification
primitive is ``pairs_product_is_one``: given K pairs (P_i in G1, Q_i in
G2) per batch item, decide prod_i e(P_i, Q_i) == 1 — exactly the check
BLS Verify / FastAggregateVerify / AggregateVerify reduce to
(crypto/bls/ciphersuite.py).

Design (vs the affine/untwist oracle in crypto/bls/pairing.py):
  * Q stays on the twist E'(Fq2) in homogeneous projective (X, Y, Z), so
    the Miller loop is inversion-free.  Lines are evaluated in scaled
    form — Fq2 scalar factors are annihilated by the final exponentiation
    — giving sparse lines with w-slots {0, 3, 5}:
      tangent at T=(X,Y,Z), evaluated at P=(x_P, y_P):
        l = -y_P*(2YZ^2)*xi + (2Y^2*Z - 3X^3) w^3 + x_P*(3X^2*Z) w^5
      chord through T and affine Q=(x2,y2), theta = Y - y2*Z,
      lam = X - x2*Z:
        l = -y_P*lam*xi + (y2*lam - theta*x2) w^3 + x_P*theta w^5
  * x = -0xd201000000010000 has only 5 set bits after the leading 1, so
    the loop is runs of pure doublings with 5 add-steps between them.
    Each run of doublings is ONE launch of K4 (``csrc/bls_miller.cu``)
    on the card, and each squaring chain of the final exponentiation ONE
    launch of K5, one thread block an item running the step's table of
    phases (``schedule.py``); the rest is torch on ``limbs.mul`` (K3).
    ``_dbl_run`` and ``_sq_run`` are the wrappers: a CUDA tensor launches
    the kernel or raises ``KernelError``, a CPU tensor runs
    ``_dbl_run_plain`` / ``_sq_run_plain``, the plain torch versions.
    x < 0 via final conjugation, as in the oracle (crypto/bls/pairing.py).
  * Final exponentiation: easy part, then the Hayashida-Hayasaka-Teruya
    decomposition  3*hard = (x-1)^2 (x+p) (x^2+p^2-1) + 3.  Computing
    f^(3*hard) instead of f^hard is sound for the ==1 check because
    gcd(3, r) = 1 (cubing is a bijection on the order-r subgroup).  The
    integer identity is checked exactly in the tests.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops.sha256 import KernelError

from . import limbs, tower

X_ABS = 0xD201000000010000
_BITS = [int(c) for c in bin(X_ABS)[3:]]  # 63 bits after the leading 1
# (run_of_doublings, then_add?) segments; |x| has 5 set bits after the lead
_SEGMENTS = []
_run = 0
for _b in _BITS:
    _run += 1
    if _b:
        _SEGMENTS.append((_run, True))
        _run = 0
if _run:
    _SEGMENTS.append((_run, False))
assert sum(n for n, _ in _SEGMENTS) == 63
assert sum(1 for _, add in _SEGMENTS if add) == 5

_MONT_ONE_FQ2 = np.zeros((2, limbs.N_LIMBS), dtype=np.int64)
_MONT_ONE_FQ2[0] = limbs.MONT_ONE_LIMBS

# The kernels take at most this many pairs an item (the verify family
# always has two)
MAX_PAIRS = 4

# Fq products (limbs.mul lanes) of the kernels' steps, for their bounds in
# chip_smoke.py: an Fq12 squaring is 2 Fq6 products of 6 Karatsuba Fq2
# products; a doubling step adds, for each pair, the point doubling and
# its line (5 Fq2 squarings of 2, 11 Fq2 products of 3, 2 scalings of 2)
# and the sparse line product (18 Fq2 products of 3)
PRODUCTS_FQ12_SQUARE = 2 * 6 * 3
PRODUCTS_DBL_STEP_PER_PAIR = (5 * 2 + 11 * 3 + 2 * 2) + 18 * 3


def _scale(a, s):
    """Fq2 [...,2,16] times Fq scalar [...,16] (both Montgomery)."""
    return limbs.mul(a, s[..., None, :])


def _dbl_step(X, Y, Z, px, py):
    """Projective doubling on the twist + scaled tangent line at P.
    Returns (X3, Y3, Z3, l0, l3, l5)."""
    sq, mul, xi = tower.fq2_square, tower.fq2_mul, tower.fq2_mul_by_xi
    rn = limbs.renorm
    XX = sq(X)
    YY = sq(Y)
    S = mul(Y, Z)
    W = XX + XX + XX                       # 3X^2
    B = mul(mul(X, Y), S)                  # XYS
    H = rn(sq(W) - 8 * B)                  # W^2 - 8B
    SS = sq(S)
    X3 = rn(2 * mul(H, S))
    Y3 = rn(mul(W, rn(4 * B - H)) - 8 * sq(mul(Y, S)))
    Z3 = rn(8 * mul(SS, S))
    beta = 2 * mul(S, Z)                   # 2YZ^2
    l0 = -_scale(xi(beta), py)
    l3 = rn(2 * mul(YY, Z) - 3 * mul(XX, X))
    l5 = _scale(rn(3 * mul(XX, Z)), px)
    return X3, Y3, Z3, l0, l3, l5


def _add_step(X, Y, Z, qx, qy, px, py):
    """Mixed addition T + Q (Q affine on the twist) + scaled chord line.
    Returns (X3, Y3, Z3, l0, l3, l5)."""
    sq, mul, xi = tower.fq2_square, tower.fq2_mul, tower.fq2_mul_by_xi
    rn = limbs.renorm
    theta = rn(Y - mul(qy, Z))
    lam = rn(X - mul(qx, Z))
    ll = sq(lam)
    lll = mul(ll, lam)
    llX = mul(ll, X)
    F = rn(mul(sq(theta), Z) + lll - 2 * llX)
    X3 = mul(lam, F)
    Y3 = rn(mul(theta, rn(llX - F)) - mul(lll, Y))
    Z3 = mul(lll, Z)
    l0 = -_scale(xi(lam), py)
    l3 = rn(mul(qy, lam) - mul(theta, qx))
    l5 = _scale(theta, px)
    return X3, Y3, Z3, l0, l3, l5


# ---------------------------------------------------------------------------
# the doubling run (K4) and the squaring run (K5), with their plain versions
# ---------------------------------------------------------------------------


def _dbl_run_step(f, X, Y, Z, px, py):
    """One Miller doubling step for K pairs: T <- 2T, f <- f^2 * prod_k
    line_k, the lines applied in pair order.  K4's schedule is recorded
    from this function (``schedule.py``)."""
    X, Y, Z, l0, l3, l5 = _dbl_step(X, Y, Z, px, py)
    f = tower.fq12_square(f)
    for k in range(px.shape[0]):
        f = tower.fq12_mul_line(f, l0[k], l3[k], l5[k])
    return f, X, Y, Z


def _dbl_run_plain(f, X, Y, Z, px, py, n: int):
    """K4's plain version: n Miller doubling steps."""
    for _ in range(n):
        f, X, Y, Z = _dbl_run_step(f, X, Y, Z, px, py)
    return f, X, Y, Z


def _sq_run_plain(acc, n: int):
    """K5's plain version: acc^(2^n) in Fq12."""
    for _ in range(n):
        acc = tower.fq12_square(acc)
    return acc


counts = {"miller_dbl_run": 0, "fq12_sq_run": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name} must be int64 limbs, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")


def _dbl_run(f, X, Y, Z, px, py, n: int):
    """n Miller doubling steps for K pairs of B items: f ``[B, 6, 2, 16]``;
    X, Y, Z ``[K, B, 2, 16]``; px, py ``[K, B, 16]``.  CUDA launches K4;
    the CPU runs ``_dbl_run_plain``."""
    K, B = px.shape[0], px.shape[1]
    dev = f.device
    _check("f", f, (B, 6, 2, limbs.N_LIMBS), dev)
    for name, t in (("X", X), ("Y", Y), ("Z", Z)):
        _check(name, t, (K, B, 2, limbs.N_LIMBS), dev)
    for name, t in (("px", px), ("py", py)):
        _check(name, t, (K, B, limbs.N_LIMBS), dev)
    if dev.type == "cuda":
        return _launch_k4(f, X, Y, Z, px, py, n)
    if dev.type == "cpu":
        return _dbl_run_plain(f, X, Y, Z, px, py, n)
    raise ValueError(f"_dbl_run runs on cuda or cpu, not {dev}")


def _sq_run(acc, n: int):
    """acc^(2^n) for acc ``[B, 6, 2, 16]``.  CUDA launches K5; the CPU runs
    ``_sq_run_plain``."""
    _check("acc", acc, (acc.shape[0], 6, 2, limbs.N_LIMBS), acc.device)
    if acc.device.type == "cuda":
        return _launch_k5(acc, n)
    if acc.device.type == "cpu":
        return _sq_run_plain(acc, n)
    raise ValueError(f"_sq_run runs on cuda or cpu, not {acc.device}")


# -- K4 and K5: the CUDA kernels ----------------------------------------------

_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
CU_SOURCES = (os.path.join(_CSRC_DIR, "bls_miller.cu"),)
HEADERS = tuple(os.path.join(_CSRC_DIR, name)
                for name in ("bls_miller_schedule.cuh", "bls_fq.cuh"))
_lib = None


def build_kernel() -> str:
    """Compile K4 and K5 with one nvcc call for sm_90a into the build
    directory (once per source digest) and return the library's path; the
    compiler's report is kept beside it as ``<library>.log``."""
    return _build.build_cuda("bls_miller", CU_SOURCES, HEADERS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(build_kernel())
        except (OSError, RuntimeError) as exc:
            raise KernelError(f"the Miller-loop kernels are not available: "
                              f"{exc}") from exc
        ptr = ctypes.c_void_p
        lib.miller_dbl_run_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        lib.miller_dbl_run_launch.restype = ctypes.c_int
        lib.fq12_sq_run_launch.argtypes = [
            ptr, ptr, ctypes.c_int, ctypes.c_int, ptr]
        lib.fq12_sq_run_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch_k4(f, X, Y, Z, px, py, n: int):
    K, B = px.shape[0], px.shape[1]
    if not 1 <= K <= MAX_PAIRS:
        raise ValueError(f"K4 takes 1 to {MAX_PAIRS} pairs an item, got {K}")
    ins = [t.contiguous() for t in (f, X, Y, Z, px, py)]
    outs = [torch.empty_like(t) for t in ins[:4]]
    lib = _library()
    with torch.cuda.device(f.device):
        rc = lib.miller_dbl_run_launch(
            *(_ptr(t) for t in ins), *(_ptr(t) for t in outs), K, B, int(n),
            ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream))
    if rc != 0:
        raise KernelError(f"K4 launch failed with CUDA error {rc}")
    counts["miller_dbl_run"] += 1
    return tuple(outs)


def _launch_k5(acc, n: int):
    acc = acc.contiguous()
    out = torch.empty_like(acc)
    lib = _library()
    with torch.cuda.device(acc.device):
        rc = lib.fq12_sq_run_launch(
            _ptr(acc), _ptr(out), acc.shape[0], int(n),
            ctypes.c_void_p(torch.cuda.current_stream(acc.device).cuda_stream))
    if rc != 0:
        raise KernelError(f"K5 launch failed with CUDA error {rc}")
    counts["fq12_sq_run"] += 1
    return out


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _add_apply(f, X, Y, Z, qx, qy, px, py):
    """One Miller add step for all K pairs."""
    K = px.shape[0]
    X, Y, Z, l0, l3, l5 = _add_step(X, Y, Z, qx, qy, px, py)
    for k in range(K):
        f = tower.fq12_mul_line(f, l0[k], l3[k], l5[k])
    return f, X, Y, Z


def _is_one(res):
    return tower.fq12_eq(res, limbs.const(tower.FQ12_ONE_LIMBS, res))


def _miller_product(px, py, qx, qy):
    """Miller loop f_{|x|}(product of K pairs), conjugated for x < 0.

    px, py: [K, B, 16] Fq (Montgomery); qx, qy: [K, B, 2, 16] Fq2.
    Returns f: [B, 6, 2, 16].
    """
    X, Y = qx, qy
    Z = torch.zeros_like(qx) + limbs.const(_MONT_ONE_FQ2, qx)
    f = (torch.zeros((qx.shape[1], 6, 2, limbs.N_LIMBS), dtype=torch.int64,
                     device=qx.device) + limbs.const(tower.FQ12_ONE_LIMBS, qx))
    for n_dbl, has_add in _SEGMENTS:
        f, X, Y, Z = _dbl_run(f, X, Y, Z, px, py, n_dbl)
        if has_add:
            f, X, Y, Z = _add_apply(f, X, Y, Z, qx, qy, px, py)
    return tower.fq12_conj(f)


def lane_product(px, py, qx, qy):
    """``_miller_product`` of the C pairs of ONE item, at most
    ``MAX_PAIRS`` pairs a K4 launch: px, py ``[C, 1, 16]``; qx, qy
    ``[C, 1, 2, 16]``; returns f ``[1, 6, 2, 16]``.

    K4 takes 1 to ``MAX_PAIRS`` pairs an item, so for C above that the C
    pairs run as ``C // MAX_PAIRS`` items of ``MAX_PAIRS`` consecutive
    pairs, plus one item of the remaining pairs, and the items' values are
    multiplied in lane order.  The value equals the one-item product as an
    Fq12 element (its limbs may differ): each pair's point and lines
    evolve alone, the squaring is multiplicative, and conjugation commutes
    with the product.  No padding pair is added (a pad pair's Miller value
    is not 1)."""
    C = px.shape[0]
    if px.shape[1] != 1:
        raise ValueError(f"lane_product takes one item, got {px.shape[1]}")
    if C <= MAX_PAIRS:
        return _miller_product(px, py, qx, qy)
    G, r = divmod(C, MAX_PAIRS)
    full = G * MAX_PAIRS

    def grouped(a):
        # [G * MAX_PAIRS, 1, ...] -> [MAX_PAIRS, G, ...]: item g holds
        # lanes g * MAX_PAIRS ... g * MAX_PAIRS + MAX_PAIRS - 1
        head = a[:full, 0]
        return head.reshape(G, MAX_PAIRS, *head.shape[1:]).transpose(
            0, 1).contiguous()

    f = _miller_product(*(grouped(a) for a in (px, py, qx, qy)))
    out = f[:1]
    for g in range(1, G):
        out = tower.fq12_mul(out, f[g:g + 1])
    if r:
        out = tower.fq12_mul(out, _miller_product(
            px[full:], py[full:], qx[full:], qy[full:]))
    return out


def _exp_abs_x(g):
    """g^|x|: squaring runs (K5 on the card) + 5 multiplications."""
    acc = g
    for n_sq, has_mul in _SEGMENTS:
        acc = _sq_run(acc, n_sq)
        if has_mul:
            acc = tower.fq12_mul(acc, g)
    return acc


def _exp_x(g):
    """g^x for the negative BLS parameter x; g must be in the cyclotomic
    subgroup (conjugate == inverse there)."""
    return tower.fq12_conj(_exp_abs_x(g))


def final_exp_value(f):
    """f^(3 (p^12-1)/r) in the HHT form: the value whose being one is the
    pairing check's verdict."""
    mul, conj = tower.fq12_mul, tower.fq12_conj
    frob1, frob2 = tower.fq12_frob1, tower.fq12_frob2
    # easy part: f^((p^6-1)(p^2+1)) — lands in the cyclotomic subgroup
    easy = mul(conj(f), tower.fq12_inv(f))
    easy = mul(frob2(easy), easy)
    # hard part (times 3), HHT: (x-1)^2 (x+p) (x^2+p^2-1) + 3
    a1 = mul(_exp_x(easy), conj(easy))                  # ^(x-1)
    a = mul(_exp_x(a1), conj(a1))                       # ^(x-1)^2
    b = mul(_exp_x(a), frob1(a))                        # ^(x+p)
    c = _exp_abs_x(_exp_abs_x(b))                       # b^(x^2)
    d = mul(mul(c, frob2(b)), conj(b))                  # ^(x^2+p^2-1)
    return mul(mul(_sq_run(easy, 1), easy), d)          # * f^3


def final_exp_is_one(f) -> np.ndarray:
    """final_exponentiation(f) == 1, via f^(3*(p^12-1)/r) == 1: bool [B]."""
    return _is_one(final_exp_value(f)).cpu().numpy()


def pairs_product_is_one(px, py, qx, qy, device) -> np.ndarray:
    """prod_i e(P_i, Q_i) == 1 per batch item, computed on ``device``.

    px, py: [K, B, 16]; qx, qy: [K, B, 2, 16] (Montgomery limbs, numpy).
    Returns bool [B].
    """
    from consensus_specs_tpu_torch._device import upload

    f = _miller_product(*(upload(np.ascontiguousarray(a, dtype=np.int64), device)
                          for a in (px, py, qx, qy)))
    return final_exp_is_one(f)
