"""Fq (BLS12-381 base field) arithmetic on 26-bit limb lanes, in torch and CUDA.

Port of ``consensus_specs_tpu/ops/bls_jax/limbs.py``.  The representation
is the reference's: an Fq element is a ``[..., N_LIMBS]`` (= 16) **int64**
tensor of little-endian 26-bit limbs, value = sum(limb[i] << 26*i), held
in Montgomery form (a*R mod p, R = 2^416).

Lazy reduction:

  * ``add``/``sub``/``neg``/``double`` are ONE elementwise op each: limbs
    are signed and may grow or go negative; nothing propagates.
  * Only ``mul`` reduces.  It accepts operands with limbs |a_i| <= 2^29
    (sums and differences of up to ~8 reduced values) whose product stays
    below R*p (the reference's docstring names |a| <= 36p; the pairing's
    operands reach about 50p, far inside the product bound), and returns
    a *reduced* element: canonical digits in [0, 2^26), value in (0, 3p).
    Equality therefore requires ``canonical()`` first.

Overflow audit for ``mul`` (int64): schoolbook product limbs
<= 16 * 2^29 * 2^29 = 2^62; REDC adds m_i * p limbs (<= 16 * 2^52 = 2^56)
and carries (< 2^37): total < 2^62.6 < 2^63.  REDC exactness needs
|a*b| < R*p: (64p)^2 = 4096 p^2 << 2^416 p.  After REDC the value lies in
(-p, 2p); the tail adds p and carry-propagates, giving (0, 3p) with
canonical digits.  ``>>`` on int64 is arithmetic and ``&`` works on
two's complement, in torch as in jnp, so signed carries propagate as the
reference's do.

Every output depends only on the integer values of the inputs (the REDC
quotient m = -a*b/p mod R and the canonical digits of a value are
unique), so any code that computes the same values gives the same limbs.

``mul`` is the one entry for products: on a CUDA tensor it launches K3
(``csrc/bls_fq.cu``; its bound and design are noted in the source), or
raises ``KernelError``; on a CPU tensor it runs ``mul_plain``, the plain
torch version.  ``tower.py`` and ``pairing.py`` build on it, so on the
card every limb product of the pipeline is a K3 launch.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops.sha256 import KernelError

P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# 16 limbs (R = 2^416) rather than the minimal 15: the extra limb buys
# enough headroom that lazily-accumulated values still satisfy the REDC
# exactness bound |a|*|b| < R*p with a wide margin.
N_LIMBS = 16
LIMB_BITS = 26
MASK = (1 << LIMB_BITS) - 1
R_BITS = N_LIMBS * LIMB_BITS  # 416

R_INT = (1 << R_BITS) % P_INT
R2_INT = (R_INT * R_INT) % P_INT
N0INV_INT = (-pow(P_INT, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def int_to_limbs(x: int) -> np.ndarray:
    """Host: python int in [0, 2^416) -> [N_LIMBS] int64 limb array
    (plain value, NOT Montgomery).  p itself is a valid input."""
    assert 0 <= x < (1 << R_BITS)
    out = np.zeros(N_LIMBS, dtype=np.int64)
    for i in range(N_LIMBS):
        out[i] = x & MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(a) -> int:
    """Host: limb array (any signed representation) -> python int value."""
    a = np.asarray(a, dtype=np.int64)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(N_LIMBS))


P_LIMBS = int_to_limbs(P_INT)
R2_LIMBS = int_to_limbs(R2_INT)
ONE_LIMBS = int_to_limbs(1)
MONT_ONE_LIMBS = int_to_limbs(R_INT)

# K3's work per product, for its bound in chip_smoke.py: bytes moved (two
# [16] int64 operands read, one written)
BYTES_PER_PRODUCT = 3 * N_LIMBS * 8


_CONSTS: dict = {}


def const(limbs_np: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A module-level host limb constant as an int64 tensor on ``like``'s
    device, uploaded once a device (the constants never change)."""
    key = (id(limbs_np), like.device)
    if key not in _CONSTS:
        _CONSTS[key] = (limbs_np, torch.as_tensor(limbs_np, dtype=torch.int64,
                                                  device=like.device))
    return _CONSTS[key][1]


# ---------------------------------------------------------------------------
# lazy elementwise ops
# ---------------------------------------------------------------------------


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def double(a):
    return a + a


def _carry(a: torch.Tensor, keep_top: bool) -> torch.Tensor:
    """Signed carry propagation over the limb axis: limbs 0..N-2 become
    canonical in [0, 2^26); the top limb is ``a[-1]`` plus the carries
    when ``keep_top``, else it is masked too and its carry dropped.

    Every limb passes its carry on at once, in rounds, until none carries:
    the represented value is unchanged by each round, and digits in
    [0, 2^26) below a top limb are the value's one such form, so the
    result is the reference's digit-serial loop's, in a few rounds of a
    handful of ops instead of 3 ops a limb."""
    v = a.clone()
    low = v[..., :-1]
    while True:
        c = low >> LIMB_BITS
        if not bool(c.any()):
            break
        low &= MASK
        v[..., 1:] += c
    if not keep_top:
        v[..., -1] &= MASK
    return v


def renorm(a):
    """Digit renormalization for lazily-accumulated elements: signed carry
    propagation with NO offset, so the represented value is unchanged (and
    may be negative).  Limbs 0..N-2 become canonical in [0, 2^26); the top
    limb absorbs the remaining signed magnitude (|value| < 2^20*p implies
    |top| < 2^32)."""
    return _carry(a, keep_top=True)


# ---------------------------------------------------------------------------
# multiplication (the only reducing op)
# ---------------------------------------------------------------------------


_COLUMNS = {}


def _column(device) -> torch.Tensor:
    """i + j for the partial products a_i * b_j, row-major, on ``device``."""
    if device not in _COLUMNS:
        i = torch.arange(N_LIMBS)
        _COLUMNS[device] = (i[:, None] + i[None, :]).reshape(-1).to(device)
    return _COLUMNS[device]


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3's plain torch version: Montgomery multiply-reduce a*b*R^-1 mod p
    of two broadcast-compatible int64 limb tensors, reduced output."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    # limb-major [N, M] rows, so that each REDC step works on whole rows
    at = a.reshape(-1, N_LIMBS).t()
    bt = b.reshape(-1, N_LIMBS).t()
    # schoolbook product: each partial product a_i * b_j added into
    # column i + j
    outer = (at[:, None, :] * bt[None, :, :]).reshape(N_LIMBS * N_LIMBS, -1)
    T = torch.zeros((2 * N_LIMBS, outer.shape[1]), dtype=torch.int64,
                    device=a.device).index_add_(0, _column(a.device), outer)

    # REDC: clear limbs 0..N-1, one limb a step (``row`` are views of T's
    # rows, updated in place)
    p = const(P_LIMBS, T)[:, None]
    row = T.unbind(0)
    for i in range(N_LIMBS):
        m = (row[i] & MASK).mul_(N0INV_INT).bitwise_and_(MASK)
        T[i:i + N_LIMBS].addcmul_(p, m)
        row[i + 1].add_(row[i] >> LIMB_BITS)           # exact: T[i] = 0 mod 2^26

    # make surely positive, then carry-propagate to canonical digits
    r = (T[N_LIMBS:] + p).t().reshape(shape)
    return _carry(r, keep_top=False)


# K3's launch shapes (the number of products of each launch), for the
# launch-shape histogram chip_smoke.py prints
launch_shapes: dict = {}
counts = {"fq_mul": 0}


def reset_counts() -> None:
    counts["fq_mul"] = 0
    launch_shapes.clear()


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery multiply-reduce: a*b*R^-1 mod p, reduced output
    (canonical digits, value in (0, 3p)).  Operands broadcast against each
    other.  CUDA launches K3; the CPU runs ``mul_plain``."""
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"mul takes int64 limbs, got {a.dtype} and {b.dtype}")
    if a.shape[-1] != N_LIMBS or b.shape[-1] != N_LIMBS:
        raise ValueError(f"mul takes [..., {N_LIMBS}] limbs, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"mul operands on {a.device} and {b.device}")
    if a.device.type == "cuda":
        return _launch_k3(a, b)
    if a.device.type == "cpu":
        return mul_plain(a, b)
    raise ValueError(f"mul runs on cuda or cpu, not {a.device}")


def square(a):
    return mul(a, a)


def to_mont(a):
    return mul(a, const(R2_LIMBS, a))


def from_mont(a):
    """Montgomery -> plain residue, canonical in [0, p)."""
    return cond_sub_p(cond_sub_p(mul(a, const(ONE_LIMBS, a))))


# ---------------------------------------------------------------------------
# K3: the CUDA kernel
# ---------------------------------------------------------------------------

_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
CU_SOURCES = (os.path.join(_CSRC_DIR, "bls_fq.cu"),)
HEADERS = (os.path.join(_CSRC_DIR, "bls_fq.cuh"),)
_lib = None


def build_kernel() -> str:
    """Compile K3 with one nvcc call for sm_90a into the build directory
    (once per source digest) and return the library's path; the
    compiler's report is kept beside it as ``<library>.log``."""
    return _build.build_cuda("bls_fq", CU_SOURCES, HEADERS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(build_kernel())
        except (OSError, RuntimeError) as exc:
            raise KernelError(f"the Fq multiply kernel is not available: "
                              f"{exc}") from exc
        lib.fq_mul_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.fq_mul_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch_k3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 on two CUDA limb tensors: the wrapper expands broadcast operands
    to ``[N, 16]`` contiguous, 16-byte aligned rows and allocates the
    output."""
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return _launch_k3(a, b)
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    rows = [t.reshape(-1, N_LIMBS).contiguous() for t in (a, b)]
    rows = [t.clone() if t.data_ptr() % 16 else t for t in rows]
    n = rows[0].shape[0]
    out = torch.empty((n, N_LIMBS), dtype=torch.int64, device=a.device)
    if n == 0:
        return out.reshape(shape)
    rc = _library().fq_mul_launch(
        rows[0].data_ptr(), rows[1].data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"K3 launch failed with CUDA error {rc}")
    counts["fq_mul"] += 1
    launch_shapes[n] = launch_shapes.get(n, 0) + 1
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# canonicalization + comparisons
# ---------------------------------------------------------------------------


def _geq_p(a):
    """a >= p for canonical-digit a (lexicographic from the top limb)."""
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq_ = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(N_LIMBS - 1, -1, -1):
        pi = int(P_LIMBS[i])
        gt = gt | (eq_ & (a[..., i] > pi))
        eq_ = eq_ & (a[..., i] == pi)
    return gt | eq_


def cond_sub_p(a):
    """Subtract p once where a >= p (canonical digits in, canonical out)."""
    d = _carry(a - const(P_LIMBS, a), keep_top=False)
    return torch.where(_geq_p(a)[..., None], d, a)


def canonical(a):
    """Fully-reduced Montgomery representative in [0, p)."""
    r = mul(a, const(MONT_ONE_LIMBS, a))  # value in (0, 2p + eps)
    return cond_sub_p(cond_sub_p(r))


def eq_canonical(a, b):
    """Equality of canonical() outputs."""
    return torch.all(a == b, dim=-1)


def is_zero_canonical(a):
    return torch.all(a == 0, dim=-1)


# ---------------------------------------------------------------------------
# fixed-exponent powers
# ---------------------------------------------------------------------------


def _exp_bits(e: int) -> list:
    return [int(c) for c in bin(e)[2:]]


_P_MINUS_2_BITS = _exp_bits(P_INT - 2)


def inv(a):
    """a^(p-2) by square-and-multiply over the fixed exponent's bits (the
    reference's ``lax.scan``, here a loop: the exponent is a constant, so
    each set bit is one more product and no select is needed)."""
    acc = torch.zeros_like(a) + const(MONT_ONE_LIMBS, a)
    for bit in _P_MINUS_2_BITS:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, a)
    return acc


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------


def host_to_mont(x: int) -> np.ndarray:
    return int_to_limbs((x * R_INT) % P_INT)


def host_from_mont(a) -> int:
    return (limbs_to_int(a) * pow(R_INT, -1, P_INT)) % P_INT
