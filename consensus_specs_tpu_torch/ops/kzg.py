"""Batched G1 scalar multiplication for KZG commitments (the G1 MSM inside
eip4844's blob_to_kzg, specs/eip4844/beacon-chain.md:112-120).

Port of ``consensus_specs_tpu/ops/kzg_jax.py``, the single-device part.
Device layout: N lanes of (affine point, 255-bit scalar); a loop over the
255 bit-planes, most significant first, runs the double-and-add for ALL
lanes at once on the Montgomery limb representation of ``ops/bls/limbs``
(``[N, 16]`` int64 tensors).  Its field products are ``limbs.mul``: on the
card each one is a launch of K3 (``csrc/bls_fq.cu``), about 28 a step; on
the CPU each is K3's plain version.  The per-lane products return to the
host, which finishes the N-way sum on the oracle curve.

Degenerate add cases (equal-x, infinity) are resolved branchlessly with
canonical-equality selects, so structured scalars cannot corrupt lanes.
Every lazy sum is renormed before the product that reads it, in the
reference's order, so each product's operands sit inside K3's envelope.

``batch_scalar_mul`` and ``msm`` run on ``device`` (None: the CUDA card,
which raises on a host without one); no setting moves them elsewhere, and
a failing K3 raises ``KernelError``.  The reference's mesh-sharded lanes
(``sharded_batch_scalar_mul``, ``sharded_msm``) belong with the port's
mesh code.  Differential tests: tests/test_torch_kzg.py.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from consensus_specs_tpu_torch._device import resolve_device
from consensus_specs_tpu_torch.crypto.bls.curve import Point, g1_infinity
from consensus_specs_tpu_torch.crypto.fr import R as FR_ORDER

from .bls import limbs

N_BITS = 255


def _sel(mask, a, b):
    """mask [...] selecting between limb arrays [..., 16]."""
    return torch.where(mask[..., None], a, b)


def _is_zero(a):
    return limbs.is_zero_canonical(limbs.canonical(a))


def _dbl(X, Y, Z):
    """Jacobian doubling (dbl-2009-l), lazy adds + renorm; Z=0 stays 0."""
    mul, rn = limbs.mul, limbs.renorm
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    D = rn(2 * (mul(rn(X + B), rn(X + B)) - A - C))
    E = rn(3 * A)
    F = mul(E, E)
    X3 = rn(F - 2 * D)
    Y3 = rn(mul(E, rn(D - X3)) - 8 * C)
    Z3 = rn(2 * mul(Y, Z))
    return X3, Y3, Z3


def _madd(X1, Y1, Z1, x2, y2):
    """Mixed add (madd-2007-bl) of jacobian (X1,Y1,Z1) + affine (x2,y2),
    with branchless handling of P1 = inf, equal-x double, and inverse."""
    mul, rn = limbs.mul, limbs.renorm
    Z1Z1 = mul(Z1, Z1)
    U2 = mul(x2, Z1Z1)
    S2 = mul(mul(y2, Z1), Z1Z1)
    H = rn(U2 - X1)
    HH = mul(H, H)
    I = rn(4 * HH)
    J = mul(H, I)
    r = rn(2 * (S2 - Y1))
    V = mul(X1, I)
    rr = mul(r, r)
    X3 = rn(rr - J - 2 * V)
    Y3 = rn(mul(r, rn(V - X3)) - 2 * mul(Y1, J))
    Z3 = rn(mul(rn(Z1 + H), rn(Z1 + H)) - Z1Z1 - HH)

    p1_inf = _is_zero(Z1)
    h_zero = _is_zero(H)
    r_zero = _is_zero(r)
    # equal-x, equal-y: the true result is double(P1)
    dX, dY, dZ = _dbl(X1, Y1, Z1)
    # equal-x, opposite-y: infinity (Z=0); X3 and Y3 stand
    double = h_zero & r_zero
    X3 = _sel(double, dX, X3)
    Y3 = _sel(double, dY, Y3)
    Z3 = _sel(double, dZ, _sel(h_zero & ~r_zero, torch.zeros_like(Z3), Z3))

    one = limbs.const(limbs.MONT_ONE_LIMBS, x2).expand_as(x2)
    X3 = _sel(p1_inf, x2, X3)
    Y3 = _sel(p1_inf, y2, Y3)
    Z3 = _sel(p1_inf, one, Z3)
    return X3, Y3, Z3


def msm_lanes(px: torch.Tensor, py: torch.Tensor, bits: torch.Tensor):
    """Per-lane scalar multiplication on ``px``'s device.

    px, py: [N, 16] affine Montgomery limbs; bits: [255, N] (MSB-first,
    nonzero = set).  Returns the jacobian [N, 16] triples, canonical."""
    X = torch.zeros_like(px)
    Y = X + limbs.const(limbs.MONT_ONE_LIMBS, px)
    Z = torch.zeros_like(px)  # infinity
    for bit_row in bits > 0:
        X, Y, Z = _dbl(X, Y, Z)
        aX, aY, aZ = _madd(X, Y, Z, px, py)
        X, Y, Z = (_sel(bit_row, aX, X), _sel(bit_row, aY, Y),
                   _sel(bit_row, aZ, Z))
    return limbs.canonical(X), limbs.canonical(Y), limbs.canonical(Z)


def to_bits(scalars: Sequence[int]) -> np.ndarray:
    """[255, N] int32 bit-planes of the scalars mod r, most significant
    first: each scalar's 32 big-endian bytes unpacked, the top bit
    dropped (r < 2^255)."""
    raw = b"".join((int(s) % FR_ORDER).to_bytes(32, "big") for s in scalars)
    planes = np.unpackbits(np.frombuffer(raw, dtype=np.uint8).reshape(
        len(scalars), 32), axis=1)
    return np.ascontiguousarray(planes[:, 256 - N_BITS:].T, dtype=np.int32)


_LIMB_BYTES = limbs.R_BITS // 8  # 52: an int below 2^416
_BIT_WEIGHTS = 1 << np.arange(limbs.LIMB_BITS, dtype=np.int64)
_R_INV = pow(limbs.R_INT, -1, limbs.P_INT)


def ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """[N, 16] int64 limbs (26-bit digits, little-endian) of ints in
    [0, 2^416): the values' bytes unpacked to bits, 26 to a limb."""
    raw = b"".join(int(v).to_bytes(_LIMB_BYTES, "little") for v in values)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8).reshape(
        len(values), _LIMB_BYTES), axis=1, bitorder="little")
    return bits.reshape(len(values), limbs.N_LIMBS, limbs.LIMB_BITS).astype(
        np.int64) @ _BIT_WEIGHTS


def limbs_to_ints(a: np.ndarray) -> List[int]:
    """The ints of [N, 16] limbs whose digits lie in [0, 2^26) (canonical
    outputs): each limb's 26 bits packed back to bytes."""
    a = np.asarray(a, dtype=np.int64)
    if a.size and (a.min() < 0 or a.max() > limbs.MASK):
        raise ValueError("limbs_to_ints takes canonical digits")
    bits = ((a[..., None] >> np.arange(limbs.LIMB_BITS)) & 1).astype(np.uint8)
    raw = np.packbits(bits.reshape(len(a), limbs.R_BITS), axis=1,
                      bitorder="little")
    return [int.from_bytes(row.tobytes(), "little") for row in raw]


# [N, 16] Montgomery limbs of a point list's affine coordinates, cached by
# the list's identity (the lru_cached setups are stable objects); strong
# refs keep the ids valid
_LIMB_CACHE: dict = {}
_LIMB_CACHE_MAX = 4


def points_to_limbs(points: Sequence[Point]) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 16] Montgomery limbs of the points' affine x and y.  A point
    object that fills several lanes (one setup under many blobs) is
    converted once; the affine forms share one inversion (Montgomery's
    batch trick)."""
    key = id(points)
    hit = _LIMB_CACHE.get(key)
    if hit is not None and hit[0] is points:
        return hit[1]
    rows: dict = {}
    distinct = []
    index = np.empty(len(points), dtype=np.int64)
    for i, p in enumerate(points):
        row = rows.get(id(p))
        if row is None:
            if p.is_infinity():
                raise ValueError("a lane's point is at infinity (no affine form)")
            row = rows[id(p)] = len(distinct)
            distinct.append(p)
        index[i] = row
    p_int = limbs.P_INT
    zs = [p.z.n for p in distinct]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % p_int)
    inv = pow(prefix[-1], p_int - 2, p_int)
    xs, ys = [0] * len(zs), [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        zi = inv * prefix[i] % p_int
        inv = inv * zs[i] % p_int
        zi2 = zi * zi % p_int
        xs[i] = distinct[i].x.n * zi2 % p_int * limbs.R_INT % p_int
        ys[i] = distinct[i].y.n * zi2 % p_int * zi % p_int * limbs.R_INT % p_int
    px, py = ints_to_limbs(xs)[index], ints_to_limbs(ys)[index]
    if len(_LIMB_CACHE) >= _LIMB_CACHE_MAX:
        _LIMB_CACHE.clear()
    _LIMB_CACHE[key] = (points, (px, py))
    return px, py


def limbs_to_points(X: np.ndarray, Y: np.ndarray, Z: np.ndarray) -> List[Point]:
    """Canonical jacobian Montgomery limb triples -> host curve points."""
    from consensus_specs_tpu_torch.crypto.bls.curve import B_G1
    from consensus_specs_tpu_torch.crypto.bls.fields import Fq

    p_int = limbs.P_INT
    out = []
    for x, y, z in zip(limbs_to_ints(X), limbs_to_ints(Y), limbs_to_ints(Z)):
        z = z * _R_INV % p_int
        if z == 0:
            out.append(g1_infinity())
            continue
        out.append(Point(Fq(x * _R_INV % p_int), Fq(y * _R_INV % p_int),
                         Fq(z), B_G1))
    return out


# the seconds of the last call's host marshalling (limbs, bit-planes,
# uploads), bit-plane loop (with its readback), host unmarshalling (limbs
# back to points) and, for msm, host tail sum
stats = {"marshal_s": 0.0, "loop_s": 0.0, "unmarshal_s": 0.0, "tail_s": 0.0}


def batch_scalar_mul(points: Sequence[Point], scalars: Sequence[int],
                     device=None) -> List[Point]:
    """[k_i * P_i] for all lanes in one run of the bit-plane loop on
    ``device`` (None: the CUDA card)."""
    assert len(points) == len(scalars)
    device = resolve_device(device)
    t0 = time.perf_counter()
    px, py = (torch.as_tensor(a, device=device) for a in points_to_limbs(points))
    bits = torch.as_tensor(to_bits(scalars), device=device)
    t1 = time.perf_counter()
    X, Y, Z = (a.cpu().numpy() for a in msm_lanes(px, py, bits))
    t2 = time.perf_counter()
    out = limbs_to_points(X, Y, Z)
    stats.update(marshal_s=t1 - t0, loop_s=t2 - t1,
                 unmarshal_s=time.perf_counter() - t2, tail_s=0.0)
    return out


def lane_sum(points: Sequence[Point]) -> Point:
    """The host tail: the sum of the lanes' products on the oracle curve."""
    acc = g1_infinity()
    for p in points:
        acc = acc + p
    return acc


def msm(points: Sequence[Point], scalars: Sequence[int], device=None) -> Point:
    """sum_i k_i * P_i: per-lane products on ``device``, host tail sum."""
    lanes = batch_scalar_mul(points, scalars, device)
    t0 = time.perf_counter()
    out = lane_sum(lanes)
    stats["tail_s"] = time.perf_counter() - t0
    return out
