"""Fr (BLS12-381 scalar field) arithmetic and NTT on torch limb lanes.

Port of ``consensus_specs_tpu/ops/fr_jax.py``, the single-device part:
the lazy-reduction Montgomery-limb design of ``ops/bls/limbs.py`` (26-bit
int64 limb lanes, only ``mul`` reduces), specialized to the 255-bit scalar
modulus: 10 limbs, R = 2^260.  An element is a ``[..., N_LIMBS]`` int64
tensor; ``mul`` and ``ntt_device`` run their tensor work on ``device``
(None: the CUDA card, which raises on a host without one; the CPU only
when the caller asks for it).  ``mul`` is plain torch on either device,
not a hand-written kernel.

Every output depends only on the integer values the reference's
operations produce: the same products, the same REDC rounds, the same
digit-serial final carry (whose last carry is dropped, so an output is
its value mod 2^260), with int64 ``>>`` arithmetic and ``&`` on two's
complement in torch as in jnp.  So the limbs equal the reference's bit for
bit, lazy negative inputs included.  Differential oracle: ``crypto/fr.py``
(host python-int NTT); tests/test_torch_fr.py holds both.

The reference's ``sharded_ntt`` (a four-step NTT over a device mesh) has
no counterpart yet: it belongs with the port's mesh code.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from consensus_specs_tpu_torch._device import resolve_device
from consensus_specs_tpu_torch.crypto.fr import R as FR_MOD
from consensus_specs_tpu_torch.crypto.fr import root_of_unity

N_LIMBS = 10
LIMB_BITS = 26
_B = LIMB_BITS
_MASK = (1 << LIMB_BITS) - 1
R_BITS = N_LIMBS * LIMB_BITS  # 260

R_INT = (1 << R_BITS) % FR_MOD
R2_INT = (R_INT * R_INT) % FR_MOD
N0INV_INT = (-pow(FR_MOD, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def int_to_limbs(x: int) -> np.ndarray:
    assert 0 <= x < (1 << R_BITS)
    out = np.zeros(N_LIMBS, dtype=np.int64)
    for i in range(N_LIMBS):
        out[i] = (x >> (LIMB_BITS * i)) & _MASK
    return out


def limbs_to_int(a) -> int:
    arr = np.asarray(a, dtype=np.int64)
    return int(sum(int(arr[..., i]) << (LIMB_BITS * i) for i in range(N_LIMBS)))


_P_LIMBS = int_to_limbs(FR_MOD)

_TABLES: dict = {}


def _tables(device: torch.device):
    """p's limbs as a column and the column index i + j of each partial
    product a_i * b_j, on ``device`` (uploaded once a device)."""
    if device not in _TABLES:
        i = torch.arange(N_LIMBS)
        _TABLES[device] = (
            torch.as_tensor(_P_LIMBS, device=device)[:, None],
            (i[:, None] + i[None, :]).reshape(-1).to(device))
    return _TABLES[device]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery multiply-reduce over ``[..., N_LIMBS]`` int64 lanes, on
    the operands' device: the schoolbook product by columns, ten REDC
    rounds, p added, then one carry pass whose last carry is dropped."""
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"mul takes int64 limbs, got {a.dtype} and {b.dtype}")
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    p, column = _tables(a.device)
    # limb-major [N_LIMBS, M] rows, so that each REDC round works on rows
    at = a.reshape(-1, N_LIMBS).t()
    bt = b.reshape(-1, N_LIMBS).t()
    outer = (at[:, None, :] * bt[None, :, :]).reshape(N_LIMBS * N_LIMBS, -1)
    T = torch.zeros((2 * N_LIMBS, outer.shape[1]), dtype=torch.int64,
                    device=a.device).index_add_(0, column, outer)
    row = T.unbind(0)  # views of T's rows, updated in place
    for i in range(N_LIMBS):
        m = (row[i] & _MASK).mul_(N0INV_INT).bitwise_and_(_MASK)
        T[i:i + N_LIMBS].addcmul_(p, m)
        row[i + 1].add_(row[i] >> _B)
    r = T[N_LIMBS:] + p
    digits = torch.empty_like(r)
    c = torch.zeros_like(r[0])
    for i in range(N_LIMBS):
        v = r[i] + c
        digits[i] = v & _MASK
        c = v >> _B
    return digits.t().reshape(shape)


def host_to_mont(x: int) -> np.ndarray:
    return int_to_limbs(x * R_INT % FR_MOD)


def host_from_mont(a) -> int:
    return limbs_to_int(np.asarray(a)) * pow(R_INT, -1, FR_MOD) % FR_MOD


def canonical_int(a) -> int:
    """Host: limb array (possibly lazy/Montgomery-reduced) -> canonical
    python int mod r, leaving Montgomery form."""
    return host_from_mont(a) % FR_MOD


_R_INV = pow(R_INT, -1, FR_MOD)
_BIT_WEIGHTS = 1 << np.arange(LIMB_BITS, dtype=np.int64)


def host_to_mont_rows(values: Sequence[int]) -> np.ndarray:
    """``[len(values), N_LIMBS]`` Montgomery limbs of the values mod r (the
    rows of ``host_to_mont``): each value's bytes unpacked to bits, 26 to
    a limb."""
    raw = b"".join((int(v) % FR_MOD * R_INT % FR_MOD).to_bytes(33, "little")
                   for v in values)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8).reshape(
        len(values), 33), axis=1, bitorder="little")[:, :R_BITS]
    return bits.reshape(len(values), N_LIMBS, LIMB_BITS).astype(np.int64) @ _BIT_WEIGHTS


def canonical_ints(rows: np.ndarray) -> List[int]:
    """``canonical_int`` of each row of (possibly signed, lazy) limbs."""
    obj = np.asarray(rows, dtype=np.int64).astype(object)
    value = obj[:, 0]
    for i in range(1, N_LIMBS):
        value = value + (obj[:, i] << (LIMB_BITS * i))
    return [int(v) * _R_INV % FR_MOD for v in value]


# ---------------------------------------------------------------------------
# NTT
# ---------------------------------------------------------------------------


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        out[i] = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
    return out


@lru_cache(maxsize=16)
def _ntt_host_precompute(n: int, w: int):
    """Index + twiddle schedule for the in-place iterative NTT."""
    perm = _bit_reverse_perm(n)
    schedule = []
    size = 2
    while size <= n:
        w_size = pow(w, n // size, FR_MOD)
        top = np.arange(n).reshape(n // size, size)[:, : size // 2].reshape(-1)
        bot = top + size // 2
        powers = [1]
        for _ in range(size // 2 - 1):
            powers.append(powers[-1] * w_size % FR_MOD)
        tw = host_to_mont_rows(powers)
        tws = np.tile(tw, (n // size, 1))
        schedule.append((top, bot, tws))
        size *= 2
    return perm, schedule


def schedule_on(schedule, device: torch.device) -> list:
    """The host schedule's index and twiddle arrays as tensors on
    ``device``."""
    return [tuple(torch.as_tensor(a, device=device) for a in stage)
            for stage in schedule]


def _ntt_apply(x: torch.Tensor, schedule) -> torch.Tensor:
    """Run the butterfly schedule (tensors on ``x``'s device) over
    ``[n, N_LIMBS]`` limbs.  Both halves of a stage read the stage's input:
    ``e`` and ``t`` are gathered before either is written."""
    for top, bot, tws in schedule:
        t = mul(tws, x[bot])
        e = x[top]
        x = x.index_copy(0, top, e + t).index_copy_(0, bot, e - t)
        # keep limbs in signed-lazy range; mul renormalizes next stage
    return x


# Lazy-carry magnitude bound: _ntt_apply accumulates e±t without per-stage
# renormalization while mul drops its final carry, so worst-case entry
# magnitudes grow ~2 canonical units per stage.  REDC stays exact for
# inputs above -2^260; 2^14 stages of growth keeps the worst case inside
# that window with margin.  Larger transforms would need renormalizing
# lanes every few stages.
MAX_NTT_SIZE = 1 << 14


def ntt_device(values: Sequence[int], inv: bool = False,
               device=None) -> List[int]:
    """NTT over Fr on ``device`` (None: the CUDA card), bit-exact vs
    crypto.fr.fft."""
    device = resolve_device(device)
    n = len(values)
    assert n & (n - 1) == 0
    assert n <= MAX_NTT_SIZE, (
        f"transform size {n} exceeds the lazy-carry bound {MAX_NTT_SIZE}")
    w = root_of_unity(n)
    if inv:
        w = pow(w, FR_MOD - 2, FR_MOD)
    perm, schedule = _ntt_host_precompute(n, w)
    x = torch.as_tensor(host_to_mont_rows(values)[perm], device=device)
    res = canonical_ints(_ntt_apply(x, schedule_on(schedule, device)).cpu().numpy())
    if inv:
        n_inv = pow(n, FR_MOD - 2, FR_MOD)
        res = [v * n_inv % FR_MOD for v in res]
    return res
