"""Batched device BLS backend: the selector's ``"torch"`` backend.

Port of ``consensus_specs_tpu/ops/bls_jax/__init__.py``.  It splits BLS
verification between the host and the device:
  * host (this module): byte deserialization + subgroup checks (cached),
    pubkey aggregation, message hashing to G2 — small, irregular, branchy
    work;
  * device (pairing.py): the pairing-product check — thousands of
    Montgomery limb multiplies per verification, batched over B
    independent verifications as [K, B, ...] limb tensors.  On the card
    each run of Miller doublings is one launch of K4, each squaring chain
    of the final exponentiation one launch of K5, and every other limb
    product a launch of K3 (``limbs.mul``).

The batch APIs are the point: a block carries <= 128 attestations
(phase0/beacon-chain.md FastAggregateVerify per attestation) and a sync
aggregate of 512 pubkeys (altair/beacon-chain.md);
``batch_fast_aggregate_verify`` decides all of them in one device pass.

The device is explicit, as at every entry point of the port: None (the
default) means the CUDA card, and a host without one raises.  Tests ask
for the CPU with ``set_device("cpu")`` and restore the previous device
afterwards.  There is no fallback to the host: a
kernel that fails raises ``ops.sha256.KernelError``.  The one host path
is the reference's own: a batch item that carries a point at infinity
(an infinity signature, say) is decided by the pure-Python pairing
oracle, while the other items stay batched on the device.

The ciphersuite-compatible scalar API (Verify/FastAggregateVerify/...)
lets ``bls.use_backend("torch")`` (``bls.use_torch()``) register this
module as a drop-in backend; Sign / SkToPk / aggregation delegate to the
port's native C++ host backend since signing is not a batch workload,
and so does AggregateVerify (distinct messages, K varies with the pubkey
count).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from consensus_specs_tpu_torch._device import resolve_device
from consensus_specs_tpu_torch.crypto.bls import ciphersuite as _py
from consensus_specs_tpu_torch.crypto.bls.curve import (
    DeserializationError,
    Point,
    g1_generator,
    g1_infinity,
    pubkey_to_point,
    signature_to_point,
)
from consensus_specs_tpu_torch.crypto.bls.hash_to_curve import DST_G2_POP, hash_to_g2

from consensus_specs_tpu_torch.ops.sha256 import KernelError
from . import limbs, pairing, tower  # noqa: F401  (tower re-exported for tests)

try:  # fast host path for hashing/signing/aggregation
    from consensus_specs_tpu_torch.crypto.bls import native as _host
except (ImportError, OSError):
    _host = None

G2_POINT_AT_INFINITY = _py.G2_POINT_AT_INFINITY

def launch_counts() -> dict:
    """The launches of K3, K4 and K5 in this process so far."""
    return {"K3": limbs.counts["fq_mul"],
            "K4": pairing.counts["miller_dbl_run"],
            "K5": pairing.counts["fq12_sq_run"]}


# host-side scalar delegates --------------------------------------------------

_delegate = _host if _host is not None else _py

Sign = _delegate.Sign
SkToPk = _delegate.SkToPk
KeyValidate = _delegate.KeyValidate
Aggregate = _delegate.Aggregate
AggregatePKs = _delegate.AggregatePKs

# the device of the pairing checks: None is the CUDA card
_device = None


def set_device(device) -> object:
    """Run the pairing checks on ``device`` (None: the card); returns the
    previous setting, for the caller to restore."""
    global _device
    previous, _device = _device, device
    return previous


def pairing_device():
    """The device the pairing checks run on: the module's (``set_device``),
    where None is the card.  Without a card it raises ``KernelError``: the
    device path cannot run, and the selector lets that through rather than
    call it an invalid signature."""
    try:
        return resolve_device(_device)
    except RuntimeError as exc:
        raise KernelError(f"the device BLS backend cannot run: {exc}") from exc


def _hash_to_g2_point(message: bytes) -> Point:
    """H(msg) as an oracle curve point, via the native C++ hasher when
    available (compressed-bytes round trip), else the Python pipeline."""
    if _host is not None:
        from consensus_specs_tpu_torch.crypto.bls.curve import g2_from_bytes

        return g2_from_bytes(_host.hash_to_g2_compressed(message, DST_G2_POP))
    return hash_to_g2(bytes(message), DST_G2_POP)


# marshalling -----------------------------------------------------------------


def _g1_coords(pt: Point) -> Tuple[np.ndarray, np.ndarray]:
    x, y = pt.to_affine()
    return limbs.host_to_mont(x.n), limbs.host_to_mont(y.n)


def _g2_coords(pt: Point) -> Tuple[np.ndarray, np.ndarray]:
    x, y = pt.to_affine()
    return (
        np.stack([limbs.host_to_mont(x.c0), limbs.host_to_mont(x.c1)]),
        np.stack([limbs.host_to_mont(y.c0), limbs.host_to_mont(y.c1)]),
    )


_NEG_G1_GEN = -g1_generator()


def _bucket(n: int) -> int:
    """The power-of-two batch size (at least 2) that holds n items: a
    bounded set of batch shapes, as the reference keeps."""
    bucket = 2
    while bucket < n:
        bucket *= 2
    return bucket


def _check_pairs_batch(
    pairs_per_item: Sequence[Sequence[Tuple[Point, Point]]], device,
) -> np.ndarray:
    """prod e(P_k, Q_k) == 1 for each item, on ``device``; every item must
    carry the same number K of pairs (the verify family always yields
    K = 2)."""
    B = len(pairs_per_item)
    K = len(pairs_per_item[0])
    assert all(len(ps) == K for ps in pairs_per_item)
    px = np.zeros((K, B, limbs.N_LIMBS), dtype=np.int64)
    py = np.zeros((K, B, limbs.N_LIMBS), dtype=np.int64)
    qx = np.zeros((K, B, 2, limbs.N_LIMBS), dtype=np.int64)
    qy = np.zeros((K, B, 2, limbs.N_LIMBS), dtype=np.int64)
    infinity_mask = np.zeros((K, B), dtype=bool)
    for b, ps in enumerate(pairs_per_item):
        for k, (p, q) in enumerate(ps):
            if p.is_infinity() or q.is_infinity():
                infinity_mask[k, b] = True  # this item goes to the host below
                continue
            px[k, b], py[k, b] = _g1_coords(p)
            qx[k, b], qy[k, b] = _g2_coords(q)
    if infinity_mask.any():
        # rare path (infinity points, e.g. infinity signatures): only the
        # affected items go to the host oracle; the rest stay batched so
        # one adversarial attestation can't stall the whole block
        from consensus_specs_tpu_torch.crypto.bls.pairing import pairings_are_identity

        out = np.zeros(B, dtype=bool)
        dirty = infinity_mask.any(axis=0)
        clean = [b for b in range(B) if not dirty[b]]
        if clean:
            # pad the clean subset to a power-of-two bucket (repeat the
            # first item), the batch shapes the standard path uses
            sel = clean + [clean[0]] * (_bucket(len(clean)) - len(clean))
            sub = pairing.pairs_product_is_one(
                px[:, sel], py[:, sel], qx[:, sel], qy[:, sel], device)
            out[clean] = sub[: len(clean)]
        for b in range(B):
            if dirty[b]:
                out[b] = pairings_are_identity(pairs_per_item[b])
        return out
    return pairing.pairs_product_is_one(px, py, qx, qy, device)


# batch APIs ------------------------------------------------------------------


def marshal_fast_aggregate_items(
    pubkeys_lists: Sequence[Sequence[bytes]],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> Tuple[List[bool], List[Tuple[int, List[Tuple[Point, Point]]]]]:
    """Host-side per-item marshalling: signature and pubkey decompression
    + subgroup checks (cached), pubkey aggregation, hash-to-curve.
    Returns ``(results, todo)``: the B-long verdict list prefilled False
    (malformed/empty items stay False) and the pairing pairs for every
    structurally valid item."""
    B = len(pubkeys_lists)
    assert len(messages) == len(signatures) == B
    results: List[bool] = [False] * B
    todo: List[Tuple[int, List[Tuple[Point, Point]]]] = []
    for b in range(B):
        try:
            if len(pubkeys_lists[b]) == 0:
                continue
            sig = signature_to_point(bytes(signatures[b]))
            agg = g1_infinity()
            ok = True
            for pk_bytes in pubkeys_lists[b]:
                pk = pubkey_to_point(bytes(pk_bytes))
                if pk.is_infinity():
                    ok = False
                    break
                agg = agg + pk
            if not ok:
                continue
            h = _hash_to_g2_point(bytes(messages[b]))
            todo.append((b, [(agg, h), (_NEG_G1_GEN, sig)]))
        except (DeserializationError, ValueError):
            continue
    return results, todo


def batch_fast_aggregate_verify(
    pubkeys_lists: Sequence[Sequence[bytes]],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> List[bool]:
    """One device pass deciding FastAggregateVerify for B items, on the
    module's device (``set_device``).

    Malformed/out-of-subgroup inputs, infinity pubkeys, and empty pubkey
    lists yield False for that item (never an exception), mirroring the
    selector's Verify-family contract (crypto/bls/__init__.py)."""
    dev = pairing_device()
    results, todo = marshal_fast_aggregate_items(
        pubkeys_lists, messages, signatures)
    if todo:
        # pad to a power-of-two bucket (min 2).  Pad with an infinity-free
        # item when one exists — duplicating a dirty (infinity-carrying)
        # item would multiply its slow host-oracle path by the pad count
        n = len(todo)
        padded = [pairs for _, pairs in todo]
        pad_src = next(
            (pairs for pairs in padded
             if not any(p.is_infinity() or q.is_infinity() for p, q in pairs)),
            padded[0],
        )
        padded.extend([pad_src] * (_bucket(n) - n))
        verdicts = _check_pairs_batch(padded, dev)
        for (b, _), v in zip(todo, verdicts[:n]):
            results[b] = bool(v)
    return list(results)


def batch_verify(
    pubkeys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> List[bool]:
    """One device pass deciding single-pubkey Verify for B items."""
    return batch_fast_aggregate_verify(
        [[pk] for pk in pubkeys], messages, signatures)


# ciphersuite-compatible scalar API ------------------------------------------


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    return batch_verify([pubkey], [message], [signature])[0]


def FastAggregateVerify(
    pubkeys: Sequence[bytes], message: bytes, signature: bytes
) -> bool:
    return batch_fast_aggregate_verify([list(pubkeys)], [message], [signature])[0]


def AggregateVerify(
    pubkeys: Sequence[bytes], messages: Sequence[bytes], signature: bytes
) -> bool:
    """Distinct-message aggregate verification.  K varies with
    len(pubkeys), so this rare, unbatchable path stays on the fastest host
    backend, as in the reference."""
    return _delegate.AggregateVerify(pubkeys, messages, signature)


def backend():
    """The module itself is the backend object the selector registers."""
    import sys

    return sys.modules[__name__]
