"""BLS signatures over BLS12-381, G2 proof-of-possession scheme
(BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_), matching the behavior the
spec requires of its BLS backend (reference: eth2spec/utils/bls.py wraps
py_ecc's G2ProofOfPossession; IETF bls-signature draft semantics).

All functions take/return the spec's byte encodings (48-byte pubkeys,
96-byte signatures); points are validated (on-curve + subgroup) on
deserialization, with failures surfacing as False from the Verify
family — the wrapper layer in __init__.py enforces that contract.
"""
from __future__ import annotations

from typing import Sequence

from .curve import (
    DeserializationError,
    g1_generator,
    g1_infinity,
    g1_to_bytes,
    g2_infinity,
    g2_to_bytes,
    pubkey_to_point,
    signature_to_point,
)
from .fields import R
from .hash_to_curve import DST_G2_POP, hash_to_g2

G2_POINT_AT_INFINITY = bytes([0xC0]) + b"\x00" * 95


def _sk_to_int(sk) -> int:
    if isinstance(sk, int):
        v = int(sk)
    else:
        v = int.from_bytes(bytes(sk), "big")
    if not 0 < v < R:
        raise ValueError("secret key out of range")
    return v


def SkToPk(sk) -> bytes:
    return g1_to_bytes(g1_generator().mul(_sk_to_int(sk)))


def Sign(sk, message: bytes) -> bytes:
    return g2_to_bytes(hash_to_g2(bytes(message), DST_G2_POP).mul(_sk_to_int(sk)))


def KeyValidate(pubkey: bytes) -> bool:
    try:
        pt = pubkey_to_point(bytes(pubkey))
    except DeserializationError:
        return False
    return not pt.is_infinity()


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    from .pairing import pairings_are_identity

    try:
        pk = pubkey_to_point(bytes(pubkey))
        sig = signature_to_point(bytes(signature))
    except DeserializationError:
        return False
    if pk.is_infinity():
        return False
    h = hash_to_g2(bytes(message), DST_G2_POP)
    return pairings_are_identity([(pk, h), (-g1_generator(), sig)])


def Aggregate(signatures: Sequence[bytes]) -> bytes:
    if len(signatures) == 0:
        raise ValueError("cannot aggregate zero signatures")
    acc = g2_infinity()
    for s in signatures:
        acc = acc + signature_to_point(bytes(s))
    return g2_to_bytes(acc)


def AggregatePKs(pubkeys: Sequence[bytes]) -> bytes:
    if len(pubkeys) == 0:
        raise ValueError("cannot aggregate zero pubkeys")
    acc = g1_infinity()
    for p in pubkeys:
        pt = pubkey_to_point(bytes(p))
        if pt.is_infinity():
            raise ValueError("identity pubkey in aggregate")
        acc = acc + pt
    return g1_to_bytes(acc)


def AggregateVerify(pubkeys: Sequence[bytes], messages: Sequence[bytes], signature: bytes) -> bool:
    from .pairing import pairings_are_identity

    if len(pubkeys) != len(messages) or len(pubkeys) == 0:
        return False
    try:
        sig = signature_to_point(bytes(signature))
        pairs = []
        for pk_bytes, msg in zip(pubkeys, messages):
            pk = pubkey_to_point(bytes(pk_bytes))
            if pk.is_infinity():
                return False
            pairs.append((pk, hash_to_g2(bytes(msg), DST_G2_POP)))
    except DeserializationError:
        return False
    pairs.append((-g1_generator(), sig))
    return pairings_are_identity(pairs)


def FastAggregateVerify(pubkeys: Sequence[bytes], message: bytes, signature: bytes) -> bool:
    from .pairing import pairings_are_identity

    if len(pubkeys) == 0:
        return False
    try:
        sig = signature_to_point(bytes(signature))
        agg = g1_infinity()
        for pk_bytes in pubkeys:
            pk = pubkey_to_point(bytes(pk_bytes))
            if pk.is_infinity():
                return False
            agg = agg + pk
    except DeserializationError:
        return False
    h = hash_to_g2(bytes(message), DST_G2_POP)
    return pairings_are_identity([(agg, h), (-g1_generator(), sig)])
