"""ctypes loader + API for the native C++ BLS12-381 backend.

Fills the reference's "fast host BLS" slot (eth2spec/utils/bls.py:8-30
selects a Rust milagro binding for CI speed); here the fast path is a
from-scratch C++ implementation compiled on first use with g++ into the
port's build directory (``_build.py``), keyed by a content hash so edits
rebuild automatically.

Exposes the same API surface as crypto/bls/ciphersuite.py so the selector
in crypto/bls/__init__.py can register it verbatim.  Raises ImportError on
any build/load failure — callers fall back to the pure-Python oracle.
"""
from __future__ import annotations

import ctypes
import os
import time
from typing import Sequence

from consensus_specs_tpu_torch import _build

_HERE = os.path.join(os.path.dirname(__file__), "native")
_SOURCES = ("bls12_381.cpp", "bls_constants.h")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17",
          "-fno-exceptions", "-fno-rtti", "-pthread")

G2_POINT_AT_INFINITY = bytes([0xC0]) + b"\x00" * 95

# subgroup order (for secret-key range checks, mirrors ciphersuite._sk_to_int)
_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def _build_library() -> str:
    """Compile the library with g++ into the port's build directory (once
    per source digest)."""
    src = os.path.join(_HERE, "bls12_381.cpp")
    try:
        return _build.build_shared(
            "libbls", [os.path.join(_HERE, n) for n in _SOURCES],
            lambda out: ["g++", *_FLAGS, src, "-o", out], flags=_FLAGS,
            timeout=300)
    except OSError as exc:
        raise ImportError(f"native BLS build failed: {exc}") from exc


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build_library())
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def sig(name, *argtypes):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        return fn

    sz = ctypes.c_size_t
    sig("bls_sk_to_pk", u8p, u8p)
    sig("bls_sign", u8p, u8p, sz, u8p)
    sig("bls_key_validate", u8p)
    sig("bls_verify", u8p, u8p, sz, u8p)
    sig("bls_aggregate", u8p, sz, u8p)
    sig("bls_aggregate_pks", u8p, sz, u8p)
    sig("bls_fast_aggregate_verify", u8p, sz, u8p, sz, u8p)
    sig("bls_decompress_pubkey", u8p, u8p)
    sig("bls_decompress_pubkeys", u8p, sz, u8p, u8p)
    sig("bls_fast_aggregate_verify_affine", u8p, sz, u8p, sz, u8p)
    sig("bls_aggregate_verify", u8p, sz, u8p, ctypes.POINTER(sz), u8p)
    sig("bls_batch_fast_aggregate_verify_affine",
        sz, u8p, ctypes.POINTER(sz), u8p, ctypes.POINTER(sz), u8p, u8p)
    sig("bls_batch_fast_aggregate_verify_affine_timed",
        sz, u8p, ctypes.POINTER(sz), u8p, ctypes.POINTER(sz), u8p, u8p,
        ctypes.POINTER(ctypes.c_double))
    sig("bls_g1_msm", u8p, u8p, sz, u8p)
    sig("bls_g2_msm", u8p, u8p, sz, u8p)
    sig("bls_h2c_cache_stats", ctypes.POINTER(ctypes.c_uint64))
    sig("bls_h2c_cache_clear")
    sig("bls_g1_msm_precompute", u8p, sz, u8p)
    sig("bls_g1_msm_fixed", u8p, sz, u8p, u8p)
    sig("bls_g1_msm_fixed_windows")
    sig("bls_hash_to_g2", u8p, sz, u8p, sz, u8p)
    sig("bls_pairing", u8p, u8p, u8p)
    sig("bls_sha256", u8p, sz, u8p)
    sig("bls_initialize")
    return lib


try:
    _lib = _load()
    _lib.bls_initialize()  # under the import lock: constants ready before any
    # ctypes call can release the GIL mid-init
except ImportError:
    raise
except Exception as exc:  # missing sources, read-only tree, dlopen failure...
    raise ImportError(f"native BLS unavailable: {exc}") from exc


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else \
        ctypes.cast(ctypes.c_char_p(b"\x00"), ctypes.POINTER(ctypes.c_uint8))


def _sk_to_bytes(sk) -> bytes:
    v = int(sk) if isinstance(sk, int) else int.from_bytes(bytes(sk), "big")
    if not 0 < v < _R:
        raise ValueError("secret key out of range")
    return v.to_bytes(32, "big")


def SkToPk(sk) -> bytes:
    out = (ctypes.c_uint8 * 48)()
    _lib.bls_sk_to_pk(_buf(_sk_to_bytes(sk)), out)
    return bytes(out)


def Sign(sk, message: bytes) -> bytes:
    msg = bytes(message)
    out = (ctypes.c_uint8 * 96)()
    _lib.bls_sign(_buf(_sk_to_bytes(sk)), _buf(msg), len(msg), out)
    return bytes(out)


def KeyValidate(pubkey: bytes) -> bool:
    pk = bytes(pubkey)
    if len(pk) != 48:
        return False
    return bool(_lib.bls_key_validate(_buf(pk)))


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    pk, msg, sig = bytes(pubkey), bytes(message), bytes(signature)
    if len(pk) != 48 or len(sig) != 96:
        return False
    return bool(_lib.bls_verify(_buf(pk), _buf(msg), len(msg), _buf(sig)))


def Aggregate(signatures: Sequence[bytes]) -> bytes:
    sigs = [bytes(s) for s in signatures]
    if len(sigs) == 0:
        raise ValueError("cannot aggregate zero signatures")
    if any(len(s) != 96 for s in sigs):
        raise ValueError("malformed signature length")
    flat = b"".join(sigs)
    out = (ctypes.c_uint8 * 96)()
    if not _lib.bls_aggregate(_buf(flat), len(sigs), out):
        # reproduce the oracle's exact exception type (DeserializationError
        # vs ValueError) so backend choice never changes caller behavior
        from . import ciphersuite as _py

        return _py.Aggregate(sigs)
    return bytes(out)


def AggregatePKs(pubkeys: Sequence[bytes]) -> bytes:
    pks = [bytes(p) for p in pubkeys]
    if len(pks) == 0:
        raise ValueError("cannot aggregate zero pubkeys")
    if any(len(p) != 48 for p in pks):
        raise ValueError("malformed pubkey length")
    flat = b"".join(pks)
    out = (ctypes.c_uint8 * 48)()
    if not _lib.bls_aggregate_pks(_buf(flat), len(pks), out):
        from . import ciphersuite as _py

        return _py.AggregatePKs(pks)
    return bytes(out)


# Validated + decompressed pubkeys (canonical affine x||y): the same
# validator keys recur in every attestation, so later aggregates skip both
# the subgroup scalar mult and the decompression square root (same idea as
# the oracle's lru_cache on pubkey_to_point, curve.py:269-276).
_AFFINE_PKS: dict = {}
_AFFINE_PKS_MAX = 1 << 20


def _affine_of(pk: bytes):
    """96-byte affine coordinates for a validated pubkey, or None if the
    key is malformed/out-of-subgroup/infinity."""
    cached = _AFFINE_PKS.get(pk)
    if cached is not None:
        return cached
    out = (ctypes.c_uint8 * 96)()
    if not _lib.bls_decompress_pubkey(_buf(pk), out):
        return None
    xy = bytes(out)
    if len(_AFFINE_PKS) < _AFFINE_PKS_MAX:
        _AFFINE_PKS[pk] = xy
    return xy


def FastAggregateVerify(pubkeys: Sequence[bytes], message: bytes, signature: bytes) -> bool:
    pks = [bytes(p) for p in pubkeys]
    sig = bytes(signature)
    if len(pks) == 0 or len(sig) != 96 or any(len(p) != 48 for p in pks):
        return False
    msg = bytes(message)
    affines = []
    for p in pks:
        xy = _affine_of(p)
        if xy is None:
            return False  # invalid pubkey: the aggregate cannot verify
        affines.append(xy)
    flat = b"".join(affines)
    return bool(
        _lib.bls_fast_aggregate_verify_affine(
            _buf(flat), len(pks), _buf(msg), len(msg), _buf(sig)
        )
    )


def _batch_call_flat(counts, flat: bytes, msgs, sigs, seed, stats=None) -> bool:
    """The ONE marshal + seed-handling path under both batch entry points:
    packs the flat-affine buffers, draws the RLC seed (``os.urandom`` once
    per batch unless a deterministic seed is supplied), and dispatches the
    timed native call.  ``stats``, when given, is a mutable mapping whose
    ``hash_to_g2_s``/``msm_s``/``miller_s``/``marshal_s`` keys accumulate
    the native per-phase breakdown plus this function's own Python-side
    marshalling time."""
    k = len(counts)
    if seed is None:
        seed = os.urandom(32)
    elif len(seed) != 32:
        # the C DRBG unconditionally reads 32 bytes; fail fast rather than
        # hand it a short buffer
        raise ValueError(f"seed must be exactly 32 bytes, got {len(seed)}")
    t0 = time.perf_counter()
    args = (
        k,
        _buf(flat),
        (ctypes.c_size_t * k)(*counts),
        _buf(b"".join(msgs)),
        (ctypes.c_size_t * k)(*[len(m) for m in msgs]),
        _buf(b"".join(sigs)),
        _buf(seed),
    )
    py_marshal = time.perf_counter() - t0
    phases = (ctypes.c_double * 4)()
    ok = bool(_lib.bls_batch_fast_aggregate_verify_affine_timed(
        *args, phases))
    if stats is not None:
        stats["hash_to_g2_s"] += phases[0]
        stats["msm_s"] += phases[1]
        stats["miller_s"] += phases[2]
        stats["marshal_s"] += phases[3] + py_marshal
    return ok


def BatchFastAggregateVerify(items, seed: bytes = None, stats=None) -> bool:
    """Batched FastAggregateVerify: ``items`` is a sequence of
    ``(pubkeys, message, signature)`` triples; True iff EVERY item verifies.

    One random-linear-combination pairing product with a single shared
    final exponentiation (C side: bls_batch_fast_aggregate_verify_affine,
    MSM-folded interior).  Soundness 2^-128 per batch over the RLC seed
    (os.urandom unless a deterministic ``seed`` is supplied for test
    replay).  This is the capability the reference's milagro slot exists
    for — BLS cheap enough for the mainnet workload (reference seam:
    eth2spec/utils/bls.py:67-74).  The compressed-key path only resolves
    keys through the affine cache; marshal + seed handling are the same
    ``_batch_call_flat`` the preflattened entry point uses.
    """
    triples = list(items)
    if not triples:
        return True
    counts, affines, msgs, sigs = [], [], [], []
    for pubkeys, message, signature in triples:
        pks = [bytes(p) for p in pubkeys]
        sig = bytes(signature)
        if len(pks) == 0 or len(sig) != 96 or any(len(p) != 48 for p in pks):
            return False
        for p in pks:
            xy = _affine_of(p)
            if xy is None:
                return False  # invalid member pubkey: that item cannot verify
            affines.append(xy)
        counts.append(len(pks))
        msgs.append(bytes(message))
        sigs.append(sig)
    return _batch_call_flat(counts, b"".join(affines), msgs, sigs, seed,
                            stats=stats)


def pubkey_affine(pubkey: bytes):
    """Validated 96-byte affine x||y for a compressed pubkey, or None when
    malformed / off-subgroup / infinity (cached; the block-transition
    engine gathers these into per-registry coordinate matrices so batch
    entries skip the per-member dict walk)."""
    return _affine_of(bytes(pubkey))


def pubkey_affine_batch(pubkeys):
    """``pubkey_affine`` for a whole key set in ONE native call: the
    sqrt + subgroup check of every uncached key fans across the native
    thread pool instead of paying a ctypes round-trip each (the registry
    affine-matrix cold build decompresses ~8k unique keys).  Returns
    {pubkey: 96-byte affine or None}, and seeds the per-key cache."""
    pubkeys = {bytes(pk) for pk in pubkeys}
    out = {}
    fresh = []
    for pk in pubkeys:
        cached = _AFFINE_PKS.get(pk)
        if cached is not None:
            out[pk] = cached
        elif len(pk) != 48:
            out[pk] = None
        else:
            fresh.append(pk)
    if fresh:
        flat = b"".join(fresh)
        xys = (ctypes.c_uint8 * (96 * len(fresh)))()
        ok = (ctypes.c_uint8 * len(fresh))()
        _lib.bls_decompress_pubkeys(_buf(flat), len(fresh), xys, ok)
        raw = bytes(xys)
        for i, pk in enumerate(fresh):
            if ok[i]:
                xy = raw[96 * i: 96 * (i + 1)]
                out[pk] = xy
                if len(_AFFINE_PKS) < _AFFINE_PKS_MAX:
                    _AFFINE_PKS[pk] = xy
            else:
                out[pk] = None
    return out


def clear_affine_cache() -> None:
    """Drop the decompressed-pubkey cache.  Measurement control: an A/B
    bench leg that should pay its own cold decompression+membership cost
    must not inherit the other leg's warm cache."""
    _AFFINE_PKS.clear()


def BatchFastAggregateVerifyFlat(counts: Sequence[int], flat_affines: bytes,
                                 messages: Sequence[bytes],
                                 signatures: Sequence[bytes],
                                 seed: bytes = None, stats=None) -> bool:
    """Preflattened BatchFastAggregateVerify: the member pubkeys of every
    item arrive as one contiguous affine-coordinate buffer (96-byte x||y
    each, item i owning ``counts[i]`` consecutive entries) instead of
    per-member compressed keys.  Coordinates must come from
    ``pubkey_affine`` (validated + subgroup-checked); the C side trusts
    them, exactly as it trusts the ``_affine_of`` cache in the compressed
    path.  Same RLC multi-pairing and soundness as
    ``BatchFastAggregateVerify``; ``stats`` forwards to the shared
    ``_batch_call_flat`` per-phase accumulator."""
    counts = [int(c) for c in counts]
    k = len(counts)
    if k == 0:
        return True
    sigs = [bytes(s) for s in signatures]
    msgs = [bytes(m) for m in messages]
    if len(sigs) != k or len(msgs) != k:
        raise ValueError(f"{k} counts vs {len(msgs)} messages / {len(sigs)} signatures")
    if any(c <= 0 for c in counts) or any(len(s) != 96 for s in sigs):
        return False
    flat = bytes(flat_affines)
    if len(flat) != 96 * sum(counts):
        raise ValueError("affine buffer size inconsistent with counts")
    return _batch_call_flat(counts, flat, msgs, sigs, seed, stats=stats)


def AggregateVerify(pubkeys: Sequence[bytes], messages: Sequence[bytes], signature: bytes) -> bool:
    pks = [bytes(p) for p in pubkeys]
    msgs = [bytes(m) for m in messages]
    sig = bytes(signature)
    if len(pks) != len(msgs) or len(pks) == 0:
        return False
    if len(sig) != 96 or any(len(p) != 48 for p in pks):
        return False
    flat_pks = b"".join(pks)
    flat_msgs = b"".join(msgs)
    lens = (ctypes.c_size_t * len(msgs))(*[len(m) for m in msgs])
    return bool(
        _lib.bls_aggregate_verify(_buf(flat_pks), len(pks), _buf(flat_msgs), lens, _buf(sig))
    )


def G1MSM(points_xy: bytes, scalars_be: bytes) -> bytes:
    """Pippenger multi-scalar multiplication over G1 (the KZG commitment
    core — reference capability: specs/eip4844/beacon-chain.md:112-120
    ``g1_lincomb``).  ``points_xy`` holds n canonical affine x||y pairs
    (96 bytes each; subgroup membership is the caller's invariant),
    ``scalars_be`` n 32-byte big-endian scalars already reduced mod r.
    Returns the compressed 48-byte sum; raises ValueError on malformed
    coordinates or off-curve points."""
    if len(points_xy) % 96 or len(scalars_be) % 32:
        raise ValueError("points must be 96-byte x||y, scalars 32-byte BE")
    n = len(points_xy) // 96
    if n != len(scalars_be) // 32:
        raise ValueError(f"{n} points vs {len(scalars_be) // 32} scalars")
    out = (ctypes.c_uint8 * 48)()
    if not _lib.bls_g1_msm(_buf(points_xy), _buf(scalars_be), n, out):
        raise ValueError("malformed or off-curve MSM input point")
    return bytes(out)


def G2MSM(points: bytes, scalars_be: bytes) -> bytes:
    """Variable-base Pippenger multi-scalar multiplication over G2 — the
    bucketed machinery behind the batch verifier's signature fold
    (``sum_i [r_i]sig_i`` in one pass instead of k serial double-and-add
    chains), exported for differential pinning.  ``points`` holds n
    compressed G2 points (96 bytes each, fully validated including the
    psi-based subgroup check; infinity entries contribute the identity),
    ``scalars_be`` n 32-byte big-endian scalars already reduced mod r.
    Returns the compressed 96-byte sum; raises ValueError on malformed or
    off-subgroup points."""
    if len(points) % 96 or len(scalars_be) % 32:
        raise ValueError("points must be 96-byte compressed G2, scalars 32-byte BE")
    n = len(points) // 96
    if n != len(scalars_be) // 32:
        raise ValueError(f"{n} points vs {len(scalars_be) // 32} scalars")
    out = (ctypes.c_uint8 * 96)()
    if not _lib.bls_g2_msm(_buf(points), _buf(scalars_be), n, out):
        raise ValueError("malformed or off-subgroup G2 MSM input point")
    return bytes(out)


def h2c_cache_stats() -> dict:
    """Hit/miss/size counters of the native bounded hash_to_g2 cache that
    fronts the batch verifier's per-message hashing."""
    out = (ctypes.c_uint64 * 3)()
    _lib.bls_h2c_cache_stats(out)
    return {"hits": int(out[0]), "misses": int(out[1]), "size": int(out[2])}


def clear_h2c_cache() -> None:
    """Drop the native hash_to_g2 cache (and its counters).  Measurement
    control, like ``clear_affine_cache``: a bench leg that should pay its
    own message hashing must not inherit a warm cache."""
    _lib.bls_h2c_cache_clear()


# window count of the C side's fixed-base layout, read from the library so
# the table buffer Python allocates can never drift from what C writes
_MSM_FIXED_WINDOWS = _lib.bls_g1_msm_fixed_windows()


def G1MSMPrecompute(points_xy: bytes) -> bytes:
    """One-time fixed-base expansion of n affine points into the shifted
    window table consumed by G1MSMFixed (window-major, 96 bytes/entry)."""
    if len(points_xy) % 96:
        raise ValueError("points must be 96-byte x||y")
    n = len(points_xy) // 96
    table = (ctypes.c_uint8 * (96 * n * _MSM_FIXED_WINDOWS))()
    rc = _lib.bls_g1_msm_precompute(_buf(points_xy), n, table)
    if rc != _MSM_FIXED_WINDOWS:
        raise ValueError("malformed or off-curve MSM input point")
    return bytes(table)


def G1MSMFixed(table: bytes, n: int, scalars_be: bytes) -> bytes:
    """Fixed-base MSM against a G1MSMPrecompute table: one bucket pass, no
    inter-window doubling chain (~1.8x the on-the-fly Pippenger at blob
    scale, on top of the table's one-time cost).  The C side sanity-checks
    the first table entry against the curve, so a table from an
    incompatible build (or a torn write that survived the disk cache's
    digest) raises the ValueError below instead of returning garbage."""
    if len(scalars_be) != 32 * n or len(table) != 96 * n * _MSM_FIXED_WINDOWS:
        raise ValueError("table/scalar sizes inconsistent with n")
    out = (ctypes.c_uint8 * 48)()
    if not _lib.bls_g1_msm_fixed(_buf(table), n, _buf(scalars_be), out):
        raise ValueError("corrupted MSM table")
    return bytes(out)


# --- diagnostics / test hooks ----------------------------------------------

def hash_to_g2_compressed(message: bytes, dst: bytes) -> bytes:
    msg, d = bytes(message), bytes(dst)
    out = (ctypes.c_uint8 * 96)()
    if not _lib.bls_hash_to_g2(_buf(msg), len(msg), _buf(d), len(d), out):
        raise ValueError("DST must be <= 255 bytes")
    return bytes(out)


def pairing_bytes(p_g1: bytes, q_g2: bytes) -> bytes:
    """e(P, Q) as 12 canonical big-endian 48-byte Fp values (test hook)."""
    out = (ctypes.c_uint8 * 576)()
    if not _lib.bls_pairing(_buf(bytes(p_g1)), _buf(bytes(q_g2)), out):
        raise ValueError("invalid pairing input")
    return bytes(out)


def sha256(data: bytes) -> bytes:
    out = (ctypes.c_uint8 * 32)()
    _lib.bls_sha256(_buf(bytes(data)), len(bytes(data)), out)
    return bytes(out)
