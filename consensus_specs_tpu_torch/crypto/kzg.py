"""KZG polynomial commitments over BLS12-381 G1 — the eip4844 crypto core
(reference capability: specs/eip4844/beacon-chain.md KZG core + the
trusted-setup preset entries KZG_SETUP_G2/KZG_SETUP_LAGRANGE).

The INSECURE deterministic trusted setup mirrors the spec's "minimal
insecure variant may be used during testing": powers of a fixed secret.
Commitment computation is a G1 multi-scalar multiplication; the host path
here is the correctness oracle, the batched device MSM lives in
ops/kzg.py and is differentially tested against this module.

Port of ``consensus_specs_tpu/crypto/kzg.py``: the same code over the
port's ``crypto.bls``; the fixed-base MSM tables persist in the port's
build directory.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

from .bls.curve import Point, g1_from_bytes, g1_generator, g1_infinity, g1_to_bytes
from .bls.fields import P as _FQ_P
from .fr import R, ifft, root_of_unity

# the spec's insecure testing secret must only ever appear in presets
INSECURE_SECRET = 1337


@lru_cache(maxsize=4)
def setup_monomial(n: int, secret: int = INSECURE_SECRET) -> List[Point]:
    """[G, sG, s^2 G, ...] — monomial-basis setup."""
    out = []
    acc = 1
    g = g1_generator()
    for _ in range(n):
        out.append(g.mul(acc))
        acc = acc * secret % R
    return out


@lru_cache(maxsize=4)
def setup_g2_monomial(n: int, secret: int = INSECURE_SECRET) -> List[Point]:
    """[H, sH, s^2 H, ...] — G2-side setup (degree proofs, sharding)."""
    from .bls.curve import g2_generator

    out = []
    acc = 1
    h = g2_generator()
    for _ in range(n):
        out.append(h.mul(acc))
        acc = acc * secret % R
    return out


@lru_cache(maxsize=4)
def setup_lagrange(n: int, secret: int = INSECURE_SECRET) -> List[Point]:
    """Lagrange-basis setup over the order-n root-of-unity domain:
    L_i(s) * G, computed as the inverse NTT of the monomial setup's
    scalars (host: scalars first, then single scalar-mults)."""
    # L_i(s) over the domain: ifft of [1, s, s^2, ...] as evaluations?
    # Direct route: L_i(s) = prod_{j!=i} (s - w^j)/(w^i - w^j); for the
    # roots-of-unity domain this reduces to w^i (s^n - 1) / (n (s - w^i)).
    w = root_of_unity(n)
    s_pow_n_minus_1 = (pow(secret, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)
    g = g1_generator()
    out = []
    wi = 1
    for _ in range(n):
        denom_inv = pow((secret - wi) % R, R - 2, R)
        li = wi * s_pow_n_minus_1 % R * n_inv % R * denom_inv % R
        out.append(g.mul(li))
        wi = wi * w % R
    return out


def g1_lincomb(points: Sequence[Point], scalars: Sequence[int]) -> Point:
    """Multi-scalar multiplication (host oracle; naive double-and-add)."""
    acc = g1_infinity()
    for p, s in zip(points, scalars):
        s %= R
        if s:
            acc = acc + p.mul(s)
    return acc


def g1_msm_pippenger(points: Sequence[Point], scalars: Sequence[int],
                     window_bits: int = 8) -> Point:
    """Bucketed MSM — ~10x the naive oracle at blob size (4096 points).
    Differentially tested against g1_lincomb."""
    n_windows = (255 + window_bits - 1) // window_bits
    n_buckets = 1 << window_bits
    scalars = [s % R for s in scalars]
    acc = g1_infinity()
    for w in range(n_windows - 1, -1, -1):
        if w != n_windows - 1:
            for _ in range(window_bits):
                acc = acc.double()
        buckets = [None] * n_buckets
        shift = w * window_bits
        for p, s in zip(points, scalars):
            digit = (s >> shift) & (n_buckets - 1)
            if digit:
                buckets[digit] = p if buckets[digit] is None else buckets[digit] + p
        # bucket aggregation: sum_i i * bucket[i] via suffix running sums
        running = g1_infinity()
        window_sum = g1_infinity()
        for i in range(n_buckets - 1, 0, -1):
            if buckets[i] is not None:
                running = running + buckets[i]
            window_sum = window_sum + running
        acc = acc + window_sum
    return acc


_UNSET = object()
_NATIVE = _UNSET


def _native_mod():
    """The C++ BLS backend module, or None when unavailable (its fast G1
    arithmetic hosts the Pippenger MSM entry point bls_g1_msm)."""
    global _NATIVE
    if _NATIVE is _UNSET:
        try:
            from .bls import native as n

            _NATIVE = n
        except ImportError:
            _NATIVE = None
    return _NATIVE


# Affine x||y serialization of a point list, cached by list identity: the
# lru_cached setups are stable objects, and batch inversion (one modular
# inverse + 3n mults) keeps a cache miss cheap.  Strong refs keep ids valid.
_AFFINE_CACHE: dict = {}
_AFFINE_CACHE_MAX = 8


def _points_affine_bytes(points: Sequence[Point]) -> bytes:
    key = id(points)
    hit = _AFFINE_CACHE.get(key)
    if hit is not None and hit[0] is points:
        return hit[1]
    n = len(points)
    zs = [p.z.n for p in points]
    prefix = [1] * (n + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % _FQ_P
    inv = pow(prefix[n], _FQ_P - 2, _FQ_P)
    zinvs = [0] * n
    for i in range(n - 1, -1, -1):
        zinvs[i] = inv * prefix[i] % _FQ_P
        inv = inv * zs[i] % _FQ_P
    parts = []
    for p, zi in zip(points, zinvs):
        zi2 = zi * zi % _FQ_P
        x = p.x.n * zi2 % _FQ_P
        y = p.y.n * zi2 % _FQ_P * zi % _FQ_P
        parts.append(x.to_bytes(48, "big") + y.to_bytes(48, "big"))
    data = b"".join(parts)
    if len(_AFFINE_CACHE) >= _AFFINE_CACHE_MAX:
        _AFFINE_CACHE.clear()
    _AFFINE_CACHE[key] = (points, data)
    return data


# fixed-base tables (blob commitments always hit the same setup): id-keyed
# like _AFFINE_CACHE; one table is ~8.6 MB at blob scale, so keep few
_FIXED_TABLES: dict = {}
_FIXED_TABLES_MAX = 2


_MSM_ABI_TAG = None


def _msm_abi_tag(nat) -> str:
    """ABI fingerprint of the persisted table format: byte order, pointer
    width, and — the real behavioral probe — a digest of the serialized
    window table of the G1 generator.  Entries are raw Montgomery limbs in
    machine byte order, so any change to limb size, limb order, or the
    Montgomery representation on the build host changes this tag and the
    stale table becomes a cache miss instead of garbage input."""
    global _MSM_ABI_TAG
    if _MSM_ABI_TAG is None:
        import ctypes
        import hashlib
        import sys

        gen = g1_generator()
        gen_xy = (gen.x.n.to_bytes(48, "big") + gen.y.n.to_bytes(48, "big"))
        h = hashlib.sha256()
        h.update(sys.byteorder.encode())
        h.update(bytes([ctypes.sizeof(ctypes.c_void_p)]))
        h.update(nat.G1MSMPrecompute(gen_xy))
        _MSM_ABI_TAG = h.hexdigest()[:8]
    return _MSM_ABI_TAG


def _fixed_table_path(nat, flat: bytes) -> str:
    """The table's file in the port's build directory (``.build/``, which
    git ignores), named by the native library's source digest, the ABI tag
    and the points' digest."""
    import hashlib
    import os

    from consensus_specs_tpu_torch import _build

    sources = [os.path.join(nat._HERE, name) for name in nat._SOURCES]
    key = (_build.source_digest(sources, nat._FLAGS)[:8] + "_"
           + _msm_abi_tag(nat) + "_" + hashlib.sha256(flat).hexdigest()[:16])
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    return os.path.join(_build.BUILD_DIR, f"_msmtab_{key}.bin")


_MSM_TABLE_KIND = "msm-fixed-table"


def _load_or_build_fixed_table(nat, flat: bytes) -> bytes:
    """Disk-cached shifted-window table: the ~1-5 s expansion of a blob
    setup otherwise recurs in every process.  Keyed by (native source
    digest, ABI tag, points digest) in the PATH — the entries are raw
    Montgomery limbs, valid only for the exact library build *and host
    ABI* — and persisted through ``persist/atomic.py``: unique-temp +
    ``os.replace`` writes,
    trailing SHA-256, and the ABI tag bound INSIDE the envelope too, so
    even a renamed foreign table degrades to a miss.

    Failure containment: a truncated, damaged, or stale-tagged file
    fails verification and is REGENERATED in place; a reader can never
    observe a half-written table (the C side's on-curve entry-0 check
    stays as the tamper backstop behind both)."""
    from consensus_specs_tpu_torch.persist import atomic

    path = _fixed_table_path(nat, flat)
    tag = _msm_abi_tag(nat)
    expect = 96 * (len(flat) // 96) * nat._MSM_FIXED_WINDOWS
    try:
        return atomic.read_artifact(path, _MSM_TABLE_KIND, tag,
                                    expected_payload_len=expect)
    except atomic.ArtifactError:
        pass  # missing / truncated / damaged / stale: rebuild below
    table = nat.G1MSMPrecompute(flat)
    try:
        atomic.write_artifact(path, table, _MSM_TABLE_KIND, tag)
    except OSError:
        pass  # read-only tree: rebuild per process
    return table


def g1_msm_native(points: Sequence[Point], scalars: Sequence[int],
                  fixed_base: bool = False):
    """Compressed-MSM fast path through the C++ Pippenger (bls_g1_msm) —
    ~20x the Python bucket MSM at blob scale.  With ``fixed_base`` the
    shifted-window table is precomputed once per point list and each call
    is a single bucket pass (bls_g1_msm_fixed) — the shape KZG wants, since
    every commitment targets the same trusted setup.  Returns compressed
    bytes, or None when the native backend is absent or an input point is
    at infinity (not representable in affine form).  Differentially pinned
    to g1_msm_pippenger/g1_lincomb in tests/test_torch_kzg.py."""
    nat = _native_mod()
    if nat is None or any(p.is_infinity() for p in points):
        return None
    sc = b"".join((s % R).to_bytes(32, "big") for s in scalars)
    if fixed_base and len(points) == len(scalars):
        key = id(points)
        hit = _FIXED_TABLES.get(key)
        if hit is None or hit[0] is not points:
            table = _load_or_build_fixed_table(
                nat, _points_affine_bytes(points))
            if len(_FIXED_TABLES) >= _FIXED_TABLES_MAX:
                _FIXED_TABLES.clear()
            _FIXED_TABLES[key] = (points, table)
        else:
            table = hit[1]
        return nat.G1MSMFixed(table, len(points), sc)
    flat = _points_affine_bytes(points)[: 96 * len(scalars)]
    return nat.G1MSM(flat, sc)


def blob_to_kzg(blob: Sequence[int], lagrange_setup: Sequence[Point]) -> bytes:
    """Commit to a blob of field elements given in evaluation form."""
    assert len(blob) <= len(lagrange_setup)
    for v in blob:
        assert 0 <= v < R
    if len(blob) == len(lagrange_setup):
        # full-width commitment (the spec's shape): fixed-base tables hit
        # across blobs because the lru_cached setup is a stable object
        nat = g1_msm_native(lagrange_setup, blob, fixed_base=True)
        if nat is not None:
            return nat
    if len(blob) >= 64:  # bucketed MSM wins well before blob scale
        # pass the UNSLICED setup (g1_msm_native truncates the serialized
        # bytes itself) so the id-keyed affine cache hits across calls
        nat = g1_msm_native(lagrange_setup, blob)
        if nat is not None:
            return nat
        return g1_to_bytes(g1_msm_pippenger(lagrange_setup[: len(blob)], blob))
    return g1_to_bytes(g1_lincomb(lagrange_setup[: len(blob)], blob))


def commitment_to_point(commitment: bytes) -> Point:
    return g1_from_bytes(bytes(commitment))


def evaluate_blob_poly(blob: Sequence[int], x: int) -> int:
    """Evaluate the polynomial interpolating the blob (evaluation form on
    the root-of-unity domain) at an arbitrary x (barycentric form)."""
    n = len(blob)
    w = root_of_unity(n)
    if pow(x, n, R) == 1:  # x on the domain: direct read-off
        wi = 1
        for i in range(n):
            if wi == x % R:
                return blob[i] % R
            wi = wi * w % R
    num = (pow(x, n, R) - 1) * pow(n, R - 2, R) % R
    acc = 0
    wi = 1
    for i in range(n):
        acc = (acc + blob[i] * wi % R * pow((x - wi) % R, R - 2, R)) % R
        wi = wi * w % R
    return acc * num % R


def verify_commitment_matches_poly(commitment: bytes, blob: Sequence[int],
                                   secret: int = INSECURE_SECRET) -> bool:
    """Test-only oracle check: C == P(s)*G for the insecure setup."""
    expected = g1_generator().mul(evaluate_blob_poly(blob, secret))
    return bytes(commitment) == g1_to_bytes(expected)
