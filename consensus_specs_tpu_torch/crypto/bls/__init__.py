"""BLS backend selector — the plugin seam the spec modules import.

Behavioral twin of the reference's eth2spec/utils/bls.py:
  * module-global backend rebinding (use_python / use_native), mirroring
    use_py_ecc/use_milagro (bls.py:17-30)
  * ``bls_active`` kill-switch + ``only_with_bls`` decorator returning
    stub values when off (bls.py:6, 33-44) — tests run 100x faster
  * Verify-family wrappers catch every exception and return False
    (bls.py:47-74): malformed inputs are invalid, never fatal

Backends:
  * "python": the from-scratch pure-Python oracle in this package
  * "native": from-scratch C++ (crypto/bls/native/), the fast host path —
    the role the reference fills with its Rust milagro binding
  * "torch": the batched device pipeline (``ops/bls``), the card's
    backend and the counterpart of the reference's "jax" — registered
    lazily.  Its pairing checks run on the CUDA card (``ops.bls.set_device``
    picks another device; without a card it raises).  There is no
    fallback to the host: a kernel that fails, or a missing card, raises
    ``ops.sha256.KernelError``, which the Verify-family wrappers let
    through instead of turning it into a False verdict.  The one host
    path is the reference's own: a batch item carrying a point at
    infinity goes to the pure-Python pairing oracle.
"""
from __future__ import annotations

from types import SimpleNamespace

from consensus_specs_tpu_torch.ops.sha256 import KernelError

from . import ciphersuite as _py_backend

G2_POINT_AT_INFINITY = _py_backend.G2_POINT_AT_INFINITY

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48
STUB_COORDINATES = G2_POINT_AT_INFINITY

bls_active = True

_backends = {"python": _py_backend}
_backend_name = "python"
bls = _py_backend


def register_backend(name: str, module) -> None:
    _backends[name] = module


def use_backend(name: str) -> None:
    global bls, _backend_name
    if name == "torch" and "torch" not in _backends:
        from consensus_specs_tpu_torch.ops import bls as device_bls

        register_backend("torch", device_bls.backend())
    if name == "native" and "native" not in _backends:
        from . import native

        register_backend("native", native)
    bls = _backends[name]
    _backend_name = name


def use_python() -> None:
    use_backend("python")


def use_native() -> None:
    use_backend("native")


def use_torch() -> None:
    use_backend("torch")


def use_fastest() -> None:
    """Prefer the native C++ backend, falling back to the Python oracle
    (mirrors the reference's bls_active default of the fastest available
    backend for CI; eth2spec/utils/bls.py:8-30).  It never selects the
    device backend: the vector generators sign and verify on the host."""
    try:
        use_backend("native")
    except ImportError:
        use_backend("python")


def backend_name() -> str:
    return _backend_name


def only_with_bls(alt_return=None):
    """Decorator: skip the wrapped function when BLS is disabled
    (reference: eth2spec/utils/bls.py:33-44)."""

    def decorator(fn):
        def wrapper(*args, **kwargs):
            if not bls_active:
                return alt_return
            return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        return wrapper

    return decorator


@only_with_bls(alt_return=True)
def Verify(PK, message, signature):
    from consensus_specs_tpu_torch import tracing

    tracing.count("bls.verify")
    try:
        return bls.Verify(PK, message, signature)
    except KernelError:
        raise
    except Exception:
        return False


@only_with_bls(alt_return=True)
def AggregateVerify(pubkeys, messages, signature):
    try:
        return bls.AggregateVerify(pubkeys, messages, signature)
    except KernelError:
        raise
    except Exception:
        return False


@only_with_bls(alt_return=True)
def FastAggregateVerify(pubkeys, message, signature):
    from consensus_specs_tpu_torch import tracing

    tracing.count("bls.fast_aggregate_verify")
    tracing.count("bls.fast_aggregate_verify.pubkeys", len(pubkeys))
    stack = _deferred_stack.get()
    if stack:
        stack[-1].entries.append(
            (tuple(bytes(p) for p in pubkeys), bytes(message), bytes(signature))
        )
        return True  # optimistic; settled at scope exit
    try:
        return bls.FastAggregateVerify(pubkeys, message, signature)
    except KernelError:
        raise
    except Exception:
        return False


# --- deferred (batched) verification ----------------------------------------
# The sanctioned sundry-layer substitution for the block-processing hot path
# (SURVEY §7; reference analogue setup.py:488-492): every FastAggregateVerify
# issued inside the scope is collected and settled in ONE batched pairing
# product with a single shared final exponentiation.

# per-context scope stack: a ContextVar (not a module list) so concurrent
# block processing in threads or asyncio tasks cannot interleave entries
# across unrelated deferred scopes
import contextvars as _contextvars

_deferred_stack: "_contextvars.ContextVar[tuple]" = _contextvars.ContextVar(
    "bls_deferred_stack", default=())


def _batch_verify(entries) -> bool:
    """True iff every (pubkeys, message, signature) entry verifies."""
    if not entries:
        return True
    backend_batch = getattr(bls, "BatchFastAggregateVerify", None)
    if backend_batch is not None:
        try:
            return bool(backend_batch(entries))
        except KernelError:
            raise
        except Exception:
            return False
    for pks, msg, sig in entries:  # backends without a batch API
        try:
            if not bls.FastAggregateVerify(pks, msg, sig):
                return False
        except KernelError:
            raise
        except Exception:
            return False
    return True


def _first_invalid(entries):
    """Index of the FIRST failing entry, or None if all verify.

    Bisects with sub-batch calls: O(log n) batched verifications instead of
    n sequential ones, and always lands on the leftmost failure so deferred
    semantics report the same culprit the sequential path would have."""
    if _batch_verify(entries):
        return None
    lo, hi = 0, len(entries)
    # invariant: entries[:lo] all verify; at least one failure in [lo, hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _batch_verify(entries[lo:mid]):
            lo = mid
        else:
            hi = mid
    return lo


class deferred_fast_aggregate_verify:
    """Context manager: FastAggregateVerify calls inside the scope return
    True optimistically and are settled as one batch on exit.

    Failure semantics mirror the sequential path:
      * all signatures valid -> scope exits cleanly (and any structural
        exception raised inside propagates unchanged);
      * some signature invalid -> AssertionError naming the first failing
        check in call order — the same check the sequential path would have
        tripped on — even if a later operation raised first while running
        optimistically.
    """

    def __enter__(self):
        self.entries = []
        self._token = _deferred_stack.set(_deferred_stack.get() + (self,))
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _deferred_stack.get()
        assert stack and stack[-1] is self, "deferred verification scopes must nest"
        _deferred_stack.reset(self._token)
        if not bls_active or not self.entries:
            return False
        first_bad = _first_invalid(self.entries)
        if first_bad is not None:
            raise AssertionError(
                f"deferred signature verification failed: batch entry "
                f"{first_bad} of {len(self.entries)} is invalid"
            ) from exc
        return False


@only_with_bls(alt_return=STUB_SIGNATURE)
def Aggregate(signatures):
    return bls.Aggregate(signatures)


@only_with_bls(alt_return=STUB_SIGNATURE)
def Sign(SK, message):
    return bls.Sign(SK, message)


@only_with_bls(alt_return=True)
def KeyValidate(pubkey):
    return bls.KeyValidate(pubkey)


def AggregatePKs(pubkeys):
    # NOT bls_active-gated: aggregation is deterministic state content
    # (sync-committee aggregate pubkeys live in the state), so it must
    # compute even when signature *verification* is stubbed off — the
    # reference's AggregatePKs is likewise ungated (utils/bls.py).
    return bls.AggregatePKs(pubkeys)


@only_with_bls(alt_return=STUB_PUBKEY)
def SkToPk(SK):
    return bls.SkToPk(SK)


@only_with_bls(alt_return=None)
def Pairing(p_g1, q_g2):
    """e(P, Q) as a comparable GT element (the sharding spec's degree-proof
    check compares two pairings; reference analogue: py_ecc pairing via
    the bls wrapper).  Accepts 48-byte G1 / 96-byte G2 encodings or curve
    Points.  With BLS disabled both sides stub to None and compare equal."""
    from .curve import Point, g1_from_bytes, g2_from_bytes
    from .pairing import pairing

    p = p_g1 if isinstance(p_g1, Point) else g1_from_bytes(bytes(p_g1))
    q = q_g2 if isinstance(q_g2, Point) else g2_from_bytes(bytes(q_g2))
    return pairing(p, q)
