"""SHA-256 hashing backends for SSZ merkleization.

This is the hasher plugin seam: the reference hard-codes
``hashlib.sha256`` (eth2spec/utils/hash_function.py:8-9); here the merkle
layer-hash is pluggable so a whole tree layer can be hashed as one batch —
on host via hashlib, or on the GPU via the hand-written SHA-256 kernel in
``consensus_specs_tpu_torch.ops.sha256`` (the ``"torch"`` backend).

The batch API is ``hash_layer(blocks)``: ``blocks`` is a list of 64-byte
inputs (two concatenated 32-byte child roots); the result is the list of
32-byte parent digests.  Merkleization in ``node.py`` always funnels
through the active backend, so swapping backends changes performance only,
never bytes.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List

# -- single-shot hash (used by spec `hash()` and small paths) ---------------


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# -- batched layer hashing ---------------------------------------------------


def _hashlib_hash_layer(blocks: List[bytes]) -> List[bytes]:
    h = hashlib.sha256
    return [h(b).digest() for b in blocks]


_BACKENDS: Dict[str, Callable[[List[bytes]], List[bytes]]] = {
    "hashlib": _hashlib_hash_layer,
}

_active_name = "hashlib"
_active: Callable[[List[bytes]], List[bytes]] = _hashlib_hash_layer

# Batches smaller than this always use hashlib regardless of the active
# backend: device dispatch overhead dominates tiny layers.
MIN_DEVICE_BATCH = 256


def register_backend(name: str, fn: Callable[[List[bytes]], List[bytes]]) -> None:
    _BACKENDS[name] = fn


# Device backends register lazily on selection (importing them pulls in
# torch, which SSZ-only consumers must not pay for).  A lazy backend's
# ``hash_layer`` takes a ``device=`` keyword, bound here when selected.
_LAZY_BACKENDS = {
    "torch": "consensus_specs_tpu_torch.ops.sha256",
}


def set_backend(name: str, device=None) -> None:
    """Select the active layer hasher.  For ``"torch"``, ``device`` is
    where layers are hashed: None means the CUDA card (raising on a host
    without one); ``"cpu"`` must be asked for explicitly."""
    global _active, _active_name
    if name in _LAZY_BACKENDS:
        import functools
        import importlib

        from consensus_specs_tpu_torch._device import resolve_device

        module = importlib.import_module(_LAZY_BACKENDS[name])
        register_backend(name, functools.partial(
            module.hash_layer, device=resolve_device(device)))
    elif device is not None:
        raise ValueError(f"backend {name!r} takes no device")
    _active = _BACKENDS[name]
    _active_name = name


def get_backend_name() -> str:
    return _active_name


def hash_layer(blocks: List[bytes]) -> List[bytes]:
    """Hash a list of 64-byte blocks into 32-byte digests."""
    if not blocks:
        return []
    if _active is not _hashlib_hash_layer and len(blocks) < MIN_DEVICE_BATCH:
        return _hashlib_hash_layer(blocks)
    return _active(blocks)


# -- zero-subtree roots ------------------------------------------------------
# zerohashes[i] = root of a depth-i tree of zero chunks
# (reference: eth2spec/utils/merkle_minimal.py:7-9)

ZERO_HASHES: List[bytes] = [b"\x00" * 32]
for _ in range(64):
    ZERO_HASHES.append(sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]))
