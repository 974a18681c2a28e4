"""SHA-256 hashing backends for SSZ merkleization.

This is the hasher plugin seam: the reference hard-codes
``hashlib.sha256`` (eth2spec/utils/hash_function.py:8-9); here the merkle
layer-hash is pluggable so a whole tree layer can be hashed as one batch —
on host via hashlib, or on the GPU via the hand-written SHA-256 kernel K1 in
``consensus_specs_tpu_torch.ops.sha256`` (the ``"torch"`` backend).

Two batch APIs.  ``hash_layer(blocks)``: ``blocks`` is a list of 64-byte
inputs (two concatenated 32-byte child roots); the result is the list of
32-byte parent digests.  A backend may also register a wave hasher
(``register_wave_backend``), which runs a whole merkle wave schedule at
once: ``node.merkle_root`` hands it every tree of at least
``MIN_DEVICE_TREE`` unhashed branch nodes, so that the ``"torch"`` backend
uploads the known child digests once, hashes every wave on the card and
downloads every digest once.  The hashlib backend has none.  Merkleization
in ``node.py`` always funnels through the active backend, so swapping
backends changes performance only, never bytes.
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


# Trees with fewer unhashed branch nodes than this are hashed one wave at
# a time (``hash_layer``) even when the active backend has a wave hasher.
MIN_DEVICE_TREE = 4096


def register_backend(name: str, fn: Callable[[List[bytes]], List[bytes]]) -> None:
    _BACKENDS[name] = fn


# -- whole-tree wave hashing (optional backend capability) ------------------
#
# A wave backend runs an entire merkle wave schedule in one call:
# ``fn(known, waves) -> digests`` where ``known`` is the list of
# already-rooted 32-byte child digests, ``waves`` is a list of
# (left_idx, right_idx) int32 index-array pairs into the digest pool
# (known rows first, then every prior wave's outputs), and the result is
# the concatenated 32-byte outputs of every wave.  This removes the
# per-tree-level host<->device round trip of layered hashing.

_WAVE_BACKENDS: Dict[str, Callable] = {}


def register_wave_backend(name: str, fn: Callable) -> None:
    _WAVE_BACKENDS[name] = fn


def get_wave_hasher():
    """The active backend's whole-tree wave hasher, or None if the active
    backend hashes per-layer only (hashlib default)."""
    return _WAVE_BACKENDS.get(_active_name)


# Device backends register lazily on selection (importing them pulls in
# torch, which SSZ-only consumers must not pay for).  A lazy backend's
# ``hash_layer`` and ``hash_waves`` take a ``device=`` keyword, bound here
# when selected, to the same device.
_LAZY_BACKENDS = {
    "torch": "consensus_specs_tpu_torch.ops.sha256",
}


def set_backend(name: str, device=None) -> None:
    """Select the active layer and wave hasher.  For ``"torch"``,
    ``device`` is where layers and wave schedules are hashed: None means
    the CUDA card (raising on a host without one); ``"cpu"`` must be asked
    for explicitly."""
    global _active, _active_name
    if name in _LAZY_BACKENDS:
        import functools
        import importlib

        from consensus_specs_tpu_torch._device import resolve_device

        module = importlib.import_module(_LAZY_BACKENDS[name])
        resolved = resolve_device(device)
        register_backend(name, functools.partial(module.hash_layer,
                                                 device=resolved))
        register_wave_backend(name, functools.partial(module.hash_waves,
                                                      device=resolved))
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
