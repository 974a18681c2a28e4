"""SSZ facade: serialize / hash_tree_root / copy / uint_to_bytes.

Mirrors the reference seam eth2spec/utils/ssz/ssz_impl.py:8-25, which is
the interface the compiled spec modules call.  ``hash_tree_root`` routes
through the persistent node layer, whose layer hashing is backend-
pluggable (see hashing.py) — that is where the device batch path plugs in.
"""
from __future__ import annotations

from . import types as tp
from .node import merkle_root
from .types import Bytes32, View, boolean, uint


def serialize(obj) -> bytes:
    return obj.encode_bytes()


def hash_tree_root(obj) -> Bytes32:
    if isinstance(obj, (uint, boolean)):
        return Bytes32(int(obj).to_bytes(32, "little"))
    if isinstance(obj, (tp.ByteVector, tp.ByteList)):
        return Bytes32(obj.hash_tree_root())
    if isinstance(obj, View):
        return Bytes32(merkle_root(obj.get_backing()))
    raise TypeError(f"cannot hash_tree_root {type(obj).__name__}")


def copy(obj):
    if isinstance(obj, View):
        return obj.copy()
    return obj  # immutable value types


def uint_to_bytes(n: uint) -> bytes:
    """Serialize a uint to its type's byte length (little-endian).

    Reference: eth2spec custom `uint_to_bytes` (setup.py injects it from
    the uint type's byte length).
    """
    return int(n).to_bytes(type(n).TYPE_BYTE_LENGTH, "little")
