"""SSZ value -> YAML/JSON-encodable structure (reference capability:
eth2spec/debug/encode.py; adapted to this framework's view classes).

Encoding contract (identical observable output to the reference, so
generated vectors' yaml parts are cross-client comparable):
  * uints <= 8 bytes -> int; larger uints -> decimal string
  * boolean -> bool
  * Bitlist/Bitvector -> '0x' + serialized hex
  * byte types -> '0x' hex
  * sequences -> list of encoded elements
  * containers -> {field: encoded}, optionally with hash_tree_root keys
  * unions -> {'selector': int, 'value': encoded | None}
"""
from __future__ import annotations

from consensus_specs_tpu_torch.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch.ssz.types import (
    Bitlist,
    Bitvector,
    Container,
    List,
    Union,
    Vector,
    boolean,
    uint,
)


def encode(value, include_hash_tree_roots: bool = False):
    if isinstance(value, uint):
        if type(value).type_byte_length() > 8:
            return str(int(value))
        return int(value)
    if isinstance(value, boolean):
        return bool(value)
    if isinstance(value, (Bitlist, Bitvector)):
        return "0x" + serialize(value).hex()
    if isinstance(value, bytes):  # ByteVector / ByteList / raw bytes
        return "0x" + bytes(value).hex()
    if isinstance(value, (List, Vector)) or isinstance(value, list):
        return [encode(v, include_hash_tree_roots) for v in value]
    if isinstance(value, Container):
        out = {}
        for name in type(value)._field_names:
            field = getattr(value, name)
            out[name] = encode(field, include_hash_tree_roots)
            if include_hash_tree_roots:
                out[name + "_hash_tree_root"] = "0x" + hash_tree_root(field).hex()
        if include_hash_tree_roots:
            out["hash_tree_root"] = "0x" + hash_tree_root(value).hex()
        return out
    if isinstance(value, Union):
        inner = value.value
        return {
            "selector": int(value.selector),
            "value": None if inner is None else encode(inner, include_hash_tree_roots),
        }
    raise TypeError(f"cannot encode {type(value).__name__}: {value!r}")
