"""YAML/JSON structure -> SSZ value (inverse of encode.py; reference
capability: eth2spec/debug/decode.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.ssz.impl import hash_tree_root
from consensus_specs_tpu_torch.ssz.types import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Union,
    Vector,
    boolean,
    uint,
)


def decode(data, typ):
    if issubclass(typ, (uint, boolean)):
        return typ(int(data))
    if issubclass(typ, (ByteVector, ByteList)):
        return typ(bytes.fromhex(data[2:]))
    if issubclass(typ, (Bitlist, Bitvector)):
        # encode() emits the serialized bit form
        return typ.decode_bytes(bytes.fromhex(data[2:]))
    if issubclass(typ, (List, Vector)):
        elem = typ.ELEM_TYPE
        return typ([decode(v, elem) for v in data])
    if issubclass(typ, Container):
        kwargs = {}
        for name, ftyp in zip(typ._field_names, typ._field_types):
            kwargs[name] = decode(data[name], ftyp)
            htr_key = name + "_hash_tree_root"
            if htr_key in data:
                assert data[htr_key][2:] == hash_tree_root(kwargs[name]).hex()
        out = typ(**kwargs)
        if "hash_tree_root" in data:
            assert data["hash_tree_root"][2:] == hash_tree_root(out).hex()
        return out
    if issubclass(typ, Union):
        selector = int(data["selector"])
        opt = typ.OPTIONS[selector]
        if opt is None:
            assert data["value"] is None
            return typ(selector=selector, value=None)
        return typ(selector=selector, value=decode(data["value"], opt))
    raise TypeError(f"cannot decode into {typ!r}")
