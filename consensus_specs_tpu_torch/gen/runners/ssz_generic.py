"""ssz_generic vector generator (reference capability:
tests/generators/ssz_generic/main.py): type-system conformance vectors
independent of any spec — valid roundtrip cases and invalid byte strings
per type family (uints, booleans, bitvectors/bitlists, vectors,
containers).

NOTE: no ``from __future__ import annotations`` — the test containers
need live type annotations for the SSZ field machinery.
"""
from random import Random
from typing import Iterable

from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.gen import gen_runner, gen_typing
from consensus_specs_tpu_torch.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch.ssz.types import (
    Bitlist,
    Bitvector,
    Container,
    List,
    Vector,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)


class SingleFieldTestStruct(Container):
    A: uint8


class SmallTestStruct(Container):
    A: uint16
    B: uint16


class FixedTestStruct(Container):
    A: uint8
    B: uint64
    C: uint32


class VarTestStruct(Container):
    A: uint16
    B: List[uint16, 1024]
    C: uint8


class ComplexTestStruct(Container):
    A: uint16
    B: List[uint16, 128]
    C: uint8
    D: List[uint8, 256]
    E: VarTestStruct
    F: Vector[FixedTestStruct, 4]


def _valid_case(typ, value):
    def fn():
        yield "serialized", "ssz", serialize(value)
        yield "value", "data", encode(value)
        yield "roots", "data", {"root": "0x" + hash_tree_root(value).hex()}

    return fn


def _invalid_case(typ, raw: bytes):
    def fn():
        try:
            typ.decode_bytes(raw)
        except Exception:
            yield "serialized", "ssz", raw
            return
        raise AssertionError(f"{typ} accepted invalid bytes {raw.hex()}")

    return fn


# --- type resolution (shared with gen/consumer.py) --------------------------

_CONTAINER_REGISTRY = {
    "SingleFieldTestStruct": SingleFieldTestStruct,
    "SmallTestStruct": SmallTestStruct,
    "FixedTestStruct": FixedTestStruct,
    "VarTestStruct": VarTestStruct,
    "ComplexTestStruct": ComplexTestStruct,
}

_UINTS = {8: uint8, 16: uint16, 32: uint32, 64: uint64, 128: uint128, 256: uint256}

_VEC_ELEMS = {"uint8": uint8, "uint16": uint16, "uint32": uint32,
              "uint64": uint64, "uint128": uint128, "uint256": uint256,
              "bool": boolean}


def resolve_case_type(handler: str, case_name: str):
    """The SSZ type a case name implies — the consumer-side half of the
    naming contract (docs/formats/ssz_generic/README.md)."""
    if handler == "boolean":
        return boolean
    if handler == "uints":
        assert case_name.startswith("uint_")
        return _UINTS[int(case_name.split("_")[1])]
    if handler == "bitvector":
        assert case_name.startswith("bitvec_")
        return Bitvector[int(case_name.split("_")[1])]
    if handler == "bitlist":
        assert case_name.startswith("bitlist_")
        return Bitlist[int(case_name.split("_")[1])]
    if handler == "basic_vector":
        assert case_name.startswith("vec_")
        _, elem, length = case_name.split("_")[:3]
        return Vector[_VEC_ELEMS[elem], int(length)]
    if handler == "containers":
        return _CONTAINER_REGISTRY[case_name.split("_")[0]]
    raise KeyError(f"unknown ssz_generic handler {handler}")


# --- case matrices -----------------------------------------------------------

def _uint_cases(rng) -> Iterable:
    for size, typ in _UINTS.items():
        nbytes = typ.type_byte_length()
        for label, val in (
            ("zero", 0),
            ("max", 256**nbytes - 1),
            ("random", rng.randrange(256**nbytes)),
            ("last_byte_empty", rng.randrange(256 ** (nbytes - 1))),
        ):
            yield "uints", f"uint_{size}_{label}", True, _valid_case(typ, typ(val))
        # wrong-length matrix: empty, one byte short, one byte long, doubled
        for label, raw in (
            ("nil", b""),
            ("one_byte_shorter", b"\x00" * (nbytes - 1)),
            ("one_byte_longer", b"\x00" * (nbytes + 1)),
            ("double_length", b"\xaa" * (nbytes * 2)),
        ):
            yield "uints", f"uint_{size}_{label}", False, _invalid_case(typ, raw)


def _boolean_cases(rng) -> Iterable:
    yield "boolean", "true", True, _valid_case(boolean, boolean(True))
    yield "boolean", "false", True, _valid_case(boolean, boolean(False))
    for label, raw in (
        ("byte_2", b"\x02"), ("byte_rev_nibble", b"\x10"),
        ("byte_full", b"\xff"), ("nil", b""), ("two_bytes", b"\x01\x00"),
    ):
        yield "boolean", f"{label}", False, _invalid_case(boolean, raw)


def _bitvector_cases(rng) -> Iterable:
    for n in (1, 2, 3, 4, 5, 8, 9, 16, 31, 512, 513):
        typ = Bitvector[n]
        bv = typ([rng.choice((True, False)) for _ in range(n)])
        yield "bitvector", f"bitvec_{n}_random", True, _valid_case(typ, bv)
        if n in (1, 8, 9, 512):
            yield "bitvector", f"bitvec_{n}_zero", True, _valid_case(
                typ, typ([False] * n))
            yield "bitvector", f"bitvec_{n}_max", True, _valid_case(
                typ, typ([True] * n))
        raw = serialize(bv)
        yield "bitvector", f"bitvec_{n}_extra_byte", False, _invalid_case(
            typ, raw + b"\x00")
        yield "bitvector", f"bitvec_{n}_one_byte_short", False, _invalid_case(
            typ, raw[:-1])
        if n % 8 != 0:
            # zeroed-padding-bit rule: bits above n in the last byte MUST be 0
            tampered = bytearray(raw)
            tampered[-1] |= 1 << (n % 8)  # lowest padding bit set
            yield "bitvector", f"bitvec_{n}_padding_bit_set", False, \
                _invalid_case(typ, bytes(tampered))
            high = bytearray(raw)
            high[-1] |= 0x80  # highest padding bit set
            if high != bytearray(raw):
                yield "bitvector", f"bitvec_{n}_high_padding_bit_set", False, \
                    _invalid_case(typ, bytes(high))


def _bitlist_cases(rng) -> Iterable:
    for limit in (1, 2, 3, 4, 5, 8, 9, 16, 31, 512, 513):
        typ = Bitlist[limit]
        # sorted: set iteration order must not leak into rng draw order, or
        # regenerated vectors stop matching committed ones despite the seed
        for length in sorted({0, 1, limit // 2, limit}):
            if length > limit:
                continue
            bl = typ([rng.choice((True, False)) for _ in range(length)])
            yield "bitlist", f"bitlist_{limit}_random_{length}", True, \
                _valid_case(typ, bl)
        # no-delimiter matrix (an empty encoding, and all-zero bytes of
        # several lengths, none of which carry the mandatory end marker)
        for label, raw in (("nil", b""), ("zero_byte", b"\x00"),
                           ("zeroes", b"\x00" * (limit // 8 + 1))):
            yield "bitlist", f"bitlist_{limit}_no_delimiter_{label}", False, \
                _invalid_case(typ, raw)
        # delimiter places the length beyond the limit
        over = Bitlist[limit * 2]([True] * (limit + 1))
        yield "bitlist", f"bitlist_{limit}_but_{limit + 1}", False, \
            _invalid_case(typ, serialize(over))
        far_over = Bitlist[limit * 8 + 64]([True] * (limit * 8 + 64))
        yield "bitlist", f"bitlist_{limit}_but_{limit * 8 + 64}", False, \
            _invalid_case(typ, serialize(far_over))


def _basic_vector_cases(rng) -> Iterable:
    for elem_name, elem in _VEC_ELEMS.items():
        for length in (1, 2, 3, 4, 5, 8, 16, 31, 512, 513):
            typ = Vector[elem, length]
            if elem is boolean:
                value = typ([rng.choice((True, False)) for _ in range(length)])
            else:
                top = 256 ** elem.type_byte_length()
                value = typ([elem(rng.randrange(top)) for _ in range(length)])
            if length in (1, 4, 8, 512) or elem_name == "uint16":
                yield "basic_vector", f"vec_{elem_name}_{length}_random", True, \
                    _valid_case(typ, value)
            raw = serialize(value)
            elem_size = 1 if elem is boolean else elem.type_byte_length()
            # element-count and byte-length violations
            yield "basic_vector", f"vec_{elem_name}_{length}_nil", False, \
                _invalid_case(typ, b"")
            yield "basic_vector", f"vec_{elem_name}_{length}_one_less", False, \
                _invalid_case(typ, raw[:-elem_size])
            yield "basic_vector", f"vec_{elem_name}_{length}_one_more", False, \
                _invalid_case(typ, raw + raw[:elem_size])
            yield "basic_vector", f"vec_{elem_name}_{length}_one_byte_less", \
                False, _invalid_case(typ, raw[:-1])
            yield "basic_vector", f"vec_{elem_name}_{length}_one_byte_more", \
                False, _invalid_case(typ, raw + b"\x00")


def _mod_offset(raw: bytes, offset_pos: int, change) -> bytes:
    """Rewrite the 4-byte little-endian offset at byte position
    ``offset_pos`` with ``change(old_value) mod 2^32``."""
    old = int.from_bytes(raw[offset_pos:offset_pos + 4], "little")
    new = change(old) % (2**32)
    return raw[:offset_pos] + new.to_bytes(4, "little") + raw[offset_pos + 4:]


def _container_cases(rng) -> Iterable:
    samples = [
        ("SingleFieldTestStruct", SingleFieldTestStruct(A=0xAB)),
        ("SmallTestStruct", SmallTestStruct(A=0x1122, B=0x3344)),
        ("FixedTestStruct", FixedTestStruct(A=0xAB, B=0x0102030405060708, C=0x11223344)),
        ("VarTestStruct", VarTestStruct(A=0xABCD, B=[1, 2, 3], C=0xFF)),
        ("ComplexTestStruct", ComplexTestStruct(
            A=0xAABB, B=[0x1122, 0x3344], C=0xFF, D=list(b"foobar"),
            E=VarTestStruct(A=0xABCD, B=[1, 2, 3], C=0xFF),
            F=[FixedTestStruct(A=i, B=i * 2, C=i * 3) for i in range(4)],
        )),
        ("VarTestStruct", VarTestStruct(A=1, B=[], C=2)),
        ("VarTestStruct", VarTestStruct(A=1, B=list(range(1024)), C=2)),
    ]
    seen = set()
    for name, value in samples:
        case = f"{name}_valid"
        while case in seen:
            case += "x"
        seen.add(case)
        yield "containers", case, True, _valid_case(type(value), value)

    for name, value in (("SingleFieldTestStruct", SingleFieldTestStruct(A=0xAB)),
                        ("SmallTestStruct", SmallTestStruct(A=1, B=2)),
                        ("FixedTestStruct", FixedTestStruct(A=1, B=2, C=3))):
        raw = serialize(value)
        typ = type(value)
        yield "containers", f"{name}_truncated", False, _invalid_case(typ, raw[:-1])
        yield "containers", f"{name}_extra_byte", False, _invalid_case(
            typ, raw + b"\x00")
        yield "containers", f"{name}_nil", False, _invalid_case(typ, b"")

    # systematic offset-tampering matrix over the variable-size containers.
    # VarTestStruct fixed part: A(2) | offset_B(4) | C(1) -> offset at byte 2.
    # ComplexTestStruct fixed part: A(2) | off_B(4) | C(1) | off_D(4) |
    # off_E(4) | F(4*13=52) -> offsets at bytes 2, 7, 11.
    matrices = [
        ("VarTestStruct", VarTestStruct(A=0xABCD, B=[1, 2, 3], C=0xFF), [2]),
        ("ComplexTestStruct", ComplexTestStruct(
            A=0xAABB, B=[0x1122, 0x3344], C=0xFF, D=list(b"foobar"),
            E=VarTestStruct(A=0xABCD, B=[1, 2, 3], C=0xFF),
            F=[FixedTestStruct(A=i, B=i * 2, C=i * 3) for i in range(4)],
        ), [2, 7, 11]),
    ]
    for name, value, offsets in matrices:
        typ = type(value)
        raw = serialize(value)
        yield "containers", f"{name}_truncated", False, _invalid_case(typ, raw[:-1])
        yield "containers", f"{name}_extra_byte", False, _invalid_case(
            typ, raw + b"\x00")
        for i, pos in enumerate(offsets):
            yield "containers", f"{name}_offset_{i}_plus_one", False, \
                _invalid_case(typ, _mod_offset(raw, pos, lambda x: x + 1))
            yield "containers", f"{name}_offset_{i}_zeroed", False, \
                _invalid_case(typ, _mod_offset(raw, pos, lambda x: 0))
            yield "containers", f"{name}_offset_{i}_minus_one", False, \
                _invalid_case(typ, _mod_offset(raw, pos, lambda x: x - 1))
            yield "containers", f"{name}_offset_{i}_overflow", False, \
                _invalid_case(typ, _mod_offset(raw, pos, lambda x: 2**32 - 1))
            yield "containers", f"{name}_offset_{i}_into_fixed_part", False, \
                _invalid_case(typ, _mod_offset(raw, pos, lambda x: pos))


def create_provider() -> gen_typing.TestProvider:
    def cases_fn() -> Iterable[gen_typing.TestCase]:
        rng = Random(55)
        for maker in (_uint_cases, _boolean_cases, _bitvector_cases,
                      _bitlist_cases, _basic_vector_cases, _container_cases):
            for handler, case_name, valid, case_fn in maker(rng):
                yield gen_typing.TestCase(
                    fork_name="phase0",
                    preset_name="general",
                    runner_name="ssz_generic",
                    handler_name=handler,
                    suite_name="valid" if valid else "invalid",
                    case_name=case_name,
                    case_fn=case_fn,
                )

    return gen_typing.TestProvider(prepare=lambda: None, make_cases=cases_fn)


def main(argv=None, device=None):
    return gen_runner.run_generator("ssz_generic", [create_provider()], argv=argv,
                             device=device)


if __name__ == "__main__":
    main()
