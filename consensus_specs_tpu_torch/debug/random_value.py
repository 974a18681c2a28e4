"""Random SSZ object generation — the fuzz engine behind ssz_static vectors
(reference capability: eth2spec/debug/random_value.py, six modes).

Modes and their vector-suite meanings:
  random     random content and random lengths
  zero       all-zero values, minimal lengths
  max        all-max values, count-1 lengths
  nil        empty collections
  one        single-element collections, random content
  lengthy    max-length collections, random content
``chaos`` re-rolls the mode per object, mixing shapes within one value.
"""
from __future__ import annotations

from enum import Enum
from random import Random
from typing import Type

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

UINT_BYTE_SIZES = (1, 2, 4, 8, 16, 32)

random_mode_names = ("random", "zero", "max", "nil", "one", "lengthy")


class RandomizationMode(Enum):
    mode_random = 0
    mode_zero = 1
    mode_max = 2
    mode_nil_count = 3
    mode_one_count = 4
    mode_max_count = 5

    def to_name(self) -> str:
        return random_mode_names[self.value]

    def is_changing(self) -> bool:
        """Modes whose output varies run-to-run (drives case counts)."""
        return self.value in (0, 4, 5)


def _rand_bytes(rng: Random, n: int) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(n))


def get_random_ssz_object(
    rng: Random,
    typ: Type,
    max_bytes_length: int,
    max_list_length: int,
    mode: RandomizationMode,
    chaos: bool = False,
):
    if chaos:
        mode = rng.choice(list(RandomizationMode))
    M = RandomizationMode

    if issubclass(typ, ByteList):
        limit = typ.LIMIT
        if mode == M.mode_nil_count:
            return typ(b"")
        if mode == M.mode_max_count:
            return typ(_rand_bytes(rng, min(max_bytes_length, limit)))
        if mode == M.mode_one_count:
            return typ(_rand_bytes(rng, min(1, limit)))
        if mode == M.mode_zero:
            return typ(b"\x00" * min(1, limit))
        if mode == M.mode_max:
            return typ(b"\xff" * min(1, limit))
        return typ(_rand_bytes(rng, rng.randint(0, min(max_bytes_length, limit))))

    if issubclass(typ, ByteVector):
        n = typ.type_byte_length()
        if mode == M.mode_zero:
            return typ(b"\x00" * n)
        if mode == M.mode_max:
            return typ(b"\xff" * n)
        return typ(_rand_bytes(rng, n))

    if issubclass(typ, boolean):
        if mode == M.mode_zero:
            return typ(False)
        if mode == M.mode_max:
            return typ(True)
        return typ(rng.choice((True, False)))

    if issubclass(typ, uint):
        size = typ.type_byte_length()
        assert size in UINT_BYTE_SIZES
        if mode == M.mode_zero:
            return typ(0)
        if mode == M.mode_max:
            return typ(256**size - 1)
        return typ(rng.randint(0, 256**size - 1))

    if issubclass(typ, Bitvector):
        n = typ.LENGTH
        if mode == M.mode_zero:
            return typ([False] * n)
        if mode == M.mode_max:
            return typ([True] * n)
        return typ([rng.choice((True, False)) for _ in range(n)])

    if issubclass(typ, Bitlist):
        limit = typ.LENGTH
        length = rng.randint(0, min(limit, max_list_length))
        if mode == M.mode_one_count:
            length = 1
        elif mode == M.mode_max_count:
            length = max_list_length
        elif mode == M.mode_nil_count:
            length = 0
        length = min(length, limit)
        if mode == M.mode_zero:
            return typ([False] * length)
        if mode == M.mode_max:
            return typ([True] * length)
        return typ([rng.choice((True, False)) for _ in range(length)])

    if issubclass(typ, Vector):
        return typ([
            get_random_ssz_object(
                rng, typ.ELEM_TYPE, max_bytes_length, max_list_length, mode, chaos
            )
            for _ in range(typ.LENGTH)
        ])

    if issubclass(typ, List):
        limit = typ.LENGTH
        length = rng.randint(0, min(limit, max_list_length))
        if mode == M.mode_one_count:
            length = 1
        elif mode == M.mode_max_count:
            length = max_list_length
        elif mode == M.mode_nil_count:
            length = 0
        length = min(length, limit)
        return typ([
            get_random_ssz_object(
                rng, typ.ELEM_TYPE, max_bytes_length, max_list_length, mode, chaos
            )
            for _ in range(length)
        ])

    if issubclass(typ, Container):
        return typ(**{
            name: get_random_ssz_object(
                rng, ftyp, max_bytes_length, max_list_length, mode, chaos
            )
            for name, ftyp in zip(typ._field_names, typ._field_types)
        })

    if issubclass(typ, Union):
        options = typ.OPTIONS
        if mode == M.mode_zero:
            selector = 0
        elif mode == M.mode_max:
            selector = len(options) - 1
        else:
            selector = rng.randrange(len(options))
        opt = options[selector]
        value = None if opt is None else get_random_ssz_object(
            rng, opt, max_bytes_length, max_list_length, mode, chaos
        )
        return typ(selector=selector, value=value)

    raise TypeError(f"cannot randomize {typ!r}")
