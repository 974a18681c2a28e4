"""SSZ type system: basic types, containers, collections, unions.

Semantics follow the SSZ spec (reference: ssz/simple-serialize.md — type
system :40-103, serialization :105-208, merkleization :210-248) and the
reference's remerkleable-based view behavior (eth2spec/utils/ssz/ssz_typing.py
re-exports), re-implemented from scratch on the persistent node layer in
``node.py``:

  * views are mutable facades over immutable backings (copy-on-write)
  * ``copy()`` is O(1): a new view over the same backing
  * child mutation propagates dirtiness to ancestors; flushing happens
    lazily on ``get_backing()`` / ``hash_tree_root()``
  * uintN arithmetic is overflow-checked (spec rule: out-of-range uint64
    math makes a state transition invalid, phase0/beacon-chain.md:1238)

Python-value caches keep hot spec loops off the tree: packed basic
sequences (balances, inactivity scores) materialize as flat int lists with
chunk-granular dirty tracking, so an epoch's worth of balance updates
turns into one bulk subtree update + one layer-batched hash pass.
"""
from __future__ import annotations

import io
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .node import (
    BranchNode,
    LeafNode,
    Node,
    get_subtree,
    merkle_root,
    pack_chunks,
    subtree_fill_to_contents,
    uint_to_leaf,
    with_updated_subtrees,
    zero_node,
)

OFFSET_BYTE_LENGTH = 4


def ceil_log2(x: int) -> int:
    if x < 1:
        return 0
    return (x - 1).bit_length()


# ---------------------------------------------------------------------------
# Base machinery
# ---------------------------------------------------------------------------


class SSZType:
    """Mixin namespace of the classmethod API every SSZ type implements."""

    @classmethod
    def _layout_key(cls) -> tuple:
        """Structural identity of the type (used to allow assigning
        layout-identical containers across fork namespaces, which the
        reference's fork-upgrade functions rely on)."""
        key = cls.__dict__.get("_layout_key_cache")
        if key is None:
            key = cls._compute_layout_key()
            cls._layout_key_cache = key
        return key

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        raise NotImplementedError

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def type_byte_length(cls) -> int:
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError

    @classmethod
    def default_node(cls) -> Node:
        raise NotImplementedError

    @classmethod
    def decode_bytes(cls, data: bytes):
        raise NotImplementedError

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        raise NotImplementedError

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        raise NotImplementedError


class View(SSZType):
    """Mutable composite view over an immutable backing."""

    __slots__ = ("_backing", "_parent", "_pkey")

    def get_backing(self) -> Node:
        raise NotImplementedError

    def encode_bytes(self) -> bytes:
        raise NotImplementedError

    def hash_tree_root(self) -> bytes:
        return merkle_root(self.get_backing())

    def copy(self):
        return type(self).view_from_backing(self.get_backing())

    def _child_changed(self, key) -> None:
        raise NotImplementedError

    def _invalidate(self) -> None:
        p = self._parent
        if p is not None:
            p._child_changed(self._pkey)

    def __eq__(self, other):
        if isinstance(other, View):
            # layout (not type identity): fork-layered spec modules each
            # define their own classes, but identical layouts compare equal
            return (
                type(self)._layout_key() == type(other)._layout_key()
                and self.hash_tree_root() == other.hash_tree_root()
            )
        return NotImplemented

    def __ne__(self, other):
        r = self.__eq__(other)
        return r if r is NotImplemented else not r

    def __hash__(self):
        return int.from_bytes(self.hash_tree_root()[:8], "little")


# ---------------------------------------------------------------------------
# Basic types: uintN, boolean
# ---------------------------------------------------------------------------


class uint(int, SSZType):
    TYPE_BYTE_LENGTH = 0

    def __new__(cls, value=0):
        value = int(value)
        if not 0 <= value < (1 << (cls.TYPE_BYTE_LENGTH * 8)):
            raise ValueError(
                f"value {value} out of range for {cls.__name__}"
            )
        return super().__new__(cls, value)

    # -- checked arithmetic (overflow/underflow -> ValueError) --
    # Non-int operands return NotImplemented so Python falls back to the
    # other operand's handler (e.g. list repetition `[x] * uint64(n)`).

    def __add__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) + int(o))

    __radd__ = __add__

    def __sub__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) - int(o))

    def __rsub__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(o) - int(self))

    def __mul__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) * int(o))

    __rmul__ = __mul__

    def __floordiv__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) // int(o))

    def __rfloordiv__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(o) // int(self))

    def __mod__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) % int(o))

    def __rmod__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(o) % int(self))

    def __pow__(self, o, mod=None):
        if not isinstance(o, int):
            return NotImplemented
        if o < 0:
            raise ValueError("negative exponent on checked uint")
        return type(self)(pow(int(self), int(o), mod))

    def __lshift__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) << int(o))

    def __rshift__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) >> int(o))

    def __and__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) & int(o))

    __rand__ = __and__

    def __or__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) | int(o))

    __ror__ = __or__

    def __xor__(self, o):
        if not isinstance(o, int):
            return NotImplemented
        return type(self)(int(self) ^ int(o))

    __rxor__ = __xor__

    # -- SSZ API --
    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.TYPE_BYTE_LENGTH

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("uint", cls.TYPE_BYTE_LENGTH)

    @classmethod
    def default(cls):
        return cls(0)

    @classmethod
    def default_node(cls) -> Node:
        return zero_node(0)

    def encode_bytes(self) -> bytes:
        return int(self).to_bytes(self.TYPE_BYTE_LENGTH, "little")

    @classmethod
    def decode_bytes(cls, data: bytes):
        assert len(data) == cls.TYPE_BYTE_LENGTH
        return cls(int.from_bytes(data, "little"))

    def get_backing(self) -> Node:
        return LeafNode(int(self).to_bytes(32, "little"))

    def hash_tree_root(self) -> bytes:
        return int(self).to_bytes(32, "little")

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        return cls(int.from_bytes(node._root[: cls.TYPE_BYTE_LENGTH], "little"))

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        return value if type(value) is cls else cls(value)


class uint8(uint):
    TYPE_BYTE_LENGTH = 1


class uint16(uint):
    TYPE_BYTE_LENGTH = 2


class uint32(uint):
    TYPE_BYTE_LENGTH = 4


class uint64(uint):
    TYPE_BYTE_LENGTH = 8


class uint128(uint):
    TYPE_BYTE_LENGTH = 16


class uint256(uint):
    TYPE_BYTE_LENGTH = 32


byte = uint8


class boolean(int, SSZType):
    TYPE_BYTE_LENGTH = 1

    def __new__(cls, value=0):
        value = int(value)
        if value not in (0, 1):
            raise ValueError(f"boolean must be 0 or 1, got {value}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return 1

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("bool",)

    @classmethod
    def default(cls):
        return cls(0)

    @classmethod
    def default_node(cls) -> Node:
        return zero_node(0)

    def encode_bytes(self) -> bytes:
        return b"\x01" if self else b"\x00"

    @classmethod
    def decode_bytes(cls, data: bytes):
        assert len(data) == 1 and data[0] in (0, 1)
        return cls(data[0])

    def get_backing(self) -> Node:
        return LeafNode(int(self).to_bytes(32, "little"))

    def hash_tree_root(self) -> bytes:
        return int(self).to_bytes(32, "little")

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        return cls(node._root[0])

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        return value if type(value) is cls else cls(value)


bit = boolean


def is_basic_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, (uint, boolean))


# ---------------------------------------------------------------------------
# ByteVector / ByteList (immutable bytes subclasses)
# ---------------------------------------------------------------------------

_byte_vector_cache: Dict[int, type] = {}
_byte_list_cache: Dict[int, type] = {}


class ByteVector(bytes, SSZType):
    TYPE_BYTE_LENGTH = 0

    def __class_getitem__(cls, length: int) -> type:
        t = _byte_vector_cache.get(length)
        if t is None:
            t = type(f"ByteVector[{length}]", (ByteVector,), {"TYPE_BYTE_LENGTH": length})
            _byte_vector_cache[length] = t
        return t

    def __new__(cls, value: bytes = None):
        if cls.TYPE_BYTE_LENGTH == 0 and cls is ByteVector:
            raise TypeError("use ByteVector[N]")
        if value is None:
            value = b"\x00" * cls.TYPE_BYTE_LENGTH
        elif isinstance(value, str):
            value = bytes.fromhex(value[2:] if value.startswith("0x") else value)
        else:
            value = bytes(value)
        if len(value) != cls.TYPE_BYTE_LENGTH:
            raise ValueError(
                f"{cls.__name__} requires {cls.TYPE_BYTE_LENGTH} bytes, got {len(value)}"
            )
        return super().__new__(cls, value)

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("bytevector", cls.TYPE_BYTE_LENGTH)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.TYPE_BYTE_LENGTH

    @classmethod
    def default(cls):
        return cls(b"\x00" * cls.TYPE_BYTE_LENGTH)

    @classmethod
    def default_node(cls) -> Node:
        return zero_node(ceil_log2((cls.TYPE_BYTE_LENGTH + 31) // 32))

    def encode_bytes(self) -> bytes:
        return bytes(self)

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    def get_backing(self) -> Node:
        chunks = pack_chunks(bytes(self))
        return subtree_fill_to_contents(chunks, ceil_log2(len(chunks)))

    def hash_tree_root(self) -> bytes:
        if self.TYPE_BYTE_LENGTH <= 32:
            return bytes(self) + b"\x00" * (32 - self.TYPE_BYTE_LENGTH)
        return merkle_root(self.get_backing())

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        n_chunks = (cls.TYPE_BYTE_LENGTH + 31) // 32
        depth = ceil_log2(n_chunks)
        data = b"".join(
            get_subtree(node, depth, i)._root for i in range(n_chunks)
        )
        return cls(data[: cls.TYPE_BYTE_LENGTH])

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        return value if type(value) is cls else cls(value)

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


class ByteList(bytes, SSZType):
    LIMIT = 0

    def __class_getitem__(cls, limit: int) -> type:
        t = _byte_list_cache.get(limit)
        if t is None:
            t = type(f"ByteList[{limit}]", (ByteList,), {"LIMIT": limit})
            _byte_list_cache[limit] = t
        return t

    def __new__(cls, value: bytes = b""):
        if isinstance(value, str):
            value = bytes.fromhex(value[2:] if value.startswith("0x") else value)
        if isinstance(value, (list, tuple)):
            value = bytes(value)
        value = bytes(value)
        if len(value) > cls.LIMIT:
            raise ValueError(f"{cls.__name__} max {cls.LIMIT} bytes, got {len(value)}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("bytelist", cls.LIMIT)

    @classmethod
    def default(cls):
        return cls(b"")

    @classmethod
    def contents_depth(cls) -> int:
        return ceil_log2((cls.LIMIT + 31) // 32)

    @classmethod
    def default_node(cls) -> Node:
        return BranchNode(zero_node(cls.contents_depth()), zero_node(0))

    def encode_bytes(self) -> bytes:
        return bytes(self)

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    def get_backing(self) -> Node:
        chunks = pack_chunks(bytes(self))
        contents = subtree_fill_to_contents(chunks, self.contents_depth())
        return BranchNode(contents, uint_to_leaf(len(self)))

    def hash_tree_root(self) -> bytes:
        return merkle_root(self.get_backing())

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        assert isinstance(node, BranchNode)
        length = int.from_bytes(node.right._root[:8], "little")
        n_chunks = (length + 31) // 32
        depth = cls.contents_depth()
        data = b"".join(
            get_subtree(node.left, depth, i)._root for i in range(n_chunks)
        )
        return cls(data[:length])

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        return value if type(value) is cls else cls(value)

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


# Common aliases used across the spec types
Bytes1 = ByteVector[1]
Bytes4 = ByteVector[4]
Bytes8 = ByteVector[8]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


# ---------------------------------------------------------------------------
# Bitvector / Bitlist
# ---------------------------------------------------------------------------


def _pack_bits(bits: Sequence[int]) -> bytes:
    n = len(bits)
    out = bytearray((n + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i >> 3] |= 1 << (i & 7)
    return bytes(out)


def _unpack_bits(data: bytes, n: int) -> list:
    return [bool((data[i >> 3] >> (i & 7)) & 1) for i in range(n)]


_bitvector_cache: Dict[int, type] = {}
_bitlist_cache: Dict[int, type] = {}


class _BitsBase(View):
    __slots__ = ("_bits",)
    LENGTH = 0  # Bitvector: exact length; Bitlist: limit

    def __init__(self, *args):
        self._parent = None
        self._pkey = None
        if len(args) == 1 and isinstance(args[0], (list, tuple, bytes, bytearray)) or (
            len(args) == 1 and hasattr(args[0], "__iter__") and not isinstance(args[0], int)
        ):
            bits = [bool(b) for b in args[0]]
        else:
            bits = [bool(b) for b in args]
        self._init_bits(bits)
        self._backing = None

    def _init_bits(self, bits):
        raise NotImplementedError

    def __len__(self):
        return len(self._bits)

    def __iter__(self):
        return iter(self._bits)

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            # length-preserving slice write (spec: justification bit rotation)
            new = [bool(b) for b in v]
            if len(self._bits[i]) != len(new):
                raise ValueError("bit slice assignment must preserve length")
            self._bits[i] = new
        else:
            self._bits[i] = bool(v)
        self._backing = None
        self._invalidate()

    def _child_changed(self, key):
        pass

    def __eq__(self, other):
        if isinstance(other, _BitsBase):
            return type(self)._layout_key() == type(other)._layout_key() and self._bits == other._bits
        if isinstance(other, (list, tuple)):
            return self._bits == [bool(b) for b in other]
        return NotImplemented

    __hash__ = View.__hash__

    def __repr__(self):
        return f"{type(self).__name__}({''.join('1' if b else '0' for b in self._bits)})"


class Bitvector(_BitsBase):
    __slots__ = ()

    def __class_getitem__(cls, length: int) -> type:
        t = _bitvector_cache.get(length)
        if t is None:
            t = type(f"Bitvector[{length}]", (Bitvector,), {"LENGTH": length, "__slots__": ()})
            _bitvector_cache[length] = t
        return t

    def _init_bits(self, bits):
        if not bits:
            bits = [False] * self.LENGTH
        if len(bits) != self.LENGTH:
            raise ValueError(f"Bitvector[{self.LENGTH}] got {len(bits)} bits")
        self._bits = bits

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return (cls.LENGTH + 7) // 8

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("bitvector", cls.LENGTH)

    @classmethod
    def chunk_depth(cls) -> int:
        return ceil_log2((cls.LENGTH + 255) // 256)

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def default_node(cls) -> Node:
        return zero_node(cls.chunk_depth())

    def encode_bytes(self) -> bytes:
        return _pack_bits(self._bits)

    @classmethod
    def decode_bytes(cls, data: bytes):
        assert len(data) == cls.type_byte_length()
        # verify padding bits are zero
        if cls.LENGTH % 8:
            assert data[-1] >> (cls.LENGTH % 8) == 0
        return cls(_unpack_bits(data, cls.LENGTH))

    def get_backing(self) -> Node:
        if self._backing is None:
            chunks = pack_chunks(_pack_bits(self._bits))
            self._backing = subtree_fill_to_contents(chunks, self.chunk_depth())
        return self._backing

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        n_chunks = (cls.LENGTH + 255) // 256
        depth = cls.chunk_depth()
        data = b"".join(get_subtree(node, depth, i)._root for i in range(n_chunks))
        v = cls(_unpack_bits(data, cls.LENGTH))
        v._parent = parent
        v._pkey = pkey
        v._backing = node
        return v

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        if isinstance(value, cls):
            v = cls(list(value._bits))
        else:
            v = cls(value)
        v._parent = parent
        v._pkey = pkey
        return v


class Bitlist(_BitsBase):
    __slots__ = ()

    def __class_getitem__(cls, limit: int) -> type:
        t = _bitlist_cache.get(limit)
        if t is None:
            t = type(f"Bitlist[{limit}]", (Bitlist,), {"LENGTH": limit, "__slots__": ()})
            _bitlist_cache[limit] = t
        return t

    def _init_bits(self, bits):
        if len(bits) > self.LENGTH:
            raise ValueError(f"Bitlist[{self.LENGTH}] got {len(bits)} bits")
        self._bits = bits

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("bitlist", cls.LENGTH)

    def append(self, v):
        if len(self._bits) >= self.LENGTH:
            raise ValueError("bitlist full")
        self._bits.append(bool(v))
        self._backing = None
        self._invalidate()

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def chunk_depth(cls) -> int:
        return ceil_log2((cls.LENGTH + 255) // 256)

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def default_node(cls) -> Node:
        return BranchNode(zero_node(cls.chunk_depth()), zero_node(0))

    def encode_bytes(self) -> bytes:
        n = len(self._bits)
        out = bytearray(_pack_bits(self._bits))
        # delimiter bit
        if n % 8 == 0:
            out.append(1)
        else:
            out[-1] |= 1 << (n % 8)
        return bytes(out)

    @classmethod
    def decode_bytes(cls, data: bytes):
        assert len(data) > 0 and data[-1] != 0, "invalid bitlist delimiter"
        last = data[-1]
        hi = last.bit_length() - 1  # delimiter position within last byte
        n = (len(data) - 1) * 8 + hi
        assert n <= cls.LENGTH
        bits = _unpack_bits(data, n)
        return cls(bits)

    def get_backing(self) -> Node:
        if self._backing is None:
            chunks = pack_chunks(_pack_bits(self._bits))
            contents = subtree_fill_to_contents(chunks, self.chunk_depth())
            self._backing = BranchNode(contents, uint_to_leaf(len(self._bits)))
        return self._backing

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        assert isinstance(node, BranchNode)
        n = int.from_bytes(node.right._root[:8], "little")
        n_chunks = (n + 255) // 256
        depth = cls.chunk_depth()
        data = b"".join(get_subtree(node.left, depth, i)._root for i in range(n_chunks))
        v = cls(_unpack_bits(data, n))
        v._parent = parent
        v._pkey = pkey
        v._backing = node
        return v

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        if isinstance(value, cls):
            v = cls(list(value._bits))
        else:
            v = cls(value)
        v._parent = parent
        v._pkey = pkey
        return v


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


class Container(View):
    __slots__ = ("_cache", "_dirty")

    _field_names: Tuple[str, ...] = ()
    _field_types: Tuple[type, ...] = ()
    _field_index: Dict[str, int] = {}
    _depth = 0
    _default_backing_cache: Optional[Node] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields: Dict[str, type] = {}
        for base in reversed(cls.__mro__):
            anns = base.__dict__.get("__annotations__", {})
            for name, t in anns.items():
                if name.startswith("_"):
                    continue
                fields[name] = t
        cls._field_names = tuple(fields.keys())
        cls._field_types = tuple(fields.values())
        cls._field_index = {n: i for i, n in enumerate(cls._field_names)}
        cls._depth = ceil_log2(len(fields)) if fields else 0
        cls._default_backing_cache = None

    def __init__(self, **kwargs):
        object.__setattr__(self, "_backing", type(self).default_backing())
        object.__setattr__(self, "_cache", {})
        object.__setattr__(self, "_dirty", set())
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pkey", None)
        for k, v in kwargs.items():
            if k not in type(self)._field_index:
                raise TypeError(f"{type(self).__name__} has no field {k}")
            setattr(self, k, v)

    @classmethod
    def default_backing(cls) -> Node:
        if cls._default_backing_cache is None:
            cls._default_backing_cache = subtree_fill_to_contents(
                [t.default_node() for t in cls._field_types], cls._depth
            )
        return cls._default_backing_cache

    @classmethod
    def default_node(cls) -> Node:
        return cls.default_backing()

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return all(t.is_fixed_byte_length() for t in cls._field_types)

    @classmethod
    def type_byte_length(cls) -> int:
        assert cls.is_fixed_byte_length()
        return sum(t.type_byte_length() for t in cls._field_types)

    # -- attribute protocol --

    def __getattr__(self, name: str):
        # only called when normal lookup fails (fields are not real attrs)
        idx = type(self)._field_index.get(name)
        if idx is None:
            raise AttributeError(f"{type(self).__name__} has no field {name}")
        cache = self._cache
        if name in cache:
            return cache[name]
        node = get_subtree(self._backing, type(self)._depth, idx)
        val = type(self)._field_types[idx].view_from_backing(node, self, name)
        cache[name] = val
        return val

    def __setattr__(self, name: str, value):
        idx = type(self)._field_index.get(name)
        if idx is None:
            object.__setattr__(self, name, value)
            return
        ftype = type(self)._field_types[idx]
        self._cache[name] = ftype.coerce_for_store(value, self, name)
        if name not in self._dirty:
            self._dirty.add(name)
            self._invalidate()

    def _child_changed(self, key):
        if key not in self._dirty:
            self._dirty.add(key)
            self._invalidate()

    # -- backing / serialization --

    def get_backing(self) -> Node:
        if self._dirty:
            cls = type(self)
            updates = []
            for name in self._dirty:
                idx = cls._field_index[name]
                updates.append((idx, _node_of(cls._field_types[idx], self._cache[name])))
            updates.sort(key=lambda kv: kv[0])
            object.__setattr__(
                self, "_backing", with_updated_subtrees(self._backing, cls._depth, updates)
            )
            self._dirty.clear()
        return self._backing

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        v = cls.__new__(cls)
        object.__setattr__(v, "_backing", node)
        object.__setattr__(v, "_cache", {})
        object.__setattr__(v, "_dirty", set())
        object.__setattr__(v, "_parent", parent)
        object.__setattr__(v, "_pkey", pkey)
        return v

    def set_backing(self, node: Node) -> None:
        """Swap this view's tree wholesale (state snapshot restore)."""
        object.__setattr__(self, "_backing", node)
        # detach handed-out child views: writes through them must not
        # re-dirty fields that no longer exist in this view's cache
        for child in self._cache.values():
            if isinstance(child, View):
                object.__setattr__(child, "_parent", None)
                object.__setattr__(child, "_pkey", None)
        self._cache.clear()
        self._dirty.clear()
        self._invalidate()

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return (
            "container",
            tuple(
                (n, t._layout_key())
                for n, t in zip(cls._field_names, cls._field_types)
            ),
        )

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        if isinstance(value, Container):
            # same class -> same layout a priori: the deep layout-key
            # tuple compare is only for cross-fork-namespace stores
            if type(value) is cls or value._layout_key() == cls._layout_key():
                return cls.view_from_backing(value.get_backing(), parent, pkey)
            # fork-extension reinterpretation (e.g. a bellatrix
            # ExecutionPayloadHeader stored into capella's, fork.md
            # upgrades): when the source's (name, layout) field list is a
            # strict prefix of the target's, rebuild the backing from the
            # source's field subtrees plus proper *default nodes* for the
            # appended fields — structurally correct for composite
            # additions, root-identical to zero-padding for basic ones.
            src = type(value)
            n_src = len(src._field_types)
            if n_src <= len(cls._field_types) and all(
                na == nb and ta._layout_key() == tb._layout_key()
                for (na, ta), (nb, tb) in zip(
                    zip(src._field_names, src._field_types),
                    zip(cls._field_names, cls._field_types),
                )
            ):
                backing = value.get_backing()
                nodes = [get_subtree(backing, src._depth, i) for i in range(n_src)]
                nodes += [t.default_node() for t in cls._field_types[n_src:]]
                rebuilt = subtree_fill_to_contents(nodes, cls._depth)
                return cls.view_from_backing(rebuilt, parent, pkey)
        raise TypeError(f"cannot store {type(value).__name__} as {cls.__name__}")

    def encode_bytes(self) -> bytes:
        cls = type(self)
        return _encode_ordered(
            [getattr(self, n) for n in cls._field_names], cls._field_types
        )

    @classmethod
    def decode_bytes(cls, data: bytes):
        values = _decode_ordered(data, cls._field_types)
        return cls(**dict(zip(cls._field_names, values)))

    def __repr__(self):
        cls = type(self)
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in cls._field_names)
        return f"{cls.__name__}({inner})"


def _uniform_tree(leaf: Node, depth: int) -> Node:
    """Depth-`depth` tree whose leaves are all `leaf` (siblings shared)."""
    if leaf is zero_node(0):
        return zero_node(depth)
    cur = leaf
    for _ in range(depth):
        cur = BranchNode(cur, cur)
    return cur


def _node_of(ftype, value) -> Node:
    """Backing node of a stored field/element value."""
    if isinstance(value, View):
        return value.get_backing()
    if isinstance(value, (uint, boolean)):
        return LeafNode(int(value).to_bytes(32, "little"))
    if isinstance(value, (ByteVector, ByteList)):
        return value.get_backing()
    raise TypeError(f"cannot get node of {type(value).__name__}")


# ---------------------------------------------------------------------------
# Vector / List
# ---------------------------------------------------------------------------

_vector_cache: Dict[Tuple[type, int], type] = {}
_list_cache: Dict[Tuple[type, int], type] = {}


class _HomogeneousBase(View):
    """Shared machinery for Vector/List.

    Packed (basic-element) sequences materialize all values into a flat
    Python list with chunk-level dirty tracking; composite-element
    sequences cache per-index child views.
    """

    __slots__ = ("_cache", "_dirty", "_values", "_dirty_chunks", "_length")

    ELEM_TYPE: type = uint8
    # Vector: LENGTH = fixed length. List: LENGTH = limit.
    LENGTH = 0
    IS_LIST = False

    # -- class helpers --

    @classmethod
    def _is_packed(cls) -> bool:
        return is_basic_type(cls.ELEM_TYPE)

    @classmethod
    def _elems_per_chunk(cls) -> int:
        return 32 // cls.ELEM_TYPE.type_byte_length()

    @classmethod
    def _limit_chunks(cls) -> int:
        if cls._is_packed():
            return (cls.LENGTH * cls.ELEM_TYPE.type_byte_length() + 31) // 32
        return cls.LENGTH

    @classmethod
    def contents_depth(cls) -> int:
        return ceil_log2(cls._limit_chunks())

    # -- init --

    def _base_init(self, values: Iterable):
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pkey", None)
        self._cache = {}
        self._dirty = set()
        self._dirty_chunks = set() if type(self)._is_packed() else None
        cls = type(self)
        vals = list(values)
        if cls.IS_LIST:
            if len(vals) > cls.LENGTH:
                raise ValueError(f"{cls.__name__}: {len(vals)} > limit {cls.LENGTH}")
        elif vals and len(vals) != cls.LENGTH:
            raise ValueError(f"{cls.__name__}: need {cls.LENGTH} elements")
        if not vals:
            # default-shaped: share the global zero backing, nothing dirty
            self._length = 0 if cls.IS_LIST else cls.LENGTH
            self._values = None
            self._backing = cls._empty_backing()
            return
        self._length = len(vals)
        self._backing = self._empty_backing()
        if cls._is_packed():
            et = cls.ELEM_TYPE
            self._values = [int(et(v)) if not isinstance(v, et) else int(v) for v in vals]
            self._dirty_chunks = True  # full rebuild pending
        else:
            et = cls.ELEM_TYPE
            self._values = None
            for i, v in enumerate(vals):
                self._cache[i] = et.coerce_for_store(v, self, i)
                self._dirty.add(i)

    @classmethod
    def _empty_backing(cls) -> Node:
        if cls.IS_LIST or cls._is_packed():
            # list slots are zero chunks until filled; packed contents are zero chunks
            contents = zero_node(cls.contents_depth())
        else:
            # Vector of composites: every element exists at its default value,
            # and element subtrees extend below the contents depth.  Identical
            # siblings share one node (persistent DAG), so this is O(depth).
            contents = _uniform_tree(cls.ELEM_TYPE.default_node(), cls.contents_depth())
        if cls.IS_LIST:
            return BranchNode(contents, zero_node(0))
        return contents

    def __init__(self, *args):
        if (
            len(args) == 1
            and not isinstance(args[0], (int, bytes, SSZType))
            and hasattr(args[0], "__iter__")
        ):
            values = args[0]
        else:
            values = args
        self._base_init(values)

    # -- python sequence protocol --

    def __len__(self):
        return self._length

    def __iter__(self):
        for i in range(self._length):
            yield self[i]

    def __contains__(self, item):
        return any(self[i] == item for i in range(self._length))

    def count(self, item) -> int:
        return sum(1 for i in range(self._length) if self[i] == item)

    def index(self, item) -> int:
        for i in range(self._length):
            if self[i] == item:
                return i
        raise ValueError(f"{item!r} not in sequence")

    def _materialize_values(self):
        """Packed path: decode all chunks into a flat int list."""
        if self._values is not None:
            return
        cls = type(self)
        per = cls._elems_per_chunk()
        n_chunks = (self._length + per - 1) // per
        contents = self._contents_node()
        depth = cls.contents_depth()
        data = b"".join(
            _collect_leaf_roots(contents, depth, n_chunks)
        )
        size = cls.ELEM_TYPE.type_byte_length()
        if size == 8:
            arr = np.frombuffer(data[: 8 * ((len(data)) // 8)], dtype="<u8")
            self._values = [int(x) for x in arr[: self._length]]
        elif size == 1:
            self._values = list(data[: self._length])
        else:
            self._values = [
                int.from_bytes(data[i * size : (i + 1) * size], "little")
                for i in range(self._length)
            ]
        self._dirty_chunks = set()

    def _contents_node(self) -> Node:
        if type(self).IS_LIST:
            assert isinstance(self._backing, BranchNode)
            return self._backing.left
        return self._backing

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._length))]
        i = int(i)
        if i < 0:
            i += self._length
        if not 0 <= i < self._length:
            raise IndexError(f"index {i} out of range (len {self._length})")
        cls = type(self)
        if cls._is_packed():
            self._materialize_values()
            return cls.ELEM_TYPE(self._values[i])
        if i in self._cache:
            return self._cache[i]
        node = get_subtree(self._contents_node(), cls.contents_depth(), i)
        v = cls.ELEM_TYPE.view_from_backing(node, self, i)
        self._cache[i] = v
        return v

    def __setitem__(self, i, value):
        i = int(i)
        if i < 0:
            i += self._length
        if not 0 <= i < self._length:
            raise IndexError(f"index {i} out of range (len {self._length})")
        cls = type(self)
        if cls._is_packed():
            self._materialize_values()
            self._values[i] = int(cls.ELEM_TYPE(value))
            if self._dirty_chunks is not True:
                self._dirty_chunks.add(i // cls._elems_per_chunk())
        else:
            self._cache[i] = cls.ELEM_TYPE.coerce_for_store(value, self, i)
            self._dirty.add(i)
        self._invalidate()

    def _child_changed(self, key):
        if key not in self._dirty:
            self._dirty.add(key)
            self._invalidate()

    def __eq__(self, other):
        if isinstance(other, View):
            return (
                type(self)._layout_key() == type(other)._layout_key()
                and self.hash_tree_root() == other.hash_tree_root()
            )
        if isinstance(other, (list, tuple)):
            return self._length == len(other) and all(
                self[i] == other[i] for i in range(self._length)
            )
        return NotImplemented

    __hash__ = View.__hash__

    def __repr__(self):
        return f"{type(self).__name__}([{', '.join(repr(self[i]) for i in range(self._length))}])"

    # -- backing --

    def get_backing(self) -> Node:
        cls = type(self)
        contents = self._contents_node()
        depth = cls.contents_depth()
        changed = False
        if cls._is_packed():
            if self._dirty_chunks is True or (self._dirty_chunks and len(self._dirty_chunks) > 0):
                per = cls._elems_per_chunk()
                size = cls.ELEM_TYPE.type_byte_length()
                vals = self._values
                n_chunks = (self._length + per - 1) // per
                if self._dirty_chunks is True:
                    chunk_ids = range(n_chunks)
                else:
                    chunk_ids = sorted(self._dirty_chunks)
                updates = []
                for c in chunk_ids:
                    lo = c * per
                    hi = min(lo + per, self._length)
                    if size == 8:
                        raw = np.asarray(vals[lo:hi], dtype="<u8").tobytes()
                    elif size == 1:
                        raw = bytes(vals[lo:hi])
                    else:
                        raw = b"".join(
                            v.to_bytes(size, "little") for v in vals[lo:hi]
                        )
                    if len(raw) < 32:
                        raw = raw + b"\x00" * (32 - len(raw))
                    updates.append((c, LeafNode(raw)))
                if self._dirty_chunks is True:
                    # bulk rebuild: zero-out beyond n_chunks is implicit (fresh tree)
                    contents = subtree_fill_to_contents([u[1] for u in updates], depth)
                else:
                    contents = with_updated_subtrees(contents, depth, updates)
                self._dirty_chunks = set()
                changed = True
        else:
            if self._dirty:
                updates = sorted(
                    (i, _node_of(cls.ELEM_TYPE, self._cache[i])) for i in self._dirty
                )
                if len(updates) == self._length and updates[-1][0] == self._length - 1:
                    # bulk build (genesis registries): one bottom-up fill
                    contents = subtree_fill_to_contents([u[1] for u in updates], depth)
                else:
                    contents = with_updated_subtrees(contents, depth, updates)
                self._dirty.clear()
                changed = True
        if changed or (cls.IS_LIST and self._length_changed()):
            if cls.IS_LIST:
                self._backing = BranchNode(contents, uint_to_leaf(self._length))
            else:
                self._backing = contents
        return self._backing

    def _length_changed(self) -> bool:
        assert isinstance(self._backing, BranchNode)
        return int.from_bytes(self._backing.right._root[:8], "little") != self._length

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        v = cls.__new__(cls)
        object.__setattr__(v, "_parent", parent)
        object.__setattr__(v, "_pkey", pkey)
        v._cache = {}
        v._dirty = set()
        v._values = None
        v._dirty_chunks = set() if cls._is_packed() else None
        v._backing = node
        if cls.IS_LIST:
            assert isinstance(node, BranchNode)
            v._length = int.from_bytes(node.right._root[:8], "little")
        else:
            v._length = cls.LENGTH
        return v

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        if isinstance(value, _HomogeneousBase):
            if value._layout_key() != cls._layout_key():
                raise TypeError(f"cannot store {type(value).__name__} as {cls.__name__}")
            v = cls.view_from_backing(value.get_backing(), parent, pkey)
        else:
            v = cls(value)
            object.__setattr__(v, "_parent", parent)
            object.__setattr__(v, "_pkey", pkey)
        return v

    # -- serialization --

    def encode_bytes(self) -> bytes:
        cls = type(self)
        if cls._is_packed():
            self._materialize_values()
            size = cls.ELEM_TYPE.type_byte_length()
            if size == 8:
                return np.asarray(self._values, dtype="<u8").tobytes()
            if size == 1:
                return bytes(self._values)
            return b"".join(v.to_bytes(size, "little") for v in self._values)
        return _encode_ordered(
            [self[i] for i in range(self._length)],
            [cls.ELEM_TYPE] * self._length,
        )


class Vector(_HomogeneousBase):
    __slots__ = ()

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("vector", cls.ELEM_TYPE._layout_key(), cls.LENGTH)

    def __class_getitem__(cls, params) -> type:
        elem_type, length = params
        key = (elem_type, length)
        t = _vector_cache.get(key)
        if t is None:
            t = type(
                f"Vector[{elem_type.__name__},{length}]",
                (Vector,),
                {"ELEM_TYPE": elem_type, "LENGTH": length, "IS_LIST": False, "__slots__": ()},
            )
            _vector_cache[key] = t
        return t

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return cls.ELEM_TYPE.is_fixed_byte_length()

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.ELEM_TYPE.type_byte_length() * cls.LENGTH

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def default_node(cls) -> Node:
        return cls._empty_backing()

    @classmethod
    def decode_bytes(cls, data: bytes):
        et = cls.ELEM_TYPE
        if et.is_fixed_byte_length():
            size = et.type_byte_length()
            assert len(data) == size * cls.LENGTH
            return cls([et.decode_bytes(data[i * size : (i + 1) * size]) for i in range(cls.LENGTH)])
        values = _decode_variable_list(data, et)
        assert len(values) == cls.LENGTH
        return cls(values)


class List(_HomogeneousBase):
    __slots__ = ()

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return ("list", cls.ELEM_TYPE._layout_key(), cls.LENGTH)

    def __class_getitem__(cls, params) -> type:
        elem_type, limit = params
        key = (elem_type, limit)
        t = _list_cache.get(key)
        if t is None:
            t = type(
                f"List[{elem_type.__name__},{limit}]",
                (List,),
                {"ELEM_TYPE": elem_type, "LENGTH": limit, "IS_LIST": True, "__slots__": ()},
            )
            _list_cache[key] = t
        return t

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def default_node(cls) -> Node:
        return BranchNode(zero_node(cls.contents_depth()), zero_node(0))

    def append(self, value):
        cls = type(self)
        if self._length >= cls.LENGTH:
            raise ValueError(f"{cls.__name__} full (limit {cls.LENGTH})")
        i = self._length
        if cls._is_packed():
            self._materialize_values()
            self._values.append(int(cls.ELEM_TYPE(value)))
            if self._dirty_chunks is not True:
                self._dirty_chunks.add(i // cls._elems_per_chunk())
        else:
            self._cache[i] = cls.ELEM_TYPE.coerce_for_store(value, self, i)
            self._dirty.add(i)
        self._length = i + 1
        self._invalidate()

    def pop(self):
        cls = type(self)
        if self._length == 0:
            raise IndexError("pop from empty list")
        i = self._length - 1
        if cls._is_packed():
            self._materialize_values()
            self._values.pop()
            if self._dirty_chunks is not True:
                self._dirty_chunks.add(i // cls._elems_per_chunk())
            self._length = i
        else:
            # flush pending updates, then zero the vacated slot (unfilled list
            # slots are zero chunks, not default-element subtrees)
            self.get_backing()
            self._cache.pop(i, None)
            self._length = i
            contents = with_updated_subtrees(
                self._contents_node(), cls.contents_depth(), [(i, zero_node(0))]
            )
            self._backing = BranchNode(contents, uint_to_leaf(self._length))
        self._invalidate()

    @classmethod
    def decode_bytes(cls, data: bytes):
        et = cls.ELEM_TYPE
        if len(data) == 0:
            return cls()
        if et.is_fixed_byte_length():
            size = et.type_byte_length()
            assert len(data) % size == 0
            n = len(data) // size
            assert n <= cls.LENGTH
            return cls([et.decode_bytes(data[i * size : (i + 1) * size]) for i in range(n)])
        values = _decode_variable_list(data, et)
        assert len(values) <= cls.LENGTH
        return cls(values)


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

_union_cache: Dict[tuple, type] = {}


class Union(View):
    __slots__ = ("_selector", "_value")

    OPTIONS: Tuple[Optional[type], ...] = ()

    def __class_getitem__(cls, params) -> type:
        if not isinstance(params, tuple):
            params = (params,)
        t = _union_cache.get(params)
        if t is None:
            name = f"Union[{','.join('None' if p is None else p.__name__ for p in params)}]"
            t = type(name, (Union,), {"OPTIONS": params, "__slots__": ()})
            _union_cache[params] = t
        return t

    def __init__(self, selector: int = 0, value=None):
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pkey", None)
        cls = type(self)
        assert 0 <= selector < len(cls.OPTIONS)
        opt = cls.OPTIONS[selector]
        if opt is None:
            assert value is None
        else:
            value = opt.coerce_for_store(value if value is not None else opt.default())
        self._selector = selector
        self._value = value
        self._backing = None

    @property
    def selector(self) -> int:
        return self._selector

    @property
    def value(self):
        return self._value

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def default(cls):
        return cls(0, None if cls.OPTIONS[0] is None else cls.OPTIONS[0].default())

    @classmethod
    def default_node(cls) -> Node:
        opt = cls.OPTIONS[0]
        val = zero_node(0) if opt is None else opt.default_node()
        return BranchNode(val, zero_node(0))

    @classmethod
    def _compute_layout_key(cls) -> tuple:
        return (
            "union",
            tuple(None if o is None else o._layout_key() for o in cls.OPTIONS),
        )

    def get_backing(self) -> Node:
        val_node = zero_node(0) if self._value is None else _node_of(None, self._value)
        return BranchNode(val_node, uint_to_leaf(self._selector))

    @classmethod
    def view_from_backing(cls, node: Node, parent=None, pkey=None):
        assert isinstance(node, BranchNode)
        sel = int.from_bytes(node.right._root[:8], "little")
        opt = cls.OPTIONS[sel]
        v = cls.__new__(cls)
        object.__setattr__(v, "_parent", parent)
        object.__setattr__(v, "_pkey", pkey)
        v._selector = sel
        v._value = None if opt is None else opt.view_from_backing(node.left, v, "value")
        v._backing = node
        return v

    @classmethod
    def coerce_for_store(cls, value, parent=None, pkey=None):
        if not (isinstance(value, Union) and value._layout_key() == cls._layout_key()):
            raise TypeError(f"cannot store {type(value).__name__} as {cls.__name__}")
        v = cls.view_from_backing(value.get_backing())
        object.__setattr__(v, "_parent", parent)
        object.__setattr__(v, "_pkey", pkey)
        return v

    def encode_bytes(self) -> bytes:
        body = b"" if self._value is None else self._value.encode_bytes()
        return bytes([self._selector]) + body

    @classmethod
    def decode_bytes(cls, data: bytes):
        sel = data[0]
        opt = cls.OPTIONS[sel]
        if opt is None:
            assert len(data) == 1
            return cls(sel, None)
        return cls(sel, opt.decode_bytes(data[1:]))

    def _child_changed(self, key):
        self._invalidate()

    def change(self, selector: int, value) -> None:
        """In-place re-tag (the sharding spec's ShardWork status flips:
        ``committee_work.status.change(selector=..., value=...)``)."""
        cls = type(self)
        assert 0 <= selector < len(cls.OPTIONS)
        opt = cls.OPTIONS[selector]
        if opt is None:
            assert value is None
            new_value = None
        else:
            new_value = opt.coerce_for_store(
                value if value is not None else opt.default(), self, "value"
            )
        self._selector = selector
        self._value = new_value
        self._invalidate()

    def __eq__(self, other):
        if isinstance(other, Union):
            return (
                type(self)._layout_key() == type(other)._layout_key()
                and self._selector == other._selector
                and self._value == other._value
            )
        return NotImplemented

    __hash__ = View.__hash__

    def __repr__(self):
        return f"{type(self).__name__}(selector={self._selector}, value={self._value!r})"


# ---------------------------------------------------------------------------
# Serialization helpers (offset scheme, ssz/simple-serialize.md:105-208)
# ---------------------------------------------------------------------------


def _encode_ordered(values, types) -> bytes:
    fixed_parts = []
    variable_parts = []
    for v, t in zip(values, types):
        if t.is_fixed_byte_length():
            fixed_parts.append(v.encode_bytes())
            variable_parts.append(b"")
        else:
            fixed_parts.append(None)
            variable_parts.append(v.encode_bytes())
    fixed_len = sum(
        len(p) if p is not None else OFFSET_BYTE_LENGTH for p in fixed_parts
    )
    out = io.BytesIO()
    offset = fixed_len
    for p, vp in zip(fixed_parts, variable_parts):
        if p is not None:
            out.write(p)
        else:
            out.write(offset.to_bytes(OFFSET_BYTE_LENGTH, "little"))
            offset += len(vp)
    for vp in variable_parts:
        out.write(vp)
    return out.getvalue()


def _decode_ordered(data: bytes, types) -> list:
    fixed_len = sum(
        t.type_byte_length() if t.is_fixed_byte_length() else OFFSET_BYTE_LENGTH
        for t in types
    )
    if len(data) < fixed_len:
        raise ValueError(f"SSZ: data shorter than fixed section ({len(data)} < {fixed_len})")
    # first pass: fixed parts + offsets
    pos = 0
    fixed_vals: list = []
    offsets: list = []
    for t in types:
        if t.is_fixed_byte_length():
            size = t.type_byte_length()
            fixed_vals.append(t.decode_bytes(data[pos : pos + size]))
            pos += size
        else:
            offsets.append((len(fixed_vals), int.from_bytes(data[pos : pos + 4], "little")))
            fixed_vals.append(None)
            pos += 4
    # validate offsets: first == end of fixed section, monotonic, within data
    for k, (_, off) in enumerate(offsets):
        if k == 0 and off != fixed_len:
            raise ValueError(f"SSZ: first offset {off} != fixed section length {fixed_len}")
        if k > 0 and off < offsets[k - 1][1]:
            raise ValueError("SSZ: offsets not monotonically increasing")
        if off > len(data):
            raise ValueError(f"SSZ: offset {off} beyond data length {len(data)}")
    if not offsets and len(data) != fixed_len:
        raise ValueError(f"SSZ: {len(data) - fixed_len} trailing bytes after fixed section")
    # second pass: slice variable parts
    for k, (idx, off) in enumerate(offsets):
        end = offsets[k + 1][1] if k + 1 < len(offsets) else len(data)
        t = types[idx]
        fixed_vals[idx] = t.decode_bytes(data[off:end])
    return fixed_vals


def _decode_variable_list(data: bytes, elem_type) -> list:
    first_offset = int.from_bytes(data[:4], "little")
    if first_offset % 4 != 0 or first_offset > len(data):
        raise ValueError("SSZ: invalid first offset in variable-size list")
    n = first_offset // 4
    offsets = [
        int.from_bytes(data[i * 4 : i * 4 + 4], "little") for i in range(n)
    ]
    for k in range(1, n):
        if offsets[k] < offsets[k - 1] or offsets[k] > len(data):
            raise ValueError("SSZ: invalid offsets in variable-size list")
    values = []
    for k in range(n):
        end = offsets[k + 1] if k + 1 < n else len(data)
        values.append(elem_type.decode_bytes(data[offsets[k] : end]))
    return values


def _collect_leaf_roots(node: Node, depth: int, count: int) -> list:
    """First `count` leaf chunk roots of a subtree, left to right (iterative)."""
    from .node import PackedLazySubtree

    out: list = []
    if count == 0:
        return out
    stack = [(node, depth)]
    while stack and len(out) < count:
        n, d = stack.pop()
        if d == 0:
            out.append(n._root if n._root is not None else merkle_root(n))
            continue
        if isinstance(n, PackedLazySubtree) and d == n._depth:
            # raw-bytes shortcut: the chunks ARE the stored buffer
            out.extend(n.leaf_roots(min(count - len(out), 1 << d)))
            continue
        assert isinstance(n, BranchNode)
        stack.append((n.right, d - 1))
        stack.append((n.left, d - 1))
    return out
