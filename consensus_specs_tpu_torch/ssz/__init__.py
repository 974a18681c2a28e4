"""SSZ type system + persistent Merkle hashing (see types.py, node.py)."""
from .hashing import ZERO_HASHES, sha256, set_backend, get_backend_name, register_backend
from .impl import copy, hash_tree_root, serialize, uint_to_bytes
from .types import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes1,
    Bytes4,
    Bytes8,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    SSZType,
    Union,
    Vector,
    View,
    bit,
    boolean,
    byte,
    uint,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from .gindex import GeneralizedIndex, build_proof, get_generalized_index
