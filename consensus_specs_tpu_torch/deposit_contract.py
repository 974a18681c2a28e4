"""Incremental deposit Merkle tree — executable mirror of the deposit
contract's accumulator algorithm (reference aux subsystem:
solidity_deposit_contract/deposit_contract.sol; the branch/size scheme of
get_deposit_root and the DepositEvent ABI data layout).

The contract keeps one 32-entry `branch` array: inserting leaf i updates
the first branch slot whose subtree became full; the root folds branch
entries against zero-subtree hashes and mixes in the little-endian count.
This mirror is differentially tested against the SSZ
List[DepositData, 2**32] hash_tree_root and the vendored bytecode
(tests/test_torch_deposit_contract.py),
which is exactly the equivalence process_deposit relies on
(phase0/beacon-chain.md is_valid_merkle_branch against eth1_data.deposit_root).
"""
from __future__ import annotations

from typing import List

from consensus_specs_tpu_torch.ssz.hashing import sha256

DEPOSIT_CONTRACT_TREE_DEPTH = 32


class DepositTree:
    """The contract's incremental accumulator."""

    def __init__(self) -> None:
        self.branch: List[bytes] = [b"\x00" * 32] * DEPOSIT_CONTRACT_TREE_DEPTH
        self.deposit_count = 0
        self._zero_hashes = [b"\x00" * 32]
        for _ in range(DEPOSIT_CONTRACT_TREE_DEPTH - 1):
            prev = self._zero_hashes[-1]
            self._zero_hashes.append(sha256(prev + prev))

    def push_leaf(self, leaf: bytes) -> None:
        assert self.deposit_count < 2**DEPOSIT_CONTRACT_TREE_DEPTH - 1, "tree full"
        self.deposit_count += 1
        size = self.deposit_count
        node = bytes(leaf)
        for height in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            if size % 2 == 1:
                self.branch[height] = node
                return
            node = sha256(self.branch[height] + node)
            size //= 2
        raise AssertionError("unreachable: loop always returns")

    def get_root(self) -> bytes:
        """Contract get_deposit_root: fold + mix in deposit_count."""
        node = b"\x00" * 32
        size = self.deposit_count
        for height in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            if size % 2 == 1:
                node = sha256(self.branch[height] + node)
            else:
                node = sha256(node + self._zero_hashes[height])
            size //= 2
        return sha256(node + self.deposit_count.to_bytes(8, "little") + b"\x00" * 24)


def deposit_event_data(pubkey: bytes, withdrawal_credentials: bytes,
                       amount_gwei: int, signature: bytes, index: int) -> bytes:
    """The DepositEvent FIELD VALUES concatenated in contract order with
    the contract's little-endian amount/index encoding.  NOTE: this is the
    logical payload, not the ABI event encoding (which adds head offsets
    and 32-byte padding around each dynamic bytes argument)."""
    assert len(pubkey) == 48 and len(withdrawal_credentials) == 32
    assert len(signature) == 96
    return b"".join([
        pubkey,
        withdrawal_credentials,
        amount_gwei.to_bytes(8, "little"),
        signature,
        index.to_bytes(8, "little"),
    ])
