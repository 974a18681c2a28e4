"""The port's deposit contract layer against the JAX package's.

* ``deposit_contract.DepositTree``: its roots equal the reference's at
  seeded counts and the SSZ ``List[DepositData, 2**32]`` root at every
  size; the tree feeds ``process_deposit`` on a CPU-built spec;
* the port's vendored artifact (``vendor/deposit_contract/``): the same
  bytes as the reference's; the constants and ABI recorded in it; an
  independent transcription of the contract's accumulator (the twin);
* the port's EVM (``evm/``) running that bytecode: root, count and logs
  equal to the twin and ``DepositTree`` after every deposit, its reverts
  and static-call guard; its Keccak on known vectors and equal to the
  reference's, and its ABI codec equal to the reference's.
Twins of the reference's ``tests/test_deposit_contract*.py``.
"""
import hashlib
import json
import random
import re
from pathlib import Path

import pytest

from consensus_specs_tpu import deposit_contract as ref_deposit_contract
from consensus_specs_tpu import evm as ref_evm
from consensus_specs_tpu_torch import evm
from consensus_specs_tpu_torch.deposit_contract import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    DepositTree,
    deposit_event_data,
)
from consensus_specs_tpu_torch.evm import EvmRevert, decode_abi, deploy, selector
from consensus_specs_tpu_torch.evm.keccak import keccak256
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz.impl import hash_tree_root
from consensus_specs_tpu_torch.ssz.types import List as SSZList

ROOT = Path(__file__).resolve().parent.parent
VENDOR = ROOT / "consensus_specs_tpu_torch" / "vendor" / "deposit_contract"
REF_VENDOR = ROOT / "consensus_specs_tpu" / "vendor" / "deposit_contract"
SOL = (VENDOR / "deposit_contract.sol").read_text()
ARTIFACT = json.loads((VENDOR / "deposit_contract.json").read_text())

GWEI = 10**9
DEPOSIT_SIG = "deposit(bytes,bytes,bytes,bytes32)"
DEPOSIT_TYPES = ["bytes", "bytes", "bytes", "bytes32"]


@pytest.fixture(scope="module")
def spec():
    return get_spec("phase0", "minimal", device="cpu")


@pytest.fixture()
def contract():
    return deploy(bytes.fromhex(ARTIFACT["bytecode"][2:]))


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _le64(value: int) -> bytes:
    return value.to_bytes(8, "little")


def _sol_deposit_data_root(pubkey: bytes, withdrawal_credentials: bytes,
                           amount_gwei: int, signature: bytes) -> bytes:
    """The contract's inline DepositData merkleization, transcribed from the
    vendored source's documented formula (sol `deposit()` body)."""
    amount = _le64(amount_gwei)
    pubkey_root = _sha(pubkey + b"\x00" * 16)
    signature_root = _sha(
        _sha(signature[:64]) + _sha(signature[64:] + b"\x00" * 32))
    return _sha(
        _sha(pubkey_root + withdrawal_credentials)
        + _sha(amount + b"\x00" * 24 + signature_root))


class _SolContract:
    """Independent python transcription of the sol accumulator (branch array
    + zero hashes + count), used ONLY as the differential twin."""

    def __init__(self):
        self.branch = [b"\x00" * 32] * 32
        self.zero_hashes = [b"\x00" * 32] * 32
        for h in range(31):
            self.zero_hashes[h + 1] = _sha(self.zero_hashes[h] * 2)
        self.count = 0

    def deposit(self, node: bytes):
        assert self.count < 2**32 - 1
        self.count += 1
        size = self.count
        for height in range(32):
            if size & 1:
                self.branch[height] = node
                return
            node = _sha(self.branch[height] + node)
            size //= 2
        raise AssertionError("unreachable")

    def get_deposit_root(self) -> bytes:
        node = b"\x00" * 32
        size = self.count
        for height in range(32):
            if size & 1:
                node = _sha(self.branch[height] + node)
            else:
                node = _sha(node + self.zero_hashes[height])
            size //= 2
        return _sha(node + _le64(self.count) + b"\x00" * 24)


# -- the tree ----------------------------------------------------------------


def test_empty_tree_matches_empty_list_root(spec):
    assert DepositTree().get_root() == hash_tree_root(
        SSZList[spec.DepositData, 2**32]())


def test_incremental_root_matches_ssz_list_at_every_size(spec):
    tree = DepositTree()
    data_list = []
    for i in range(10):
        dd = spec.DepositData(
            pubkey=bytes([i + 1]) * 48,
            withdrawal_credentials=bytes([i]) * 32,
            amount=spec.Gwei(32 * 10**9 + i))
        data_list.append(dd)
        tree.push_leaf(hash_tree_root(dd))
        expected = hash_tree_root(SSZList[spec.DepositData, 2**32](data_list))
        assert tree.get_root() == expected, f"size {i + 1}"


@pytest.mark.parametrize("count", [0, 1, 2, 3, 31, 32, 33, 257, 1000])
def test_tree_roots_equal_the_references_at_seeded_counts(count):
    rng = random.Random(1000 + count)
    ours, theirs = DepositTree(), ref_deposit_contract.DepositTree()
    for _ in range(count):
        leaf = rng.randbytes(32)
        ours.push_leaf(leaf)
        theirs.push_leaf(leaf)
    assert ours.get_root() == theirs.get_root()
    assert ours.branch == theirs.branch
    assert ours.deposit_count == theirs.deposit_count == count


def test_tree_root_feeds_process_deposit(spec):
    """The contract mirror's root is the one ``process_deposit`` checks
    the deposit's proof against."""
    from consensus_specs_tpu_torch.testing.context import (
        default_activation_threshold,
        default_balances,
    )
    from consensus_specs_tpu_torch.testing.helpers.deposits import (
        prepare_state_and_deposit,
    )
    from consensus_specs_tpu_torch.testing.helpers.genesis import (
        create_genesis_state,
    )

    state = create_genesis_state(
        spec, default_balances(spec), default_activation_threshold(spec))
    index = len(state.validators)
    deposit = prepare_state_and_deposit(
        spec, state, index, spec.MAX_EFFECTIVE_BALANCE, signed=True)
    tree = DepositTree()
    tree.push_leaf(hash_tree_root(deposit.data))
    assert tree.get_root() == state.eth1_data.deposit_root
    spec.process_deposit(state, deposit)
    assert len(state.validators) == index + 1


def test_deposit_event_layout():
    args = (b"\x01" * 48, b"\x02" * 32, 32 * 10**9, b"\x03" * 96, 7)
    data = deposit_event_data(*args)
    assert len(data) == 48 + 32 + 8 + 96 + 8
    assert data[80:88] == (32 * 10**9).to_bytes(8, "little")
    assert data[-8:] == (7).to_bytes(8, "little")
    assert data == ref_deposit_contract.deposit_event_data(*args)


# -- the vendored artifact ----------------------------------------------------


@pytest.mark.parametrize("name", ["deposit_contract.json",
                                  "deposit_contract.sol"])
def test_vendored_copies_equal_the_references(name):
    ours = hashlib.sha256((VENDOR / name).read_bytes()).hexdigest()
    assert ours == hashlib.sha256((REF_VENDOR / name).read_bytes()).hexdigest()


def test_constants_match_sol_source():
    depth = int(re.search(
        r"DEPOSIT_CONTRACT_TREE_DEPTH = (\d+);", SOL).group(1))
    assert depth == DEPOSIT_CONTRACT_TREE_DEPTH == 32
    assert "MAX_DEPOSIT_COUNT = 2**DEPOSIT_CONTRACT_TREE_DEPTH - 1" in SOL


def test_abi_shape():
    abi = {entry.get("name"): entry for entry in ARTIFACT["abi"]
           if entry.get("type") in ("function", "event")}
    assert [arg["name"] for arg in abi["deposit"]["inputs"]] == [
        "pubkey", "withdrawal_credentials", "signature", "deposit_data_root"]
    assert [arg["name"] for arg in abi["DepositEvent"]["inputs"]] == [
        "pubkey", "withdrawal_credentials", "amount", "signature", "index"]
    assert abi["get_deposit_root"]["outputs"][0]["type"] == "bytes32"
    assert abi["get_deposit_count"]["outputs"][0]["type"] == "bytes"
    assert ARTIFACT["bytecode"].startswith("0x")


def test_sol_twin_matches_deposit_tree_mirror():
    twin, mirror = _SolContract(), DepositTree()
    assert twin.get_deposit_root() == mirror.get_root()
    for i in range(33):  # crosses several subtree-boundary sizes
        leaf = _sha(i.to_bytes(4, "little"))
        twin.deposit(leaf)
        mirror.push_leaf(leaf)
        assert twin.get_deposit_root() == mirror.get_root(), i


def test_sol_deposit_data_root_matches_ssz(spec):
    pubkey, creds = bytes(range(48)), b"\x11" * 32
    signature, amount = bytes(range(96)), 32 * 10**9
    data = spec.DepositData(pubkey=pubkey, withdrawal_credentials=creds,
                            amount=amount, signature=signature)
    assert _sol_deposit_data_root(pubkey, creds, amount, signature) \
        == bytes(hash_tree_root(data))


def test_full_differential_vs_ssz_list_root(spec):
    twin = _SolContract()
    datas = []
    for i in range(10):
        data = spec.DepositData(
            pubkey=bytes([i]) * 48,
            withdrawal_credentials=bytes([i ^ 0xFF]) * 32,
            amount=(i + 1) * 10**9,
            signature=bytes([i | 0x40]) * 96)
        datas.append(data)
        twin.deposit(_sol_deposit_data_root(
            bytes(data.pubkey), bytes(data.withdrawal_credentials),
            int(data.amount), bytes(data.signature)))
        assert twin.get_deposit_root() == bytes(hash_tree_root(
            SSZList[spec.DepositData, 2**32](*datas))), i


def test_gwei_bounds_from_sol():
    assert "msg.value >= 1 ether" in SOL
    assert "msg.value % 1 gwei == 0" in SOL
    with pytest.raises(AssertionError):
        full = _SolContract()
        full.count = 2**32 - 1
        full.deposit(b"\x00" * 32)


# -- the bytecode on the port's EVM ------------------------------------------


def _deposit_data(spec, i, amount_gwei):
    return spec.DepositData(
        pubkey=bytes([i + 1]) * 48,
        withdrawal_credentials=bytes([i + 0x20]) * 32,
        amount=amount_gwei,
        signature=bytes([i + 0x60]) * 96)


def _call_deposit(contract, data, root=None, pubkey=None, extra_wei=0,
                  static=False):
    return contract.call(
        DEPOSIT_SIG, DEPOSIT_TYPES,
        [bytes(data.pubkey) if pubkey is None else pubkey,
         bytes(data.withdrawal_credentials), bytes(data.signature),
         bytes(data.hash_tree_root()) if root is None else root],
        value=int(data.amount) * GWEI + extra_wei, static=static)


def _evm_root(contract) -> bytes:
    return contract.call("get_deposit_root()", [], [], static=True)


def _evm_count(contract) -> int:
    raw = decode_abi(["bytes"], contract.call(
        "get_deposit_count()", [], [], static=True))[0]
    return int.from_bytes(raw, "little")


def test_empty_tree_root_matches_twin(contract):
    assert _evm_root(contract) == DepositTree().get_root()
    assert _evm_count(contract) == 0


def test_deposit_sequence_bytecode_vs_twin_vs_ssz(contract, spec):
    """Every step: the bytecode's root == the twin's == ``DepositTree``'s
    == the SSZ list root, and each log's fields are
    ``deposit_event_data``'s."""
    twin, tree, datas = _SolContract(), DepositTree(), []
    for i in range(5):
        data = _deposit_data(spec, i, 32 * 10**9)
        _call_deposit(contract, data)
        leaf = bytes(data.hash_tree_root())
        twin.deposit(leaf)
        tree.push_leaf(leaf)
        datas.append(data)
        root = _evm_root(contract)
        assert root == twin.get_deposit_root() == tree.get_root(), i
        assert _evm_count(contract) == tree.deposit_count == i + 1
        assert root == bytes(SSZList[spec.DepositData, 2**32](
            datas).hash_tree_root())
        fields = decode_abi(["bytes"] * 5, contract.logs[-1].data)
        assert b"".join(fields) == deposit_event_data(
            bytes(data.pubkey), bytes(data.withdrawal_credentials),
            int(data.amount), bytes(data.signature), i)
    assert len(contract.logs) == 5


def test_deposit_event_log_fields(contract, spec):
    data = _deposit_data(spec, 7, 32 * 10**9)
    _call_deposit(contract, data)
    assert len(contract.logs) == 1
    pk, wc, amount_le, sig, index_le = decode_abi(
        ["bytes"] * 5, contract.logs[0].data)
    assert pk == bytes(data.pubkey)
    assert wc == bytes(data.withdrawal_credentials)
    assert int.from_bytes(amount_le, "little") == int(data.amount)
    assert sig == bytes(data.signature)
    assert int.from_bytes(index_le, "little") == 0


@pytest.mark.parametrize("case", ["low_value", "non_gwei_multiple",
                                  "wrong_data_root", "malformed_pubkey",
                                  "static_call"])
def test_bad_deposits_revert_and_leave_no_trace(contract, spec, case):
    """The contract's requires (at least 1 ETH, gwei granularity, the data
    root, the pubkey length) and the static-call guard revert, leaving the
    count at zero."""
    data = _deposit_data(spec, 1, 10**8 if case == "low_value" else 32 * 10**9)
    kwargs = {"non_gwei_multiple": {"extra_wei": 1},
              "wrong_data_root": {"root": b"\xbe" * 32},
              "malformed_pubkey": {"pubkey": b"\x01" * 47},
              "static_call": {"static": True}}.get(case, {})
    with pytest.raises(EvmRevert):
        _call_deposit(contract, data, **kwargs)
    assert _evm_count(contract) == 0
    assert contract.logs == []


def test_supports_interface(contract):
    out = contract.call("supportsInterface(bytes4)", ["bytes4"],
                        [bytes.fromhex("01ffc9a7")], static=True)
    assert decode_abi(["bool"], out)[0] is True
    out = contract.call("supportsInterface(bytes4)", ["bytes4"],
                        [b"\xde\xad\xbe\xef"], static=True)
    assert decode_abi(["bool"], out)[0] is False
    assert selector("supportsInterface(bytes4)") != selector(DEPOSIT_SIG)


def test_reverted_call_discards_storage_effects(contract, spec):
    data = _deposit_data(spec, 4, 32 * 10**9)
    _call_deposit(contract, data)
    pre_storage, pre_root = dict(contract.storage), _evm_root(contract)
    with pytest.raises(EvmRevert):
        _call_deposit(contract, data, root=b"\xaa" * 32)
    assert contract.storage == pre_storage
    assert _evm_root(contract) == pre_root
    assert _evm_count(contract) == 1


def test_port_and_reference_evms_agree_deposit_by_deposit(spec):
    """The same bytecode on both packages' EVMs: the same return data,
    storage and logs after each of a seeded run of deposits."""
    code = bytes.fromhex(ARTIFACT["bytecode"][2:])
    ours, theirs = deploy(code), ref_evm.deploy(code)
    rng = random.Random(90013)
    for i in range(4):
        args = [rng.randbytes(48), rng.randbytes(32), rng.randbytes(96)]
        data = spec.DepositData(pubkey=args[0], withdrawal_credentials=args[1],
                                amount=(i + 1) * 10**9, signature=args[2])
        args.append(bytes(data.hash_tree_root()))
        value = int(data.amount) * GWEI
        assert ours.call(DEPOSIT_SIG, DEPOSIT_TYPES, args, value=value) == \
            theirs.call(DEPOSIT_SIG, DEPOSIT_TYPES, args, value=value)
        assert ours.storage == theirs.storage
        assert [(log.topics, log.data) for log in ours.logs] == \
            [(log.topics, log.data) for log in theirs.logs]
    assert _evm_root(ours) == _evm_root(theirs)


# -- Keccak and the ABI codec -------------------------------------------------


@pytest.mark.parametrize("message, digest", [
    (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
    (b"The quick brown fox jumps over the lazy dog",
     "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15"),
    (b"a" * 200, None),
])
def test_keccak_known_vectors_and_the_reference(message, digest):
    ours = keccak256(message)
    if digest is not None:
        assert ours.hex() == digest
    assert ours == ref_evm.keccak256(message)


def test_selectors_and_abi_codec_equal_the_references():
    for sig in (DEPOSIT_SIG, "get_deposit_root()", "get_deposit_count()",
                "supportsInterface(bytes4)", "transfer(address,uint256)"):
        assert selector(sig) == ref_evm.selector(sig)
    assert selector("transfer(address,uint256)").hex() == "a9059cbb"
    types = ["bytes", "bytes32", "uint256", "bool", "bytes4"]
    values = [b"\x07" * 50, b"\x01" * 32, 2**200 + 3, True, b"\xab\xcd\xef\x01"]
    encoded = evm.encode_abi(types, values)
    assert encoded == ref_evm.encode_abi(types, values)
    words = types[:4]  # the decoder reads the deposit contract's types
    assert evm.decode_abi(words, encoded) == ref_evm.decode_abi(
        words, encoded) == values[:4]
