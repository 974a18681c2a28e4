"""Runtime config values ("mainnet"/"minimal" networks).

Protocol data transcribed from the reference runtime configs
(reference: configs/{mainnet,minimal}.yaml).  Spec functions reach these
as ``config.<NAME>`` — the reference gets the same effect by rewriting
bare references into ``config.`` attribute access at compile time
(setup.py:619-621); here spec source simply writes ``config.X`` directly.

``Config`` is a mutable namespace (not a frozen NamedTuple like the
reference's) because the test framework must be able to override fields
per-test (reference: with_config_overrides, test/context.py:492-534);
overriding there required rebuilding a whole spec module copy.
"""
from __future__ import annotations

from typing import Any, Dict


class Config:
    """Attribute-access view over config vars, dict-convertible for vectors."""

    def __init__(self, values: Dict[str, Any]):
        self.__dict__.update(values)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def replace(self, **overrides) -> "Config":
        merged = dict(self.__dict__)
        merged.update(overrides)
        return Config(merged)


_UINT64_MAX = 2**64 - 1

_MAINNET = {
    "PRESET_BASE": "mainnet",
    "CONFIG_NAME": "mainnet",
    # Transition
    "TERMINAL_TOTAL_DIFFICULTY": 2**256 - 2**10,
    "TERMINAL_BLOCK_HASH": b"\x00" * 32,
    "TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH": _UINT64_MAX,
    # Genesis
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": 16384,
    "MIN_GENESIS_TIME": 1606824000,
    "GENESIS_FORK_VERSION": bytes.fromhex("00000000"),
    "GENESIS_DELAY": 604800,
    # Forking
    "ALTAIR_FORK_VERSION": bytes.fromhex("01000000"),
    "ALTAIR_FORK_EPOCH": 74240,
    "BELLATRIX_FORK_VERSION": bytes.fromhex("02000000"),
    "BELLATRIX_FORK_EPOCH": _UINT64_MAX,
    "CAPELLA_FORK_VERSION": bytes.fromhex("03000000"),
    "CAPELLA_FORK_EPOCH": _UINT64_MAX,
    "SHARDING_FORK_VERSION": bytes.fromhex("04000000"),
    "SHARDING_FORK_EPOCH": _UINT64_MAX,
    "EIP4844_FORK_VERSION": bytes.fromhex("05000000"),
    "EIP4844_FORK_EPOCH": _UINT64_MAX,
    "CUSTODY_GAME_FORK_VERSION": bytes.fromhex("06000000"),
    "CUSTODY_GAME_FORK_EPOCH": _UINT64_MAX,
    "DAS_FORK_VERSION": bytes.fromhex("07000000"),
    "DAS_FORK_EPOCH": _UINT64_MAX,
    # Time parameters
    "SECONDS_PER_SLOT": 12,
    "SECONDS_PER_ETH1_BLOCK": 14,
    "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": 256,
    "SHARD_COMMITTEE_PERIOD": 256,
    "ETH1_FOLLOW_DISTANCE": 2048,
    # Validator cycle
    "INACTIVITY_SCORE_BIAS": 4,
    "INACTIVITY_SCORE_RECOVERY_RATE": 16,
    "EJECTION_BALANCE": 16_000_000_000,
    "MIN_PER_EPOCH_CHURN_LIMIT": 4,
    "CHURN_LIMIT_QUOTIENT": 65536,
    # Fork choice
    "PROPOSER_SCORE_BOOST": 33,
    # Deposit contract
    "DEPOSIT_CHAIN_ID": 1,
    "DEPOSIT_NETWORK_ID": 1,
    "DEPOSIT_CONTRACT_ADDRESS": bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa"),
}

_MINIMAL = dict(
    _MAINNET,
    PRESET_BASE="minimal",
    CONFIG_NAME="minimal",
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=64,
    MIN_GENESIS_TIME=1578009600,
    GENESIS_FORK_VERSION=bytes.fromhex("00000001"),
    GENESIS_DELAY=300,
    ALTAIR_FORK_VERSION=bytes.fromhex("01000001"),
    ALTAIR_FORK_EPOCH=_UINT64_MAX,
    BELLATRIX_FORK_VERSION=bytes.fromhex("02000001"),
    CAPELLA_FORK_VERSION=bytes.fromhex("03000001"),
    SHARDING_FORK_VERSION=bytes.fromhex("04000001"),
    EIP4844_FORK_VERSION=bytes.fromhex("05000001"),
    CUSTODY_GAME_FORK_VERSION=bytes.fromhex("06000001"),
    DAS_FORK_VERSION=bytes.fromhex("07000001"),
    SECONDS_PER_SLOT=6,
    SHARD_COMMITTEE_PERIOD=64,
    ETH1_FOLLOW_DISTANCE=16,
    CHURN_LIMIT_QUOTIENT=32,
    DEPOSIT_CHAIN_ID=5,
    DEPOSIT_NETWORK_ID=5,
    DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("1234567890123456789012345678901234567890"),
)

_CONFIGS = {"mainnet": _MAINNET, "minimal": _MINIMAL}


def get_config(name: str) -> Config:
    return Config(dict(_CONFIGS[name]))
