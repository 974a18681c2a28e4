"""Compile-time preset values, mainnet and minimal, per fork.

Protocol data (not code) transcribed from the reference preset tables
(reference: presets/{mainnet,minimal}/{phase0,altair,bellatrix}.yaml and
the capella markdown preset tables, specs/capella/beacon-chain.md:77-89).
A preset is the union of all per-fork preset vars — exactly how the
reference merges per-fork YAML files (setup.py:782-797) — so one preset
dict serves every fork.
"""
from __future__ import annotations

from typing import Dict

PRESET_NAMES = ("mainnet", "minimal")

_PHASE0_MAINNET = {
    # Misc
    "MAX_COMMITTEES_PER_SLOT": 64,
    "TARGET_COMMITTEE_SIZE": 128,
    "MAX_VALIDATORS_PER_COMMITTEE": 2048,
    "SHUFFLE_ROUND_COUNT": 90,
    "HYSTERESIS_QUOTIENT": 4,
    "HYSTERESIS_DOWNWARD_MULTIPLIER": 1,
    "HYSTERESIS_UPWARD_MULTIPLIER": 5,
    # Fork choice
    "SAFE_SLOTS_TO_UPDATE_JUSTIFIED": 8,
    # Gwei values
    "MIN_DEPOSIT_AMOUNT": 1_000_000_000,
    "MAX_EFFECTIVE_BALANCE": 32_000_000_000,
    "EFFECTIVE_BALANCE_INCREMENT": 1_000_000_000,
    # Time parameters
    "MIN_ATTESTATION_INCLUSION_DELAY": 1,
    "SLOTS_PER_EPOCH": 32,
    "MIN_SEED_LOOKAHEAD": 1,
    "MAX_SEED_LOOKAHEAD": 4,
    "EPOCHS_PER_ETH1_VOTING_PERIOD": 64,
    "SLOTS_PER_HISTORICAL_ROOT": 8192,
    "MIN_EPOCHS_TO_INACTIVITY_PENALTY": 4,
    # State list lengths
    "EPOCHS_PER_HISTORICAL_VECTOR": 65536,
    "EPOCHS_PER_SLASHINGS_VECTOR": 8192,
    "HISTORICAL_ROOTS_LIMIT": 16_777_216,
    "VALIDATOR_REGISTRY_LIMIT": 2**40,
    # Reward and penalty quotients
    "BASE_REWARD_FACTOR": 64,
    "WHISTLEBLOWER_REWARD_QUOTIENT": 512,
    "PROPOSER_REWARD_QUOTIENT": 8,
    "INACTIVITY_PENALTY_QUOTIENT": 2**26,
    "MIN_SLASHING_PENALTY_QUOTIENT": 128,
    "PROPORTIONAL_SLASHING_MULTIPLIER": 1,
    # Max operations per block
    "MAX_PROPOSER_SLASHINGS": 16,
    "MAX_ATTESTER_SLASHINGS": 2,
    "MAX_ATTESTATIONS": 128,
    "MAX_DEPOSITS": 16,
    "MAX_VOLUNTARY_EXITS": 16,
}

# minimal = mainnet with the [customized] keys overridden
_PHASE0_MINIMAL = dict(
    _PHASE0_MAINNET,
    MAX_COMMITTEES_PER_SLOT=4,
    TARGET_COMMITTEE_SIZE=4,
    SHUFFLE_ROUND_COUNT=10,
    SAFE_SLOTS_TO_UPDATE_JUSTIFIED=2,
    SLOTS_PER_EPOCH=8,
    EPOCHS_PER_ETH1_VOTING_PERIOD=4,
    SLOTS_PER_HISTORICAL_ROOT=64,
    EPOCHS_PER_HISTORICAL_VECTOR=64,
    EPOCHS_PER_SLASHINGS_VECTOR=64,
    INACTIVITY_PENALTY_QUOTIENT=2**25,
    MIN_SLASHING_PENALTY_QUOTIENT=64,
    PROPORTIONAL_SLASHING_MULTIPLIER=2,
)

_ALTAIR_MAINNET = {
    "INACTIVITY_PENALTY_QUOTIENT_ALTAIR": 3 * 2**24,
    "MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR": 64,
    "PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR": 2,
    "SYNC_COMMITTEE_SIZE": 512,
    "EPOCHS_PER_SYNC_COMMITTEE_PERIOD": 256,
    "MIN_SYNC_COMMITTEE_PARTICIPANTS": 1,
    "UPDATE_TIMEOUT": 8192,
}

_ALTAIR_MINIMAL = dict(
    _ALTAIR_MAINNET,
    SYNC_COMMITTEE_SIZE=32,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=8,
    UPDATE_TIMEOUT=64,
)

_BELLATRIX_BOTH = {
    "INACTIVITY_PENALTY_QUOTIENT_BELLATRIX": 2**24,
    "MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX": 32,
    "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX": 3,
    "MAX_BYTES_PER_TRANSACTION": 2**30,
    "MAX_TRANSACTIONS_PER_PAYLOAD": 2**20,
    "BYTES_PER_LOGS_BLOOM": 256,
    "MAX_EXTRA_DATA_BYTES": 32,
}

# Capella preset vars live in the markdown tables in this snapshot
# (specs/capella/beacon-chain.md:77-89); same for both presets.
_CAPELLA_BOTH = {
    "WITHDRAWALS_QUEUE_LIMIT": 2**40,
    "MAX_BLS_TO_EXECUTION_CHANGES": 16,
    "MAX_WITHDRAWALS_PER_PAYLOAD": 16,
}

# EIP-4844 preset (specs/eip4844/beacon-chain.md:56-60, p2p MAX_BLOBS):
# minimal shrinks the blob domain — the spec explicitly allows an insecure
# minimal trusted-setup variant for testing.
_EIP4844_MAINNET = {
    "FIELD_ELEMENTS_PER_BLOB": 4096,
    "MAX_BLOBS_PER_BLOCK": 16,
}
_EIP4844_MINIMAL = {
    "FIELD_ELEMENTS_PER_BLOB": 16,
    "MAX_BLOBS_PER_BLOCK": 16,
}

# Sharding preset (specs/sharding/beacon-chain.md:147-182); minimal
# shrinks the sample-blob domain so insecure setups stay instant.
_SHARDING_MAINNET = {
    "MAX_SHARDS": 2**10,
    "INITIAL_ACTIVE_SHARDS": 2**6,
    "SAMPLE_PRICE_ADJUSTMENT_COEFFICIENT": 2**3,
    "MAX_SHARD_PROPOSER_SLASHINGS": 2**4,
    "MAX_SHARD_HEADERS_PER_SHARD": 4,
    "SHARD_STATE_MEMORY_SLOTS": 2**8,
    "BLOB_BUILDER_REGISTRY_LIMIT": 2**40,
    "MAX_SAMPLES_PER_BLOB": 2**11,
    "TARGET_SAMPLES_PER_BLOB": 2**10,
    "MAX_SAMPLE_PRICE": 2**33,
    "MIN_SAMPLE_PRICE": 2**3,
}
_SHARDING_MINIMAL = dict(
    _SHARDING_MAINNET,
    # [customized] reduced for testing (reference minimal/sharding.yaml)
    MAX_SHARDS=2**3,
    INITIAL_ACTIVE_SHARDS=2**1,
    MAX_SHARD_PROPOSER_SLASHINGS=2**2,
    # deliberate deviation from the reference YAML (2048/1024 at both
    # presets there): the DAS/erasure tests run real Fr NTTs over
    # MAX_SAMPLES_PER_BLOB * POINTS_PER_SAMPLE points, so minimal keeps
    # them small the same way the reference shrinks SHUFFLE_ROUND_COUNT
    MAX_SAMPLES_PER_BLOB=2**3,
    TARGET_SAMPLES_PER_BLOB=2**2,
)

# Custody game preset (specs/custody_game/beacon-chain.md preset tables;
# per-preset values mirror reference presets/{mainnet,minimal}/custody_game.yaml)
_CUSTODY_MAINNET = {
    "MAX_CUSTODY_CHUNK_CHALLENGE_RECORDS": 2**20,
    "RANDAO_PENALTY_EPOCHS": 2**1,
    "EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS": 2**15,
    "EPOCHS_PER_CUSTODY_PERIOD": 2**14,
    "CUSTODY_PERIOD_TO_RANDAO_PADDING": 2**11,
    "MAX_CHUNK_CHALLENGE_DELAY": 2**15,
    "MAX_CUSTODY_KEY_REVEALS": 2**8,
    "MAX_EARLY_DERIVED_SECRET_REVEALS": 2**0,
    "MAX_CUSTODY_CHUNK_CHALLENGES": 2**2,
    "MAX_CUSTODY_CHUNK_CHALLENGE_RESPONSES": 2**4,
    "MAX_CUSTODY_SLASHINGS": 2**0,
    "EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE": 2**1,
    "MINOR_REWARD_QUOTIENT": 2**8,
}
_CUSTODY_MINIMAL = dict(
    _CUSTODY_MAINNET,
    # [customized] quicker for testing (reference minimal/custody_game.yaml)
    EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS=64,
    EPOCHS_PER_CUSTODY_PERIOD=32,
    CUSTODY_PERIOD_TO_RANDAO_PADDING=8,
    MAX_CHUNK_CHALLENGE_DELAY=64,
    MAX_CUSTODY_CHUNK_CHALLENGES=2,
    MAX_CUSTODY_CHUNK_CHALLENGE_RESPONSES=8,
)

_EXPERIMENTAL_MAINNET = {**_EIP4844_MAINNET, **_SHARDING_MAINNET, **_CUSTODY_MAINNET}
_EXPERIMENTAL_MINIMAL = {**_EIP4844_MINIMAL, **_SHARDING_MINIMAL, **_CUSTODY_MINIMAL}

_PRESETS: Dict[str, Dict[str, int]] = {
    "mainnet": {**_PHASE0_MAINNET, **_ALTAIR_MAINNET, **_BELLATRIX_BOTH,
                **_CAPELLA_BOTH, **_EXPERIMENTAL_MAINNET},
    "minimal": {**_PHASE0_MINIMAL, **_ALTAIR_MINIMAL, **_BELLATRIX_BOTH,
                **_CAPELLA_BOTH, **_EXPERIMENTAL_MINIMAL},
}


def get_preset(name: str) -> Dict[str, int]:
    return dict(_PRESETS[name])
