"""Mock genesis state construction.

Parity surface: reference ``eth2spec/test/helpers/genesis.py``. Validators
are written straight into the registry instead of replaying deposits — the
standard pyspec shortcut — but here the per-fork extension fields and the
altair participation columns are installed in bulk after the loop rather
than interleaved per validator.
"""
from __future__ import annotations

from .constants import (
    CUSTODY_GAME,
    FORKS_BEFORE_ALTAIR,
    FORKS_BEFORE_BELLATRIX,
    FORKS_BEFORE_CAPELLA,
)
from .keys import pubkeys


def build_mock_validator(spec, i: int, balance: int):
    # Withdrawal credentials are derived from a second (equally insecure)
    # test pubkey taken from the far end of the key table.
    creds = bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(pubkeys[-1 - i])[1:]
    effective = min(
        int(balance) - int(balance) % int(spec.EFFECTIVE_BALANCE_INCREMENT),
        int(spec.MAX_EFFECTIVE_BALANCE))
    validator = spec.Validator(
        pubkey=pubkeys[i],
        withdrawal_credentials=creds,
        effective_balance=effective,
        activation_eligibility_epoch=spec.FAR_FUTURE_EPOCH,
        activation_epoch=spec.FAR_FUTURE_EPOCH,
        exit_epoch=spec.FAR_FUTURE_EPOCH,
        withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
    )
    if spec.fork not in FORKS_BEFORE_CAPELLA:
        validator.fully_withdrawn_epoch = spec.FAR_FUTURE_EPOCH
    if spec.fork == CUSTODY_GAME:
        # The custody Validator extension reads epoch zero as "already
        # revealed"; fresh validators must start at FAR_FUTURE_EPOCH
        # (custody_game/beacon-chain.md Validator table).
        validator.all_custody_secrets_revealed_epoch = spec.FAR_FUTURE_EPOCH
    return validator


def get_sample_genesis_execution_payload_header(spec, eth1_block_hash=None):
    if eth1_block_hash is None:
        eth1_block_hash = b"\x55" * 32
    return spec.ExecutionPayloadHeader(
        parent_hash=b"\x30" * 32,
        fee_recipient=b"\x42" * 20,
        state_root=b"\x20" * 32,
        receipts_root=b"\x20" * 32,
        logs_bloom=b"\x35" * spec.BYTES_PER_LOGS_BLOOM,
        prev_randao=eth1_block_hash,
        block_number=0,
        gas_limit=30000000,
        base_fee_per_gas=1000000000,
        block_hash=eth1_block_hash,
        transactions_root=spec.Root(b"\x56" * 32),
    )


def _fork_at_genesis(spec):
    """A Fork whose previous version follows the builder's fork topology, so
    experimental branches stamp their parent's version as previous (the same
    shape upgrade_to_* would have produced)."""
    from consensus_specs_tpu_torch.specs.builder import FORK_PARENTS

    def _version(fork_name):
        if fork_name in (None, "phase0"):
            return spec.config.GENESIS_FORK_VERSION
        return getattr(spec.config, f"{fork_name.upper()}_FORK_VERSION")

    return spec.Fork(
        previous_version=_version(FORK_PARENTS.get(spec.fork, None)),
        current_version=_version(spec.fork),
        epoch=spec.GENESIS_EPOCH,
    )


def create_genesis_state(spec, validator_balances, activation_threshold):
    eth1_block_hash = b"\xda" * 32
    count = len(validator_balances)

    state = spec.BeaconState(
        genesis_time=0,
        eth1_deposit_index=count,
        eth1_data=spec.Eth1Data(
            deposit_root=b"\x42" * 32,
            deposit_count=count,
            block_hash=eth1_block_hash,
        ),
        fork=_fork_at_genesis(spec),
        latest_block_header=spec.BeaconBlockHeader(
            body_root=spec.hash_tree_root(spec.BeaconBlockBody())),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
    )

    # Registry injection: skip deposit processing entirely and write the
    # validators in directly, activating those above the threshold.
    state.balances = validator_balances
    registry = []
    for i, balance in enumerate(validator_balances):
        validator = build_mock_validator(spec, i, balance)
        if validator.effective_balance >= activation_threshold:
            validator.activation_eligibility_epoch = spec.GENESIS_EPOCH
            validator.activation_epoch = spec.GENESIS_EPOCH
        registry.append(validator)
    state.validators = registry

    post_altair = spec.fork not in FORKS_BEFORE_ALTAIR
    if post_altair:
        zero_flags = [spec.ParticipationFlags(0)] * count
        state.previous_epoch_participation = zero_flags
        state.current_epoch_participation = zero_flags
        state.inactivity_scores = [spec.uint64(0)] * count

    # Domain separation / chain versioning root over the final registry.
    state.genesis_validators_root = spec.hash_tree_root(state.validators)

    if post_altair:
        # Genesis assigns the same committee to both the current and next slots.
        state.current_sync_committee = spec.get_next_sync_committee(state)
        state.next_sync_committee = spec.get_next_sync_committee(state)

    if spec.fork not in FORKS_BEFORE_BELLATRIX:
        state.latest_execution_payload_header = get_sample_genesis_execution_payload_header(
            spec, eth1_block_hash=eth1_block_hash)

    return state
