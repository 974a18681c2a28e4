"""The main path's inputs: one mainnet-shape epoch of signed blocks.

The port's counterpart of the reference bench's input builders
(``bench.py``: ``build_state``, ``_install_real_pubkeys``,
``_attestations_for``, ``_build_epoch_blocks``).  The main path is one
epoch at ``n`` validators: a state at epoch 2, then 32 signed blocks,
each carrying the aggregates of every committee of the two preceding
slots (3,904 in all on the mainnet preset), the last of which crosses the
epoch boundary and so runs the epoch transition.  On phase0 the state's
previous epoch holds a full complement of pending attestations; on the
altair lineage its participation flags and inactivity scores start at
zero, its sync committees are drawn from the registry as
``upgrade_to_altair`` draws them, and every block also carries a sync
aggregate of the whole 512-member committee (``with_sync=True``).  From
bellatrix on the state is past the merge (its latest execution payload
header is not the default) and every block carries an execution payload
that extends the previous one, with a transaction list the size of a
mainnet block after the merge (``TXS_PER_PAYLOAD`` transactions of
``TX_BYTES`` random bytes, about 90 KB).

All signing goes through the native C++ ``Sign``; every validator gets a
real pubkey (cycled from the 8192 deterministic test keys), so
verification with BLS on is meaningful.  An aggregate over one message is
the signature by the sum of its members' secret keys.
"""
from __future__ import annotations

import numpy as np

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.crypto.bls import native
from consensus_specs_tpu_torch.crypto.bls.curve import R as CURVE_ORDER
from consensus_specs_tpu_torch.ssz import bulk
from consensus_specs_tpu_torch.ssz.node import (
    BranchNode,
    subtree_fill_to_contents,
    uint_to_leaf,
)
from consensus_specs_tpu_torch.testing.keys import (
    NUM_KEYS,
    privkeys,
    pubkey_to_privkey,
    pubkeys,
)

FAR_FUTURE = 2**64 - 1

# The execution payload's transactions: this many a block, each of a size
# drawn uniformly from this range of bytes (~90 KB a block on average)
TXS_PER_PAYLOAD = 150
TX_BYTES = (200, 1_000)


def build_state(spec, n: int):
    """Synthetic mainnet-shape state at epoch 2: n active validators with
    a full previous epoch of maximum-participation pending attestations
    (phase0), or zeroed participation flags and inactivity scores sized to
    the registry (the altair lineage)."""
    state = spec.BeaconState()
    state.slot = 2 * spec.SLOTS_PER_EPOCH

    vnode = spec.Validator(
        effective_balance=spec.MAX_EFFECTIVE_BALANCE,
        activation_epoch=0,
        activation_eligibility_epoch=0,
        exit_epoch=FAR_FUTURE,
        withdrawable_epoch=FAR_FUTURE,
        **_never_withdrawn(spec),
    ).get_backing()
    vlist_t = type(state.validators)
    contents = subtree_fill_to_contents([vnode] * n, vlist_t.contents_depth())
    state.validators = vlist_t.view_from_backing(
        BranchNode(contents, uint_to_leaf(n))
    )
    bulk.set_packed_uint64_from_numpy(
        state.balances, np.full(n, int(spec.MAX_EFFECTIVE_BALANCE), dtype=np.int64)
    )

    if "previous_epoch_attestations" not in type(state)._field_names:
        # altair+: participation flags instead of attestations; size the
        # per-validator lists to the registry
        zeros8 = np.zeros(n, dtype=np.uint8)
        bulk.set_packed_uint8_from_numpy(state.previous_epoch_participation, zeros8)
        bulk.set_packed_uint8_from_numpy(state.current_epoch_participation, zeros8)
        bulk.set_packed_uint64_from_numpy(
            state.inactivity_scores, np.zeros(n, dtype=np.int64))
        return state
    prev_epoch = spec.get_previous_epoch(state)
    start_slot = spec.compute_start_slot_at_epoch(prev_epoch)
    committees_per_slot = int(spec.get_committee_count_per_slot(state, prev_epoch))
    for slot in range(int(start_slot), int(start_slot) + int(spec.SLOTS_PER_EPOCH)):
        for index in range(committees_per_slot):
            committee = spec.get_beacon_committee(state, slot, index)
            data = spec.AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=spec.get_block_root_at_slot(state, slot),
                source=state.previous_justified_checkpoint,
                target=spec.Checkpoint(
                    epoch=prev_epoch, root=spec.get_block_root(state, prev_epoch)
                ),
            )
            att = spec.PendingAttestation(
                aggregation_bits=[True] * len(committee),
                data=data,
                inclusion_delay=1,
                proposer_index=slot % n,
            )
            state.previous_epoch_attestations.append(att)
    return state


def _never_withdrawn(spec) -> dict:
    """Capella's ``fully_withdrawn_epoch`` as ``upgrade_to_capella`` sets
    it (its SSZ default 0 would mark every validator withdrawn); nothing
    before capella."""
    if "fully_withdrawn_epoch" in spec.Validator._field_names:
        return {"fully_withdrawn_epoch": FAR_FUTURE}
    return {}


def install_real_pubkeys(spec, state, n: int) -> None:
    """Give every validator a REAL pubkey (cycled from the deterministic
    8192-key table) so signature verification is meaningful.  Repeated keys
    are cryptographically fine for aggregate verification: the aggregate
    pubkey is the sum of member pubkeys regardless of duplicates."""
    vlist_t = type(state.validators)
    unique_nodes = []
    for k in range(min(n, NUM_KEYS)):
        unique_nodes.append(spec.Validator(
            pubkey=pubkeys[k],
            effective_balance=spec.MAX_EFFECTIVE_BALANCE,
            activation_epoch=0,
            activation_eligibility_epoch=0,
            exit_epoch=FAR_FUTURE,
            withdrawable_epoch=FAR_FUTURE,
            **_never_withdrawn(spec),
        ).get_backing())
    nodes = [unique_nodes[i % NUM_KEYS] for i in range(n)]
    contents = subtree_fill_to_contents(nodes, vlist_t.contents_depth())
    state.validators = vlist_t.view_from_backing(
        BranchNode(contents, uint_to_leaf(n)))


def build_main_path_state(spec, n: int):
    """``build_state`` with real pubkeys, on the altair lineage real sync
    committees drawn from that registry the way ``upgrade_to_altair`` seeds
    them (altair/fork.md), and from bellatrix on a completed merge: the
    pre-state of the main path."""
    state = build_state(spec, n)
    install_real_pubkeys(spec, state, n)
    if hasattr(state, "current_sync_committee"):
        state.current_sync_committee = spec.get_next_sync_committee(state)
        state.next_sync_committee = spec.get_next_sync_committee(state)
    if hasattr(state, "latest_execution_payload_header"):
        state.latest_execution_payload_header = merged_payload_header(spec)
    return state


def merged_payload_header(spec):
    """A non-default execution payload header, so that
    ``is_merge_transition_complete`` holds and no block of the epoch is a
    merge-transition block (which would need a PoW block lookup)."""
    block_hash = spec.hash(b"scenario: the execution head before the epoch")
    return spec.ExecutionPayloadHeader(
        parent_hash=spec.hash(block_hash),
        fee_recipient=b"\x42" * 20,
        state_root=spec.hash(block_hash + b"state"),
        receipts_root=spec.hash(block_hash + b"receipts"),
        block_number=1_000_000,
        gas_limit=30_000_000,
        gas_used=15_000_000,
        base_fee_per_gas=10**9,
        block_hash=block_hash,
        transactions_root=spec.hash(block_hash + b"transactions"),
    )


def execution_payload(spec, state, rng):
    """The execution payload of the next block on ``state`` (advanced to
    that block's slot, before its RANDAO reveal): it extends the state's
    latest header, carries the RANDAO mix the block's payload check reads,
    the slot's timestamp and ``TXS_PER_PAYLOAD`` random transactions.  No
    execution client is attached, so its block hash is a deterministic
    digest of the payload's root that the next payload chains to."""
    prev = state.latest_execution_payload_header
    sizes = rng.integers(TX_BYTES[0], TX_BYTES[1] + 1, TXS_PER_PAYLOAD)
    blob = rng.integers(0, 256, int(sizes.sum()), dtype=np.uint8).tobytes()
    ends = np.cumsum(sizes)
    payload = spec.ExecutionPayload(
        parent_hash=prev.block_hash,
        fee_recipient=prev.fee_recipient,
        state_root=rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
        receipts_root=rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
        logs_bloom=rng.integers(0, 256, int(spec.BYTES_PER_LOGS_BLOOM),
                                dtype=np.uint8).tobytes(),
        prev_randao=spec.get_randao_mix(state, spec.get_current_epoch(state)),
        block_number=prev.block_number + 1,
        gas_limit=prev.gas_limit,
        gas_used=int(rng.integers(0, int(prev.gas_limit) + 1)),
        timestamp=spec.compute_timestamp_at_slot(state, state.slot),
        base_fee_per_gas=prev.base_fee_per_gas,
        transactions=[blob[end - size:end] for size, end in zip(sizes, ends)],
    )
    if hasattr(spec, "get_expected_withdrawals"):
        # capella: the payload dequeues the state's withdrawal queue
        payload.withdrawals = spec.get_expected_withdrawals(state)
    payload.block_hash = spec.hash(
        payload.hash_tree_root() + b"scenario: execution block hash")
    return payload


def _sk_for(index) -> int:
    return privkeys[int(index) % NUM_KEYS]


def _aggregate_sign(members_sks, signing_root) -> bytes:
    """Aggregate signature over ONE message == signature by the sum of the
    member secret keys."""
    return native.Sign(sum(members_sks) % CURVE_ORDER, signing_root)


def attestations_for(spec, st, block_slot: int) -> list:
    """Every committee of the two preceding slots of the current epoch."""
    atts = []
    epoch = spec.get_current_epoch(st)
    epoch_start = int(spec.compute_start_slot_at_epoch(epoch))
    for prev_slot in (block_slot - 1, block_slot - 2):
        if prev_slot < epoch_start:
            continue
        committees = int(spec.get_committee_count_per_slot(st, epoch))
        for index in range(committees):
            committee = spec.get_beacon_committee(st, prev_slot, index)
            data = spec.AttestationData(
                slot=prev_slot,
                index=index,
                beacon_block_root=spec.get_block_root_at_slot(st, prev_slot),
                source=st.current_justified_checkpoint,
                target=spec.Checkpoint(
                    epoch=epoch, root=spec.get_block_root(st, epoch)),
            )
            root = spec.compute_signing_root(
                data, spec.get_domain(st, spec.DOMAIN_BEACON_ATTESTER, epoch))
            atts.append(spec.Attestation(
                aggregation_bits=[True] * len(committee),
                data=data,
                signature=_aggregate_sign(
                    [_sk_for(m) for m in committee], root),
            ))
    return atts


def build_epoch_blocks(spec, state, with_sync: bool = False,
                       seed: int = 0, address_changes=None) -> list:
    """Construct and sign one epoch of full blocks from ``state`` (which is
    left untouched).  ``with_sync`` adds a fully participating sync
    aggregate to every block (altair+); on a state past the merge every
    block carries an execution payload whose random bytes come from
    ``seed``; ``address_changes`` maps a block's index in the epoch to the
    signed BLS-to-execution changes it carries (capella).  Verification is
    off while constructing; the caller's ``bls.bls_active`` is restored
    afterwards."""
    was_active = bls.bls_active
    bls.bls_active = False
    try:
        return _build_epoch_blocks(spec, state, with_sync, seed,
                                   address_changes or {})
    finally:
        bls.bls_active = was_active


def _build_epoch_blocks(spec, state, with_sync: bool, seed: int,
                        address_changes: dict):
    build_st = state.copy()
    rng = np.random.default_rng(seed)
    sync_sks = _sync_secret_keys(state) if with_sync else None
    return [_next_signed_block(spec, build_st, rng, sync_sks,
                               address_changes.get(i, ()))
            for i in range(int(spec.SLOTS_PER_EPOCH))]


def _sync_secret_keys(state) -> list:
    return [pubkey_to_privkey[bytes(pk)]
            for pk in state.current_sync_committee.pubkeys]


def _next_signed_block(spec, build_st, rng, sync_sks, changes=(), blobs=()):
    """The signed block of the slot after ``build_st``'s, which it applies
    to ``build_st``: the aggregates of the two preceding slots, an
    execution payload past the merge (with a blob transaction a blob of
    ``blobs`` and their commitments in the body, eip4844), ``changes``
    (capella) and, given the committee's secret keys, a full sync
    aggregate."""
    slot = int(build_st.slot) + 1
    stub = build_st.copy()
    spec.process_slots(stub, slot)
    proposer = spec.get_beacon_proposer_index(stub)

    block = spec.BeaconBlock(slot=slot, proposer_index=proposer)
    header = build_st.latest_block_header.copy()
    if header.state_root == spec.Root():
        header.state_root = build_st.hash_tree_root()
    block.parent_root = header.hash_tree_root()
    epoch = spec.compute_epoch_at_slot(slot)
    block.body.randao_reveal = native.Sign(
        _sk_for(proposer), spec.compute_signing_root(
            epoch, spec.get_domain(build_st, spec.DOMAIN_RANDAO, epoch)))
    for att in attestations_for(spec, stub, slot):
        block.body.attestations.append(att)
    if (hasattr(build_st, "latest_execution_payload_header")
            and spec.is_merge_transition_complete(build_st)):
        block.body.execution_payload = execution_payload(spec, stub, rng)
    if blobs:
        payload = block.body.execution_payload
        for blob in blobs:
            commitment = spec.blob_to_kzg(spec.Blob(blob))
            block.body.blob_kzgs.append(commitment)
            payload.transactions.append(blob_transaction(
                spec, [spec.kzg_to_versioned_hash(commitment)]))
        payload.block_hash = spec.hash(
            payload.hash_tree_root() + b"scenario: execution block hash")
    for change in changes:
        block.body.bls_to_execution_changes.append(change)
    if sync_sks is not None:
        # process_sync_aggregate verifies over the previous slot's
        # block root (altair/beacon-chain.md:536-543) = parent_root
        domain = spec.get_domain(
            build_st, spec.DOMAIN_SYNC_COMMITTEE,
            spec.compute_epoch_at_slot(slot - 1))
        root = spec.compute_signing_root(spec.Root(block.parent_root), domain)
        block.body.sync_aggregate = spec.SyncAggregate(
            sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
            sync_committee_signature=_aggregate_sign(sync_sks, root),
        )

    spec.process_slots(build_st, slot)
    spec.process_block(build_st, block)
    block.state_root = build_st.hash_tree_root()
    return spec.SignedBeaconBlock(
        message=block,
        signature=native.Sign(
            _sk_for(proposer), spec.compute_signing_root(
                block, spec.get_domain(
                    build_st, spec.DOMAIN_BEACON_PROPOSER))))


def blob_transaction(spec, versioned_hashes) -> bytes:
    """An opaque blob transaction as eip4844's
    ``tx_peek_blob_versioned_hashes`` reads one: the type byte, the
    message's offset, then a message whose bytes 156:160 give the
    position in the transaction of the versioned hashes that follow (the
    shape the reference's experimental-fork tests build)."""
    message_offset = 5
    message = (bytes(156) + (message_offset + 160).to_bytes(4, "little")
               + b"".join(bytes(h) for h in versioned_hashes))
    return (bytes([int(spec.BLOB_TX_TYPE)])
            + (message_offset - 1).to_bytes(4, "little") + message)


def seeded_blobs(spec, count: int, seed: int) -> list:
    """``count`` blobs of ``FIELD_ELEMENTS_PER_BLOB`` field elements from
    ``seed``: 256 random bits an element, reduced mod the modulus."""
    words = np.random.default_rng(seed).integers(
        0, 2**64, size=(count, int(spec.FIELD_ELEMENTS_PER_BLOB), 4),
        dtype=np.uint64)
    modulus = int(spec.BLS_MODULUS)
    return [[int.from_bytes(row.tobytes(), "little") % modulus for row in blob]
            for blob in words]


def blob_block(spec, state, blobs, seed: int = 0):
    """One signed eip4844 block on ``state`` (left untouched), a state past
    the merge with real sync committees (``build_main_path_state``, then
    ``upgrade_to_eip4844``): the next slot's full block whose payload
    carries a blob transaction a blob and whose body the blobs'
    commitments, ``spec.blob_to_kzg`` of each.  Verification is off while
    constructing; the caller's ``bls.bls_active`` is restored."""
    was_active = bls.bls_active
    bls.bls_active = False
    try:
        return _next_signed_block(spec, state.copy(), np.random.default_rng(seed),
                                  _sync_secret_keys(state), blobs=blobs)
    finally:
        bls.bls_active = was_active


def capella_withdrawal_epoch(spec, n: int, seed: int = 0):
    """(pre-state, signed blocks): one capella epoch from
    ``build_main_path_state`` in which validator 1 holds eth1 credentials
    and becomes withdrawable in the state's epoch, so the epoch transition
    queues its full withdrawal and the boundary block's payload dequeues
    it, and the epoch's third block rotates validator 2's BLS credentials
    (those of test key ``NUM_KEYS - 1``) to an execution address."""
    state = build_main_path_state(spec, n)
    withdrawn = state.validators[1]
    withdrawn.withdrawal_credentials = (
        bytes(spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX) + b"\x00" * 11 + b"\x51" * 20)
    withdrawn.withdrawable_epoch = spec.get_current_epoch(state)
    key = NUM_KEYS - 1
    state.validators[2].withdrawal_credentials = (
        bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(pubkeys[key])[1:])
    change = spec.BLSToExecutionChange(
        validator_index=2, from_bls_pubkey=pubkeys[key],
        to_execution_address=b"\x52" * 20)
    domain = spec.get_domain(state, spec.DOMAIN_BLS_TO_EXECUTION_CHANGE)
    signed = spec.SignedBLSToExecutionChange(
        message=change,
        signature=native.Sign(privkeys[key], spec.compute_signing_root(change, domain)))
    blocks = build_epoch_blocks(spec, state, with_sync=True, seed=seed,
                                address_changes={2: [signed]})
    return state, blocks


def example_delta_inputs(n: int):
    """Seeded ``DeltaInputs`` for ``n`` validators and their balances: the
    port's copy of ``_example_inputs`` in the reference's
    ``__graft_entry__.py``, the same draws from the same seed (42), so
    both packages see the same registry."""
    from consensus_specs_tpu_torch.ops.epoch import DeltaInputs

    rng = np.random.default_rng(42)
    eff = (rng.integers(16, 33, n) * 10**9).astype(np.int64)
    eligible = rng.random(n) < 0.95
    src = (rng.random(n) < 0.8) & eligible
    tgt = src & (rng.random(n) < 0.9)
    head = tgt & (rng.random(n) < 0.9)
    total = int(np.sum(np.where(eligible, eff, 0), dtype=np.uint64))
    inp = DeltaInputs(
        effective_balance=eff,
        eligible=eligible,
        source_part=src,
        target_part=tgt,
        head_part=head,
        incl_delay=np.where(src, rng.integers(1, 9, n), 1).astype(np.int64),
        incl_proposer=rng.integers(0, n, n).astype(np.int64),
        total_balance=total,
        sqrt_total=int(np.sqrt(total)),
        finality_delay=2,
        base_reward_factor=64,
        base_rewards_per_epoch=4,
        proposer_reward_quotient=8,
        inactivity_penalty_quotient=2**26,
        min_epochs_to_inactivity_penalty=4,
        effective_balance_increment=10**9,
    )
    balances = (rng.integers(16, 33, n) * 10**9).astype(np.int64)
    return inp, balances
