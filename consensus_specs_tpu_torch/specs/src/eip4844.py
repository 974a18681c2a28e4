# EIP-4844 executable spec (transcribes specs/eip4844/beacon-chain.md,
# fork.md, validator.md of the reference snapshot; builds on bellatrix).
#
# The KZG crypto seam: commitments route through the host oracle
# (crypto/kzg.py), as in the reference; the batched device MSM
# (ops/kzg.py) computes the same commitments and is held against it.

# Custom types (eip4844/beacon-chain.md:42-48)
BLSFieldElement = uint256
VersionedHash = Bytes32
KZGCommitment = Bytes48

# Constants (eip4844/beacon-chain.md:50-56)
BLOB_TX_TYPE = uint8(0x05)
BLS_MODULUS = 52435875175126190479447740508185965837690552500527637822603658699938581184513
# version byte prefixing KZG versioned hashes
BLOB_COMMITMENT_VERSION_KZG = b"\x01"

DOMAIN_BLOBS_SIDECAR = Bytes4(bytes.fromhex("0a000000"))

Blob = Vector[BLSFieldElement, FIELD_ELEMENTS_PER_BLOB]


# Trusted setup (eip4844/beacon-chain.md:66-73): the insecure testing
# variant, generated deterministically at first use.
def _kzg_setup_lagrange():
    from consensus_specs_tpu_torch.crypto import kzg as _kzg

    return _kzg.setup_lagrange(int(FIELD_ELEMENTS_PER_BLOB))


class BeaconBlockBody(Container):
    randao_reveal: BLSSignature
    eth1_data: Eth1Data
    graffiti: Bytes32
    proposer_slashings: List[ProposerSlashing, MAX_PROPOSER_SLASHINGS]
    attester_slashings: List[AttesterSlashing, MAX_ATTESTER_SLASHINGS]
    attestations: List[Attestation, MAX_ATTESTATIONS]
    deposits: List[Deposit, MAX_DEPOSITS]
    voluntary_exits: List[SignedVoluntaryExit, MAX_VOLUNTARY_EXITS]
    sync_aggregate: SyncAggregate
    execution_payload: ExecutionPayload
    blob_kzgs: List[KZGCommitment, MAX_BLOBS_PER_BLOCK]  # [New in EIP-4844]


class BeaconBlock(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body: BeaconBlockBody


class SignedBeaconBlock(Container):
    message: BeaconBlock
    signature: BLSSignature


class BlobsSidecar(Container):
    beacon_block_root: Root
    beacon_block_slot: Slot
    blobs: List[Blob, MAX_BLOBS_PER_BLOCK]


class SignedBlobsSidecar(Container):
    message: BlobsSidecar
    signature: BLSSignature


# KZG core (eip4844/beacon-chain.md:112-128)
def blob_to_kzg(blob: Blob) -> KZGCommitment:
    from consensus_specs_tpu_torch.crypto import kzg as _kzg

    for value in blob:
        assert value < BLS_MODULUS
    return KZGCommitment(
        _kzg.blob_to_kzg([int(v) for v in blob], _kzg_setup_lagrange())
    )


def kzg_to_versioned_hash(kzg: KZGCommitment) -> VersionedHash:
    return VersionedHash(BLOB_COMMITMENT_VERSION_KZG + hash(kzg)[1:])


# Misc (eip4844/beacon-chain.md:132-160)
def tx_peek_blob_versioned_hashes(opaque_tx: Transaction) -> Sequence[VersionedHash]:
    assert opaque_tx[0] == BLOB_TX_TYPE
    message_offset = 1 + uint32.decode_bytes(bytes(opaque_tx[1:5]))
    # field offset: 32 + 8 + 32 + 32 + 8 + 4 + 32 + 4 + 4 = 156
    blob_versioned_hashes_offset = uint32.decode_bytes(
        bytes(opaque_tx[message_offset + 156:message_offset + 160])
    )
    return [
        VersionedHash(bytes(opaque_tx[x:x + 32]))
        for x in range(blob_versioned_hashes_offset, len(opaque_tx), 32)
    ]


def verify_kzgs_against_transactions(transactions: Sequence[Transaction],
                                     blob_kzgs: Sequence[KZGCommitment]) -> bool:
    all_versioned_hashes = []
    for tx in transactions:
        if tx[0] == BLOB_TX_TYPE:
            all_versioned_hashes.extend(tx_peek_blob_versioned_hashes(tx))
    return all_versioned_hashes == [kzg_to_versioned_hash(kzg) for kzg in blob_kzgs]


# Block processing (eip4844/beacon-chain.md:164-186)
def process_block(state: BeaconState, block: BeaconBlock) -> None:
    process_block_header(state, block)
    if is_execution_enabled(state, block.body):
        process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)
    process_randao(state, block.body)
    process_eth1_data(state, block.body)
    process_operations(state, block.body)
    process_sync_aggregate(state, block.body.sync_aggregate)
    process_blob_kzgs(state, block.body)  # [New in EIP-4844]


def process_blob_kzgs(state: BeaconState, body: BeaconBlockBody) -> None:
    assert verify_kzgs_against_transactions(
        body.execution_payload.transactions, body.blob_kzgs
    )


# Availability gate (eip4844/validator.md:49-55).  ``retrieve_blobs_sidecar``
# is implementation-dependent in the reference ("raises an exception if not
# available"); here it is a pluggable seam like get_pow_block/EXECUTION_ENGINE
# so tests and a real client can install a blob store.  Without the sidecar a
# block may be processed optimistically but MUST NOT be considered valid.


class BlobsSidecarUnavailable(Exception):
    """Raised when no sidecar is retrievable for (slot, block root)."""


def retrieve_blobs_sidecar(slot: Slot, beacon_block_root: Root) -> BlobsSidecar:
    raise BlobsSidecarUnavailable(
        f"no blobs sidecar for slot={int(slot)} root={bytes(beacon_block_root).hex()}")


def is_data_available(slot: Slot, beacon_block_root: Root,
                      kzgs: Sequence[KZGCommitment]) -> None:
    sidecar = retrieve_blobs_sidecar(slot, beacon_block_root)  # implementation dependent, raises an exception if not available
    verify_blobs_sidecar(slot, beacon_block_root, kzgs, sidecar)


# Sidecar validation (eip4844/validator.md)
def verify_blobs_sidecar(slot: Slot, beacon_block_root: Root,
                         expected_kzgs: Sequence[KZGCommitment],
                         blobs_sidecar: BlobsSidecar) -> None:
    assert slot == blobs_sidecar.beacon_block_slot
    assert beacon_block_root == blobs_sidecar.beacon_block_root
    blobs = blobs_sidecar.blobs
    assert len(expected_kzgs) == len(blobs)
    for kzg, blob in zip(expected_kzgs, blobs):
        assert blob_to_kzg(blob) == kzg


# Fork (eip4844/fork.md): the state format equals bellatrix's; only the
# fork version advances.
def upgrade_to_eip4844(pre: bellatrix.BeaconState) -> BeaconState:
    epoch = bellatrix.get_current_epoch(pre)
    post = BeaconState.view_from_backing(pre.get_backing())
    post.fork = Fork(
        previous_version=pre.fork.current_version,
        current_version=config.EIP4844_FORK_VERSION,
        epoch=epoch,
    )
    return post
