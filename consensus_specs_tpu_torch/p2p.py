"""Networking (p2p-interface) layer: constants, wire containers, and
gossip message-id functions.

Reference: specs/phase0/p2p-interface.md (config table at :170-184,
containers at :650-700, 800-880, message-id at :255-264, ENRForkID at
:940-970) and specs/altair/p2p-interface.md (:48-91 — syncnets MetaData
and the topic-aware message-id).  The reference does NOT compile this
document into its executable pyspec; here it is a standalone module so
the wire-format containers and message-id rules are still testable.

The req/resp payloads are plain SSZ containers from the repo's own type
system; snappy framing uses the from-scratch codec in gen/snappy.py.
(No `from __future__ import annotations` here: the Container metaclass
resolves field annotations eagerly.)
"""
import hashlib

from consensus_specs_tpu_torch.gen.snappy import decompress as snappy_decompress
from consensus_specs_tpu_torch.ssz.types import (
    Bitvector,
    Bytes4,
    Bytes32,
    Container,
    List,
    uint64,
)

# -- configuration (phase0 p2p-interface.md:170-184) ------------------------

GOSSIP_MAX_SIZE = 2**20
MAX_REQUEST_BLOCKS = 2**10
MAX_CHUNK_SIZE = 2**20
TTFB_TIMEOUT = 5  # seconds
RESP_TIMEOUT = 10  # seconds
ATTESTATION_PROPAGATION_SLOT_RANGE = 32
MAXIMUM_GOSSIP_CLOCK_DISPARITY_MS = 500
MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"
MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
ATTESTATION_SUBNET_COUNT = 64
SYNC_COMMITTEE_SUBNET_COUNT = 4


def min_epochs_for_block_requests(config) -> int:
    """MIN_VALIDATOR_WITHDRAWABILITY_DELAY + CHURN_LIMIT_QUOTIENT // 2
    (phase0 p2p-interface.md:174; rationale at :1437-1443); 33024 on
    mainnet (~5 months)."""
    return (
        config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
        + config.CHURN_LIMIT_QUOTIENT // 2
    )

# -- req/resp wire containers (phase0 p2p-interface.md) ---------------------


class Status(Container):
    fork_digest: Bytes4
    finalized_root: Bytes32
    finalized_epoch: uint64
    head_root: Bytes32
    head_slot: uint64


class Goodbye(Container):
    reason: uint64


class Ping(Container):
    seq_number: uint64


class MetaData(Container):
    """Phase0 MetaData (p2p-interface.md:186-199)."""
    seq_number: uint64
    attnets: Bitvector[ATTESTATION_SUBNET_COUNT]


class MetaDataAltair(Container):
    """Altair MetaData V2 with sync-subnet bits (altair/p2p-interface.md:50-63)."""
    seq_number: uint64
    attnets: Bitvector[ATTESTATION_SUBNET_COUNT]
    syncnets: Bitvector[SYNC_COMMITTEE_SUBNET_COUNT]


class BeaconBlocksByRangeRequest(Container):
    start_slot: uint64
    count: uint64
    step: uint64


BeaconBlocksByRootRequest = List[Bytes32, MAX_REQUEST_BLOCKS]


class ENRForkID(Container):
    """`eth2` ENR entry value (phase0 p2p-interface.md:940-952)."""
    fork_digest: Bytes4
    next_fork_version: Bytes4
    next_fork_epoch: uint64


# -- gossip message-id (phase0 p2p-interface.md:255-264) --------------------


def compute_message_id(message_data: bytes) -> bytes:
    """Phase0 gossip message-id: 20-byte SHA-256 prefix over the snappy
    domain + (decompressed) payload."""
    try:
        payload = MESSAGE_DOMAIN_VALID_SNAPPY + snappy_decompress(message_data)
    except ValueError:
        payload = MESSAGE_DOMAIN_INVALID_SNAPPY + message_data
    return hashlib.sha256(payload).digest()[:20]


def compute_message_id_altair(message_topic, message_data: bytes) -> bytes:
    """Altair gossip message-id: additionally binds the topic byte string
    (altair/p2p-interface.md:77-86).  The topic may be given as `str`
    (as produced by `gossip_topic`) or raw UTF-8 bytes."""
    if isinstance(message_topic, str):
        message_topic = message_topic.encode("utf-8")
    topic_part = len(message_topic).to_bytes(8, "little") + message_topic
    try:
        body = snappy_decompress(message_data)
        payload = MESSAGE_DOMAIN_VALID_SNAPPY + topic_part + body
    except ValueError:
        payload = MESSAGE_DOMAIN_INVALID_SNAPPY + topic_part + message_data
    return hashlib.sha256(payload).digest()[:20]


# -- gossip topic names (phase0 p2p-interface.md:268-300) -------------------


def gossip_topic(fork_digest: bytes, name: str, encoding: str = "ssz_snappy") -> str:
    return f"/eth2/{fork_digest.hex()}/{name}/{encoding}"


def attestation_subnet_topic(fork_digest: bytes, subnet_id: int) -> str:
    return gossip_topic(fork_digest, f"beacon_attestation_{subnet_id}")


def sync_committee_subnet_topic(fork_digest: bytes, subnet_id: int) -> str:
    return gossip_topic(fork_digest, f"sync_committee_{subnet_id}")


# -- eip4844 blob-sidecar wire layer (eip4844/p2p-interface.md) -------------
#
# Gossip: one global `blobs_sidecar` topic carrying SignedBlobsSidecar.
# Req/Resp: BlobsSidecarsByRange v1 returns up to MAX_REQUEST_BLOBS_SIDECARS
# sidecars for [start_slot, start_slot + count); servers must cover the
# trailing MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS epochs.

MAX_REQUEST_BLOBS_SIDECARS = 2**7
MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS = 2**13

BLOBS_SIDECARS_BY_RANGE_PROTOCOL_ID = \
    "/eth2/beacon_chain/req/blobs_sidecars_by_range/1/"


class BlobsSidecarsByRangeRequest(Container):
    start_slot: uint64
    count: uint64


def blobs_sidecar_topic(fork_digest: bytes) -> str:
    """Gossip topic carrying ``SignedBlobsSidecar`` (eip4844+)."""
    return gossip_topic(fork_digest, "blobs_sidecar")


def blobs_sidecar_request_bounds(current_epoch: int, genesis_epoch: int = 0):
    """The epoch range a compliant server must answer sidecar requests for."""
    low = max(genesis_epoch,
              current_epoch - MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS)
    return low, current_epoch


# -- sharding shard-blob gossip layer (sharding/p2p-interface.md) -----------
#
# The reference never compiles this document (prose-only WIP); here the
# constants, topic names, subnet mapping, and the statically-checkable
# subset of the gossip validation rules are executable against the
# compiled sharding spec module.

SHARD_BLOB_SUBNET_COUNT = 64       # sharding/p2p-interface.md:38
SHARD_TX_PROPAGATION_GRACE_SLOTS = 4    # :39
SHARD_TX_PROPAGATION_BUFFER_SLOTS = 8   # :40


def shard_blob_subnet_topic(fork_digest: bytes, subnet_id: int) -> str:
    """`shard_blob_{subnet_id}` — SignedShardBlob (sharding/p2p:51)."""
    return gossip_topic(fork_digest, f"shard_blob_{subnet_id}")


def shard_blob_header_topic(fork_digest: bytes) -> str:
    """Global `shard_blob_header` — SignedShardBlobHeader (:52)."""
    return gossip_topic(fork_digest, "shard_blob_header")


def shard_blob_tx_topic(fork_digest: bytes) -> str:
    """Global `shard_blob_tx` — builder-signed SignedShardBlobHeader (:53)."""
    return gossip_topic(fork_digest, "shard_blob_tx")


def shard_proposer_slashing_topic(fork_digest: bytes) -> str:
    """Global `shard_proposer_slashing` — ShardProposerSlashing (:54)."""
    return gossip_topic(fork_digest, "shard_proposer_slashing")


def compute_subnet_for_shard_blob(spec, state, slot, shard) -> int:
    """Subnet for a shard-blob publication (sharding/p2p-interface.md:67-77
    — mimics compute_subnet_for_attestation)."""
    committee_index = int(spec.compute_committee_index_from_shard(
        state, slot, shard))
    committees_per_slot = int(spec.get_committee_count_per_slot(
        state, spec.compute_epoch_at_slot(slot)))
    slots_since_epoch_start = int(slot) % int(spec.SLOTS_PER_EPOCH)
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (committees_since_epoch_start + committee_index) \
        % SHARD_BLOB_SUBNET_COUNT


def validate_shard_blob_gossip(spec, state, signed_blob, current_slot: int,
                               subnet_id: int) -> str:
    """The statically-checkable subset of the `shard_blob_{subnet_id}`
    validation rules (sharding/p2p-interface.md:80-104).  Returns
    'accept', 'ignore', or 'reject'.  Signature/fee/first-seen rules need
    node-local context (peer store, dedup cache) and stay with the caller."""
    blob = signed_blob.message
    if int(blob.slot) > current_slot + 1:
        return "ignore"  # published >1 slot early
    if int(spec.compute_epoch_at_slot(blob.slot)) < \
            int(spec.get_previous_epoch(state)):
        return "ignore"  # too old to process
    epoch = spec.compute_epoch_at_slot(blob.slot)
    if int(blob.shard) >= int(spec.get_active_shard_count(state, epoch)):
        return "reject"  # inactive shard
    try:
        spec.compute_committee_index_from_shard(state, blob.slot, blob.shard)
    except AssertionError:
        return "reject"  # no committee for this shard at this slot
    if compute_subnet_for_shard_blob(
            spec, state, blob.slot, blob.shard) != subnet_id:
        return "reject"  # wrong subnet
    if any(int(p) >= spec.MODULUS for p in blob.body.data):
        return "reject"  # non-canonical field point
    return "accept"


def validate_shard_blob_tx_window(current_slot: int, header_slot: int) -> str:
    """The `shard_blob_tx` propagation window (sharding/p2p:148-151)."""
    if header_slot > current_slot + SHARD_TX_PROPAGATION_BUFFER_SLOTS:
        return "ignore"  # too early
    if header_slot + SHARD_TX_PROPAGATION_GRACE_SLOTS < current_slot:
        return "ignore"  # too late
    return "accept"


# -- DAS sample transport (das/p2p-interface.md) ----------------------------
#
# Push: vertical `das_sample_{subnet_index}` gossip subnets; horizontal
# reuse of the shard-blob subnets for fan-out reconstruction.  Pull:
# DASQuery under the dedicated `/eth2/das/req` protocol prefix.

DAS_SUBNET_COUNT = 256  # vertical subnets; the reference doc sizes this
#                         only as "many tiny samples" — fixed here so the
#                         mapping below is executable

DAS_QUERY_PROTOCOL_ID = "/eth2/das/req/query/1/"  # das/p2p-interface.md:203


class DASQueryRequest(Container):
    """DASQuery request content (das/p2p-interface.md:205-210)."""
    sample_index: uint64


def das_sample_subnet_topic(fork_digest: bytes, subnet_index: int) -> str:
    """`das_sample_{subnet_index}` — DASSample (das/p2p:147-149)."""
    return gossip_topic(fork_digest, f"das_sample_{subnet_index}")


def compute_subnet_for_das_sample(shard: int, slot: int, sample_index: int,
                                  subnet_count: int = DAS_SUBNET_COUNT) -> int:
    """(shard, slot, sample_index) -> vertical subnet index.

    The reference leaves this hash function an explicit TODO
    (das/p2p-interface.md:111-114: "a simple hash function ... defines
    which samples go where ... to evenly distribute samples").  This
    framework's concrete choice: SHA-256 over the little-endian key
    triple, reduced mod the subnet count — uniform, stateless, and
    trivially portable."""
    key = (int(shard).to_bytes(8, "little")
           + int(slot).to_bytes(8, "little")
           + int(sample_index).to_bytes(8, "little"))
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") \
        % subnet_count


def validate_das_sample_gossip(spec, state, sample, sample_count: int,
                               commitment, current_slot: int,
                               subnet_index: int) -> str:
    """The statically-checkable subset of the `das_sample_{subnet_index}`
    validation rules (das/p2p-interface.md:172-185).  Returns 'accept',
    'ignore', or 'reject'; first-seen/commitment-known bookkeeping stays
    with the caller."""
    if compute_subnet_for_das_sample(
            int(sample.shard), int(sample.slot),
            int(sample.index)) != subnet_index:
        return "reject"  # wrong vertical subnet
    epoch = spec.compute_epoch_at_slot(sample.slot)
    if int(sample.shard) >= int(spec.get_active_shard_count(state, epoch)):
        return "reject"  # shard out of range
    if int(sample.index) >= sample_count:
        return "reject"  # sample index out of range
    if int(sample.slot) > current_slot:
        return "ignore"  # future slot (MAY queue)
    if any(int(p) >= spec.MODULUS for p in sample.data):
        return "reject"  # non-canonical field point
    try:
        spec.verify_sample(sample, sample_count, commitment)
    except AssertionError:
        return "reject"  # KZG proof invalid
    return "accept"
