"""The port's networking layer (``p2p.py``) against the JAX package's.

* twins of the reference's own cases (``tests/test_p2p.py``) run on the
  port: message ids for valid and invalid snappy payloads, the wire
  containers, ENRForkID, the subnet counts, the topics, the eip4844
  sidecar layer, the sharding shard-blob checks and the DAS samples, on
  CPU-built minimal specs;
* the same seeded payloads, topics and containers through both packages
  give the same message ids, topic strings, encodings and verdicts.
"""
import hashlib
import random

import pytest

from consensus_specs_tpu import p2p as ref_p2p
from consensus_specs_tpu.gen.snappy import compress as ref_compress
from consensus_specs_tpu_torch import p2p
from consensus_specs_tpu_torch.config.configs import get_config
from consensus_specs_tpu_torch.gen.snappy import compress


def test_min_epochs_for_block_requests_mainnet():
    assert p2p.min_epochs_for_block_requests(get_config("mainnet")) == 33024


def test_message_id_valid_snappy():
    body = b"hello gossip" * 10
    mid = p2p.compute_message_id(compress(body))
    assert mid == hashlib.sha256(b"\x01\x00\x00\x00" + body).digest()[:20]
    assert len(mid) == 20


def test_message_id_invalid_snappy():
    junk = b"\xff\xff\xff not snappy"
    mid = p2p.compute_message_id(junk)
    assert mid == hashlib.sha256(b"\x00\x00\x00\x00" + junk).digest()[:20]


def test_message_id_altair_binds_topic():
    body = b"altair payload"
    topic = b"/eth2/aabbccdd/beacon_block/ssz_snappy"
    data = compress(body)
    expected = hashlib.sha256(
        b"\x01\x00\x00\x00" + len(topic).to_bytes(8, "little") + topic + body
    ).digest()[:20]
    assert p2p.compute_message_id_altair(topic, data) == expected
    # different topic -> different id (phase0 variant would collide)
    assert p2p.compute_message_id_altair(b"other", data) != expected
    # invalid snappy falls back to the raw-data domain
    junk = b"\x00\xff junk"
    expected_invalid = hashlib.sha256(
        b"\x00\x00\x00\x00" + len(topic).to_bytes(8, "little") + topic + junk
    ).digest()[:20]
    assert p2p.compute_message_id_altair(topic, junk) == expected_invalid


def test_status_roundtrip():
    s = p2p.Status(
        fork_digest=b"\x01\x02\x03\x04",
        finalized_root=b"\xaa" * 32,
        finalized_epoch=7,
        head_root=b"\xbb" * 32,
        head_slot=262,
    )
    data = s.encode_bytes()
    assert len(data) == 4 + 32 + 8 + 32 + 8  # fixed-size container
    back = p2p.Status.decode_bytes(data)
    assert back == s and back.head_slot == 262


def test_metadata_shapes():
    md = p2p.MetaData(seq_number=3)
    md.attnets[5] = True
    back = p2p.MetaData.decode_bytes(md.encode_bytes())
    assert back.seq_number == 3 and bool(back.attnets[5]) and not bool(back.attnets[4])

    md2 = p2p.MetaDataAltair(seq_number=4)
    md2.syncnets[2] = True
    back2 = p2p.MetaDataAltair.decode_bytes(md2.encode_bytes())
    assert bool(back2.syncnets[2]) and len(back2.syncnets) == 4


def test_blocks_by_range_and_root_requests():
    req = p2p.BeaconBlocksByRangeRequest(start_slot=100, count=64, step=1)
    assert p2p.BeaconBlocksByRangeRequest.decode_bytes(req.encode_bytes()).count == 64

    roots = p2p.BeaconBlocksByRootRequest([b"\x11" * 32, b"\x22" * 32])
    back = p2p.BeaconBlocksByRootRequest.decode_bytes(roots.encode_bytes())
    assert len(back) == 2 and bytes(back[1]) == b"\x22" * 32


def test_enr_fork_id_matches_spec_fork_digest():
    from consensus_specs_tpu_torch.specs import get_spec

    spec = get_spec("phase0", "minimal", device="cpu")
    digest = spec.compute_fork_digest(
        spec.config.GENESIS_FORK_VERSION, b"\x00" * 32
    )
    enr = p2p.ENRForkID(
        fork_digest=bytes(digest),
        next_fork_version=bytes(spec.config.GENESIS_FORK_VERSION),
        next_fork_epoch=2**64 - 1,
    )
    back = p2p.ENRForkID.decode_bytes(enr.encode_bytes())
    assert bytes(back.fork_digest) == bytes(digest)


def test_subnet_counts_match_compiled_spec():
    """Guard against drift between p2p's bitvector widths and the spec
    modules' subnet constants."""
    from consensus_specs_tpu_torch.specs import get_spec

    spec = get_spec("altair", "minimal", device="cpu")
    assert p2p.ATTESTATION_SUBNET_COUNT == spec.ATTESTATION_SUBNET_COUNT
    assert p2p.SYNC_COMMITTEE_SUBNET_COUNT == spec.SYNC_COMMITTEE_SUBNET_COUNT


def test_message_id_altair_accepts_str_topic():
    fd = b"\x01\x02\x03\x04"
    topic = p2p.gossip_topic(fd, "beacon_block")
    data = b"\xff not snappy"
    assert p2p.compute_message_id_altair(topic, data) == p2p.compute_message_id_altair(
        topic.encode("utf-8"), data
    )


def test_gossip_topic_names():
    fd = b"\x01\x02\x03\x04"
    assert p2p.gossip_topic(fd, "beacon_block") == "/eth2/01020304/beacon_block/ssz_snappy"
    assert p2p.attestation_subnet_topic(fd, 9).endswith("/beacon_attestation_9/ssz_snappy")
    assert p2p.sync_committee_subnet_topic(fd, 3).endswith("/sync_committee_3/ssz_snappy")


def test_blobs_sidecar_wire_layer():
    """eip4844 p2p additions: gossip topic, by-range request container and
    server range bounds (eip4844/p2p-interface.md)."""
    digest = b"\x0a\x0b\x0c\x0d"
    assert p2p.blobs_sidecar_topic(digest) == \
        "/eth2/0a0b0c0d/blobs_sidecar/ssz_snappy"
    assert p2p.BLOBS_SIDECARS_BY_RANGE_PROTOCOL_ID == \
        "/eth2/beacon_chain/req/blobs_sidecars_by_range/1/"

    req = p2p.BlobsSidecarsByRangeRequest(start_slot=11, count=4)
    from consensus_specs_tpu_torch.ssz.impl import serialize
    assert type(req).decode_bytes(serialize(req)) == req
    assert p2p.MAX_REQUEST_BLOBS_SIDECARS == 128

    low, high = p2p.blobs_sidecar_request_bounds(10000)
    assert (low, high) == (10000 - 8192, 10000)
    assert p2p.blobs_sidecar_request_bounds(100) == (0, 100)


def test_signed_blobs_sidecar_container_round_trip():
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.ssz.impl import serialize

    spec = get_spec("eip4844", "minimal", device="cpu")
    sidecar = spec.BlobsSidecar(beacon_block_root=b"\x31" * 32,
                                beacon_block_slot=3)
    signed = spec.SignedBlobsSidecar(message=sidecar, signature=b"\x09" * 96)
    assert type(signed).decode_bytes(serialize(signed)) == signed


# -- sharding shard-blob gossip layer (sharding/p2p-interface.md) -----------


def _sharding_state():
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.testing.context import (
        default_activation_threshold,
        default_balances,
    )
    from consensus_specs_tpu_torch.testing.helpers.genesis import create_genesis_state

    spec = get_spec("sharding", "minimal", device="cpu")
    state = create_genesis_state(
        spec, default_balances(spec), default_activation_threshold(spec))
    return spec, state


def test_shard_blob_topics_and_subnet_mapping():
    digest = b"\x01\x02\x03\x04"
    assert p2p.shard_blob_subnet_topic(digest, 9) == \
        "/eth2/01020304/shard_blob_9/ssz_snappy"
    assert p2p.shard_blob_header_topic(digest).endswith(
        "/shard_blob_header/ssz_snappy")
    assert p2p.shard_blob_tx_topic(digest).endswith(
        "/shard_blob_tx/ssz_snappy")
    assert p2p.shard_proposer_slashing_topic(digest).endswith(
        "/shard_proposer_slashing/ssz_snappy")

    spec, state = _sharding_state()
    slot = spec.Slot(3)
    count = int(spec.get_committee_count_per_slot(
        state, spec.compute_epoch_at_slot(slot)))
    seen = set()
    for index in range(count):
        shard = spec.compute_shard_from_committee_index(
            state, slot, spec.CommitteeIndex(index))
        sub = p2p.compute_subnet_for_shard_blob(spec, state, slot, shard)
        assert 0 <= sub < p2p.SHARD_BLOB_SUBNET_COUNT
        seen.add(sub)
    assert len(seen) == count  # distinct committees -> distinct subnets here


def test_shard_blob_gossip_validation_matrix():
    spec, state = _sharding_state()
    slot = spec.Slot(3)
    shard = spec.compute_shard_from_committee_index(
        state, slot, spec.CommitteeIndex(0))
    subnet = p2p.compute_subnet_for_shard_blob(spec, state, slot, shard)

    def blob(slot=slot, shard=shard, data=(1, 2, 3)):
        return spec.SignedShardBlob(message=spec.ShardBlob(
            slot=slot, shard=shard,
            body=spec.ShardBlobBody(data=list(data))))

    current = int(slot)
    assert p2p.validate_shard_blob_gossip(
        spec, state, blob(), current, subnet) == "accept"
    # >1 slot early -> ignore
    assert p2p.validate_shard_blob_gossip(
        spec, state, blob(slot=spec.Slot(current + 2)), current, subnet) \
        == "ignore"
    # inactive shard -> reject
    bad_shard = int(spec.get_active_shard_count(
        state, spec.compute_epoch_at_slot(slot)))
    assert p2p.validate_shard_blob_gossip(
        spec, state, blob(shard=spec.Shard(bad_shard)), current, subnet) \
        == "reject"
    # wrong subnet -> reject
    assert p2p.validate_shard_blob_gossip(
        spec, state, blob(), current,
        (subnet + 1) % p2p.SHARD_BLOB_SUBNET_COUNT) == "reject"
    # non-canonical field point -> reject
    assert p2p.validate_shard_blob_gossip(
        spec, state, blob(data=(spec.MODULUS,)), current, subnet) == "reject"

    # tx propagation window (buffer 8 ahead, grace 4 behind)
    assert p2p.validate_shard_blob_tx_window(100, 108) == "accept"
    assert p2p.validate_shard_blob_tx_window(100, 109) == "ignore"
    assert p2p.validate_shard_blob_tx_window(100, 96) == "accept"
    assert p2p.validate_shard_blob_tx_window(100, 95) == "ignore"


# -- DAS sample transport (das/p2p-interface.md) ----------------------------


def test_das_sample_subnet_mapping_uniform_and_deterministic():
    subs = [p2p.compute_subnet_for_das_sample(s, 5, i)
            for s in range(4) for i in range(64)]
    assert all(0 <= x < p2p.DAS_SUBNET_COUNT for x in subs)
    assert subs == [p2p.compute_subnet_for_das_sample(s, 5, i)
                    for s in range(4) for i in range(64)]
    assert len(set(subs)) > 100  # spreads over many subnets

    assert p2p.DAS_QUERY_PROTOCOL_ID == "/eth2/das/req/query/1/"
    from consensus_specs_tpu_torch.ssz.impl import serialize

    req = p2p.DASQueryRequest(sample_index=77)
    assert type(req).decode_bytes(serialize(req)) == req


def test_das_sample_gossip_validation_with_real_samples():
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.testing.context import (
        default_activation_threshold,
        default_balances,
    )
    from consensus_specs_tpu_torch.testing.helpers.genesis import create_genesis_state

    spec = get_spec("das", "minimal", device="cpu")
    state = create_genesis_state(
        spec, default_balances(spec), default_activation_threshold(spec))

    from consensus_specs_tpu_torch.crypto import kzg as _kzg
    from consensus_specs_tpu_torch.crypto.bls.curve import g1_to_bytes

    data = [i + 1 for i in range(int(spec.POINTS_PER_SAMPLE) * 2)]
    extended = spec.extend_data(data)
    slot, shard = spec.Slot(2), spec.Shard(0)
    samples = spec.sample_data(slot, shard, extended)
    sample_count = len(samples)
    # commitment the way the das sanity suite builds it: monomial-basis
    # commitment to the low-degree interpolant of the extended data
    poly = spec.inverse_fft(
        spec.reverse_bit_order_list([int(v) for v in extended]))
    commitment_pt = spec.BLSCommitment(g1_to_bytes(
        _kzg.g1_lincomb(_kzg.setup_monomial(len(poly)), poly)))

    sample = samples[0]
    subnet = p2p.compute_subnet_for_das_sample(
        int(sample.shard), int(sample.slot), int(sample.index))
    assert p2p.validate_das_sample_gossip(
        spec, state, sample, sample_count, commitment_pt,
        current_slot=int(slot), subnet_index=subnet) == "accept"
    # tampered data -> reject (KZG proof check)
    tampered = sample.copy()
    tampered.data[0] = int(tampered.data[0]) ^ 1
    assert p2p.validate_das_sample_gossip(
        spec, state, tampered, sample_count, commitment_pt,
        current_slot=int(slot), subnet_index=subnet) == "reject"

    # wrong subnet -> reject
    assert p2p.validate_das_sample_gossip(
        spec, state, sample, sample_count, commitment_pt,
        current_slot=int(slot),
        subnet_index=(subnet + 1) % p2p.DAS_SUBNET_COUNT) == "reject"
    # future slot -> ignore
    assert p2p.validate_das_sample_gossip(
        spec, state, sample, sample_count, commitment_pt,
        current_slot=int(slot) - 1, subnet_index=subnet) == "ignore"
    # out-of-range index -> reject
    bad = spec.DASSample(slot=sample.slot, shard=sample.shard,
                         index=sample_count + 7, proof=sample.proof,
                         data=sample.data)
    bad_subnet = p2p.compute_subnet_for_das_sample(
        int(bad.shard), int(bad.slot), int(bad.index))
    assert p2p.validate_das_sample_gossip(
        spec, state, bad, sample_count, commitment_pt,
        current_slot=int(slot), subnet_index=bad_subnet) == "reject"


# -- the port against the reference on seeded inputs ------------------------


def _payloads(seed: int = 15, n: int = 24):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        body = bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 300)))
        # even entries: valid snappy frames; odd: raw bytes (most of which
        # do not decompress, so both message-id domains are exercised)
        out.append(ref_compress(body) if i % 2 == 0 else body)
    return out


def test_snappy_frames_equal_the_references():
    for payload in _payloads():
        assert compress(payload) == ref_compress(payload)


@pytest.mark.parametrize("variant", ["phase0", "altair_bytes", "altair_str"])
def test_message_ids_equal_the_references_on_seeded_payloads(variant):
    digest = bytes.fromhex("a1b2c3d4")
    topic = p2p.gossip_topic(digest, "beacon_block")
    for payload in _payloads():
        if variant == "phase0":
            got = p2p.compute_message_id(payload)
            want = ref_p2p.compute_message_id(payload)
        else:
            t = topic if variant == "altair_str" else topic.encode()
            got = p2p.compute_message_id_altair(t, payload)
            want = ref_p2p.compute_message_id_altair(t, payload)
        assert got == want and len(got) == 20


def test_topics_and_subnets_equal_the_references():
    rng = random.Random(90013)
    for _ in range(16):
        digest = bytes(rng.getrandbits(8) for _ in range(4))
        subnet = rng.randrange(64)
        for name in ("gossip_topic", "attestation_subnet_topic",
                     "sync_committee_subnet_topic", "blobs_sidecar_topic",
                     "shard_blob_subnet_topic", "shard_blob_header_topic",
                     "shard_blob_tx_topic", "shard_proposer_slashing_topic",
                     "das_sample_subnet_topic"):
            arg = "beacon_block" if name == "gossip_topic" else subnet
            args = (digest,) if name in (
                "blobs_sidecar_topic", "shard_blob_header_topic",
                "shard_blob_tx_topic", "shard_proposer_slashing_topic") \
                else (digest, arg)
            assert getattr(p2p, name)(*args) == getattr(ref_p2p, name)(*args)
        shard, slot, index = (rng.randrange(2**16) for _ in range(3))
        assert p2p.compute_subnet_for_das_sample(shard, slot, index) == \
            ref_p2p.compute_subnet_for_das_sample(shard, slot, index)
        epoch = rng.randrange(2**20)
        assert p2p.blobs_sidecar_request_bounds(epoch) == \
            ref_p2p.blobs_sidecar_request_bounds(epoch)
        now, header = rng.randrange(20, 200), rng.randrange(0, 220)
        assert p2p.validate_shard_blob_tx_window(now, header) == \
            ref_p2p.validate_shard_blob_tx_window(now, header)


def test_constants_and_containers_equal_the_references():
    names = [n for n in dir(ref_p2p) if n.isupper()]
    assert names == [n for n in dir(p2p) if n.isupper()]
    for name in names:
        assert getattr(p2p, name) == getattr(ref_p2p, name), name
    rng = random.Random(7)
    status = dict(fork_digest=rng.randbytes(4), finalized_root=rng.randbytes(32),
                  finalized_epoch=rng.randrange(2**40),
                  head_root=rng.randbytes(32), head_slot=rng.randrange(2**40))
    fork_id = dict(fork_digest=rng.randbytes(4),
                   next_fork_version=rng.randbytes(4),
                   next_fork_epoch=2**64 - 1)
    for cls, kwargs in (
            ("Status", status), ("Goodbye", {"reason": 3}),
            ("Ping", {"seq_number": 11}),
            ("MetaData", {"seq_number": 5}),
            ("MetaDataAltair", {"seq_number": 6}),
            ("BeaconBlocksByRangeRequest",
             {"start_slot": 100, "count": 64, "step": 1}),
            ("ENRForkID", fork_id),
            ("BlobsSidecarsByRangeRequest", {"start_slot": 9, "count": 4}),
            ("DASQueryRequest", {"sample_index": 77})):
        ours = getattr(p2p, cls)(**kwargs)
        theirs = getattr(ref_p2p, cls)(**kwargs)
        assert bytes(ours.encode_bytes()) == bytes(theirs.encode_bytes()), cls
        assert bytes(ours.hash_tree_root()) == bytes(theirs.hash_tree_root())
    roots = [rng.randbytes(32) for _ in range(5)]
    assert bytes(p2p.BeaconBlocksByRootRequest(roots).hash_tree_root()) == \
        bytes(ref_p2p.BeaconBlocksByRootRequest(roots).hash_tree_root())
