"""The research forks on the port (eip4844, sharding, custody_game, das)
against the JAX package's: specs built by the port's builder on the CPU,
states and blocks carried across as SSZ bytes.

* the genesis state of each fork (minimal preset, 16 to 64 validators)
  has the reference's root;
* ``upgrade_to_eip4844`` and ``upgrade_to_sharding`` of a bellatrix state
  give the reference's roots;
* an eip4844 block from ``scenario.blob_block`` (blob transactions in its
  payload, their commitments in its body) applies on the port and on the
  reference with equal post-state roots, and the blobs' sidecar verifies
  on both;
* the builder gives the research forks the reference's topology, its
  vectorized attestation path to eip4844 alone, and their slashing
  multiplier.
"""
import pytest

from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.helpers.genesis import (
    create_genesis_state as ref_genesis,
)
from consensus_specs_tpu_torch import scenario
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.specs import builder, get_spec
from consensus_specs_tpu_torch.testing.helpers.genesis import create_genesis_state

RESEARCH = ("eip4844", "sharding", "custody_game", "das")


@pytest.fixture
def bls_off():
    saved = bls.bls_active, ref_bls.bls_active
    bls.bls_active = ref_bls.bls_active = False
    yield
    bls.bls_active, ref_bls.bls_active = saved


def _genesis(spec, make, n):
    return make(spec, [spec.MAX_EFFECTIVE_BALANCE] * n, spec.MAX_EFFECTIVE_BALANCE)


@pytest.mark.parametrize("fork,n", [("eip4844", 64), ("sharding", 32),
                                    ("custody_game", 16), ("das", 16)])
def test_genesis_root_equals_the_reference(bls_off, fork, n):
    port = _genesis(get_spec(fork, "minimal", device="cpu"), create_genesis_state, n)
    ref = _genesis(ref_get_spec(fork, "minimal"), ref_genesis, n)
    assert bytes(port.hash_tree_root()) == bytes(ref.hash_tree_root())


@pytest.mark.parametrize("fork", ["eip4844", "sharding"])
def test_upgrade_root_equals_the_reference(bls_off, fork):
    port_pre = _genesis(get_spec("bellatrix", "minimal", device="cpu"),
                        create_genesis_state, 32)
    ref_pre = _genesis(ref_get_spec("bellatrix", "minimal"), ref_genesis, 32)
    upgrade = f"upgrade_to_{fork}"
    port = getattr(get_spec(fork, "minimal", device="cpu"), upgrade)(port_pre)
    ref = getattr(ref_get_spec(fork, "minimal"), upgrade)(ref_pre)
    assert port.fork.current_version == ref.fork.current_version
    assert bytes(port.hash_tree_root()) == bytes(ref.hash_tree_root())


def test_eip4844_blob_block_equals_the_reference():
    bellatrix = get_spec("bellatrix", "minimal", device="cpu")
    spec = get_spec("eip4844", "minimal", device="cpu")
    ref_spec = ref_get_spec("eip4844", "minimal")
    state = spec.upgrade_to_eip4844(scenario.build_main_path_state(bellatrix, 64))
    blobs = scenario.seeded_blobs(spec, 2, seed=3)
    signed = scenario.blob_block(spec, state, blobs)
    body = signed.message.body
    assert len(body.blob_kzgs) == 2
    assert spec.verify_kzgs_against_transactions(
        body.execution_payload.transactions, body.blob_kzgs)

    ref_state = ref_spec.BeaconState.decode_bytes(bytes(state.encode_bytes()))
    ref_signed = ref_spec.SignedBeaconBlock.decode_bytes(bytes(signed.encode_bytes()))
    saved = bls.bls_active, ref_bls.bls_active
    bls.bls_active = ref_bls.bls_active = True
    try:
        post = state.copy()
        spec.state_transition(post, signed, True)
        ref_spec.state_transition(ref_state, ref_signed, True)
    finally:
        bls.bls_active, ref_bls.bls_active = saved
    assert bytes(post.hash_tree_root()) == bytes(ref_state.hash_tree_root())

    root = signed.message.hash_tree_root()
    for s, sig_blobs in ((spec, blobs), (ref_spec, blobs)):
        sidecar = s.BlobsSidecar(beacon_block_root=root,
                                 beacon_block_slot=signed.message.slot,
                                 blobs=[s.Blob(b) for b in sig_blobs])
        s.verify_blobs_sidecar(signed.message.slot, root,
                               list(body.blob_kzgs), sidecar)


def test_builder_carries_the_reference_topology():
    from consensus_specs_tpu.specs import builder as ref_builder

    for fork in RESEARCH:
        assert builder.FORK_PARENTS[fork] == ref_builder.FORK_PARENTS[fork]
        assert builder._SLASHING_MULT[fork] == ref_builder._SLASHING_MULT[fork]
    assert [f for f in RESEARCH if f in builder.ALTAIR_LINEAGE] == ["eip4844"]
    # the mainline ladder, the generators' forks and the engine's fast
    # forks stay as they were: eip4844 blocks replay literally
    assert builder.available_forks() == ref_builder.available_forks()
    from consensus_specs_tpu_torch.stf import engine

    assert "eip4844" not in engine.FAST_FORKS
