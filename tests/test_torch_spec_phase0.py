"""The torch port's phase0 spec against the reference spec, with BLS on.

States and blocks cross between the two SSZ type systems serialized
(``encode_bytes`` / ``decode_bytes``); post-state roots must be equal.

* minimal preset: a genesis state and signed blocks with full attestations
  across three epochs (two epoch transitions), built with the reference's
  testing helpers, replayed through the port's spec built for the CPU;
* mainnet preset at 16,384 validators: the main-path state built by the
  port's ``scenario`` and by the reference's bench builder; the epoch
  transition goes through the port's fused balance/merkle path;
* the whole 400,000-validator main path (``slow``).
"""
import pytest

import bench
from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.attestations import (
    next_epoch_with_attestations,
)
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu_torch import scenario
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.specs import get_spec


@pytest.fixture
def bls_on():
    """Native BLS with verification on in both packages, restored after."""
    saved = (ref_bls.bls_active, ref_bls.backend_name(),
             bls.bls_active, bls.backend_name())
    ref_bls.use_native()
    bls.use_native()
    ref_bls.bls_active = True
    bls.bls_active = True
    try:
        yield
    finally:
        ref_bls.bls_active, bls.bls_active = saved[0], saved[2]
        ref_bls.use_backend(saved[1])
        bls.use_backend(saved[3])


def _to_port(port_type, ref_obj):
    return port_type.decode_bytes(bytes(ref_obj.encode_bytes()))


def test_minimal_blocks_across_two_epoch_transitions(bls_on):
    ref_spec = ref_get_spec("phase0", "minimal")
    spec = get_spec("phase0", "minimal", device="cpu")
    state = create_genesis_state(ref_spec, default_balances(ref_spec),
                                 default_activation_threshold(ref_spec))
    pre = state.copy()
    blocks = []
    for fill_prev in (False, True, True):
        _, epoch_blocks, state = next_epoch_with_attestations(
            ref_spec, state, True, fill_prev)
        blocks += epoch_blocks
    assert len(blocks) == 3 * int(ref_spec.SLOTS_PER_EPOCH)
    assert sum(len(b.message.body.attestations) for b in blocks) > 0

    port_state = _to_port(spec.BeaconState, pre)
    assert port_state.hash_tree_root() == pre.hash_tree_root()
    for signed in blocks:
        spec.state_transition(
            port_state, _to_port(spec.SignedBeaconBlock, signed), True)
        assert bytes(port_state.hash_tree_root()) == bytes(
            signed.message.state_root)
    assert bytes(port_state.encode_bytes()) == bytes(state.encode_bytes())


def test_mainnet_epoch_at_16384_through_the_fused_path(monkeypatch):
    # the CPU keeps the host path by default (the reference's policy);
    # forced here to hold the fused route to the reference on the CPU
    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)
    n = merkle_resident.RESIDENT_MIN
    ref_spec = ref_get_spec("phase0", "mainnet")
    spec = get_spec("phase0", "mainnet", device="cpu")
    ref_state = bench.build_state(ref_spec, n)
    port_state = scenario.build_state(spec, n)
    assert bytes(port_state.encode_bytes()) == bytes(ref_state.encode_bytes())
    crossed = _to_port(spec.BeaconState, ref_state)
    assert crossed.hash_tree_root() == port_state.hash_tree_root()

    ref_spec.process_epoch(ref_state)
    before = merkle_resident.stats["fused_epoch_updates"]
    spec.process_epoch(port_state)
    assert merkle_resident.stats["fused_epoch_updates"] == before + 1
    assert bytes(port_state.hash_tree_root()) == bytes(ref_state.hash_tree_root())


@pytest.mark.slow
def test_main_path_at_400k_matches_reference(bls_on, monkeypatch):
    """The main path on the CPU: 32 signed blocks at 400,000 validators,
    port vs reference, equal roots after every block; the fused epoch
    route forced on the CPU, as the card takes it."""
    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)
    n = 400_000
    spec = get_spec("phase0", "mainnet", device="cpu")
    ref_spec = ref_get_spec("phase0", "mainnet")
    state = scenario.build_main_path_state(spec, n)
    blocks = scenario.build_epoch_blocks(spec, state)
    ref_state = ref_spec.BeaconState.decode_bytes(bytes(state.encode_bytes()))
    before = merkle_resident.stats["fused_epoch_updates"]
    for signed in blocks:
        spec.state_transition(state, signed, True)
        ref_spec.state_transition(
            ref_state, ref_spec.SignedBeaconBlock.decode_bytes(
                bytes(signed.encode_bytes())), True)
        assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    assert merkle_resident.stats["fused_epoch_updates"] == before + 1
