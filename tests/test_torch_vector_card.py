"""On the card: an ``ssz_static`` case of a whole mainnet ``BeaconState``.

The runner's mainnet setting (``mode_random``) draws one ``BeaconState``
on a CUDA-built phase0 spec and writes its case under the ``"torch"`` SSZ
hasher, whose root takes K1's wave route (about 84,000 leaf chunks, far
above ``hashing.MIN_DEVICE_TREE``); the root in ``roots.yaml`` must equal
hashlib's root of the serialized value.  ``cuda``-marked: it skips on a
host without a card, and this file imports no JAX.
"""
from random import Random

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return "cuda"


@pytest.mark.cuda
def test_mainnet_beacon_state_case_root_on_the_card(cuda_device):
    from consensus_specs_tpu_torch.gen.runners import ssz_static
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.ssz import hashing

    seed, preset, mode, chaos, _ = next(
        s for s in ssz_static.settings() if s[1] == "mainnet")
    spec = get_spec("phase0", preset, cuda_device)
    names = [name for name, _ in ssz_static.get_spec_ssz_types(spec)]
    rng = Random(seed * 1000 + names.index("BeaconState"))
    hashing.set_backend("torch", device=cuda_device)
    try:
        sha256.reset_counts()
        parts = {name: value for name, _, value in ssz_static.create_test_case(
            rng, spec.BeaconState, mode, chaos)}
        torch.cuda.synchronize()
        launches = sha256.counts["sha256_block64"]
    finally:
        hashing.set_backend("hashlib")
    state = spec.BeaconState.decode_bytes(parts["serialized"])
    assert len(state.randao_mixes) == 65_536
    assert parts["roots"]["root"] == "0x" + bytes(state.hash_tree_root()).hex()
    assert launches > 0
