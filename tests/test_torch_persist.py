"""The port's persistence (``persist/``) against the JAX package's: one
file format, byte for byte, read by either package.

* the artifact envelope: a file the port writes is the file the
  reference writes for the same payload, and each reads the other's;
* the tree codec: ``encode_tree`` of the same state gives the same
  bytes in both packages, and each decodes the other's stream to the
  same root;
* the checkpoint store: the same minimal corpus served through both
  nodes leaves the same checkpoint files, name for name and byte for
  byte; the reference recovers from the port's directory and the port
  from the reference's, each on its checkpoint fast path, with the served
  node's head, state root and checkpoints;
* the corruption ladder on the port: a flipped byte in the newest
  artifact is counted, quarantined, and recovery restores the next one.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from consensus_specs_tpu import faults as ref_faults
from consensus_specs_tpu.node import service as ref_service
from consensus_specs_tpu.persist import atomic as ref_atomic
from consensus_specs_tpu.persist import store as ref_store_mod
from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.node import service
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.persist import atomic
from consensus_specs_tpu_torch.persist import store as store_mod
from consensus_specs_tpu_torch.ssz import bulk
from tests.torch_node_common import (  # noqa: F401
    bls_off,
    own_index,
    served,
)


@pytest.fixture(autouse=True)
def _own_index(own_index):
    yield


@pytest.mark.parametrize("size", [0, 1, 4096])
def test_artifact_files_are_the_same_bytes(tmp_path, size):
    payload = bytes(range(256)) * (size // 256) + bytes(size % 256)
    port_path, ref_path = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
    atomic.write_artifact(port_path, payload, "test-kind", "v1")
    ref_atomic.write_artifact(ref_path, payload, "test-kind", "v1")
    with open(port_path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    assert ref_atomic.read_artifact(port_path, "test-kind", "v1") == payload
    assert atomic.read_artifact(ref_path, "test-kind", "v1") == payload


def test_foreign_tag_is_stale_in_both_packages(tmp_path):
    path = str(tmp_path / "a.bin")
    atomic.write_artifact(path, b"x" * 64, "test-kind", "v1")
    with pytest.raises(ref_atomic.ArtifactStaleTag):
        ref_atomic.read_artifact(path, "test-kind", "v2")
    with pytest.raises(atomic.ArtifactStaleTag):
        atomic.read_artifact(path, "test-kind", "v2")


@pytest.mark.parametrize("site,kind", [("persist.write", "error"),
                                       ("persist.replace", "error"),
                                       ("persist.read", "corrupt")])
def test_an_injected_fault_leaves_no_torn_file(tmp_path, site, kind):
    """The port's own fault sites: a failure before the promotion leaves
    no final file and no temp; a corrupted read is caught by the digest."""
    path = str(tmp_path / "a.bin")
    plan = faults.FaultPlan([faults.Fault(site, nth=1, kind=kind)])
    if site == "persist.read":
        atomic.write_artifact(path, b"y" * 256, "k", "v1")
        with faults.inject(plan), pytest.raises(atomic.ArtifactCorrupt):
            atomic.read_artifact(path, "k", "v1")
        assert atomic.read_artifact(path, "k", "v1") == b"y" * 256
        return
    with faults.inject(plan), pytest.raises(faults.InjectedFault):
        atomic.write_artifact(path, b"y" * 256, "k", "v1")
    assert os.listdir(tmp_path) == []
    # the port's site, not the reference's: one registry a package
    assert faults.registry()[site] is not ref_faults.registry()[site]


def _encode(mod, view) -> bytes:
    view.hash_tree_root()
    out = bytearray()
    mod.encode_tree(view.get_backing(), out, {})
    return bytes(out)


def test_tree_codec_bytes_equal_and_cross_decode(served):
    ref_spec, spec = served["ref_spec"], served["spec"]
    node = served["node"]
    head = bytes(node.get_head())
    state = node.store.block_states[head]
    ref_state = served["ref_node"].store.block_states[head]
    port_bytes = _encode(store_mod, state)
    assert port_bytes == _encode(ref_store_mod, ref_state)
    root = bytes(state.hash_tree_root())
    backing, off = ref_store_mod.decode_tree(port_bytes, 0, [])
    assert off == len(port_bytes)
    assert bytes(ref_spec.BeaconState.view_from_backing(
        backing).hash_tree_root()) == root
    backing, off = store_mod.decode_tree(port_bytes, 0, [])
    rebuilt = spec.BeaconState.view_from_backing(backing)
    assert bytes(rebuilt.encode_bytes()) == bytes(ref_state.encode_bytes())


def test_tree_codec_under_a_device_computed_balances_root(served):
    """The fused epoch update and the resident slot root memoize only the
    balances list's contents root (K2's, on the card); the interior below
    it was never hashed on the host.  The codec hashes that interior when
    it gets there, and writes the bytes of the host-hashed state, which are
    the reference's."""
    spec = served["spec"]
    head = bytes(served["node"].get_head())
    base = served["node"].store.block_states[head]
    values = bulk.packed_uint64_to_numpy(base.balances).astype(np.int64) + 7
    state = base.copy()
    bulk.set_packed_uint64_from_numpy(state.balances, values)
    n_pad = 4 << max((len(values) + 3) // 4 - 1, 0).bit_length()
    padded = np.zeros(n_pad, dtype=np.int64)
    padded[:len(values)] = values
    merkle_resident.memoize_packed_u64_contents_root(
        state.balances, merkle_resident._root_bytes(
            merkle_resident.packed_u64_root(torch.as_tensor(padded)).numpy()))
    assert state.balances.get_backing().left.left._root is None
    host = spec.BeaconState.decode_bytes(bytes(state.encode_bytes()))
    ref_host = served["ref_spec"].BeaconState.decode_bytes(
        bytes(state.encode_bytes()))
    assert _encode(store_mod, state) == _encode(store_mod, host) == \
        _encode(ref_store_mod, ref_host)


def test_checkpoint_files_are_byte_identical(served):
    port_dir, ref_dir = served["port_dir"], served["ref_dir"]
    names = sorted(os.listdir(port_dir))
    assert names and names == sorted(os.listdir(ref_dir))
    for name in names:
        with open(os.path.join(port_dir, name), "rb") as f, \
                open(os.path.join(ref_dir, name), "rb") as g:
            assert f.read() == g.read(), name


def _assert_same_world(node, recovered):
    head = bytes(node.get_head())
    assert bytes(recovered.get_head()) == head
    assert bytes(recovered.store.block_states[head].hash_tree_root()) == \
        bytes(node.store.block_states[head].hash_tree_root())
    for name in ("justified_checkpoint", "finalized_checkpoint"):
        a, b = getattr(recovered.store, name), getattr(node.store, name)
        assert (int(a.epoch), bytes(a.root)) == (int(b.epoch), bytes(b.root))
    assert {int(v): (int(m.epoch), bytes(m.root))
            for v, m in recovered.store.latest_messages.items()} == {
        int(v): (int(m.epoch), bytes(m.root))
        for v, m in node.store.latest_messages.items()}


def test_reference_recovers_from_the_ports_checkpoints(served, bls_off,
                                                        tmp_path):
    directory = str(tmp_path / "from_port")
    shutil.copytree(served["port_dir"], directory)
    ref_node = served["ref_node"]
    ref_service.reset_stats()
    recovered = ref_service.recover_node(
        served["ref_spec"], served["ref_state"],
        served["ref_corpus"].anchor_block, ref_node.journal,
        checkpoint_store=ref_store_mod.CheckpointStore(
            directory, asynchronous=False))
    assert ref_service.stats["checkpoint_recoveries"] == 1
    assert ref_store_mod.stats["corruptions"] == 0
    assert ref_store_mod.stats["restore_fallbacks"] == 0
    _assert_same_world(served["node"], recovered)


def test_port_recovers_from_the_references_checkpoints(served, bls_off,
                                                       tmp_path):
    directory = str(tmp_path / "from_ref")
    shutil.copytree(served["ref_dir"], directory)
    node = served["node"]
    service.reset_stats()
    recovered = service.recover_node(
        served["spec"], served["state"], served["corpus"].anchor_block,
        node.journal, checkpoint_store=store_mod.CheckpointStore(
            directory, asynchronous=False))
    assert service.stats["checkpoint_recoveries"] == 1
    assert store_mod.stats["corruptions"] == 0
    assert store_mod.stats["restore_fallbacks"] == 0
    assert recovered.journal == node.journal
    _assert_same_world(served["ref_node"], recovered)


def test_port_walks_past_a_corrupt_newest_checkpoint(served, bls_off,
                                                     tmp_path):
    directory = str(tmp_path / "damaged")
    shutil.copytree(served["port_dir"], directory)
    store = store_mod.CheckpointStore(directory, asynchronous=False)
    candidates = store.candidates()
    assert len(candidates) >= 2
    with open(candidates[0], "r+b") as f:
        f.seek(os.path.getsize(candidates[0]) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    node = served["node"]
    service.reset_stats()
    recovered = service.recover_node(
        served["spec"], served["state"], served["corpus"].anchor_block,
        node.journal, checkpoint_store=store)
    assert store_mod.stats["corruptions"] == 1
    assert service.stats["checkpoint_recoveries"] == 1
    assert candidates[0] not in store.candidates()
    _assert_same_world(node, recovered)
