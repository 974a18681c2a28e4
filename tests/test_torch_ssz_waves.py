"""The wave route of the port's SSZ hasher against the reference.

``ops.sha256.hash_waves`` (a whole merkle wave schedule over a digest pool)
is held against ``consensus_specs_tpu.ops.sha256_jax.hash_waves`` and
hashlib, and ``ssz.node.merkle_root``'s wave branch (trees of at least
``hashing.MIN_DEVICE_TREE`` unhashed nodes under the ``"torch"`` backend)
against the reference package's roots, fresh and after scattered writes.
Exact equality: digests are integers.  On the CPU the schedule runs the
plain version; K1's gathered launches and its one-block tail are held
against the plain version on a GPU (``cuda`` marker; skips here without
one).
"""
import hashlib
import os
import pathlib
import random
import re

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256_jax
from consensus_specs_tpu.ssz.types import List as RefList
from consensus_specs_tpu.ssz.types import uint64 as ref_uint64
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.ssz import hashing
from consensus_specs_tpu_torch.ssz.types import List, uint64


def _hashlib_waves(known, waves):
    """The schedule's outputs, one hashlib call a message."""
    pool, out = list(known), []
    for left, right in waves:
        digests = [hashlib.sha256(pool[a] + pool[b]).digest()
                   for a, b in zip(np.asarray(left).tolist(),
                                   np.asarray(right).tolist())]
        out.extend(digests)
        pool.extend(digests)
    return out


def _dag_schedule():
    """tests/test_sha256_jax.py's DAG: deduplicated known children, a
    message that reads one row twice, waves reading known rows and earlier
    waves' outputs."""
    rng = random.Random(99)
    known = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(11)]
    w0 = (np.array([0, 2, 4, 10], dtype=np.int32),
          np.array([1, 3, 5, 10], dtype=np.int32))
    w1 = (np.array([11, 13, 6], dtype=np.int32),
          np.array([12, 14, 7], dtype=np.int32))
    w2 = (np.array([15], dtype=np.int32), np.array([16], dtype=np.int32))
    return known, [w0, w1, w2]


def _random_schedule(sizes, n_known, seed):
    """Known digests and waves of these sizes whose children are random rows
    the known digests or an earlier wave filled, the newest wave's rows
    favoured (as in a tree)."""
    rng = np.random.default_rng(seed)
    known = rng.integers(0, 2**32, (n_known, 8), dtype=np.uint64).astype(np.uint32)
    known[0] = 0xFFFFFFFF
    waves, filled, prev = [], n_known, 0
    for size in sizes:
        def rows():
            recent = rng.integers(prev, filled, size)
            anywhere = rng.integers(0, filled, size)
            return np.where(rng.random(size) < 0.8, recent, anywhere).astype(np.int32)
        waves.append((rows(), rows()))
        prev, filled = filled, filled + size
    return known, waves


def test_hash_waves_dag_matches_jax_and_hashlib():
    known, waves = _dag_schedule()
    got = sha256.hash_waves(known, waves, "cpu")
    assert got == _hashlib_waves(known, waves)
    assert got == sha256_jax.hash_waves(known, waves)


def test_hash_waves_empty_and_single_message_waves():
    known, _ = _dag_schedule()
    assert sha256.hash_waves(known, [], "cpu") == []
    assert sha256.hash_waves([], [], "cpu") == []
    # a chain of one-message waves, as up a list's zero padding
    chain = [(np.array([0], dtype=np.int32), np.array([1], dtype=np.int32))]
    chain += [(np.array([len(known) + i], dtype=np.int32),
               np.array([2 + i], dtype=np.int32)) for i in range(5)]
    got = sha256.hash_waves(known, chain, "cpu")
    assert len(got) == 6 and got == _hashlib_waves(known, chain)


def test_hash_waves_u32_matches_hashlib_on_random_schedules():
    known, waves = _random_schedule([40, 9, 1, 1, 17, 1], 30, seed=5)
    got = sha256.hash_waves_u32(known, waves, "cpu")
    assert got.dtype == np.uint32 and got.shape == (69, 8)
    known_bytes = [row.astype(">u4").tobytes() for row in known]
    want = _hashlib_waves(known_bytes, waves)
    assert [row.astype(">u4").tobytes() for row in got] == want


@pytest.mark.parametrize("left,right", [
    ([0, 4], [1, 2]),     # row 4 is this wave's own output
    ([0, -1], [1, 2]),    # negative
    ([0, 1], [1, 9]),     # past every row
])
def test_wave_indices_refuse_rows_not_yet_filled(left, right):
    waves = [(np.array([0], dtype=np.int32), np.array([1], dtype=np.int32)),
             (np.array(left, dtype=np.int32), np.array(right, dtype=np.int32))]
    with pytest.raises(ValueError):
        sha256.wave_indices(3, waves)


def test_wave_indices_lay_out_rows_and_starts():
    known, waves = _dag_schedule()
    lefts, rights, starts = sha256.wave_indices(len(known), waves)
    assert starts.tolist() == [0, 4, 7, 8]
    assert lefts.tolist() == [0, 2, 4, 10, 11, 13, 6, 15]
    assert rights.tolist() == [1, 3, 5, 10, 12, 14, 7, 16]
    with pytest.raises(ValueError):
        sha256.wave_indices(1, [(np.array([0, 0]), np.array([0]))])


@pytest.mark.parametrize("sizes,launches", [
    ([], []),
    ([5000, 2000, 257], [(0, 1), (1, 2), (2, 3)]),
    ([5000, 256, 100, 1, 1], [(0, 1), (1, 5)]),
    ([300, 1, 0, 300, 2], [(0, 1), (1, 3), (3, 4), (4, 5)]),
    ([0, 0], []),
    ([1, 1, 1], [(0, 3)]),
])
def test_wave_launches_plan(sizes, launches):
    """A wave of more than ``TAIL_MAX_MESSAGES`` messages is a grid launch
    of its own; each run of smaller waves with a message is one tail."""
    assert sha256.TAIL_MAX_MESSAGES == 256
    assert sha256.wave_launches(sizes) == launches


def test_tail_cut_mirrors_the_kernel_source():
    """``TAIL_MAX_MESSAGES`` is the tail block's thread count, so that a
    tail wave is one message a thread."""
    path = os.path.join(sha256._CSRC_DIR, "sha256.cu")
    text = pathlib.Path(path).read_text()
    [threads] = re.findall(r"constexpr int kTailThreads = (\d+);", text)
    assert sha256.TAIL_MAX_MESSAGES == int(threads)


def test_launch_waves_refuses_host_tensors():
    pool = torch.zeros((3, 8), dtype=torch.int32)
    index = torch.zeros(2 + 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        sha256.launch_waves(pool, index, [0, 1])


def test_get_wave_hasher_is_none_under_hashlib():
    assert hashing.get_backend_name() == "hashlib"
    assert hashing.get_wave_hasher() is None
    assert hashing.MIN_DEVICE_TREE == 4096


def _calls(monkeypatch):
    """Count calls of the wave hasher the ``"torch"`` backend registers."""
    calls = []
    waves = sha256.hash_waves

    def counted(known, index_waves, device):
        calls.append(len(index_waves))
        return waves(known, index_waves, device)

    monkeypatch.setattr(sha256, "hash_waves", counted)
    return calls


def test_wave_route_list_root_matches_reference(monkeypatch):
    """Above ``MIN_DEVICE_TREE`` a fresh list's root goes through the wave
    hasher; after writes to every 101st element the dirty subtree's root
    (per layer: too few nodes) equals the reference's too."""
    calls = _calls(monkeypatch)
    values = list(range(40_000))
    ref = RefList[ref_uint64, 2**40](*values)
    hashing.set_backend("torch", device="cpu")
    try:
        assert hashing.get_wave_hasher() is not None
        port = List[uint64, 2**40](*values)
        assert bytes(port.hash_tree_root()) == bytes(ref.hash_tree_root())
        assert len(calls) == 1
        for i in range(0, 40_000, 101):
            port[i] = uint64(i + 7)
            ref[i] = ref_uint64(i + 7)
        assert bytes(port.hash_tree_root()) == bytes(ref.hash_tree_root())
    finally:
        hashing.set_backend("hashlib")
    assert hashing.get_wave_hasher() is None


def test_wave_route_dirty_rehash_matches_reference(monkeypatch):
    """With the tree floor lowered, a dirty subtree's rehash goes through
    the wave hasher too (memoised roots as known rows) and gives the
    reference's root."""
    calls = _calls(monkeypatch)
    monkeypatch.setattr(hashing, "MIN_DEVICE_TREE", 1)
    values = list(range(1000))
    ref = RefList[ref_uint64, 2**10](*values)
    hashing.set_backend("torch", device="cpu")
    try:
        port = List[uint64, 2**10](*values)
        assert bytes(port.hash_tree_root()) == bytes(ref.hash_tree_root())
        for i in range(0, 1000, 101):
            port[i] = uint64(2**64 - 1 - i)
            ref[i] = ref_uint64(2**64 - 1 - i)
        assert bytes(port.hash_tree_root()) == bytes(ref.hash_tree_root())
    finally:
        hashing.set_backend("hashlib")
    assert len(calls) == 2


# -- K1's wave launches on the card ------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,n_known,seed", [
    ([1], 2, 0),
    ([3000, 700, 257, 256, 255, 3, 1, 1, 1], 5000, 1),
    ([1, 1, 40_000, 1, 300, 2, 1], 3, 2),
    ([600, 256, 128, 64, 32, 16, 8, 4, 2, 1] + [1] * 30, 1200, 3),
])
def test_k1_waves_match_plain(cuda_device, sizes, n_known, seed):
    """Grid launches and one-block tails, crossing the cut both ways,
    against the plain version on the card and hashlib on a sample; the
    launch count is the plan's."""
    known, waves = _random_schedule(sizes, n_known, seed)
    before = sha256.counts["sha256_block64"]
    got = sha256.hash_waves_u32(known, waves, cuda_device)
    assert (sha256.counts["sha256_block64"] - before
            == len(sha256.wave_launches(sizes)))
    lefts, rights, starts = sha256.wave_indices(n_known, waves)
    plain = sha256.hash_waves_plain(
        torch.from_numpy(known.view(np.int32)).to(cuda_device),
        torch.from_numpy(lefts).to(cuda_device),
        torch.from_numpy(rights).to(cuda_device), starts.tolist())
    assert np.array_equal(got, plain.cpu().numpy().view(np.uint32))
    pool = np.concatenate([known, got])
    sample = np.random.default_rng(seed).choice(len(got), min(len(got), 256),
                                                replace=False)
    for i in sample:
        block = np.concatenate([pool[lefts[i]], pool[rights[i]]])
        digest = hashlib.sha256(block.astype(">u4").tobytes()).digest()
        assert got[i].astype(">u4").tobytes() == digest


@pytest.mark.cuda
def test_k1_wave_route_list_of_2_20_chunks(cuda_device):
    """A list of 2^20 chunks (one tree of 2^20 - 1 messages and its zero
    padding) through the wave route on the card, against hashlib."""
    n = 1 << 22  # uint64 values: 2^20 chunks
    data = np.random.default_rng(7).integers(0, 2**63, n, dtype=np.int64).tobytes()
    want = bytes(List[uint64, 2**24].decode_bytes(data).hash_tree_root())
    before = sha256.counts["sha256_block64"]
    hashing.set_backend("torch", device=cuda_device)
    try:
        got = bytes(List[uint64, 2**24].decode_bytes(data).hash_tree_root())
    finally:
        hashing.set_backend("hashlib")
    assert got == want
    assert sha256.counts["sha256_block64"] > before


def test_failed_wave_hasher_leaves_the_tree_unhashed(monkeypatch):
    """A wave hasher that raises (``KernelError`` on a card that fails)
    leaves no root behind: hashing again, under hashlib, gives the
    reference's root."""
    def failing(known, index_waves):
        raise sha256.KernelError("the card failed")

    monkeypatch.setattr(hashing, "MIN_DEVICE_TREE", 1)
    monkeypatch.setitem(hashing._WAVE_BACKENDS, "hashlib", failing)
    values = list(range(1000))
    port = List[uint64, 2**10](*values)
    with pytest.raises(sha256.KernelError):
        port.hash_tree_root()
    monkeypatch.delitem(hashing._WAVE_BACKENDS, "hashlib")
    want = RefList[ref_uint64, 2**10](*values).hash_tree_root()
    assert bytes(port.hash_tree_root()) == bytes(want)
