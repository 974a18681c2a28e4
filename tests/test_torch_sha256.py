"""SHA-256 merkle compression of the torch port against the reference.

The port's plain torch version (``sha256_block64`` on a CPU tensor) is held
against ``consensus_specs_tpu.ops.sha256_jax.sha256_block64`` — the Pallas
kernel's bit-identical XLA twin — and against hashlib.  Exact equality:
digests are integers.  The CUDA kernel K1 is held against both on a GPU
(``cuda`` marker; skips here without one).
"""
import hashlib
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256_jax
from consensus_specs_tpu.ssz.types import List as RefList
from consensus_specs_tpu.ssz.types import uint64 as ref_uint64
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch.ops import sha256
from consensus_specs_tpu_torch.ssz import hashing
from consensus_specs_tpu_torch.ssz.types import List, uint64


def _words(n, seed):
    """[n, 16] uint32 message words from numpy, with words >= 2^31."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)
    w[0, :] = 0xFFFFFFFF
    w[-1, ::2] = 0x80000000
    return w


def _hashlib_digests(words):
    return np.array([np.frombuffer(hashlib.sha256(row.astype(">u4").tobytes())
                                   .digest(), dtype=">u4") for row in words],
                    dtype=np.uint32)


@pytest.mark.parametrize("n", [1, 127, 129, 1024])
def test_plain_block64_matches_jax_and_hashlib(n):
    words = _words(n, seed=n)
    got = sha256.sha256_block64(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, 8)
    got = got.numpy().view(np.uint32)
    ref = np.asarray(jax.jit(sha256_jax.sha256_block64)(jnp.asarray(words)))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _hashlib_digests(words))


def test_int32_bit_conversion_is_exact():
    vals = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1],
                        dtype=torch.int64)
    bits = sha256.to_int32_bits(vals)
    assert bits.dtype == torch.int32
    assert bits.tolist() == [0, 1, 2**31 - 1, -2**31, -2**31 + 5, -1]
    assert torch.equal(sha256.from_int32_bits(bits), vals)


def test_hash_layer_merkle_parent_and_empty():
    left = hashlib.sha256(b"left").digest()
    right = hashlib.sha256(b"right").digest()
    [parent] = sha256.hash_layer([left + right], device="cpu")
    assert parent == hashlib.sha256(left + right).digest()
    assert sha256.hash_layer([], device="cpu") == []
    blocks = [bytes([i % 256, i // 256]) * 32 for i in range(300)]
    assert sha256.hash_layer(blocks, device="cpu") == [
        hashlib.sha256(b).digest() for b in blocks]


def test_wrapper_refuses_bad_inputs():
    with pytest.raises(TypeError):
        sha256.sha256_block64(torch.zeros((2, 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        sha256.sha256_block64(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        sha256.sha256_block64(torch.zeros((16, 2), dtype=torch.int32).t())


@pytest.mark.parametrize("edited", range(len(sha256.SOURCES)))
def test_build_digest_covers_every_source(tmp_path, edited):
    """The library is named by a digest of all its sources, the shared
    header among them, so editing any one of them rebuilds it."""
    names = [os.path.basename(p) for p in sha256.SOURCES]
    assert "sha256_core.cuh" in names
    copies = []
    for src in sha256.SOURCES:
        copy = tmp_path / os.path.basename(src)
        copy.write_bytes(pathlib.Path(src).read_bytes())
        copies.append(str(copy))
    before = _build.source_digest(copies, sha256._NVCC_FLAGS)
    with open(copies[edited], "ab") as f:
        f.write(b"\n// edited\n")
    assert _build.source_digest(copies, sha256._NVCC_FLAGS) != before


@pytest.mark.parametrize("failure", [OSError("build failed"),
                                     RuntimeError("nvcc not found")])
def test_unavailable_library_raises_kernel_error(monkeypatch, failure):
    """A library that cannot be built or loaded raises ``KernelError``, the
    one type callers let through, with the cause attached."""
    def fail():
        raise failure

    monkeypatch.setattr(sha256, "_lib", None)
    monkeypatch.setattr(sha256, "build_kernel", fail)
    with pytest.raises(sha256.KernelError) as info:
        sha256._library()
    assert info.value.__cause__ is failure


@pytest.mark.parametrize("n_chunks,plan", [
    (1, (1, 0)), (512, (1, 0)), (1024, (1, 0)), (1 << 17, (2, 128)),
    (1 << 18, (2, 256)), (1 << 19, (2, 512)), (1 << 20, (2, 1024)),
    (1 << 21, (3, 2050)),
])
def test_k2_plan_counts_passes_and_scratch(n_chunks, plan):
    assert sha256.k2_plan(n_chunks) == plan


def _tree_source_constants() -> dict:
    """The ``constexpr int`` constants of ``csrc/sha256_tree.cu``, each a
    product of literals and the constants before it."""
    path = os.path.join(sha256._CSRC_DIR, "sha256_tree.cu")
    text = pathlib.Path(path).read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        value = 1
        for factor in expr.split("*"):  # a product of literals and names
            factor = factor.strip()
            value *= int(factor) if factor.isdigit() else consts[factor]
        consts[name] = value
    return consts


def test_k2_plan_mirrors_the_launcher_source():
    """``K2_LEAVES_PER_CTA`` and ``k2_plan`` against the launcher's own
    constants and loop (``u64_list_root_launch``), read from the source:
    a CTA of ``kThreads`` threads hashes two leaves a thread, a pass
    reduces ``kLeavesPerCta`` leaves a CTA, and every pass but the last
    writes its CTA roots to scratch."""
    consts = _tree_source_constants()
    assert consts["kLeavesPerCta"] == 2 * consts["kThreads"]
    assert sha256.K2_LEAVES_PER_CTA == consts["kLeavesPerCta"]
    for k in range(31):
        n, passes, scratch = 1 << k, 0, 0
        while True:
            per_cta = min(n, consts["kLeavesPerCta"])
            blocks = n // per_cta
            passes += 1
            if blocks == 1:
                break
            scratch += blocks
            n = blocks
        assert sha256.k2_plan(1 << k) == (passes, scratch), k


@pytest.mark.parametrize("min_batch", [None, 1])
def test_torch_backend_list_root_matches_reference(monkeypatch, min_batch):
    """The ``"torch"`` hashing backend on the CPU gives the reference's
    hashlib root; with the batch floor lowered every layer goes through
    the backend."""
    expected = bytes(RefList[ref_uint64, 2**40](*range(1500)).hash_tree_root())
    if min_batch is not None:
        monkeypatch.setattr(hashing, "MIN_DEVICE_BATCH", min_batch)
    hashing.set_backend("torch", device="cpu")
    try:
        assert hashing.get_backend_name() == "torch"
        root = bytes(List[uint64, 2**40](*range(1500)).hash_tree_root())
    finally:
        hashing.set_backend("hashlib")
    assert root == expected
    assert hashing.get_backend_name() == "hashlib"


def test_backend_without_device_refuses_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        hashing.set_backend("torch")
    assert hashing.get_backend_name() == "hashlib"


# -- K1 on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 1024, 1 << 16])
def test_k1_matches_plain_and_hashlib(cuda_device, n):
    words = _words(n, seed=n)
    dev = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    before = sha256.counts["sha256_block64"]
    got = sha256.sha256_block64(dev)
    torch.cuda.synchronize()
    assert sha256.counts["sha256_block64"] == before + 1
    plain = sha256.to_int32_bits(
        sha256.sha256_block64_plain(sha256.from_int32_bits(dev)))
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy().view(np.uint32)[:1024],
                          _hashlib_digests(words[:1024]))


@pytest.mark.cuda
def test_k1_backend_list_root(cuda_device, monkeypatch):
    expected = bytes(RefList[ref_uint64, 2**40](*range(1500)).hash_tree_root())
    monkeypatch.setattr(hashing, "MIN_DEVICE_BATCH", 1)
    hashing.set_backend("torch", device=cuda_device)
    try:
        root = bytes(List[uint64, 2**40](*range(1500)).hash_tree_root())
    finally:
        hashing.set_backend("hashlib")
    assert root == expected
