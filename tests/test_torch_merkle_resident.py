"""The fused epoch balance update and merkle root of the torch port against
the reference (``consensus_specs_tpu.ops.merkle_resident``) and against
the SSZ host hasher.  Exact equality: balances are integers, roots bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import merkle_resident as ref_mr
from consensus_specs_tpu.ssz.impl import hash_tree_root as ref_hash_tree_root
from consensus_specs_tpu.ssz.types import List as RefList
from consensus_specs_tpu.ssz.types import uint64 as ref_uint64
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.ssz import bulk
from consensus_specs_tpu_torch.ssz.types import List, uint64
from tests.test_torch_epoch import _inputs

LIMIT = 2**40


def _ssz_root(values) -> bytes:
    return bytes(ref_hash_tree_root(RefList[ref_uint64, LIMIT](*map(int, values))))


@pytest.mark.parametrize("n_chunks", [1, 2, 64, 1024])
def test_reduce_to_root_matches_reference(n_chunks):
    rng = np.random.default_rng(n_chunks)
    values = rng.integers(0, 2**63, 4 * n_chunks, dtype=np.uint64)
    halves = values.view("<u4").reshape(-1, 2)
    ref = np.asarray(ref_mr._jit_reduce(jnp.asarray(halves[:, 0].copy()),
                                        jnp.asarray(halves[:, 1].copy())))
    lo = torch.as_tensor(halves[:, 0].astype(np.int64))
    hi = torch.as_tensor(halves[:, 1].astype(np.int64))
    got = merkle_resident._reduce_to_root(lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8,)
    assert np.array_equal(got.numpy().view(np.uint32), ref)


def _u64_patterns(n_values, seed):
    """Seeded uint64 values over the whole range, with the top bit set in
    some and all-ones / sign-bit-only patterns at the ends."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**64, n_values, dtype=np.uint64)
    values[0] = 2**64 - 1
    values[-1] = 2**63
    return values


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 64, 512, 1024, 4096])
def test_packed_u64_root_matches_reference(n_chunks):
    values = _u64_patterns(4 * n_chunks, seed=n_chunks)
    halves = values.view("<u4").reshape(-1, 2)
    ref = np.asarray(ref_mr._jit_reduce(jnp.asarray(halves[:, 0].copy()),
                                        jnp.asarray(halves[:, 1].copy())))
    got = merkle_resident.packed_u64_root(torch.from_numpy(values.view(np.int64)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8,)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    port = merkle_resident._reduce_to_root(
        torch.as_tensor(halves[:, 0].astype(np.int64)),
        torch.as_tensor(halves[:, 1].astype(np.int64)))
    assert torch.equal(got, port)


@pytest.mark.parametrize("values,error", [
    (torch.zeros(8, dtype=torch.int32), TypeError),          # dtype
    (torch.zeros((16, 2), dtype=torch.int64).t()[0], ValueError),  # strided
    (torch.zeros(6, dtype=torch.int64), ValueError),         # not 4 * k
    (torch.zeros(12, dtype=torch.int64), ValueError),        # 3 chunks
    (torch.zeros(0, dtype=torch.int64), ValueError),         # no chunk
    (torch.zeros(9, dtype=torch.int64)[1:], ValueError),     # 8-byte offset
])
def test_packed_u64_root_refuses_bad_inputs(values, error):
    with pytest.raises(error):
        merkle_resident.packed_u64_root(values)


def test_add_u64_matches_reference():
    rng = np.random.default_rng(5)
    lo, hi, dlo, dhi = (rng.integers(0, 2**32, 4096, dtype=np.uint64)
                        .astype(np.uint32) for _ in range(4))
    lo[:64] = 0xFFFFFFFF  # carries
    ref_lo, ref_hi = ref_mr._jit_add(*map(jnp.asarray, (lo, hi, dlo, dhi)))
    got_lo, got_hi = merkle_resident._add_u64(
        *(torch.as_tensor(a.astype(np.int64)) for a in (lo, hi, dlo, dhi)))
    assert np.array_equal(got_lo.numpy(), np.asarray(ref_lo).astype(np.int64))
    assert np.array_equal(got_hi.numpy(), np.asarray(ref_hi).astype(np.int64))


@pytest.mark.parametrize("n,finality_delay", [(4096, 2), (20_000, 5)])
def test_fused_update_matches_reference_and_ssz(n, finality_delay):
    inp, balances = _inputs(n, finality_delay)
    ref_bal, ref_root = ref_mr.fused_epoch_balance_update(
        inp, balances, jax.devices("cpu")[0])
    before = merkle_resident.stats["fused_epoch_updates"]
    new_bal, root = merkle_resident.fused_epoch_balance_update(
        inp, balances, device="cpu")
    assert merkle_resident.stats["fused_epoch_updates"] == before + 1
    assert np.array_equal(new_bal, ref_bal)
    assert root == ref_root
    # the padded-subtree root is the SSZ contents root of the new balances
    # at the padded depth: fold it up and mix in the length
    lst = List[uint64, LIMIT]()
    bulk.set_packed_uint64_from_numpy(lst, new_bal)
    merkle_resident.memoize_packed_u64_contents_root(lst, root)
    assert bytes(lst.hash_tree_root()) == _ssz_root(new_bal)


@pytest.mark.parametrize("n", [16_384, 20_000])
def test_memoized_contents_root_matches_host(n):
    """memoize_packed_u64_contents_root installs the root the host hasher
    would have produced, with the root from the port's reduction."""
    rng = np.random.default_rng(n)
    values = rng.integers(0, 2**63, n, dtype=np.uint64)
    n_pad = 1 << (n - 1).bit_length()
    padded = np.zeros(n_pad, dtype=np.uint64)
    padded[:n] = values
    halves = torch.as_tensor(padded.view("<u4").reshape(-1, 2).astype(np.int64))
    words = merkle_resident._reduce_to_root(halves[:, 0], halves[:, 1])
    padded_root = words.numpy().view(np.uint32).astype(">u4").tobytes()

    lst = List[uint64, LIMIT]()
    bulk.set_packed_uint64_from_numpy(lst, values)
    before = merkle_resident.stats["roots_memoized"]
    merkle_resident.memoize_packed_u64_contents_root(lst, padded_root)
    assert merkle_resident.stats["roots_memoized"] == before + 1
    assert lst.get_backing().left._root is not None, "root was not memoized"
    assert bytes(lst.hash_tree_root()) == _ssz_root(values)


def test_resident_device_gates_on_size_only():
    assert merkle_resident.resident_device(merkle_resident.RESIDENT_MIN - 1,
                                           "cpu") is None
    assert merkle_resident.resident_device(merkle_resident.RESIDENT_MIN,
                                           "cpu") == torch.device("cpu")


# -- K2 on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 2, 512, 1024, 1 << 17, 1 << 19])
def test_k2_matches_plain(cuda_device, n_chunks):
    """One, two and three passes (2^19 chunks); the count is what the
    launcher reports it ran."""
    from consensus_specs_tpu_torch.ops import sha256

    values = _u64_patterns(4 * n_chunks, seed=n_chunks)
    dev = torch.from_numpy(values.view(np.int64)).to(cuda_device)
    before = sha256.counts["u64_list_root"]
    got = merkle_resident.packed_u64_root(dev)
    torch.cuda.synchronize()
    assert sha256.counts["u64_list_root"] - before == sha256.k2_plan(n_chunks)[0]
    plain = merkle_resident.packed_u64_root(dev.cpu())
    assert torch.equal(got.cpu(), plain)
