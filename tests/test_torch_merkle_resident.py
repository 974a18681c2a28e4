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


def test_resident_device_gates_on_size_only(monkeypatch):
    """The reference's policy: the CPU stays on the host hashing path at
    any size unless ``RESIDENT_ON_CPU`` forces the route; a CUDA device is
    gated by the size alone (the policy reads no card)."""
    n_min = merkle_resident.RESIDENT_MIN
    assert merkle_resident.RESIDENT_ON_CPU is False
    for n in (0, n_min - 1, n_min, 400_000, 2**40):
        assert merkle_resident.resident_device(n, "cpu") is None
        assert merkle_resident.resident_device(n, torch.device("cpu")) is None
    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)
    assert merkle_resident.resident_device(n_min - 1, "cpu") is None
    assert merkle_resident.resident_device(n_min, "cpu") == torch.device("cpu")
    for forced in (True, False):
        monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", forced)
        assert merkle_resident.resident_device(n_min - 1, "cuda") is None
        assert merkle_resident.resident_device(n_min, "cuda") == torch.device("cuda")
        assert merkle_resident.resident_device(
            400_000, "cuda:0") == torch.device("cuda:0")


# -- K2 on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1 << k for k in range(21)])
def test_k2_matches_plain(cuda_device, n_chunks):
    """Every power of two from 1 to 2^20 chunks: one pass up to 1,024
    chunks, two above; the count is what the launcher reports it ran."""
    from consensus_specs_tpu_torch.ops import sha256

    values = _u64_patterns(4 * n_chunks, seed=n_chunks)
    dev = torch.from_numpy(values.view(np.int64)).to(cuda_device)
    before = sha256.counts["u64_list_root"]
    got = merkle_resident.packed_u64_root(dev)
    torch.cuda.synchronize()
    assert sha256.counts["u64_list_root"] - before == sha256.k2_plan(n_chunks)[0]
    plain = merkle_resident.packed_u64_root(dev.cpu())
    assert torch.equal(got.cpu(), plain)


# -- ResidentPackedU64List ----------------------------------------------------


def _near_wrap_patterns(n_values, seed):
    """Seeded uint64 values with the ones next to 2^63 and 2^64 first."""
    values = _u64_patterns(n_values, seed)
    edges = np.array([2**64 - 1, 2**64 - 2, 2**63 - 1, 2**63, 0, 1],
                     dtype=np.uint64)
    values[: min(n_values, len(edges))] = edges[:n_values]
    return values


@pytest.mark.parametrize("n", [1, 2, 5, 16_384])
def test_resident_list_matches_reference(n):
    values = _near_wrap_patterns(n, seed=n)
    ref = ref_mr.ResidentPackedU64List(LIMIT, device=jax.devices("cpu")[0])
    ref.upload(values)
    got = merkle_resident.ResidentPackedU64List(LIMIT, device="cpu")
    got.upload(values)
    assert got.length == n
    assert np.array_equal(got.to_numpy(), ref.to_numpy())
    assert got.contents_subtree_root() == ref.contents_subtree_root()
    assert got.root() == ref.root() == _ssz_root(values)
    # an int64 tensor of the same bit patterns is the same list
    from_tensor = merkle_resident.ResidentPackedU64List(LIMIT, device="cpu")
    from_tensor.upload(torch.from_numpy(values.view(np.int64)))
    assert from_tensor.root() == ref.root()


def _deltas(kind, n, rng):
    """(reference delta, port delta, the delta as int64 numpy) of a kind."""
    if kind == "scalar":
        return 3, 3, np.full(n, 3, dtype=np.int64)
    if kind == "negative_scalar":
        return -5, -5, np.full(n, -5, dtype=np.int64)
    vector = rng.integers(-2**63, 2**63, n, dtype=np.int64)
    vector[: min(n, 4)] = np.array([-1, 1, -2**63, 2**63 - 1])[: min(n, 4)]
    if kind == "vector":
        return vector, vector.copy(), vector
    return jnp.asarray(vector), torch.from_numpy(vector.copy()), vector


@pytest.mark.parametrize("kind", ["scalar", "negative_scalar", "vector", "tensor"])
@pytest.mark.parametrize("n", [5, 1024])
def test_resident_list_apply_add_wraps_like_reference(kind, n):
    """Adds are exact mod 2^64: against the reference's carry add and
    numpy's uint64 wraparound, twice in a row."""
    rng = np.random.default_rng(n)
    values = _near_wrap_patterns(n, seed=n + 1)
    ref = ref_mr.ResidentPackedU64List(LIMIT, device=jax.devices("cpu")[0])
    ref.upload(values)
    got = merkle_resident.ResidentPackedU64List(LIMIT, device="cpu")
    got.upload(values)
    want = values.copy()
    for _ in range(2):
        ref_delta, delta, as_int64 = _deltas(kind, n, rng)
        ref.apply_add(ref_delta)
        got.apply_add(delta)
        want = want + as_int64.view(np.uint64)  # numpy wraps uint64 mod 2^64
        assert np.array_equal(got.to_numpy(), want)
        assert np.array_equal(got.to_numpy(), ref.to_numpy())
        assert got.root() == ref.root()


def test_resident_list_refuses_non_int64_tensors():
    lst = merkle_resident.ResidentPackedU64List(LIMIT, device="cpu")
    with pytest.raises(TypeError):
        lst.upload(torch.zeros(4, dtype=torch.int32))
    lst.upload(np.arange(4, dtype=np.uint64))
    with pytest.raises(TypeError):
        lst.apply_add(torch.ones(4, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted({5, 100_000} | {4 << k for k in range(21)}))
def test_resident_list_root_on_the_card(cuda_device, n):
    """``contents_subtree_root`` on the card (K2) against the plain
    version on the CPU, before and after a wrapping add: every power of
    two from 1 to 2^20 chunks (4 << k values), and two lengths that pad."""
    from consensus_specs_tpu_torch.ops import sha256

    values = _near_wrap_patterns(n, seed=n)
    on_card = merkle_resident.ResidentPackedU64List(LIMIT, device=cuda_device)
    on_card.upload(values)
    plain = merkle_resident.ResidentPackedU64List(LIMIT, device="cpu")
    plain.upload(values)
    n_chunks = on_card._values.shape[0] // 4
    before = sha256.counts["u64_list_root"]
    assert on_card.contents_subtree_root() == plain.contents_subtree_root()
    assert sha256.counts["u64_list_root"] - before == sha256.k2_plan(n_chunks)[0]
    on_card.apply_add(-7)
    plain.apply_add(-7)
    assert np.array_equal(on_card.to_numpy(), plain.to_numpy())
    assert on_card.root() == plain.root()
