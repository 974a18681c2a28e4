"""The port's Fq limb arithmetic (``ops/bls/limbs.py``) against the JAX
package's (``ops/bls_jax/limbs.py``) and python ints.

Inputs are made with numpy from a seed: random residues, lazy signed sums
of up to 8 of them (limbs up to 2^29, values up to 8p), values at the
edges (0, p, 3p, 36p, -36p).  Both packages get the same limbs; their
outputs must be equal limb for limb and as canonical values (tolerance 0:
every output is an integer), and ``mul``'s output must keep its contract
(digits in [0, 2^26), value below 3p).  K3, the CUDA kernel behind
``limbs.mul``, is held against the plain version on the card (``cuda``
marker; skips here without one).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_specs_tpu.ops.bls_jax import limbs as ref
from consensus_specs_tpu_torch.ops.bls import limbs

P = limbs.P_INT
SEED = 8


def residues(rng, n: int) -> np.ndarray:
    """n random residues below p as canonical limbs."""
    return np.stack([limbs.int_to_limbs(int.from_bytes(rng.bytes(48), "big") % P)
                     for _ in range(n)])


def lazy(rng, n: int) -> np.ndarray:
    """Signed sums of up to 8 residues: K3's operand envelope."""
    acc = np.zeros((n, limbs.N_LIMBS), dtype=np.int64)
    for _ in range(8):
        acc += rng.integers(-1, 2, (n, 1)) * residues(rng, n)
    return acc


EDGES = [0, 1, P - 1, P, P + 1, 2 * P, 3 * P - 1, 36 * P]


def operands(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = np.stack([limbs.int_to_limbs(x) for x in EDGES])
    return np.concatenate([residues(rng, 8), lazy(rng, 8), edges, -edges])


@pytest.fixture(scope="module")
def ab():
    a, b = operands(SEED), operands(SEED + 1)
    return a, b[np.random.default_rng(SEED).permutation(len(b))]


def value(row) -> int:
    return limbs.limbs_to_int(row)


def test_constants_match_the_reference():
    assert limbs.P_INT == ref.P_INT and limbs.N0INV_INT == ref.N0INV_INT
    for name in ("P_LIMBS", "R2_LIMBS", "ONE_LIMBS", "MONT_ONE_LIMBS"):
        assert np.array_equal(getattr(limbs, name), getattr(ref, name)), name


def test_host_conversions_round_trip():
    rng = np.random.default_rng(SEED)
    for x in [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "big") % P
                              for _ in range(8)]:
        assert limbs.limbs_to_int(limbs.int_to_limbs(x)) == x
        assert limbs.host_from_mont(limbs.host_to_mont(x)) == x
        assert np.array_equal(limbs.host_to_mont(x), ref.host_to_mont(x))


def test_mul_equals_reference_and_keeps_its_contract(ab):
    a, b = ab
    got = limbs.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(ref.mul(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    assert ((got >= 0) & (got <= limbs.MASK)).all()
    r_inv = pow(limbs.R_INT, -1, P)
    for i in range(len(a)):
        v = value(got[i])
        assert 0 <= v < 3 * P
        assert v % P == value(a[i]) * value(b[i]) * r_inv % P


def test_square_and_broadcast_operands(ab):
    a, _ = ab
    ta = torch.from_numpy(a)
    assert torch.equal(limbs.square(ta), limbs.mul(ta, ta))
    # a [N, 16] row against one [16] constant, as the tower's scalings do
    one = torch.from_numpy(limbs.MONT_ONE_LIMBS)
    got = limbs.mul(ta, one).numpy()
    want = np.asarray(ref.mul(jnp.asarray(a), jnp.asarray(limbs.MONT_ONE_LIMBS)))
    assert np.array_equal(got, want)


def test_renorm_and_canonical(ab):
    a, _ = ab
    got = limbs.renorm(torch.from_numpy(a)).numpy()
    assert np.array_equal(got, np.asarray(ref.renorm(jnp.asarray(a))))
    assert ((got[:, :-1] >= 0) & (got[:, :-1] <= limbs.MASK)).all()
    assert [value(r) for r in got] == [value(r) for r in a]
    canon = limbs.canonical(torch.from_numpy(a)).numpy()
    assert np.array_equal(canon, np.asarray(ref.canonical(jnp.asarray(a))))
    for i in range(len(a)):
        assert value(canon[i]) == value(a[i]) % P


def test_mont_round_trip_and_cond_sub_p():
    rng = np.random.default_rng(SEED + 2)
    plain = np.concatenate([residues(rng, 6),
                            np.stack([limbs.int_to_limbs(x) for x in (0, 1, P - 1)])])
    mont = limbs.to_mont(torch.from_numpy(plain))
    assert np.array_equal(mont.numpy(), np.asarray(ref.to_mont(jnp.asarray(plain))))
    back = limbs.from_mont(mont).numpy()
    assert np.array_equal(back, plain)
    # cond_sub_p on canonical digits in [0, 2p)
    two = np.stack([limbs.int_to_limbs(x) for x in (0, P - 1, P, P + 5, 2 * P - 1)])
    got = limbs.cond_sub_p(torch.from_numpy(two)).numpy()
    assert np.array_equal(got, np.asarray(ref.cond_sub_p(jnp.asarray(two))))
    assert [value(r) for r in got] == [0, P - 1, 0, 5, P - 1]
    assert limbs.eq_canonical(torch.from_numpy(two[:1]),
                              torch.from_numpy(two[:1])).all()
    assert limbs.is_zero_canonical(torch.from_numpy(two[:1])).all()


def test_inv():
    rng = np.random.default_rng(SEED + 3)
    xs = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(2)] + [1]
    a = np.stack([limbs.host_to_mont(x) for x in xs])
    got = limbs.inv(torch.from_numpy(a)).numpy()
    # the same chain of products, so the same limbs (and canonical values)
    assert np.array_equal(got, np.asarray(ref.inv(jnp.asarray(a))))
    for x, row in zip(xs, got):
        assert limbs.host_from_mont(row) == pow(x, P - 2, P)


def test_mul_refuses_what_it_does_not_take():
    a = torch.zeros(2, limbs.N_LIMBS, dtype=torch.int64)
    with pytest.raises(TypeError):
        limbs.mul(a.to(torch.int32), a)
    with pytest.raises(ValueError):
        limbs.mul(a[:, :8], a[:, :8])


# -- K3 on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K3 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4096])
def test_k3_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(lazy(rng, n)).to(cuda_device)
    b = torch.from_numpy(lazy(rng, n)).to(cuda_device)
    before = limbs.counts["fq_mul"]
    got = limbs.mul(a, b)
    torch.cuda.synchronize()
    assert limbs.counts["fq_mul"] == before + 1
    assert torch.equal(got, limbs.mul_plain(a, b))
    assert torch.equal(limbs.canonical(got).cpu(),
                       limbs.canonical(limbs.mul_plain(a.cpu(), b.cpu())))
    assert torch.equal(limbs.renorm(a).cpu(), limbs.renorm(a.cpu()))
