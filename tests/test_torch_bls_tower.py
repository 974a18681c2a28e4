"""The port's Fq2 / Fq6 / Fq12 tower (``ops/bls/tower.py``) against the JAX
package's (``ops/bls_jax/tower.py``) on the same limbs, and against the
pure-int oracle (``crypto/bls/fields.py``).

Elements are drawn with numpy from a seed, two of each a call.  Every op
must equal the oracle as field values, and the JAX package's limb for
limb (tolerance 0).  The JAX package runs its tower eagerly, compiling
each primitive at each new shape, which costs seconds an op on the CPU,
so the cheap conjugation and Frobenius maps meet it here and every other
op in the ``slow`` test at the end.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_specs_tpu.ops.bls_jax import tower as ref
from consensus_specs_tpu_torch.crypto.bls.fields import Fq2, Fq6, Fq12, P
from consensus_specs_tpu_torch.ops.bls import limbs, tower

SEED = 12


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(SEED)


def rand_fq(rng) -> int:
    return int.from_bytes(rng.bytes(48), "big") % P


def rand_fq2(rng) -> Fq2:
    return Fq2(rand_fq(rng), rand_fq(rng))


def rand_fq12(rng) -> Fq12:
    return Fq12(Fq6(rand_fq2(rng), rand_fq2(rng), rand_fq2(rng)),
                Fq6(rand_fq2(rng), rand_fq2(rng), rand_fq2(rng)))


def h2(x: Fq2) -> np.ndarray:
    return np.stack([limbs.host_to_mont(x.c0), limbs.host_to_mont(x.c1)])


def h6(x: Fq6) -> np.ndarray:
    return np.stack([h2(x.c0), h2(x.c1), h2(x.c2)])


def from2(a) -> Fq2:
    return Fq2(limbs.host_from_mont(a[0]), limbs.host_from_mont(a[1]))


def from6(a) -> Fq6:
    return Fq6(from2(a[0]), from2(a[1]), from2(a[2]))


def both(fn_port, fn_ref, *args):
    """The port's and the JAX package's outputs on the same limbs (numpy)."""
    got = port(fn_port, *args)
    want = np.asarray(fn_ref(*(jnp.asarray(a) for a in args)))
    assert np.array_equal(got, want)
    return got


def port(fn, *args):
    return fn(*(torch.from_numpy(a) for a in args)).numpy()


def fq2_inputs(rng):
    xs = [rand_fq2(rng) for _ in range(2)]
    ys = [rand_fq2(rng) for _ in range(2)]
    return xs, ys, np.stack([h2(x) for x in xs]), np.stack([h2(y) for y in ys])


def fq6_inputs(rng):
    xs = [Fq6(rand_fq2(rng), rand_fq2(rng), rand_fq2(rng)) for _ in range(2)]
    ys = [Fq6(rand_fq2(rng), rand_fq2(rng), rand_fq2(rng)) for _ in range(2)]
    return xs, ys, np.stack([h6(x) for x in xs]), np.stack([h6(y) for y in ys])


def test_fq2_ops(rng):
    xs, ys, a, b = fq2_inputs(rng)
    prod = port(tower.fq2_mul, a, b)
    sq = port(tower.fq2_square, a)
    inv = port(tower.fq2_inv, a)
    xi = port(tower.fq2_mul_by_xi, a)
    conj = port(tower.fq2_conj, a)
    scaled = port(tower.fq2_scale_fq, a, b[:, 0])
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert from2(prod[i]) == x * y
        assert from2(sq[i]) == x * x
        assert from2(inv[i]) == x.inv()
        assert from2(xi[i]) == x * Fq2(1, 1)
        assert from2(conj[i]) == Fq2(x.c0, -x.c1)
        assert from2(scaled[i]) == x * Fq2(y.c0, 0)
    assert tower.fq2_eq(torch.from_numpy(a), torch.from_numpy(a)).all()
    assert not tower.fq2_eq(torch.from_numpy(a), torch.from_numpy(b)).any()


def test_fq6_ops(rng):
    xs, ys, a, b = fq6_inputs(rng)
    prod = port(tower.fq6_mul, a, b)
    inv = port(tower.fq6_inv, a)
    by_v = port(tower.fq6_mul_by_v, a)
    v = Fq6(Fq2(0, 0), Fq2(1, 0), Fq2(0, 0))
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert from6(prod[i]) == x * y
        assert from6(inv[i]) == x.inv()
        assert from6(by_v[i]) == x * v


def test_fq12_mul_square_conj(rng):
    xs = [rand_fq12(rng) for _ in range(2)]
    ys = [rand_fq12(rng) for _ in range(2)]
    a = np.stack([tower.host_fq12_from_oracle(x) for x in xs])
    b = np.stack([tower.host_fq12_from_oracle(y) for y in ys])
    prod = port(tower.fq12_mul, a, b)
    sq = port(tower.fq12_square, a)
    conj = both(tower.fq12_conj, ref.fq12_conj, a)
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert tower.host_fq12_to_oracle(prod[i]) == x * y
        assert tower.host_fq12_to_oracle(sq[i]) == x.square()
        assert tower.host_fq12_to_oracle(conj[i]) == x.conjugate()
    assert tower.fq12_eq(torch.from_numpy(prod),
                         tower.fq12_mul(torch.from_numpy(b),
                                        torch.from_numpy(a))).all()


def test_fq12_inv(rng):
    xs = [rand_fq12(rng) for _ in range(2)]
    a = np.stack([tower.host_fq12_from_oracle(x) for x in xs])
    inv = port(tower.fq12_inv, a)
    for i, x in enumerate(xs):
        assert tower.host_fq12_to_oracle(inv[i]) == x.inv()
        assert tower.host_fq12_to_oracle(inv[i]) * x == Fq12.one()


def test_fq12_frobenius(rng):
    xs = [rand_fq12(rng) for _ in range(2)]
    a = np.stack([tower.host_fq12_from_oracle(x) for x in xs])
    f1 = both(tower.fq12_frob1, ref.fq12_frob1, a)
    f2 = both(tower.fq12_frob2, ref.fq12_frob2, a)
    for i, x in enumerate(xs):
        assert tower.host_fq12_to_oracle(f1[i]) == x.pow(P)
        assert tower.host_fq12_to_oracle(f2[i]) == x.pow(P * P)


def test_fq12_mul_line_matches_full_mul(rng):
    xs = [rand_fq12(rng) for _ in range(2)]
    ls = [[rand_fq2(rng) for _ in range(3)] for _ in range(2)]
    a = np.stack([tower.host_fq12_from_oracle(x) for x in xs])
    l0, l3, l5 = (np.stack([h2(line[j]) for line in ls]) for j in range(3))
    got = port(tower.fq12_mul_line, a, l0, l3, l5)
    zero = Fq2(0, 0)
    for i, (x, (m0, m3, m5)) in enumerate(zip(xs, ls)):
        # the sparse element with w-slots {0, 3, 5}
        sparse = Fq12(Fq6(m0, zero, zero), Fq6(zero, m3, m5))
        assert tower.host_fq12_to_oracle(got[i]) == x * sparse


def test_host_conversions_match_the_reference(rng):
    x = rand_fq12(rng)
    arr = tower.host_fq12_from_oracle(x)
    assert np.array_equal(arr, ref.host_fq12_from_oracle(x))
    assert tower.host_fq12_to_oracle(arr) == x
    assert np.array_equal(tower.FQ12_ONE_LIMBS, ref.FQ12_ONE_LIMBS)
    assert np.array_equal(tower._FROB1_C, np.asarray(ref._FROB1_C))
    assert np.array_equal(tower._FROB2_C, np.asarray(ref._FROB2_C))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["fq2_mul", "fq2_square", "fq2_inv",
                                  "fq2_mul_by_xi", "fq2_conj", "fq2_scale_fq",
                                  "fq6_mul", "fq6_inv", "fq6_mul_by_v",
                                  "fq12_mul", "fq12_square", "fq12_mul_line",
                                  "fq12_inv"])
def test_tower_ops_equal_the_jax_package(rng, name):
    if name.startswith("fq12"):
        a, b = (np.stack([tower.host_fq12_from_oracle(rand_fq12(rng))
                          for _ in range(2)]) for _ in range(2))
        args = {"fq12_mul": (a, b),
                "fq12_mul_line": (a, b[:, 0], b[:, 3], b[:, 5])
                }.get(name, (a,))
    elif name.startswith("fq2"):
        _, _, a, b = fq2_inputs(rng)
        args = (a, b[:, 0]) if name == "fq2_scale_fq" else (
            (a, b) if name == "fq2_mul" else (a,))
    else:
        _, _, a, b = fq6_inputs(rng)
        args = (a, b) if name == "fq6_mul" else (a,)
    both(getattr(tower, name), getattr(ref, name), *args)
