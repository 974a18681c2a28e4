"""The port's KZG (``crypto/kzg.py``, ``ops/kzg.py``) against the JAX
package's (``crypto/kzg.py``, ``ops/kzg_jax.py``) and the host oracle.

Every comparison is exact: one Jacobian doubling and one mixed addition
on 8 lanes equal ``kzg_jax._dbl`` / ``_madd`` (called eagerly) limb for
limb, every degenerate case of the addition among the lanes (P1 at
infinity, equal x with equal y, equal x with opposite y); the 255-step
lane product equals the host's ``p.mul`` on the reference test's lanes
and scalars (``tests/crypto/test_kzg.py``); ``msm`` equals the
reference's ``g1_lincomb``; a commitment's bytes equal the reference's
``blob_to_kzg``.  The lane product against the jitted
``kzg_jax.batch_scalar_mul`` costs the JAX side about 25 s of compile, so
it is ``slow``.  The port runs on the CPU here; on the card its products
are K3 launches, which the ``cuda`` variants count.
"""
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import kzg as ref_kzg
from consensus_specs_tpu.crypto.bls.curve import g1_generator as ref_g1_generator
from consensus_specs_tpu.ops import kzg_jax
from consensus_specs_tpu.ops.bls_jax import limbs as jlimbs
from consensus_specs_tpu_torch.crypto import fr, kzg
from consensus_specs_tpu_torch.crypto.bls.curve import g1_generator, g1_to_bytes
from consensus_specs_tpu_torch.ops import kzg as okzg
from consensus_specs_tpu_torch.ops.bls import limbs

rng = random.Random(1717)
G = g1_generator()
# the reference test's lanes: [1..8] G and structured scalars
POINTS = [G.mul(i + 1) for i in range(8)]
SCALARS = [0, 1, 2, fr.R - 1, rng.randrange(fr.R), rng.randrange(fr.R),
           (fr.R + 1) // 2, 3]
BLOB = [rng.randrange(fr.R) for _ in range(16)]

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return request.param


def _mont(v: int) -> np.ndarray:
    return limbs.host_to_mont(v)


def _jacobian(p, z: int):
    """Montgomery limbs of (x z^2, y z^3, z) for the affine point p."""
    x, y = (c.n for c in p.to_affine())
    return (_mont(x * z * z % limbs.P_INT), _mont(y * z ** 3 % limbs.P_INT),
            _mont(z))


def _degenerate_lanes():
    """8 lanes of (X1, Y1, Z1, x2, y2): generic sums, P1 at infinity, P1 =
    P2 (the doubling branch) and P1 = -P2 (the sum is infinity)."""
    lane_rng = random.Random(5)
    rows = []
    for lane in range(8):
        p2 = G.mul(lane_rng.randrange(1, fr.R))
        z = lane_rng.randrange(1, limbs.P_INT)
        if lane == 1:
            p1 = (np.zeros(16, np.int64), _mont(1), np.zeros(16, np.int64))
        elif lane == 2:
            p1 = _jacobian(p2, z)
        elif lane == 3:
            p1 = _jacobian(-p2, z)
        else:
            p1 = _jacobian(G.mul(lane_rng.randrange(1, fr.R)), z)
        rows.append((*p1, *(_mont(c.n) for c in p2.to_affine())))
    return [np.stack(column) for column in zip(*rows)]


def _jax(fn, *arrays):
    return [np.asarray(a) for a in fn(*(jlimbs.jnp.asarray(a) for a in arrays))]


def _port(fn, *arrays):
    return [a.numpy() for a in fn(*(torch.as_tensor(a) for a in arrays))]


def test_dbl_equals_kzg_jax_limb_for_limb():
    X1, Y1, Z1, _, _ = _degenerate_lanes()
    got = _port(okzg._dbl, X1, Y1, Z1)
    for a, b in zip(got, _jax(kzg_jax._dbl, X1, Y1, Z1)):
        np.testing.assert_array_equal(a, b)
    # P1 at infinity stays there
    assert limbs.host_from_mont(got[2][1]) == 0


def test_madd_equals_kzg_jax_limb_for_limb_in_every_degenerate_case():
    lanes = _degenerate_lanes()
    got = _port(okzg._madd, *lanes)
    for a, b in zip(got, _jax(kzg_jax._madd, *lanes)):
        np.testing.assert_array_equal(a, b)
    X, Y, Z = got
    points = okzg.limbs_to_points(*(limbs.canonical(torch.as_tensor(a)).numpy()
                                    for a in (X, Y, Z)))
    x2, y2 = lanes[3][1], lanes[4][1]
    assert points[1].to_affine()[0].n == limbs.host_from_mont(x2)  # inf + P2
    assert points[1].to_affine()[1].n == limbs.host_from_mont(y2)
    assert points[3].is_infinity()  # P + (-P)
    p2 = okzg.limbs_to_points(lanes[3][2:3], lanes[4][2:3],
                              np.stack([_mont(1)]))[0]
    assert points[2] == p2.double()  # P + P


@pytest.fixture(scope="module")
def lanes():
    """The reference test's 8 lanes and a 16-element blob's lanes on the
    Lagrange setup, as one 24-lane product on the CPU."""
    setup = kzg.setup_lagrange(16)
    return okzg.batch_scalar_mul(POINTS + setup, SCALARS + BLOB, device="cpu")


def test_batch_scalar_mul_equals_the_host(lanes):
    for p, s, out in zip(POINTS, SCALARS, lanes[:8]):
        assert out == p.mul(s % fr.R), f"lane with scalar {s}"


def test_blob_commitment_bytes_equal_the_reference(lanes):
    ref = ref_kzg.blob_to_kzg(BLOB, ref_kzg.setup_lagrange(16))
    assert kzg.blob_to_kzg(BLOB, kzg.setup_lagrange(16)) == ref
    assert g1_to_bytes(okzg.lane_sum(lanes[8:])) == ref
    assert kzg.verify_commitment_matches_poly(ref, BLOB)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_msm_equals_the_reference_lincomb(device):
    setup = kzg.setup_lagrange(8)
    blob = BLOB[:8]
    limbs.reset_counts()
    got = okzg.msm(setup, blob, device=device)
    ref = ref_kzg.g1_lincomb(ref_kzg.setup_lagrange(8), blob)
    assert g1_to_bytes(got) == g1_to_bytes(ref)
    # on the card every product is a K3 launch: 28 a bit-plane and the
    # three final canonicalizations
    assert limbs.counts["fq_mul"] == (28 * okzg.N_BITS + 3 if device == "cuda" else 0)


def test_native_fixed_base_msm_equals_the_reference():
    setup = kzg.setup_lagrange(16)
    got = kzg.g1_msm_native(setup, BLOB, fixed_base=True)
    assert got == ref_kzg.g1_msm_native(ref_kzg.setup_lagrange(16), BLOB,
                                        fixed_base=True)
    assert got == g1_to_bytes(kzg.g1_lincomb(setup, BLOB))


def test_to_bits_equals_kzg_jax():
    scalars = SCALARS + [fr.R, 2 * fr.R + 5, 2**255 - 1]
    np.testing.assert_array_equal(okzg.to_bits(scalars), kzg_jax._to_bits(scalars))


def test_setups_equal_the_reference():
    assert [g1_to_bytes(p) for p in kzg.setup_lagrange(16)] == [
        ref_kzg.g1_to_bytes(p) for p in ref_kzg.setup_lagrange(16)]
    assert [g1_to_bytes(p) for p in kzg.setup_monomial(4)] == [
        ref_kzg.g1_to_bytes(p) for p in ref_kzg.setup_monomial(4)]


def test_msm_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        okzg.msm(POINTS[:1], [1])


@pytest.mark.slow
def test_lane_product_equals_kzg_jax_batch_scalar_mul():
    setup = kzg.setup_lagrange(16)
    got = okzg.batch_scalar_mul(POINTS + setup, SCALARS + BLOB, device="cpu")
    ref_points = [ref_g1_generator().mul(i + 1) for i in range(8)]
    want = kzg_jax.batch_scalar_mul(ref_points + ref_kzg.setup_lagrange(16),
                                    SCALARS + BLOB)
    assert [g1_to_bytes(p) for p in got] == [ref_kzg.g1_to_bytes(p) for p in want]
