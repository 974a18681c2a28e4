"""The port's Fr field and NTT (``crypto/fr.py``, ``ops/fr.py``) against the
JAX package's (``crypto/fr.py``, ``ops/fr_jax.py``).

Every comparison is exact: ``ops.fr.mul`` equals ``fr_jax.mul`` limb for
limb, on reduced Montgomery limbs and on the signed lazy limbs that the
NTT's unrenormalized butterflies feed it; ``ntt_device`` equals
``fr_jax.ntt_device`` and the host ``fft``, forward and inverse; the
port's host field code equals the reference's.  The port runs on the CPU
here (``device="cpu"``); its ``cuda`` variants skip without a card.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import fr as ref_fr
from consensus_specs_tpu.ops import fr_jax
from consensus_specs_tpu_torch.crypto import fr
from consensus_specs_tpu_torch.ops import fr as ofr

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return request.param


def _reduced(rng, n):
    return np.stack([ofr.host_to_mont(int(v) % fr.R)
                     for v in rng.integers(0, 2**63, n)])


def _lazy(rng, n, stages):
    """Signed limbs of the magnitude the NTT's ``stages`` unrenormalized
    butterfly levels reach: sums and differences of reduced values."""
    x = _reduced(rng, n)
    for _ in range(stages):
        sign = rng.choice([-1, 1], size=(n, 1))
        x = x + sign * _reduced(rng, n)
    return x


def _jax_mul(a, b):
    return np.asarray(fr_jax.mul(fr_jax.jnp.asarray(a), fr_jax.jnp.asarray(b)))


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("stages", [0, 1, 14])
def test_mul_equals_fr_jax_limb_for_limb(device, stages):
    rng = np.random.default_rng(1000 + stages)
    a, b = _lazy(rng, 64, stages), _reduced(rng, 64)
    if stages:
        assert (a < 0).any()  # negative lazy limbs are in the sample
    got = ofr.mul(torch.as_tensor(a, device=device),
                  torch.as_tensor(b, device=device)).cpu().numpy()
    np.testing.assert_array_equal(got, _jax_mul(a, b))
    # and the value: mont(a) * mont(b) / R = mont(a * b)
    for i in range(4):
        assert ofr.canonical_int(got[i]) == (
            ofr.canonical_int(a[i]) * ofr.canonical_int(b[i]) % fr.R)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("n", [2, 8, 64])
def test_ntt_equals_fr_jax_and_host_fft(device, n, inv):
    rng = np.random.default_rng(n + inv)
    vals = [int(x) for x in rng.integers(0, 2**63, n)]
    got = ofr.ntt_device(vals, inv=inv, device=device)
    assert got == fr_jax.ntt_device(vals, inv=inv)
    assert got == fr.fft(vals, inv=inv) == ref_fr.fft(vals, inv=inv)


def test_ntt_stage_reads_its_input():
    """Both halves of a butterfly stage read the stage's input: the
    bottom rows' update must not see the top rows' new values."""
    perm, schedule = ofr._ntt_host_precompute(8, fr.root_of_unity(8))
    x = _reduced(np.random.default_rng(3), 8)
    got = ofr._ntt_apply(torch.as_tensor(x), ofr.schedule_on(schedule, "cpu"))
    want = fr_jax._ntt_apply(fr_jax.jnp.asarray(x), schedule)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ntt_keeps_the_lazy_carry_bound():
    assert ofr.MAX_NTT_SIZE == fr_jax.MAX_NTT_SIZE == 1 << 14
    with pytest.raises(AssertionError, match="lazy-carry bound"):
        ofr.ntt_device([0] * (ofr.MAX_NTT_SIZE * 2), device="cpu")


def test_ntt_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ofr.ntt_device([1, 2])


def test_host_field_code_equals_the_reference():
    rng = np.random.default_rng(11)
    vals = [int(x) % fr.R for x in rng.integers(0, 2**63, 32)]
    assert fr.fft(vals) == ref_fr.fft(vals)
    assert fr.ifft(vals) == ref_fr.ifft(vals)
    assert fr.zero_poly([1, 5, 9], 16) == ref_fr.zero_poly([1, 5, 9], 16)
    assert fr.reverse_bit_order_list(vals) == ref_fr.reverse_bit_order_list(vals)
    evals = fr.fft(vals[:16] + [0] * 16)
    samples = [None if i % 3 == 0 else v for i, v in enumerate(evals)]
    assert fr.recover_polynomial(samples) == ref_fr.recover_polynomial(samples) == evals
    assert fr.root_of_unity(1 << 12) == ref_fr.root_of_unity(1 << 12)
