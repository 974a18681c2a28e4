"""The port's batched pairing (``ops/bls/pairing.py``) against the JAX
package's (``ops/bls_jax/pairing.py``) at K = 2 pairs and B = 2 items,
the shapes the JAX package's own tests compile, and against the oracle.

* the Miller doubling and addition steps and the squaring run: equal to
  the JAX package's limb for limb (tolerance 0: every output is an
  integer);
* the doubling run at n = 1 and at the longest segment of |x|, on real
  points: T against the oracle's doublings, f against the oracle's Fq12
  products of each step's lines;
* the whole product check on signature pairs: its verdicts are the
  signatures' (one valid, one on another message), and every operand pair the pipeline hands to ``limbs.mul``
  lies in the envelope K3 takes (limbs below 2^29, products below R*p);
* the HHT identity the final exponentiation rests on, exactly;
* ``slow``: the doubling run, the Miller product and the final
  exponentiation against the JAX package's jitted pipeline (about 6 s of
  XLA cache loads a process for the run alone, 20 s for the whole
  pipeline, on the CPU);
* ``cuda``: K4 and K5 against their plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_specs_tpu.ops.bls_jax import pairing as ref
from consensus_specs_tpu_torch.crypto.bls import native
from consensus_specs_tpu_torch.crypto.bls.curve import (
    g1_generator, g2_generator, pubkey_to_point, signature_to_point)
from consensus_specs_tpu_torch.crypto.bls.fields import Fq2, Fq6, Fq12, P, R, X_PARAM
from consensus_specs_tpu_torch.ops import bls as device_bls
from consensus_specs_tpu_torch.ops.bls import limbs, pairing, tower

K, B = 2, 2
SEED = 9


def residues(rng, *shape) -> np.ndarray:
    out = np.zeros(shape + (limbs.N_LIMBS,), dtype=np.int64)
    flat = out.reshape(-1, limbs.N_LIMBS)
    for i in range(flat.shape[0]):
        flat[i] = limbs.host_to_mont(int.from_bytes(rng.bytes(48), "big") % P)
    return out


@pytest.fixture(scope="module")
def state():
    """f, T = (X, Y, Z) and P = (px, py) for K pairs of B items."""
    rng = np.random.default_rng(SEED)
    return {"f": residues(rng, B, 6, 2), "X": residues(rng, K, B, 2),
            "Y": residues(rng, K, B, 2), "Z": residues(rng, K, B, 2),
            "qx": residues(rng, K, B, 2), "qy": residues(rng, K, B, 2),
            "px": residues(rng, K, B), "py": residues(rng, K, B)}


def port(fn, *args, **kw):
    out = fn(*(torch.from_numpy(a) for a in args), **kw)
    if isinstance(out, tuple):
        return [o.numpy() for o in out]
    return out.numpy()


def jax_run(fn, *args, **kw):
    out = fn(*(jnp.asarray(a) for a in args), **kw)
    if isinstance(out, tuple):
        return [np.asarray(o) for o in out]
    return np.asarray(out)


def assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_segments_of_x_match_the_reference():
    assert pairing._SEGMENTS == ref._SEGMENTS
    assert pairing.X_ABS == ref.X_ABS == -X_PARAM


def test_dbl_and_add_steps(state):
    s = state
    args = (s["X"], s["Y"], s["Z"], s["px"], s["py"])
    assert_equal(port(pairing._dbl_step, *args), jax_run(ref._dbl_step, *args))
    args = (s["X"], s["Y"], s["Z"], s["qx"], s["qy"], s["px"], s["py"])
    assert_equal(port(pairing._add_step, *args), jax_run(ref._add_step, *args))


LONGEST_RUN = max(n for n, _ in pairing._SEGMENTS)


def oracle_fq2(a) -> Fq2:
    return Fq2(limbs.host_from_mont(a[0]), limbs.host_from_mont(a[1]))


@pytest.mark.parametrize("n", [1, LONGEST_RUN])
def test_dbl_run(state, n):
    """n doublings of real points: T ends at 2^n T in the oracle's group
    law (homogeneous projective, x = X/Z), and f at f^(2^n) times every
    step's lines, multiplied in the oracle's Fq12 (the lines themselves
    are the JAX package's, by ``test_dbl_and_add_steps``)."""
    qs = [[g2_generator().mul(3 + 2 * k + b) for b in range(B)] for k in range(K)]
    ps = [[g1_generator().mul(5 + 2 * k + b) for b in range(B)] for k in range(K)]
    X = np.zeros((K, B, 2, limbs.N_LIMBS), dtype=np.int64)
    Y, Z = np.zeros_like(X), np.zeros_like(X)
    px = np.zeros((K, B, limbs.N_LIMBS), dtype=np.int64)
    py_ = np.zeros_like(px)
    for k in range(K):
        for b in range(B):
            X[k, b], Y[k, b] = device_bls._g2_coords(qs[k][b])
            Z[k, b, 0] = limbs.MONT_ONE_LIMBS
            px[k, b], py_[k, b] = device_bls._g1_coords(ps[k][b])
    f, X3, Y3, Z3 = port(pairing._dbl_run, state["f"], X, Y, Z, px, py_, n=n)

    want = [tower.host_fq12_to_oracle(state["f"][b]) for b in range(B)]
    T = [torch.from_numpy(t) for t in (X, Y, Z)]
    P_ = [torch.from_numpy(t) for t in (px, py_)]
    zero = Fq2(0, 0)
    for _ in range(n):
        *T, l0, l3, l5 = pairing._dbl_step(*T, *P_)
        for b in range(B):
            want[b] = want[b].square()
            for k in range(K):
                want[b] = want[b] * Fq12(
                    Fq6(oracle_fq2(l0[k, b]), zero, zero),
                    Fq6(zero, oracle_fq2(l3[k, b]), oracle_fq2(l5[k, b])))
    for b in range(B):
        assert tower.host_fq12_to_oracle(f[b]) == want[b]
        for k in range(K):
            x, y = qs[k][b].mul(2 ** n).to_affine()
            z_inv = oracle_fq2(Z3[k, b]).inv()
            assert oracle_fq2(X3[k, b]) * z_inv == x
            assert oracle_fq2(Y3[k, b]) * z_inv == y


@pytest.mark.slow
@pytest.mark.parametrize("n", [1, LONGEST_RUN])
def test_dbl_run_equals_the_jax_package(state, n):
    s = state
    args = (s["f"], s["X"], s["Y"], s["Z"], s["px"], s["py"])
    got = port(pairing._dbl_run, *args, n=n)
    assert_equal(got, jax_run(ref._dbl_run, *args, n=n))


def test_sq_run(state):
    got = port(pairing._sq_run, state["f"], n=3)
    assert np.array_equal(got, jax_run(ref._sq_run, state["f"], n=3))
    want = tower.host_fq12_to_oracle(state["f"][0])
    for _ in range(3):
        want = want.square()
    assert tower.host_fq12_to_oracle(got[0]) == want


def test_hht_hard_part_identity():
    """3 * (p^4 - p^2 + 1)/r == (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3, exactly."""
    x = X_PARAM
    assert 3 * ((P**4 - P**2 + 1) // R) == (
        (x - 1) ** 2 * (x + P) * (x**2 + P**2 - 1) + 3)


def signature_pairs():
    """Two FastAggregateVerify-shaped pair lists: a valid one and one whose
    message is not the signed one (signed and hashed by the native host
    backend)."""
    msg = b"device bls pairing"
    sks = [5, 7]
    agg_pk = (pubkey_to_point(native.SkToPk(sks[0]))
              + pubkey_to_point(native.SkToPk(sks[1])))
    sig = signature_to_point(native.Aggregate([native.Sign(sk, msg) for sk in sks]))
    neg_g1 = -g1_generator()
    return [[(agg_pk, device_bls._hash_to_g2_point(msg)), (neg_g1, sig)],
            [(agg_pk, device_bls._hash_to_g2_point(b"another message")),
             (neg_g1, sig)]]


def marshal(items):
    px = np.zeros((K, len(items), limbs.N_LIMBS), dtype=np.int64)
    py_ = np.zeros_like(px)
    qx = np.zeros((K, len(items), 2, limbs.N_LIMBS), dtype=np.int64)
    qy = np.zeros_like(qx)
    for b, pairs in enumerate(items):
        for k, (p, q) in enumerate(pairs):
            px[k, b], py_[k, b] = device_bls._g1_coords(p)
            qx[k, b], qy[k, b] = device_bls._g2_coords(q)
    return px, py_, qx, qy


def test_product_check_verdicts_and_the_operand_envelope(monkeypatch):
    items = signature_pairs()
    widest = {"limb": 0, "value": 0.0, "product": 0.0}
    plain = limbs.mul_plain
    place = 2.0 ** (limbs.LIMB_BITS * torch.arange(limbs.N_LIMBS,
                                                   dtype=torch.float64))

    def recording(a, b):
        va, vb = (t.double() @ place for t in (a, b))
        widest["limb"] = max(widest["limb"], int(a.abs().max()),
                             int(b.abs().max()))
        widest["value"] = max(widest["value"], float(va.abs().max()),
                              float(vb.abs().max()))
        widest["product"] = max(widest["product"],
                                float((va * vb).abs().max()))
        return plain(a, b)

    monkeypatch.setattr(limbs, "mul_plain", recording)
    got = pairing.pairs_product_is_one(*marshal(items), "cpu")
    # by construction: a valid aggregate, then one on another message
    assert list(got) == [True, False]
    # K3 reads each limb as a signed 32-bit word, and its int64 column
    # sums stay below 2^63 for limbs below 2^29; REDC is exact while
    # |a*b| < R*p.  (Values reach about 50p here, past the 36p the
    # reference's docstring names; the product bound is the one REDC needs.)
    assert widest["limb"] < 2**29
    assert widest["product"] < float(2 ** limbs.R_BITS) * P
    assert widest["value"] < 64 * P


@pytest.mark.slow
def test_miller_product_and_final_exponentiation_equal_the_jax_package():
    args = marshal(signature_pairs())
    f = port(pairing._miller_product, *args)
    f_ref = jax_run(ref._miller_product, *args)
    assert np.array_equal(limbs.canonical(torch.from_numpy(f)).numpy(),
                          np.asarray(ref.limbs.canonical(jnp.asarray(f_ref))))
    assert np.array_equal(f, f_ref)
    value = port(pairing.final_exp_value, f)
    assert np.array_equal(
        limbs.canonical(torch.from_numpy(value)).numpy(),
        np.asarray(ref.limbs.canonical(
            jnp.asarray(value_of_reference(f_ref)))))
    assert list(pairing.final_exp_is_one(torch.from_numpy(f))) == list(
        ref.final_exp_is_one(jnp.asarray(f_ref))) == [True, False]


def value_of_reference(f):
    """The JAX package's f^(3 (p^12-1)/r), by its own pieces."""
    easy = ref._mul12(ref._conj12(f), ref._inv12(f))
    easy = ref._mul12(ref._frob2_12(easy), easy)
    a1 = ref._mul12(ref._exp_x(easy), ref._conj12(easy))
    a = ref._mul12(ref._exp_x(a1), ref._conj12(a1))
    b = ref._mul12(ref._exp_x(a), ref._frob1_12(a))
    c = ref._exp_abs_x(ref._exp_abs_x(b))
    d = ref._mul12(ref._mul12(c, ref._frob2_12(b)), ref._conj12(b))
    return ref._mul12(ref._mul12(ref._sq_run(easy, 1), easy), d)


def test_wrappers_refuse_what_the_kernels_do_not_take(state):
    s = state
    f = torch.from_numpy(s["f"])
    with pytest.raises(ValueError):
        pairing._dbl_run(f[:1], *(torch.from_numpy(s[k])
                                  for k in ("X", "Y", "Z", "px", "py")), 1)
    with pytest.raises(TypeError):
        pairing._sq_run(f.to(torch.int32), 1)


# -- K4 and K5 on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 and K5 are CUDA kernels with no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 5])
def test_k4_k5_match_plain(cuda_device, state, n):
    s = state
    host = [torch.from_numpy(s[k]) for k in ("f", "X", "Y", "Z", "px", "py")]
    dev = [t.to(cuda_device) for t in host]
    before = dict(pairing.counts)
    got4 = pairing._dbl_run(*dev, n)
    got5 = pairing._sq_run(dev[0], n)
    torch.cuda.synchronize()
    assert pairing.counts["miller_dbl_run"] == before["miller_dbl_run"] + 1
    assert pairing.counts["fq12_sq_run"] == before["fq12_sq_run"] + 1
    for g, w in zip(got4, pairing._dbl_run_plain(*host, n)):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got5.cpu(), pairing._sq_run_plain(host[0], n))
