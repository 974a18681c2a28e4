"""The port's device BLS backend (``ops/bls``), on the CPU: its verdicts
against the native host backend's and the JAX package's ``ops/bls_jax``,
through the batch API, the scalar API, the selector and one of the
reference's always-BLS spec cases.

Each batch is one pass of the plain pipeline (a couple of seconds here),
so the cases are packed into few batches.  The JAX package decides the
items it settles on the host (malformed, empty, infinity) here; its
device pipeline costs about 20 s of XLA compiles and cache loads on the
CPU, so the ``slow`` test holds every verdict against it.
"""
import pytest
import torch

from consensus_specs_tpu.ops import bls_jax
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.crypto.bls import native
from consensus_specs_tpu_torch.ops import bls as device_bls
from consensus_specs_tpu_torch.ops.sha256 import KernelError

MSG = b"device bls batch"
SKS = [11, 22, 33]


@pytest.fixture(scope="module")
def keys():
    pks = [native.SkToPk(sk) for sk in SKS]
    sigs = [native.Sign(sk, MSG) for sk in SKS]
    return pks, sigs, native.Aggregate(sigs)


@pytest.fixture
def on_cpu():
    previous = device_bls.set_device("cpu")
    try:
        yield
    finally:
        device_bls.set_device(previous)


def mixed_items(keys):
    """(label, pubkeys, message, signature) for each kind of item."""
    pks, sigs, agg = keys
    return [
        ("valid", pks, MSG, agg),
        ("wrong message", pks, b"wrong message", agg),
        ("other key", pks[:2], MSG, agg),
        ("malformed pubkey", [pks[0], b"\xff" * 48], MSG, agg),
        ("empty pubkeys", [], MSG, agg),
        ("infinity signature", pks[:1], MSG, device_bls.G2_POINT_AT_INFINITY),
        ("valid single", pks[1:2], MSG, sigs[1]),
    ]


HOST_DECIDED = ("malformed pubkey", "empty pubkeys", "infinity signature")


def test_batch_fast_aggregate_verify_mixed(keys, on_cpu):
    items = mixed_items(keys)
    got = device_bls.batch_fast_aggregate_verify(
        [i[1] for i in items], [i[2] for i in items], [i[3] for i in items])
    want = [bool(native.FastAggregateVerify(pk, m, s))  # noqa: ST01 per-item reference verdicts
            for _, pk, m, s in items]
    assert got == want == [True, False, False, False, False, False, True]
    # the items the JAX package settles on the host, by its own backend
    host = [i for i in items if i[0] in HOST_DECIDED]
    assert bls_jax.batch_fast_aggregate_verify(
        [i[1] for i in host], [i[2] for i in host], [i[3] for i in host]
    ) == [got[items.index(i)] for i in host]


def test_batch_verify_and_empty_batches(keys, on_cpu):
    pks, sigs, _ = keys
    got = device_bls.batch_verify([pks[0], pks[1]], [MSG, MSG],
                                  [sigs[0], sigs[0]])
    assert got == [True, False]
    assert got == [native.Verify(pks[0], MSG, sigs[0]),
                   native.Verify(pks[1], MSG, sigs[0])]
    assert device_bls.batch_fast_aggregate_verify([], [], []) == []
    # nothing structurally valid: no pairing check runs
    assert device_bls.batch_fast_aggregate_verify(
        [[]], [MSG], [sigs[0]]) == [False]


def test_scalar_api(keys, on_cpu):
    """Verify on the device; FastAggregateVerify's device run is the
    selector test's, the infinity signature's host path the mixed
    batch's."""
    pks, sigs, agg = keys
    assert not device_bls.Verify(pks[0], MSG, sigs[1])
    # distinct-message AggregateVerify delegates to the host backend
    msgs = [b"m1", b"m2", b"m3"]
    agg2 = native.Aggregate([native.Sign(sk, m) for sk, m in zip(SKS, msgs)])
    assert device_bls.AggregateVerify(pks, msgs, agg2)
    assert not device_bls.AggregateVerify(pks, list(reversed(msgs)), agg2)
    assert device_bls.Sign(SKS[0], MSG) == sigs[0]
    assert device_bls.SkToPk(SKS[0]) == pks[0]


def test_selector_use_torch_round_trip(keys, on_cpu):
    pks, sigs, agg = keys
    prev = bls.backend_name()
    try:
        bls.use_torch()
        assert bls.backend_name() == "torch"
        assert bls.bls is device_bls.backend()
        assert bls.FastAggregateVerify(pks, MSG, agg)
        assert bls.Sign(SKS[0], MSG) == sigs[0]
        # a malformed input is an invalid signature, not an error
        assert not bls.Verify(b"\xff" * 48, MSG, sigs[0])
    finally:
        bls.use_backend(prev)
    assert bls.backend_name() == prev


def test_without_a_card_the_backend_raises(keys, monkeypatch):
    """No device set and no card: the device path cannot run, and the
    selector lets the KernelError through instead of calling the
    signature invalid."""
    pks, sigs, _ = keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError):
        device_bls.Verify(pks[0], MSG, sigs[0])
    prev = bls.backend_name()
    try:
        bls.use_backend("torch")
        with pytest.raises(KernelError):
            bls.Verify(pks[0], MSG, sigs[0])
    finally:
        bls.use_backend(prev)


def test_always_bls_case_names():
    from consensus_specs_tpu_torch.testing import reference_cases as rc

    names = rc.always_bls_case_names(
        "phase0/block_processing/test_process_attestation.py")
    assert "test_wrong_index_for_committee_signature" in names
    assert "test_before_inclusion_delay" not in names


def test_always_bls_spec_case_under_the_torch_backend(monkeypatch):
    """One of the reference's always-BLS cases on a CPU-built phase0 spec
    with the device backend selected: its one signature check is a
    pairing check of the port's."""
    from consensus_specs_tpu_torch.ops.bls import pairing
    from consensus_specs_tpu_torch.testing import reference_cases as rc

    checks = []
    product_is_one = pairing.pairs_product_is_one

    def counted(*args):
        checks.append(args[-1])
        return product_is_one(*args)

    monkeypatch.setattr(pairing, "pairs_product_is_one", counted)
    case = rc.cases("phase0/block_processing/test_process_attestation.py")[
        "test_wrong_index_for_committee_signature"]
    before = (bls.backend_name(), device_bls._device)
    with rc.configured("cpu", forks=("phase0",), bls_backend="torch"):
        assert bls.backend_name() == "torch"
        case()
    assert checks == [torch.device("cpu")]
    assert (bls.backend_name(), device_bls._device) == before


@pytest.mark.slow
def test_every_verdict_equals_the_jax_package(keys, on_cpu):
    items = mixed_items(keys)
    args = ([i[1] for i in items], [i[2] for i in items], [i[3] for i in items])
    assert device_bls.batch_fast_aggregate_verify(*args) == (
        bls_jax.batch_fast_aggregate_verify(*args))
    pks, sigs, agg = keys
    assert device_bls.FastAggregateVerify(pks, MSG, agg) == (
        bls_jax.FastAggregateVerify(pks, MSG, agg))
    assert device_bls.Verify(pks[0], MSG, sigs[1]) == (
        bls_jax.Verify(pks[0], MSG, sigs[1]))


@pytest.mark.slow
@pytest.mark.parametrize("relpath", [
    "phase0/test_batch_verification.py",
    "phase0/block_processing/test_process_attestation.py",
    "altair/test_sync_aggregate.py"])
def test_always_bls_spec_cases_under_the_torch_backend(relpath):
    """Every always-BLS case of the file on CPU-built minimal specs, under
    the device backend: each passes, as under native."""
    from consensus_specs_tpu_torch.testing import reference_cases as rc

    names = rc.always_bls_case_names(relpath)
    assert names
    cases = rc.cases(relpath)
    with rc.configured("cpu", bls_backend="torch"):
        for name in names:
            cases[name]()
