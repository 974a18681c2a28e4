"""The torch port's capella spec against the reference spec, with BLS on.

This capella is the early withdrawals draft: full withdrawals through an
in-state queue (``process_full_withdrawals`` at the epoch transition,
``process_withdrawals`` against each payload) and BLS-to-execution
changes.  The engine has no capella fast path: every capella block
replays through the literal spec, as in the reference.

* ``upgrade_to_capella`` of a bellatrix state;
* minimal preset: a capella genesis state (past the merge) where a few
  validators hold eth1 credentials and become withdrawable, then signed
  blocks across two epoch transitions, built with the reference's testing
  helpers: the first transition queues their full withdrawals, the later
  payloads dequeue them, one block carries a valid BLS-to-execution
  change; the reference's root after every block, and a block with an
  invalid change fails in both specs with equal poisoned states;
* the same walk through ``stf.apply_signed_blocks``: every block
  replayed with the reference engine's reason, the same roots;
* ``ssz/bulk.validator_columns`` on a capella registry (nine fields, so
  a deeper field tree than phase0's eight) against per-validator reads.
"""
import numpy as np

from consensus_specs_tpu import stf as ref_stf
from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.attestations import get_valid_attestation
from consensus_specs_tpu.testing.helpers.block import build_empty_block_for_next_slot
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu.testing.helpers.keys import pubkey_to_privkey, pubkeys
from consensus_specs_tpu.testing.helpers.state import (
    next_epoch,
    state_transition_and_sign_block,
)
from consensus_specs_tpu_torch import stf
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import bulk

from .test_torch_spec_altair import bls_on, to_port
from .test_torch_stf_engine_altair import _capture, _fresh_engines

__all__ = ["bls_on"]  # the fixture, shared with the altair tests

_CORPUS = {}

# validators given eth1 credentials and made withdrawable in the walk's
# first epoch; the index whose BLS credentials a valid change rotates, and
# the block that carries it
WITHDRAWN = (3, 7, 12, 30)
CHANGED = 5
CHANGE_AT = 2


def signed_address_change(ref_spec, state, index, address=b"\x42" * 20):
    """A BLS-to-execution change of validator ``index`` signed by the
    withdrawal key its mock credentials were derived from."""
    withdrawal_pubkey = pubkeys[-1 - index]
    change = ref_spec.BLSToExecutionChange(
        validator_index=index, from_bls_pubkey=withdrawal_pubkey,
        to_execution_address=address)
    domain = ref_spec.get_domain(state, ref_spec.DOMAIN_BLS_TO_EXECUTION_CHANGE)
    return ref_spec.SignedBLSToExecutionChange(
        message=change,
        signature=ref_bls.Sign(pubkey_to_privkey[withdrawal_pubkey],
                               ref_spec.compute_signing_root(change, domain)))


def capella_corpus():
    """(reference spec, port spec, reference pre-state, reference signed
    blocks, reference pre-state of the invalid block, the invalid block):
    from an epoch-aligned minimal capella state, 2 epochs + 1 blocks with
    one aggregate a committee of the slot before it; ``WITHDRAWN`` become
    fully withdrawable in the first epoch, block ``CHANGE_AT`` rotates
    ``CHANGED``'s credentials, and a last block carries a change with a
    wrong signature."""
    if not _CORPUS:
        was = ref_bls.bls_active, ref_bls.backend_name()
        ref_bls.use_native()
        ref_bls.bls_active = True
        try:
            ref_spec = ref_get_spec("capella", "minimal")
            state = create_genesis_state(
                ref_spec, default_balances(ref_spec),
                default_activation_threshold(ref_spec))
            next_epoch(ref_spec, state)
            for index in WITHDRAWN:
                validator = state.validators[index]
                validator.withdrawal_credentials = (
                    bytes(ref_spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX)
                    + bytes(validator.withdrawal_credentials[1:]))
                validator.withdrawable_epoch = ref_spec.get_current_epoch(state)
            pre = state.copy()
            blocks = []
            for i in range(2 * int(ref_spec.SLOTS_PER_EPOCH) + 1):
                block = build_empty_block_for_next_slot(ref_spec, state)
                n_committees = ref_spec.get_committee_count_per_slot(
                    state, ref_spec.get_current_epoch(state))
                for index in range(n_committees):
                    block.body.attestations.append(get_valid_attestation(
                        ref_spec, state, state.slot, index=index, signed=True))
                if i == CHANGE_AT:
                    block.body.bls_to_execution_changes.append(
                        signed_address_change(ref_spec, state, CHANGED))
                blocks.append(
                    state_transition_and_sign_block(ref_spec, state, block))
            bad_pre = state.copy()
            block = build_empty_block_for_next_slot(ref_spec, state)
            change = signed_address_change(ref_spec, state, CHANGED + 1)
            change.signature = ref_spec.BLSSignature(
                b"\x01" + bytes(change.signature[1:]))
            block.body.bls_to_execution_changes.append(change)
            bad = state_transition_and_sign_block(
                ref_spec, state, block, expect_fail=True)
        finally:
            ref_bls.bls_active = was[0]
            ref_bls.use_backend(was[1])
        _CORPUS.update(ref_spec=ref_spec, pre=pre, blocks=blocks,
                       bad_pre=bad_pre, bad=bad,
                       spec=get_spec("capella", "minimal", device="cpu"))
    c = _CORPUS
    return c["ref_spec"], c["spec"], c["pre"], c["blocks"], c["bad_pre"], c["bad"]


def test_upgrade_to_capella_matches_reference():
    ref_bellatrix = ref_get_spec("bellatrix", "minimal")
    ref_spec = ref_get_spec("capella", "minimal")
    spec = get_spec("capella", "minimal", device="cpu")
    assert spec.bellatrix is get_spec("bellatrix", "minimal", device="cpu")
    pre = create_genesis_state(ref_bellatrix, default_balances(ref_bellatrix),
                               default_activation_threshold(ref_bellatrix))
    next_epoch(ref_bellatrix, pre)
    want = ref_spec.upgrade_to_capella(pre.copy())
    got = spec.upgrade_to_capella(to_port(spec.bellatrix.BeaconState, pre))
    assert bytes(got.hash_tree_root()) == bytes(want.hash_tree_root())
    assert bytes(got.fork.current_version) == bytes(spec.config.CAPELLA_FORK_VERSION)
    assert all(int(v.fully_withdrawn_epoch) == int(spec.FAR_FUTURE_EPOCH)
               for v in got.validators)


def test_minimal_capella_walk_matches_reference(bls_on):
    ref_spec, spec, pre, blocks, bad_pre, bad = capella_corpus()
    state = to_port(spec.BeaconState, pre)
    ref_state = pre.copy()
    withdrawn = []
    for i, signed in enumerate(blocks):
        spec.state_transition(state, to_port(spec.SignedBeaconBlock, signed), True)
        ref_spec.state_transition(ref_state, signed, True)
        assert bytes(state.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
        assert bytes(state.hash_tree_root()) == bytes(signed.message.state_root)
        withdrawn += signed.message.body.execution_payload.withdrawals
    # the first epoch transition queued every full withdrawal, the later
    # payloads dequeued them, and the change rotated the credentials
    assert sorted(bytes(w.address) for w in withdrawn) == sorted(
        bytes(pre.validators[index].withdrawal_credentials[12:])
        for index in WITHDRAWN)
    assert all(int(w.amount) > 0 for w in withdrawn)
    assert int(state.withdrawal_index) == len(WITHDRAWN)
    assert len(state.withdrawals_queue) == 0
    for index in WITHDRAWN:
        assert int(state.validators[index].fully_withdrawn_epoch) == int(
            spec.get_current_epoch(to_port(spec.BeaconState, pre)))
    creds = state.validators[CHANGED].withdrawal_credentials
    assert bytes(creds[:1]) == bytes(spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX)
    assert bytes(creds[12:]) == b"\x42" * 20
    assert bytes(state.encode_bytes()) == bytes(ref_state.encode_bytes())

    # the invalid change: both specs raise, with equal poisoned states
    port_bad = to_port(spec.BeaconState, bad_pre)
    ref_bad = bad_pre.copy()
    exc = _capture(spec.state_transition, port_bad,
                   to_port(spec.SignedBeaconBlock, bad), True)
    ref_exc = _capture(ref_spec.state_transition, ref_bad, bad, True)
    assert isinstance(ref_exc, AssertionError), ref_exc
    assert type(exc) is type(ref_exc)
    assert bytes(port_bad.hash_tree_root()) == bytes(ref_bad.hash_tree_root())


def test_capella_walk_replays_through_the_engine(bls_on):
    """Capella is not a fast fork: every block replays through the literal
    spec, counted under the reference engine's reason, with the same
    roots; the invalid block raises the same exception in both engines."""
    from consensus_specs_tpu_torch.stf import engine

    assert "capella" not in engine.FAST_FORKS
    ref_spec, spec, pre, blocks, bad_pre, bad = capella_corpus()
    _fresh_engines()
    ref_state = pre.copy()
    ref_stf.apply_signed_blocks(ref_spec, ref_state, blocks, True)
    state = to_port(spec.BeaconState, pre)
    stf.apply_signed_blocks(
        spec, state, [to_port(spec.SignedBeaconBlock, b) for b in blocks], True)
    assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    assert bytes(state.hash_tree_root()) == bytes(blocks[-1].message.state_root)
    assert stf.stats["fast_blocks"] == ref_stf.stats["fast_blocks"] == 0
    assert stf.stats["replayed_blocks"] == ref_stf.stats["replayed_blocks"] == len(blocks)
    assert stf.stats["replay_reasons"] == ref_stf.stats["replay_reasons"]
    assert stf.stats["replay_reasons"] == {"FastPathViolation": len(blocks)}

    port_bad = to_port(spec.BeaconState, bad_pre)
    ref_bad = bad_pre.copy()
    exc = _capture(stf.apply_signed_blocks, spec, port_bad,
                   [to_port(spec.SignedBeaconBlock, bad)], True)
    ref_exc = _capture(ref_stf.apply_signed_blocks, ref_spec, ref_bad, [bad], True)
    assert isinstance(ref_exc, AssertionError), ref_exc
    assert type(exc) is type(ref_exc)
    assert str(exc) == str(ref_exc)
    assert bytes(port_bad.hash_tree_root()) == bytes(ref_bad.hash_tree_root())


def test_validator_columns_on_a_capella_registry():
    """The nine-field capella ``Validator`` (``fully_withdrawn_epoch``
    added): the columns of one registry walk equal the per-validator field
    reads, epochs saturated at 2^63 - 1 as the column store keeps them."""
    spec = get_spec("capella", "minimal", device="cpu")
    assert len(spec.Validator._field_names) == 9
    rng = np.random.default_rng(9)
    n = 200
    far = int(spec.FAR_FUTURE_EPOCH)
    validators = []
    for i in range(n):
        epochs = [int(e) if e < 2**20 else far
                  for e in rng.integers(0, 2**21, 5)]
        validators.append(spec.Validator(
            pubkey=pubkeys[i],
            withdrawal_credentials=rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
            effective_balance=int(rng.integers(0, 2**36)),
            slashed=bool(rng.integers(0, 2)),
            activation_eligibility_epoch=epochs[0],
            activation_epoch=epochs[1],
            exit_epoch=epochs[2],
            withdrawable_epoch=epochs[3],
            fully_withdrawn_epoch=epochs[4]))
    state = spec.BeaconState(validators=validators)
    cols = bulk.validator_columns(state.validators)
    cap = 2**63 - 1
    for name in ("effective_balance", "activation_eligibility_epoch",
                 "activation_epoch", "exit_epoch", "withdrawable_epoch"):
        want = [min(int(getattr(v, name)), cap) for v in state.validators]
        assert cols[name].tolist() == want, name
    assert cols["slashed"].tolist() == [bool(v.slashed) for v in state.validators]


def test_scenario_capella_epoch_matches_reference(bls_on):
    """The port's own capella epoch (``scenario.capella_withdrawal_epoch``,
    the walk the card's smoke run drives): one full withdrawal queued at
    the epoch transition and dequeued by the boundary block's payload, one
    BLS-to-execution change; the reference's root after every block."""
    from consensus_specs_tpu_torch import scenario

    spec = get_spec("capella", "minimal", device="cpu")
    ref_spec = ref_get_spec("capella", "minimal")
    pre, blocks = scenario.capella_withdrawal_epoch(spec, 64)
    state = pre.copy()
    ref_state = to_port(ref_spec.BeaconState, pre)
    for i, signed in enumerate(blocks):
        spec.state_transition(state, signed, True)
        ref_spec.state_transition(
            ref_state, to_port(ref_spec.SignedBeaconBlock, signed), True)
        assert bytes(state.hash_tree_root()) == bytes(
            ref_state.hash_tree_root()), f"block {i}"
    assert [len(b.message.body.execution_payload.withdrawals)
            for b in blocks] == [0] * (len(blocks) - 1) + [1]
    assert [len(b.message.body.bls_to_execution_changes) for b in blocks].count(1) == 1
    assert int(state.withdrawal_index) == 1
    assert int(state.validators[1].fully_withdrawn_epoch) == int(
        spec.get_current_epoch(pre))
    assert bytes(state.validators[2].withdrawal_credentials[12:]) == b"\x52" * 20
