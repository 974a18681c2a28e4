"""Capella fork-upgrade runner (parity capability: the early-draft era
reference ``test/helpers/capella/fork.py``), parameterizing the shared
runner. Capella widens two container types, so ``validators`` and the
payload header get structural checks instead of direct equality."""
from ..fork_upgrade import base_stable_fields, run_upgrade_test

CAPELLA_FORK_TEST_META_TAGS = {
    "fork": "capella",
}


def _capella_extras(post_spec, pre_state, post_state):
    # ExecutionPayloadHeader gains withdrawals_root: the shared fields must
    # carry over and the new root must be zero.
    pre_h, post_h = pre_state.latest_execution_payload_header, post_state.latest_execution_payload_header
    for fname in type(pre_h)._field_names:
        assert getattr(pre_h, fname) == getattr(post_h, fname), fname
    assert post_h.withdrawals_root == b"\x00" * 32

    # Validator gains fully_withdrawn_epoch (early-capella draft), which must
    # initialize to FAR_FUTURE_EPOCH with everything else preserved.
    assert len(post_state.validators) == len(pre_state.validators)
    for pre_v, post_v in zip(pre_state.validators, post_state.validators):
        assert post_v.pubkey == pre_v.pubkey
        assert post_v.effective_balance == pre_v.effective_balance
        assert int(post_v.fully_withdrawn_epoch) == int(post_spec.FAR_FUTURE_EPOCH)

    assert int(post_state.withdrawal_index) == 0


def run_fork_test(post_spec, pre_state):
    yield from run_upgrade_test(
        post_spec, pre_state,
        upgrade_fn=post_spec.upgrade_to_capella,
        version_var="CAPELLA_FORK_VERSION",
        stable_fields=base_stable_fields(with_altair=True, with_validators=False),
        extra_checks=_capella_extras,
    )
