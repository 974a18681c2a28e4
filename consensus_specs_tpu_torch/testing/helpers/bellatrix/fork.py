"""Bellatrix fork-upgrade runner (parity capability: reference
``test/helpers/bellatrix/fork.py``), parameterizing the shared runner."""
from ..fork_upgrade import base_stable_fields, run_upgrade_test

BELLATRIX_FORK_TEST_META_TAGS = {
    "fork": "bellatrix",
}


def _bellatrix_extras(post_spec, pre_state, post_state):
    # Pre-merge: the payload header slot must start at its type's defaults.
    assert post_state.latest_execution_payload_header == post_spec.ExecutionPayloadHeader()


def run_fork_test(post_spec, pre_state):
    yield from run_upgrade_test(
        post_spec, pre_state,
        upgrade_fn=post_spec.upgrade_to_bellatrix,
        version_var="BELLATRIX_FORK_VERSION",
        stable_fields=base_stable_fields(with_altair=True),
        extra_checks=_bellatrix_extras,
    )
