"""Altair fork-upgrade runner (parity capability: reference
``test/helpers/altair/fork.py``), parameterizing the shared runner."""
from ..fork_upgrade import base_stable_fields, run_upgrade_test

ALTAIR_FORK_TEST_META_TAGS = {
    "fork": "altair",
}


def _altair_extras(post_spec, pre_state, post_state):
    # The upgrade replaces pending attestations with participation flags,
    # so the fork struct is the only field asserted as *changed*.
    assert pre_state.fork != post_state.fork


def run_fork_test(post_spec, pre_state):
    # Drop pending current-epoch attestations first so the pre-state looks
    # like a realistic mid-epoch snapshot.
    pre_state.current_epoch_attestations = []
    yield from run_upgrade_test(
        post_spec, pre_state,
        upgrade_fn=post_spec.upgrade_to_altair,
        version_var="ALTAIR_FORK_VERSION",
        stable_fields=base_stable_fields(with_altair=False),
        extra_checks=_altair_extras,
    )
