"""Shared machinery for fork-upgrade tests (altair/bellatrix/capella).

Parity capability: the reference's per-fork ``test/helpers/<fork>/fork.py``
runners, folded into one parameterized runner. Each fork module supplies its
upgrade callable, the config var naming its version, and any fork-specific
extra checks; the invariant machinery (stable-field comparison, fork-struct
rotation) lives here once.
"""
from __future__ import annotations

# Fields every upgrade must carry over untouched, grouped by concern.
_BASE_STABLE = (
    # identity + clock
    "genesis_time", "genesis_validators_root", "slot",
    # history accumulator
    "latest_block_header", "block_roots", "state_roots", "historical_roots",
    # eth1 bridge
    "eth1_data", "eth1_data_votes", "eth1_deposit_index",
    # registry + balances
    "balances",
    # randomness + slashings
    "randao_mixes", "slashings",
    # finality machinery
    "justification_bits", "previous_justified_checkpoint",
    "current_justified_checkpoint", "finalized_checkpoint",
)

# Altair-introduced state that later upgrades must also preserve.
_ALTAIR_STABLE = (
    "previous_epoch_participation", "current_epoch_participation",
    "inactivity_scores", "current_sync_committee", "next_sync_committee",
)


def assert_fork_rotation(post_spec, pre_state, post_state, version_var: str):
    """The Fork struct must rotate: old current becomes previous, the new
    version comes from config, and the epoch is stamped now."""
    assert post_state.fork.previous_version == pre_state.fork.current_version
    assert post_state.fork.current_version == getattr(post_spec.config, version_var)
    assert post_state.fork.epoch == post_spec.get_current_epoch(post_state)


def run_upgrade_test(post_spec, pre_state, upgrade_fn, version_var: str,
                     stable_fields, extra_checks=None):
    """Yield pre/post around ``upgrade_fn`` while checking invariants."""
    yield "pre", pre_state
    post_state = upgrade_fn(pre_state)
    for field in stable_fields:
        assert getattr(pre_state, field) == getattr(post_state, field), field
    assert_fork_rotation(post_spec, pre_state, post_state, version_var)
    if extra_checks is not None:
        extra_checks(post_spec, pre_state, post_state)
    yield "post", post_state


def base_stable_fields(*, with_altair: bool, with_validators: bool = True):
    fields = _BASE_STABLE + (("validators",) if with_validators else ())
    if with_altair:
        fields += _ALTAIR_STABLE
    return fields
