"""Ordered epoch sub-transition runner (reference: test/helpers/epoch_processing.py)."""
from ..context import is_post_altair


def get_process_calls(spec):
    # Unrecognized processing functions are ignored; this is the aggregate
    # over all phases.
    return [
        "process_justification_and_finalization",
        "process_inactivity_updates",  # altair
        "process_rewards_and_penalties",
        "process_registry_updates",
        "process_reveal_deadlines",  # custody game
        "process_challenge_deadlines",  # custody game
        "process_slashings",
        "process_pending_header.",  # sharding
        "charge_confirmed_header_fees",  # sharding
        "reset_pending_headers",  # sharding
        "process_eth1_data_reset",
        "process_effective_balance_updates",
        "process_slashings_reset",
        "process_randao_mixes_reset",
        "process_historical_roots_update",
        # Altair replaced `process_participation_record_updates` with
        # `process_participation_flag_updates`
        "process_participation_flag_updates" if is_post_altair(spec) else (
            "process_participation_record_updates"
        ),
        "process_sync_committee_updates",  # altair
        "process_full_withdrawals",  # capella
    ]


def run_epoch_processing_to(spec, state, process_name: str):
    """
    Processes to the next epoch transition, up to, but not including,
    the sub-transition named ``process_name``.
    """
    slot = state.slot + (spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH)

    # transition state to slot before epoch state transition
    if state.slot < slot - 1:
        spec.process_slots(state, slot - 1)

    # start transitioning, do one slot update before the epoch itself
    spec.process_slot(state)

    # process components of epoch transition before the target
    for name in get_process_calls(spec):
        if name == process_name:
            break
        # only run when present; later phases introduce more to epoch processing
        if hasattr(spec, name):
            getattr(spec, name)(state)


def run_epoch_processing_with(spec, state, process_name: str):
    """
    Processes to the next epoch transition, up to and including
    ``process_name``, yielding 'pre' and 'post' states around it.
    """
    run_epoch_processing_to(spec, state, process_name)
    # vectors record which sub-transition the case targets so consumers
    # of grouped handlers replay the right one (meta.yaml: sub_transition)
    yield "sub_transition", "meta", process_name
    yield "pre", state
    getattr(spec, process_name)(state)
    yield "post", state
