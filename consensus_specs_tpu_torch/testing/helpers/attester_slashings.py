"""Attester-slashing construction (parity surface: reference
``eth2spec/test/helpers/attester_slashings.py``)."""
from .attestations import get_valid_attestation, sign_attestation, sign_indexed_attestation


def _conflicting_pair(spec, state, slot, signed_1, signed_2, filter_participant_set=None):
    """Two attestations by the same committee that disagree on target root."""
    first = get_valid_attestation(
        spec, state, slot=slot, signed=signed_1,
        filter_participant_set=filter_participant_set)
    second = first.copy()
    second.data.target.root = b"\x01" * 32
    if signed_2:
        sign_attestation(spec, state, second)
    return first, second


def get_valid_attester_slashing(spec, state, slot=None, signed_1=False, signed_2=False,
                                filter_participant_set=None):
    att_1, att_2 = _conflicting_pair(
        spec, state, slot, signed_1, signed_2, filter_participant_set)
    return spec.AttesterSlashing(
        attestation_1=spec.get_indexed_attestation(state, att_1),
        attestation_2=spec.get_indexed_attestation(state, att_2),
    )


def get_valid_attester_slashing_by_indices(spec, state, indices_1, indices_2=None,
                                           slot=None, signed_1=False, signed_2=False):
    """Like get_valid_attester_slashing but with hand-picked participant sets."""
    indices_2 = indices_1 if indices_2 is None else indices_2
    assert indices_1 == sorted(indices_1) and indices_2 == sorted(indices_2)

    slashing = get_valid_attester_slashing(spec, state, slot=slot)
    slashing.attestation_1.attesting_indices = indices_1
    slashing.attestation_2.attesting_indices = indices_2
    for flag, side in ((signed_1, slashing.attestation_1), (signed_2, slashing.attestation_2)):
        if flag:
            sign_indexed_attestation(spec, state, side)
    return slashing


def get_indexed_attestation_participants(spec, indexed_att):
    return list(indexed_att.attesting_indices)


def set_indexed_attestation_participants(spec, indexed_att, participants):
    indexed_att.attesting_indices = participants


def get_attestation_1_data(spec, att_slashing):
    return att_slashing.attestation_1.data


def get_attestation_2_data(spec, att_slashing):
    return att_slashing.attestation_2.data
