"""Voluntary-exit construction and registry exit queries (parity surface:
reference ``eth2spec/test/helpers/voluntary_exits.py``)."""
from __future__ import annotations

from random import Random

from consensus_specs_tpu_torch.crypto import bls

from .keys import privkeys


def sign_voluntary_exit(spec, state, voluntary_exit, privkey):
    domain = spec.get_domain(state, spec.DOMAIN_VOLUNTARY_EXIT, voluntary_exit.epoch)
    return spec.SignedVoluntaryExit(
        message=voluntary_exit,
        signature=bls.Sign(privkey, spec.compute_signing_root(voluntary_exit, domain)),
    )


def prepare_signed_exits(spec, state, indices):
    epoch = spec.get_current_epoch(state)
    return [
        sign_voluntary_exit(
            spec, state,
            spec.VoluntaryExit(epoch=epoch, validator_index=index),
            privkeys[index])
        for index in indices
    ]


def get_exited_validators(spec, state):
    now = spec.get_current_epoch(state)
    return [i for i, v in enumerate(state.validators) if v.exit_epoch <= now]


def get_unslashed_exited_validators(spec, state):
    return [i for i in get_exited_validators(spec, state) if not state.validators[i].slashed]


def exit_validators(spec, state, validator_count, rng=None):
    """Initiate exit for ``validator_count`` randomly sampled validators."""
    rng = rng or Random(1337)
    chosen = rng.sample(range(len(state.validators)), validator_count)
    for index in chosen:
        spec.initiate_validator_exit(state, index)
    return chosen
