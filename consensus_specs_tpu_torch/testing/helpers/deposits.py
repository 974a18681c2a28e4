"""Deposit construction for tests.

Parity surface: reference ``eth2spec/test/helpers/deposits.py``. The merkle
side is factored through ``_deposit_tree`` so proof construction happens in
one place; batch preparation funnels through ``_make_deposit`` rather than
each caller restating the pubkey/credential plumbing.
"""
from __future__ import annotations

from random import Random

from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ssz.impl import hash_tree_root
from consensus_specs_tpu_torch.ssz.merkle_minimal import calc_merkle_tree_from_leaves, get_merkle_proof
from consensus_specs_tpu_torch.ssz.types import List

from ..context import is_post_altair
from .keys import privkeys, pubkeys


def mock_deposit(spec, state, index):
    """Rewind validator ``index`` to freshly-deposited (not yet eligible)."""
    now = spec.get_current_epoch(state)
    assert spec.is_active_validator(state.validators[index], now)
    v = state.validators[index]
    v.activation_eligibility_epoch = spec.FAR_FUTURE_EPOCH
    v.activation_epoch = spec.FAR_FUTURE_EPOCH
    v.effective_balance = spec.MAX_EFFECTIVE_BALANCE
    if is_post_altair(spec):
        state.inactivity_scores[index] = 0
    assert not spec.is_active_validator(state.validators[index], now)


def default_withdrawal_credentials(spec, pubkey):
    # Tests have no real withdrawal keys; derive credentials from the pubkey.
    return bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(pubkey)[1:]


def sign_deposit_data(spec, deposit_data, privkey):
    message = spec.DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount)
    root = spec.compute_signing_root(message, spec.compute_domain(spec.DOMAIN_DEPOSIT))
    deposit_data.signature = bls.Sign(privkey, root)


def build_deposit_data(spec, pubkey, privkey, amount, withdrawal_credentials, signed=False):
    data = spec.DepositData(
        pubkey=pubkey, withdrawal_credentials=withdrawal_credentials, amount=amount)
    if signed:
        sign_deposit_data(spec, data, privkey)
    return data


def _deposit_tree(spec, deposit_data_list):
    """(merkle tree over data roots, SSZ root of the deposit list)."""
    leaves = tuple(d.hash_tree_root() for d in deposit_data_list)
    limit = 2 ** spec.DEPOSIT_CONTRACT_TREE_DEPTH
    list_root = hash_tree_root(List[spec.DepositData, limit](*deposit_data_list))
    return calc_merkle_tree_from_leaves(leaves), list_root


def deposit_from_context(spec, deposit_data_list, index):
    tree, list_root = _deposit_tree(spec, deposit_data_list)
    # A deposit proof is the branch plus the list length mixed in at the top.
    branch = list(get_merkle_proof(tree, item_index=index, tree_len=32))
    branch.append(len(deposit_data_list).to_bytes(32, "little"))
    data = deposit_data_list[index]
    assert spec.is_valid_merkle_branch(
        data.hash_tree_root(), branch, spec.DEPOSIT_CONTRACT_TREE_DEPTH + 1, index, list_root)
    return spec.Deposit(proof=branch, data=data), list_root, deposit_data_list


def build_deposit(spec, deposit_data_list, pubkey, privkey, amount,
                  withdrawal_credentials, signed):
    deposit_data_list.append(
        build_deposit_data(spec, pubkey, privkey, amount, withdrawal_credentials, signed=signed))
    return deposit_from_context(spec, deposit_data_list, len(deposit_data_list) - 1)


def _make_deposit(spec, deposit_data_list, key_index, amount,
                  withdrawal_credentials=None, signed=False):
    pubkey = pubkeys[key_index]
    if withdrawal_credentials is None:
        withdrawal_credentials = default_withdrawal_credentials(spec, pubkey)
    return build_deposit(
        spec, deposit_data_list, pubkey, privkeys[key_index], amount,
        withdrawal_credentials, signed)


def prepare_full_genesis_deposits(spec, amount, deposit_count, min_pubkey_index=0,
                                  signed=False, deposit_data_list=None):
    deposit_data_list = deposit_data_list if deposit_data_list is not None else []
    deposits, root = [], None
    for key_index in range(min_pubkey_index, min_pubkey_index + deposit_count):
        deposit, root, deposit_data_list = _make_deposit(
            spec, deposit_data_list, key_index, amount, signed=signed)
        deposits.append(deposit)
    return deposits, root, deposit_data_list


def prepare_random_genesis_deposits(spec, deposit_count, max_pubkey_index,
                                    min_pubkey_index=0, max_amount=None,
                                    min_amount=None, deposit_data_list=None, rng=None):
    rng = rng or Random(3131)
    lo = min_amount if min_amount is not None else spec.MIN_DEPOSIT_AMOUNT
    hi = max_amount if max_amount is not None else spec.MAX_EFFECTIVE_BALANCE
    deposit_data_list = deposit_data_list if deposit_data_list is not None else []
    deposits, root = [], None
    for _ in range(deposit_count):
        key_index = rng.randint(min_pubkey_index, max_pubkey_index)
        creds = bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(bytes([rng.randint(0, 255)]))[1:]
        deposit, root, deposit_data_list = _make_deposit(
            spec, deposit_data_list, key_index, rng.randint(lo, hi),
            withdrawal_credentials=creds, signed=True)
        deposits.append(deposit)
    return deposits, root, deposit_data_list


def prepare_state_and_deposit(spec, state, validator_index, amount,
                              withdrawal_credentials=None, signed=False):
    """Point ``state.eth1_data`` at a one-deposit tree and return the deposit."""
    deposit, root, data_list = _make_deposit(
        spec, [], validator_index, amount,
        withdrawal_credentials=withdrawal_credentials, signed=signed)
    state.eth1_deposit_index = 0
    state.eth1_data.deposit_root = root
    state.eth1_data.deposit_count = len(data_list)
    return deposit
