"""Spec builder: exec fork sources layered over one another.

Architecture (mirrors the reference's compiled-module semantics,
setup.py:741-764, without the markdown round-trip):

  * each fork has a Python *source template* in ``specs/src/<fork>.py``
    written against free globals (SSZ types, ``bls``, ``hash``, preset
    constants, ``config``);
  * ``get_spec(fork, preset)`` builds a fresh module whose globals are
    pre-seeded with the environment, then execs the source of every fork
    up to and including the target in order — later definitions override
    earlier ones, and because all functions share ONE globals dict, a
    phase0 function calling ``process_epoch`` dispatches to the newest
    fork's override, exactly like the reference's single flat module;
  * the previous fork's finished module is injected under its name
    (``phase0``, ``altair``, ...) so ``upgrade_to_<fork>`` functions can
    reference predecessor types (reference: setup.py:456-461);
  * after exec, a sundry layer installs LRU caches on hot accessors
    (reference: setup.py:358-428) and semantics-preserving optimizations
    (vectorized whole-committee shuffling; reference's analogue:
    implement_optimizations, setup.py:65-68).

Port of ``consensus_specs_tpu/specs/builder.py``.  A spec is built for one
torch device (``get_spec(fork, preset, device=None)``; None is the CUDA
card): its epoch substitutions run their tensor work there.  The port
builds the reference's fork topology: the mainline ladder phase0 ->
altair -> bellatrix -> capella, and the research forks that hang off
bellatrix (eip4844, sharding, and sharding's custody_game and das).
"""
from __future__ import annotations

import itertools
import sys
import threading
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import (
    Any,
    Callable,
    Dict,
    NamedTuple,
    Optional,
    Protocol,
    Sequence,
    Set,
    Tuple,
    TypeVar,
)

import numpy as np
import torch

from consensus_specs_tpu_torch._device import resolve_device
from consensus_specs_tpu_torch.config import get_config, get_preset
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ops.shuffle import compute_shuffle_permutation
from consensus_specs_tpu_torch.ssz import hashing
from consensus_specs_tpu_torch.ssz.gindex import get_generalized_index
from consensus_specs_tpu_torch.ssz.impl import copy, hash_tree_root, serialize, uint_to_bytes
from consensus_specs_tpu_torch.ssz.types import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Union,
    Vector,
    View,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)

SRC_DIR = Path(__file__).parent / "src"

# Fork topology: each fork execs its parent chain's sources then its own.
# Mainline ladder phase0 -> altair -> bellatrix -> capella; experimental
# branches hang off bellatrix (mirrors the reference's spec-fork layout:
# eip4844/fork.md builds on bellatrix, sharding/custody_game/das are
# bellatrix-era research forks).
FORK_PARENTS = {
    "phase0": None,
    "altair": "phase0",
    "bellatrix": "altair",
    "capella": "bellatrix",
    "eip4844": "bellatrix",
    "sharding": "bellatrix",
    "custody_game": "sharding",
    "das": "sharding",
}

# Mainline order (kept for callers that iterate the production ladder).
FORK_ORDER = ("phase0", "altair", "bellatrix", "capella")

# The forks that inherit altair's process_attestation and sync aggregate
# verbatim: they take the vectorized attestation path and its
# participation scope.  The sharding-family forks redefine
# process_attestation with shard-header voting and keep the sequential
# path.
ALTAIR_LINEAGE = ("altair", "bellatrix", "capella", "eip4844")


def fork_chain(fork: str) -> Tuple[str, ...]:
    """Ancestor chain root-first, ending at ``fork``."""
    chain = []
    cur: Optional[str] = fork
    while cur is not None:
        chain.append(cur)
        cur = FORK_PARENTS[cur]
    return tuple(reversed(chain))

# Config vars are typed when materialized (reference types them in the
# Configuration NamedTuple, setup.py:632-639).
_CONFIG_TYPES = {
    "TERMINAL_TOTAL_DIFFICULTY": uint256,
    "TERMINAL_BLOCK_HASH": ByteVector[32],
    "GENESIS_FORK_VERSION": ByteVector[4],
    "ALTAIR_FORK_VERSION": ByteVector[4],
    "BELLATRIX_FORK_VERSION": ByteVector[4],
    "CAPELLA_FORK_VERSION": ByteVector[4],
    "SHARDING_FORK_VERSION": ByteVector[4],
    "EIP4844_FORK_VERSION": ByteVector[4],
    "CUSTODY_GAME_FORK_VERSION": ByteVector[4],
    "DAS_FORK_VERSION": ByteVector[4],
    "DEPOSIT_CONTRACT_ADDRESS": ByteVector[20],
    "PRESET_BASE": str,
    "CONFIG_NAME": str,
}


def available_forks() -> Tuple[str, ...]:
    return tuple(f for f in FORK_ORDER if (SRC_DIR / f"{f}.py").exists())


def _typed_config(raw: Dict[str, Any]):
    from consensus_specs_tpu_torch.config.configs import Config

    typed = {}
    for k, v in raw.items():
        t = _CONFIG_TYPES.get(k, uint64)
        typed[k] = v if t is str else t(v)
    return Config(typed)


def _spec_hash_fn():
    """Memoized sha256 — the reference also caches `hash` (it is called
    with identical seeds thousands of times per shuffle)."""
    sha = hashing.sha256
    Bytes32 = ByteVector[32]
    cache: Dict[bytes, bytes] = {}

    def hash_fn(data: bytes) -> bytes:
        data = bytes(data)
        out = cache.get(data)
        if out is None:
            if len(cache) > 200_000:
                cache.clear()
            out = Bytes32(sha(data))
            cache[data] = out
        return out

    return hash_fn


def _base_env(preset: Dict[str, int], config) -> Dict[str, Any]:
    env: Dict[str, Any] = {
        # typing / dataclasses for spec annotations
        "Any": Any,
        "Callable": Callable,
        "Dict": Dict,
        "Set": Set,
        "Sequence": Sequence,
        "Tuple": Tuple,
        "Optional": Optional,
        "NamedTuple": NamedTuple,
        "Protocol": Protocol,
        "TypeVar": TypeVar,
        "dataclass": dataclass,
        "field": field,
        # SSZ type system
        "View": View,
        "boolean": boolean,
        "Container": Container,
        "List": List,
        "Vector": Vector,
        "Union": Union,
        "Bitlist": Bitlist,
        "Bitvector": Bitvector,
        "ByteList": ByteList,
        "ByteVector": ByteVector,
        "uint8": uint8,
        "uint16": uint16,
        "uint32": uint32,
        "uint64": uint64,
        "uint128": uint128,
        "uint256": uint256,
        "Bytes1": ByteVector[1],
        "Bytes4": ByteVector[4],
        "Bytes20": ByteVector[20],
        "Bytes32": ByteVector[32],
        "Bytes48": ByteVector[48],
        "Bytes96": ByteVector[96],
        # seams
        "bls": bls,
        "hash": _spec_hash_fn(),
        "hash_tree_root": hash_tree_root,
        "serialize": serialize,
        "copy": copy,
        "uint_to_bytes": uint_to_bytes,
        "config": config,
        # merkle-proof machinery (altair light client, merkle-proofs.md)
        "GeneralizedIndex": int,
        "get_generalized_index": get_generalized_index,
        "floorlog2": lambda x: uint64(int(x).bit_length() - 1),
    }
    # preset vars become module constants, typed uint64 (setup.py emits
    # them as typed constants the same way)
    for k, v in preset.items():
        env[k] = uint64(v)
    return env


class LRUDict:
    """Small LRU dict (stand-in for the reference's lru-dict C extension,
    setup.py:333).  Accesses refresh recency via move-to-end."""

    __slots__ = ("size", "d")

    def __init__(self, size: int):
        self.size = size
        self.d: Dict[Any, Any] = {}

    def get(self, key, default=None):
        if key in self.d:
            return self[key]
        return default

    def __contains__(self, key):
        return key in self.d

    def __getitem__(self, key):
        value = self.d.pop(key)
        self.d[key] = value  # re-insert at the recent end
        return value

    def __setitem__(self, key, value):
        if key not in self.d and len(self.d) >= self.size:
            self.d.pop(next(iter(self.d)))  # evict least-recent
        self.d[key] = value


def cache_this(key_fn, value_fn, lru_size):
    """Memoize ``value_fn`` under ``key_fn`` (reference: setup.py:369-379)."""
    cache = LRUDict(lru_size)

    def wrapper(*args, **kw):
        key = key_fn(*args, **kw)
        if key not in cache:
            cache[key] = value_fn(*args, **kw)
        return cache[key]

    wrapper.__wrapped__ = value_fn
    return wrapper


def _install_sundry(g: Dict[str, Any]) -> None:
    """LRU caches over hot accessors, keyed on (sub)tree roots so they
    survive state copies (reference: setup.py:380-428)."""
    SLOTS_PER_EPOCH = int(g["SLOTS_PER_EPOCH"])
    MAX_COMMITTEES_PER_SLOT = int(g["MAX_COMMITTEES_PER_SLOT"])

    g["cache_this"] = cache_this

    g["compute_shuffled_index"] = cache_this(
        lambda index, index_count, seed: (index, index_count, seed),
        g["compute_shuffled_index"], lru_size=SLOTS_PER_EPOCH * 3)

    g["get_total_active_balance"] = cache_this(
        lambda state: (state.validators.hash_tree_root(), g["compute_epoch_at_slot"](state.slot)),
        g["get_total_active_balance"], lru_size=10)

    g["get_base_reward"] = cache_this(
        lambda state, index: (state.validators.hash_tree_root(), state.slot, index),
        g["get_base_reward"], lru_size=2048)

    g["get_committee_count_per_slot"] = cache_this(
        lambda state, epoch: (state.validators.hash_tree_root(), epoch),
        g["get_committee_count_per_slot"], lru_size=SLOTS_PER_EPOCH * 3)

    g["get_active_validator_indices"] = cache_this(
        lambda state, epoch: (state.validators.hash_tree_root(), epoch),
        g["get_active_validator_indices"], lru_size=3)

    g["get_beacon_committee"] = cache_this(
        lambda state, slot, index: (
            state.validators.hash_tree_root(), state.randao_mixes.hash_tree_root(), slot, index),
        g["get_beacon_committee"], lru_size=SLOTS_PER_EPOCH * MAX_COMMITTEES_PER_SLOT * 3)

    g["get_matching_target_attestations"] = cache_this(
        lambda state, epoch: (state.hash_tree_root(), epoch),
        g["get_matching_target_attestations"], lru_size=10)

    g["get_matching_head_attestations"] = cache_this(
        lambda state, epoch: (state.hash_tree_root(), epoch),
        g["get_matching_head_attestations"], lru_size=10)

    g["get_attesting_indices"] = cache_this(
        lambda state, data, bits: (
            state.randao_mixes.hash_tree_root(),
            state.validators.hash_tree_root(), data.hash_tree_root(), bits.hash_tree_root(),
        ),
        g["get_attesting_indices"], lru_size=SLOTS_PER_EPOCH * MAX_COMMITTEES_PER_SLOT * 3)


def _install_optimizations(g: Dict[str, Any], device: torch.device) -> None:
    """Semantics-preserving substitutions (the reference sanctions these
    via implement_optimizations, setup.py:65-68).

    ``compute_committee`` is replaced with a whole-permutation variant:
    one vectorized pass produces every committee of the epoch instead of
    2×rounds SHA-256 per member (differential test: tests/test_shuffle.py).
    """
    round_count = int(g["SHUFFLE_ROUND_COUNT"])
    uint64_t = g["uint64"]

    def compute_committee(indices, seed, index, count):
        n = len(indices)
        start = (n * index) // count
        end = (n * uint64_t(index + 1)) // count
        # Failure-semantics parity with the sequential spec: an out-of-range
        # committee index makes compute_shuffled_index trip its
        # `index < index_count` assert there; raise AssertionError here too,
        # not IndexError (fork-choice handlers catch AssertionError only).
        assert end <= n
        perm = compute_shuffle_permutation(bytes(seed), n, round_count)
        return [indices[perm[i]] for i in range(start, end)]

    compute_committee.__doc__ = g["compute_committee"].__doc__
    compute_committee.__wrapped__ = g["compute_committee"]
    g["compute_committee"] = compute_committee

    _install_registry_vectorization(g)
    _install_attestation_pubkey_column(g)
    if g["fork"] == "phase0":
        _install_phase0_epoch_kernel(g, device)
    else:
        _install_altair_epoch_kernel(g)
        if g["fork"] in ALTAIR_LINEAGE:
            _install_altair_attestation_kernel(g)
        _install_sync_aggregate_index(g)  # every fork inherits altair's
    _install_deferred_block_verification(g)


def _install_attestation_pubkey_column(g: Dict[str, Any]) -> None:
    """Swap the per-index pubkey gather in is_valid_indexed_attestation
    (``[state.validators[i].pubkey for i in indices]`` — a tree descent +
    view materialization per member, ~25k reads per mainnet block) for a
    registry-root-cached pubkey column read (ssz/bulk.py, one walk per
    registry version).  Semantics preserved exactly: same emptiness /
    sorted-unique gate, same IndexError on out-of-range indices, same
    verification call.  Differential test:
    tests/spec/phase0/test_pubkey_column.py."""
    from consensus_specs_tpu_torch.ssz import bulk

    def is_valid_indexed_attestation(state, indexed_attestation):
        indices = indexed_attestation.attesting_indices
        if len(indices) == 0 or not indices == sorted(set(indices)):
            return False
        column = bulk.cached_validator_pubkeys(state.validators)
        pubkeys = [column[int(i)] for i in indices]
        domain = g["get_domain"](state, g["DOMAIN_BEACON_ATTESTER"],
                                 indexed_attestation.data.target.epoch)
        signing_root = g["compute_signing_root"](
            indexed_attestation.data, domain)
        return g["bls"].FastAggregateVerify(
            pubkeys, signing_root, indexed_attestation.signature)

    _swap(g, "is_valid_indexed_attestation", is_valid_indexed_attestation)


import contextvars as _contextvars

# block-scoped numpy mirror of the altair participation lists: the spec's
# per-index flag writes are single-item tree path copies (~25k per mainnet
# block); within one process_block the mirror absorbs them and ONE packed
# write per touched list materializes the result
_part_scope: "_contextvars.ContextVar" = _contextvars.ContextVar(
    "altair_participation_scope", default=None)


class _ParticipationBlockScope:
    def __init__(self, state):
        from consensus_specs_tpu_torch.ssz import bulk

        self._bulk = bulk
        self.prev = bulk.packed_uint8_to_numpy(state.previous_epoch_participation)
        self.cur = bulk.packed_uint8_to_numpy(state.current_epoch_participation)
        self.n0_prev = len(self.prev)
        self.n0_cur = len(self.cur)
        self.dirty_prev = False
        self.dirty_cur = False
        # per-block base-reward column (effective balances and the
        # per-increment reward are constant within a block)
        self.base_rewards = None

    def flush(self, state) -> None:
        """Materialize mirror updates.  Entries appended DURING the block
        (process_deposit) live only in the view and are untouched by flag
        updates (a just-deposited validator cannot attest), so the merged
        result is mirror[:n0] + view[n0:]."""
        import numpy as np

        for dirty, mirror, n0, name in (
            (self.dirty_prev, self.prev, self.n0_prev,
             "previous_epoch_participation"),
            (self.dirty_cur, self.cur, self.n0_cur,
             "current_epoch_participation"),
        ):
            if not dirty:
                continue
            view = getattr(state, name)
            if len(view) > n0:
                tail = self._bulk.packed_uint8_to_numpy(view)[n0:]
                mirror = np.concatenate([mirror, tail])
            self._bulk.set_packed_uint8_from_numpy(view, mirror)


def _install_altair_attestation_kernel(g: Dict[str, Any]) -> None:
    """Vectorize altair's process_attestation flag loop (the per-block hot
    path: ~25k single-index participation writes through the tree on a
    full mainnet block).  Validation asserts are transcribed verbatim;
    inside a process_block participation scope the flag updates and the
    proposer-reward numerator are computed on the numpy mirror with EXACT
    integer arithmetic; outside a scope the sequential original runs.
    Failure contract matches the deferred-BLS wrapper: a raising block
    leaves state partially applied and callers discard it.  Differential
    tests: tests/test_torch_spec_altair.py (roots equal to the
    reference's after every block)."""
    import numpy as np

    from consensus_specs_tpu_torch.ops import epoch as epoch_ops

    orig = g["process_attestation"]

    def process_attestation(state, attestation):
        scope = _part_scope.get()
        if scope is None:
            return orig(state, attestation)
        data = attestation.data
        assert data.target.epoch in (
            g["get_previous_epoch"](state), g["get_current_epoch"](state))
        assert data.target.epoch == g["compute_epoch_at_slot"](data.slot)
        assert (data.slot + g["MIN_ATTESTATION_INCLUSION_DELAY"]
                <= state.slot <= data.slot + g["SLOTS_PER_EPOCH"])
        assert data.index < g["get_committee_count_per_slot"](
            state, data.target.epoch)
        committee = g["get_beacon_committee"](state, data.slot, data.index)
        assert len(attestation.aggregation_bits) == len(committee)

        participation_flag_indices = g[
            "get_attestation_participation_flag_indices"](
            state, data, state.slot - data.slot)

        assert g["is_valid_indexed_attestation"](
            state, g["get_indexed_attestation"](state, attestation))

        if data.target.epoch == g["get_current_epoch"](state):
            mirror = scope.cur
            scope.dirty_cur = True
        else:
            mirror = scope.prev
            scope.dirty_prev = True

        members = np.fromiter(
            g["get_attesting_indices"](state, data, attestation.aggregation_bits),
            dtype=np.int64)
        # exact get_base_reward column: effective // EBI * per-increment,
        # computed once per block scope
        if scope.base_rewards is None:
            cols = epoch_ops.registry_columns(state)
            per_incr = int(g["get_base_reward_per_increment"](state))
            ebi = int(g["EFFECTIVE_BALANCE_INCREMENT"])
            scope.base_rewards = cols["effective_balance"] // ebi * per_incr
        base_rewards = scope.base_rewards

        proposer_reward_numerator = 0
        for flag_index, weight in enumerate(g["PARTICIPATION_FLAG_WEIGHTS"]):
            if flag_index not in participation_flag_indices:
                continue
            bit = np.uint8(1 << flag_index)
            newly = members[(mirror[members] & bit) == 0]
            if len(newly) == 0:
                continue
            mirror[newly] |= bit
            proposer_reward_numerator += int(
                np.sum(base_rewards[newly], dtype=np.uint64)) * int(weight)

        proposer_reward_denominator = (
            (g["WEIGHT_DENOMINATOR"] - g["PROPOSER_WEIGHT"])
            * g["WEIGHT_DENOMINATOR"] // g["PROPOSER_WEIGHT"])
        proposer_reward = g["Gwei"](
            proposer_reward_numerator // int(proposer_reward_denominator))
        g["increase_balance"](
            state, g["get_beacon_proposer_index"](state), proposer_reward)

    _swap(g, "process_attestation", process_attestation)


def _install_sync_aggregate_index(g: Dict[str, Any]) -> None:
    """Replace process_sync_aggregate's committee-index resolution — the
    spec scans ALL validators and runs a linear ``list.index`` per
    committee seat (altair/beacon-chain.md:503-504), an O(registry)
    full-view walk per block — with the registry-root-cached pubkey
    reverse index (first-occurrence semantics identical to list.index).
    Signature verification and the reward arithmetic stay the spec's own
    lines.  Differential: tests/test_torch_spec_altair.py."""
    def process_sync_aggregate(state, sync_aggregate):
        from consensus_specs_tpu_torch.ssz import bulk

        Slot = g["Slot"]
        Gwei = g["Gwei"]
        committee_pubkeys = state.current_sync_committee.pubkeys
        participant_pubkeys = [
            pubkey for pubkey, bit
            in zip(committee_pubkeys, sync_aggregate.sync_committee_bits)
            if bit]
        previous_slot = max(state.slot, Slot(1)) - Slot(1)
        domain = g["get_domain"](
            state, g["DOMAIN_SYNC_COMMITTEE"],
            g["compute_epoch_at_slot"](previous_slot))
        signing_root = g["compute_signing_root"](
            g["get_block_root_at_slot"](state, previous_slot), domain)
        assert g["eth_fast_aggregate_verify"](
            participant_pubkeys, signing_root,
            sync_aggregate.sync_committee_signature)

        total_active_increments = (
            g["get_total_active_balance"](state)
            // g["EFFECTIVE_BALANCE_INCREMENT"])
        total_base_rewards = Gwei(
            g["get_base_reward_per_increment"](state) * total_active_increments)
        max_participant_rewards = Gwei(
            total_base_rewards * g["SYNC_REWARD_WEIGHT"]
            // g["WEIGHT_DENOMINATOR"] // g["SLOTS_PER_EPOCH"])
        participant_reward = Gwei(
            max_participant_rewards // g["SYNC_COMMITTEE_SIZE"])
        proposer_reward = Gwei(
            participant_reward * g["PROPOSER_WEIGHT"]
            // (g["WEIGHT_DENOMINATOR"] - g["PROPOSER_WEIGHT"]))

        index_of = bulk.cached_pubkey_index(state.validators)
        try:
            committee_indices = [
                g["ValidatorIndex"](index_of[bytes(pubkey)])
                for pubkey in committee_pubkeys]
        except KeyError:
            # exception-type parity with the spec's list.index on a
            # pubkey missing from the registry
            raise ValueError("sync committee pubkey is not in list") from None
        for participant_index, participation_bit in zip(
                committee_indices, sync_aggregate.sync_committee_bits):
            if participation_bit:
                g["increase_balance"](
                    state, participant_index, participant_reward)
                g["increase_balance"](
                    state, g["get_beacon_proposer_index"](state),
                    proposer_reward)
            else:
                g["decrease_balance"](
                    state, participant_index, participant_reward)

    _swap(g, "process_sync_aggregate", process_sync_aggregate)


def _install_deferred_block_verification(g: Dict[str, Any]) -> None:
    """Batch a block's aggregate-signature checks into one pairing product.

    ``process_block`` runs under ``bls.deferred_fast_aggregate_verify``:
    every FastAggregateVerify its operations issue (attestations via
    is_valid_indexed_attestation, attester slashings, altair+ sync
    aggregates) is collected and settled in a single batched verification
    with one shared final exponentiation — the sanctioned sundry-layer
    substitution (SURVEY §7; reference analogue setup.py:488-492).  Failure
    ordering is preserved by the context manager: the AssertionError names
    the first failing check in sequential call order.  Differential tests:
    tests/spec/phase0/test_batch_verification.py.

    CONTRACT — state mutation on failure: execution is optimistic, so an
    operation whose aggregate signature is invalid has already mutated
    ``state`` (e.g. an attester slashing applied) by the time the deferred
    settlement raises at scope exit.  The sequential reference path asserts
    BEFORE applying.  Callers must therefore treat ``state`` as poisoned
    whenever process_block raises — exactly what every in-repo caller
    (state_transition wrappers, the test harness, gen runners) already
    does by discarding the failed state object."""
    from consensus_specs_tpu_torch.crypto import bls as bls_mod

    orig = g["process_block"]
    # only the forks whose process_attestation consumes the scope (the
    # altair lineage)
    with_participation = g["fork"] in ALTAIR_LINEAGE

    def process_block(state, block):
        scope = token = None
        if with_participation:
            scope = _ParticipationBlockScope(state)
            token = _part_scope.set(scope)
        try:
            with bls_mod.deferred_fast_aggregate_verify():
                orig(state, block)
            if scope is not None:
                # success only: a raising block leaves state partially
                # applied per the contract above, and flushing optimistic
                # flag updates would widen the divergence
                scope.flush(state)
        finally:
            if token is not None:
                _part_scope.reset(token)

    process_block.__doc__ = orig.__doc__
    process_block.__wrapped__ = orig
    g["process_block"] = process_block


def _install_altair_epoch_kernel(g: Dict[str, Any]) -> None:
    """Post-altair epoch vectorization: flag-based rewards, inactivity
    scores, participation rotation (ops/epoch_altair.py).  Differential
    tests: tests/test_torch_epoch_altair.py."""
    from consensus_specs_tpu_torch.ops import epoch_altair

    proxy = _LiveSpecProxy(g)
    _swap(g, "process_justification_and_finalization",
          lambda state: epoch_altair.justification_and_finalization(proxy, state))
    _swap(g, "process_rewards_and_penalties",
          lambda state: epoch_altair.rewards_and_penalties(proxy, state))
    _swap(g, "process_inactivity_updates",
          lambda state: epoch_altair.inactivity_updates(proxy, state))
    _swap(g, "process_participation_flag_updates",
          lambda state: epoch_altair.participation_flag_updates(proxy, state))


def _swap(g: Dict[str, Any], name: str, fn) -> None:
    orig = g[name]
    fn.__doc__ = orig.__doc__
    fn.__wrapped__ = orig
    g[name] = fn


# process_slashings carries a fork-specific proportional multiplier
# constant; experimental forks inherit their parent's epoch processing
_SLASHING_MULT = {
    "phase0": "PROPORTIONAL_SLASHING_MULTIPLIER",
    "altair": "PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR",
    "bellatrix": "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
    "capella": "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
    "eip4844": "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
    "sharding": "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
    "custody_game": "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
    "das": "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX",
}


def _install_registry_vectorization(g: Dict[str, Any]) -> None:
    """Fork-independent O(n) registry scans -> columns off the Merkle
    backing + numpy (semantics-preserving; sequential originals stay on
    __wrapped__; differential tests in tests/spec/phase0/test_epoch_kernel.py).
    Runs BEFORE the sundry layer so its LRU caches wrap these."""
    from consensus_specs_tpu_torch.ops import epoch as epoch_ops

    proxy = _LiveSpecProxy(g)
    Gwei = g["Gwei"]
    Vidx = g["ValidatorIndex"]

    _swap(g, "get_active_validator_indices",
          lambda state, epoch: [
              Vidx(i) for i in epoch_ops.active_validator_indices(proxy, state, epoch)
          ])
    _swap(g, "get_total_active_balance",
          lambda state: Gwei(epoch_ops.total_active_balance(proxy, state)))
    _swap(g, "process_effective_balance_updates",
          lambda state: epoch_ops.effective_balance_updates(proxy, state))
    _swap(g, "process_registry_updates",
          lambda state: epoch_ops.registry_updates(proxy, state))

    mult_name = _SLASHING_MULT[g["fork"]]

    def process_slashings(state):
        epoch_ops.slashings_sweep(proxy, state, int(g[mult_name]))

    _swap(g, "process_slashings", process_slashings)


class _LiveSpecProxy:
    """Attribute view over a spec module's globals dict; hands the epoch
    kernels a `spec`-shaped object that sees sundry-layer caches."""

    def __init__(self, g: Dict[str, Any]):
        self._g = g

    def __getattr__(self, name: str):
        try:
            return self._g[name]
        except KeyError:
            raise AttributeError(name) from None


def _install_phase0_epoch_kernel(g: Dict[str, Any], device: torch.device) -> None:
    """Swap the O(validators x attestations) Python rewards loop for the
    vectorized torch deltas on ``device`` + bulk balance write (SURVEY §7
    step 7; sanctioned-substitution pattern of reference setup.py:65-68).
    At ``RESIDENT_MIN`` validators and up, the deltas, the balance update
    and the balances' merkle root run as one fused pass on ``device`` (on a
    CPU device only with ``merkle_resident.RESIDENT_ON_CPU``).
    Differential tests: tests/test_torch_spec_phase0.py."""
    from consensus_specs_tpu_torch.ops import epoch as epoch_ops
    from consensus_specs_tpu_torch.ops import merkle_resident

    proxy = _LiveSpecProxy(g)
    Gwei = g["Gwei"]
    orig_deltas = g["get_attestation_deltas"]
    orig_rap = g["process_rewards_and_penalties"]

    def get_attestation_deltas(state):
        rewards, penalties = epoch_ops.attestation_deltas_for_state(proxy, state, device)
        return (
            [Gwei(int(x)) for x in rewards],
            [Gwei(int(x)) for x in penalties],
        )

    get_attestation_deltas.__doc__ = orig_deltas.__doc__
    get_attestation_deltas.__wrapped__ = orig_deltas
    g["get_attestation_deltas"] = get_attestation_deltas

    def process_rewards_and_penalties(state):
        from consensus_specs_tpu_torch.stf import columns as stf_columns

        if g["get_current_epoch"](state) == g["GENESIS_EPOCH"]:
            return
        inp = epoch_ops.extract_delta_inputs(proxy, state)
        # balance read + write ride the resident column store:
        # the read is a dict probe when any earlier consumer touched this
        # version, and the flush stages the written array so the rest of
        # the epoch transition (slashings, hysteresis, resident upload)
        # never re-walks the subtree
        balances = stf_columns.balance_column(state)
        resident = merkle_resident.resident_device(len(balances), device)
        cache_key = epoch_ops.delta_device_cache(proxy, state)
        if resident is not None:
            # residency composes: deltas kernel + balance update + merkle
            # reduction in ONE device program; the device-computed subtree
            # root is memoized into the fresh backing so the next state
            # root never hashes the balances subtree on host
            new_balances, padded_root = merkle_resident.fused_epoch_balance_update(
                inp, balances, resident, device_cache=cache_key)
            stf_columns.flush_balances(state, new_balances)
            merkle_resident.memoize_packed_u64_contents_root(
                state.balances, padded_root)
            return
        rewards, penalties = epoch_ops.attestation_deltas(
            inp, device, device_cache=cache_key)
        increased = balances + rewards
        new_balances = np.where(penalties > increased, 0, increased - penalties)
        stf_columns.flush_balances(state, new_balances)

    process_rewards_and_penalties.__doc__ = orig_rap.__doc__
    process_rewards_and_penalties.__wrapped__ = orig_rap
    g["process_rewards_and_penalties"] = process_rewards_and_penalties

    _swap(g, "get_attesting_balance",
          lambda state, attestations: g["Gwei"](
              epoch_ops.attesting_balance(proxy, state, attestations)))

    # the epoch's pending scans ride ONE shared memoized pass (target +
    # head computed together, both key halves memoized subtree roots)
    # instead of two per-pending listcomps LRU'd on the full state root;
    # downstream attester resolution already rides the plan-cache path
    # (epoch_ops.attesting_indices).  Differential:
    # tests/spec/phase0/test_epoch_kernel.py::test_matching_scans in the
    # reference
    _swap(g, "get_matching_target_attestations",
          lambda state, epoch: epoch_ops.matching_target_attestations(
              proxy, state, epoch))
    _swap(g, "get_matching_head_attestations",
          lambda state, epoch: epoch_ops.matching_head_attestations(
              proxy, state, epoch))


# RLock: building fork F recursively resolves its predecessor via get_spec
_lock = threading.RLock()
_spec_cache: Dict[Tuple[str, str, str], ModuleType] = {}
# numbers the modules of config builds (see build_spec)
_config_builds = itertools.count()


def build_spec(fork: str, preset_name: str, device=None, config=None,
               name: Optional[str] = None) -> ModuleType:
    """Build a fresh spec module (uncached) whose device work runs on
    ``device`` (None: the CUDA card).  ``config`` may be a Config override
    (the test framework's ``with_config_overrides``); the intermediate forks
    are then built with it too.  ``name`` names the module."""
    assert fork in FORK_PARENTS, f"unknown fork {fork}"
    device = resolve_device(device)
    preset = get_preset(preset_name)
    cfg = config if config is not None else _typed_config(get_config(preset_name).to_dict())

    # the device is part of the name: a cpu and a cuda build of one fork
    # must not replace each other in sys.modules, and a config build takes
    # a name of its own, so that it never replaces the cached spec's
    dev_tag = str(device).replace(":", "_")
    mod_name = name or f"consensus_specs_tpu_torch.specs.{fork}_{preset_name}_{dev_tag}"
    if name is None and config is not None:
        mod_name += f"_config{next(_config_builds)}"
    mod = ModuleType(mod_name)
    g = mod.__dict__
    g.update(_base_env(preset, cfg))
    g["fork"] = fork
    g["preset_name"] = preset_name
    # the block engine's per-slot roots (stf/slot_roots.py) read the
    # device the spec was built for from here
    g["device"] = device
    # dataclasses (and pickling) resolve classes through sys.modules
    sys.modules[mod_name] = mod

    prev: Optional[ModuleType] = None
    for f in fork_chain(fork):
        if prev is not None:
            # predecessor module available under its fork name for
            # upgrade_to_* functions
            g[prev.fork] = prev
        src = (SRC_DIR / f"{f}.py").read_text()
        # dont_inherit: this module's `from __future__ import annotations`
        # must NOT leak into spec sources (containers need live types)
        code = compile(src, str(SRC_DIR / f"{f}.py"), "exec", dont_inherit=True)
        exec(code, g)
        if f == fork:
            break
        # snapshot the intermediate fork as its own finished spec so
        # upgrade functions see the *complete* predecessor
        prev = (get_spec(f, preset_name, device) if config is None
                else build_spec(f, preset_name, device, cfg))

    # optimizations first: the sundry LRU caches then wrap the vectorized
    # accessors (get_total_active_balance etc.), not the sequential ones
    _install_optimizations(g, device)
    _install_sundry(g)
    return mod


def get_spec(fork: str, preset_name: str = "minimal", device=None) -> ModuleType:
    """Cached spec module for fork×preset×device (reference: the 8-module
    registry in test/context.py:73-86).  ``device`` None is the CUDA card;
    without one this raises rather than build a CPU spec."""
    device = resolve_device(device)
    key = (fork, preset_name, str(device))
    with _lock:
        spec = _spec_cache.get(key)
        if spec is None:
            spec = build_spec(fork, preset_name, device)
            _spec_cache[key] = spec
    return spec
