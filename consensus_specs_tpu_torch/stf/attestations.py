"""Whole-block attestation resolution for the batched transition engine.

The spec's ``process_attestation`` resolves each aggregate's committee with
``get_beacon_committee`` (a Python list comprehension over the shuffled
permutation) and its attesters with a per-bit Python loop, then gathers
per-member pubkeys one view access at a time — ~25k Python object hops per
full mainnet block.  This module resolves the WHOLE block at once:

* committees come straight off the cached whole-epoch shuffle permutation
  (``ops/shuffle.py``) as numpy gathers — ``active[perm[start:end]]`` with
  the spec's exact ``compute_committee`` slice arithmetic
  (``ops/shuffle.committee_bounds``);
* attester sets are one boolean mask + sort per attestation, with
  per-attestation participation counts reduced in bulk by
  ``ops/segment.segment_sum`` (the same primitive the fork-choice batch
  path uses for vote deltas);
* member pubkeys are rows of a registry-keyed affine-coordinate matrix
  (decompressed once per validator through the native cache), so batch
  entries are contiguous buffer slices instead of per-member dict walks.

Every structural rule of ``process_attestation`` is checked here in spec
order; any violation raises ``FastPathViolation`` and the engine replays
the block through the literal spec path, which re-raises the spec's exact
exception (stf/engine.py).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from consensus_specs_tpu_torch import faults, telemetry
from consensus_specs_tpu_torch.ops.segment import segment_sum
from consensus_specs_tpu_torch.ops.shuffle import committee_bounds, compute_shuffle_permutation
from consensus_specs_tpu_torch.ssz import bulk

from . import staging


class FastPathViolation(Exception):
    """A block failed a fast-path check (or needs a capability the fast
    path lacks): the engine rolls back and replays through the literal
    spec, which raises the spec's own exception."""


# fault probes (tests/chaos/): whole-block resolution and the affine
# gather feed the signature batch — both must fail into the replay
# contract without poisoning a memo; the plan memo is probed on the
# value it is about to insert, so a corrupted plan is both consumed by
# the faulted block (bad members -> failed batch or root mismatch) and
# popped again by the cache transaction when that block rolls back
_SITE_RESOLVE = faults.site("stf.attestations.resolve")
_SITE_AFFINE_ROWS = faults.site("stf.attestations.affine_rows")
_SITE_PLAN_MEMO = faults.site("stf.attestations.plan_memo")

# plan-cache effectiveness counters: the e2e speed story leans
# on re-carried aggregates hitting the plan memo, so the hit/miss split
# is first-class telemetry — bench embeds the ratio and the trend gate
# refuses a run whose ratio silently collapsed
stats = {"plan_hits": 0, "plan_misses": 0}


def reset_stats() -> None:
    """Zero the plan-cache counters (``reset_caches`` calls this too, so
    a cold-start-controlled bench pass reports its own ratio)."""
    for k in stats:
        stats[k] = 0


# -- per-epoch committee geometry --------------------------------------------

_ACTIVE_CACHE: dict = {}
_CTX_CACHE: dict = {}
_CTX_LOOKUP: dict = {}
_CACHE_MAX = 8


def _fifo_put(cache: dict, key, value, cap: int = _CACHE_MAX):
    """FIFO insert, recorded with the block's cache transaction (if one
    is active) so a failed block's inserts roll back — the transactional
    half of the rollback contract (stf/staging.py)."""
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value
    staging.note_insert(cache, key)
    return value


def active_indices(spec, state, epoch: int) -> np.ndarray:
    """Ascending active-validator index array for ``epoch`` (the numpy
    form of ``get_active_validator_indices``), registry-root-cached."""
    from consensus_specs_tpu_torch.ops.epoch import active_mask, registry_columns

    key = (bytes(state.validators.hash_tree_root()), int(epoch))
    hit = _ACTIVE_CACHE.get(key)
    if hit is not None:
        return hit
    return _fifo_put(_ACTIVE_CACHE, key, np.nonzero(
        active_mask(registry_columns(state), int(epoch)))[0])


class _CommitteeContext:
    """Numpy view of one epoch's committees: active-validator array, the
    cached shuffle permutation, and all committee slice bounds."""

    def __init__(self, spec, state, epoch: int, seed: bytes):
        self.active = active_indices(spec, state, epoch)
        self.slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
        n = len(self.active)
        # get_committee_count_per_slot (beacon-chain.md:931-940) off the
        # active COUNT — the spec call would materialize the 400k-element
        # active index list just to len() it
        self.committees_per_slot = max(1, min(
            int(spec.MAX_COMMITTEES_PER_SLOT),
            n // self.slots_per_epoch // int(spec.TARGET_COMMITTEE_SIZE)))
        count = self.committees_per_slot * self.slots_per_epoch
        self.bounds = committee_bounds(n, count)
        self.perm = compute_shuffle_permutation(
            seed, n, int(spec.SHUFFLE_ROUND_COUNT))

    def committee(self, slot: int, index: int) -> np.ndarray:
        g = (slot % self.slots_per_epoch) * self.committees_per_slot + index
        lo, hi = self.bounds[g], self.bounds[g + 1]
        return self.active[self.perm[lo:hi]]


def _spec_geometry_key(spec) -> tuple:
    """The spec constants the committee computation reads — every memo
    key below must bind them (CC02): two spec builds sharing registry and
    randao roots but differing in preset geometry must never share a
    context."""
    return (int(spec.SLOTS_PER_EPOCH), int(spec.MAX_COMMITTEES_PER_SLOT),
            int(spec.TARGET_COMMITTEE_SIZE), int(spec.SHUFFLE_ROUND_COUNT))


def _ctx_lookup_key(spec, state, epoch: int) -> tuple:
    """The memoized-root lookup key of one epoch's committee geometry —
    also the context half of every attestation-plan key (below): two
    states sharing it resolve every committee identically."""
    return (
        bytes(state.validators.hash_tree_root()),
        bytes(state.randao_mixes.hash_tree_root()),
        int(epoch),
        _spec_geometry_key(spec),
    )


def committee_context(spec, state, epoch: int) -> _CommitteeContext:
    """Cached committee geometry.  The context itself is keyed on registry
    root + attester seed (the full input set of the spec's committee
    computation); a lookup layer keyed on the memoized registry/randao
    roots makes the per-attestation hit path a dict probe instead of a
    ``get_seed`` hash chain."""
    lookup_key = _ctx_lookup_key(spec, state, epoch)
    ctx = _CTX_LOOKUP.get(lookup_key)
    if ctx is not None:
        return ctx
    seed = bytes(spec.get_seed(
        state, spec.Epoch(epoch), spec.DOMAIN_BEACON_ATTESTER))
    key = (lookup_key[0], int(epoch), seed, _spec_geometry_key(spec))
    ctx = _CTX_CACHE.get(key)
    if ctx is None:
        ctx = _fifo_put(
            _CTX_CACHE, key, _CommitteeContext(spec, state, int(epoch), seed))
    return _fifo_put(_CTX_LOOKUP, lookup_key, ctx)


# -- proposer index off the numpy active set ---------------------------------

_PROPOSER_CACHE: dict = {}


def beacon_proposer_index(spec, state):
    """``get_beacon_proposer_index`` (beacon-chain.md:954-961) evaluated
    against the numpy active array: same seed, same scalar shuffled-index
    walk, same effective-balance rejection sampling — without building the
    spec's 400k-element ``ValidatorIndex`` list per epoch."""
    from consensus_specs_tpu_torch.ops.epoch import registry_columns

    epoch = spec.get_current_epoch(state)
    seed = bytes(spec.hash(
        spec.get_seed(state, epoch, spec.DOMAIN_BEACON_PROPOSER)
        + spec.uint_to_bytes(spec.uint64(state.slot))))
    key = (bytes(state.validators.hash_tree_root()), seed,
           _spec_geometry_key(spec), int(spec.MAX_EFFECTIVE_BALANCE))
    hit = _PROPOSER_CACHE.get(key)
    if hit is not None:
        return hit
    active = active_indices(spec, state, int(epoch))
    eff = registry_columns(state)["effective_balance"]
    max_eb = int(spec.MAX_EFFECTIVE_BALANCE)
    total = spec.uint64(len(active))
    # compute_proposer_index (beacon-chain.md:886-902) verbatim over the
    # numpy candidates; compute_shuffled_index is the spec's own (LRU'd)
    assert total > 0
    i = spec.uint64(0)
    while True:
        shuffled = spec.compute_shuffled_index(
            spec.uint64(int(i) % int(total)), total, seed)
        candidate = int(active[int(shuffled)])
        random_byte = spec.hash(
            seed + spec.uint_to_bytes(spec.uint64(int(i) // 32)))[int(i) % 32]
        if int(eff[candidate]) * 255 >= max_eb * random_byte:
            return _fifo_put(_PROPOSER_CACHE, key, spec.ValidatorIndex(candidate))
        i = spec.uint64(int(i) + 1)


# -- registry affine-coordinate matrix ---------------------------------------

_AFFINE_MATRIX_CACHE = bulk.RootKeyedCache(2)

_ZERO_ROW = b"\x00" * 96


def _new_affine_matrix(validators):
    """Eager whole-registry affine matrix: decompress each UNIQUE pubkey
    once through the batched native entry (one thread-pooled call, not a
    ctypes round-trip per key), then one C-speed join over the column.
    Rows whose pubkey cannot decompress are zero-marked, not fatal — the
    spec only fails when such a validator actually attests."""
    from consensus_specs_tpu_torch.crypto.bls import native

    column = bulk.cached_validator_pubkeys(validators)
    affine_of = native.pubkey_affine_batch(set(column))
    invalid_pks = {pk for pk, xy in affine_of.items() if xy is None}
    for pk in invalid_pks:
        affine_of[pk] = _ZERO_ROW
    n = len(column)
    mat = np.frombuffer(
        b"".join(map(affine_of.__getitem__, column)), dtype=np.uint8
    ).reshape(n, 96)
    invalid = None
    if invalid_pks:
        invalid = np.fromiter(
            (pk in invalid_pks for pk in column), dtype=bool, count=n)
    return {"mat": mat, "invalid": invalid, "root": bytes(validators.hash_tree_root())}


def affine_matrix(validators) -> dict:
    """Registry-root-cached affine coordinate matrix + invalid-row mask.
    A build triggered mid-block is recorded with the cache transaction
    like every other fast-path insert (the value is pure in the registry
    root, so the rollback only costs a rebuild)."""
    return _AFFINE_MATRIX_CACHE.get(validators, _new_affine_matrix,
                                    on_insert=staging.note_insert)


def reset_caches() -> None:
    """Drop every derived-geometry cache (committee contexts, active sets,
    proposer walks, attestation plans, affine matrices, sync-committee
    seat rows, resident columns) plus the native decompression cache —
    bench cold-start control and test isolation."""
    from . import columns, sync

    from consensus_specs_tpu_torch.ops import epoch

    _ACTIVE_CACHE.clear()
    _CTX_CACHE.clear()
    _CTX_LOOKUP.clear()
    _PROPOSER_CACHE.clear()
    _PLAN_CACHE.clear()
    _PLAN_CTX_LOOKUP.clear()
    _AFFINE_MATRIX_CACHE._store.clear()
    reset_stats()
    sync.reset_caches()
    columns.reset_caches()
    epoch.reset_caches()  # matching-scan memo: same cold-start control
    try:
        from consensus_specs_tpu_torch.crypto.bls import native

        native.clear_affine_cache()
        native.clear_h2c_cache()  # same cold-start control for hashing
    except ImportError:
        pass


def affine_rows(validators, indices: np.ndarray) -> bytes:
    """Contiguous affine x||y coordinates for ``indices`` (ascending
    member order of one batch entry)."""
    entry = affine_matrix(validators)
    if entry["invalid"] is not None and entry["invalid"][indices].any():
        # an unverifiable member pubkey: the spec's FastAggregateVerify
        # returns False and process_attestation asserts — replay path
        raise FastPathViolation("invalid registry pubkey among attesters")
    # probed on the outgoing buffer: a corrupted coordinate fails the
    # batch, bisects to this entry, and the block replays literally
    return _SITE_AFFINE_ROWS(entry["mat"][indices].tobytes())


# -- whole-block resolution: the epoch-scoped attestation plan ---------------

# plan memo: (plan ctx key, attestation-data root, aggregation-bits
# root) -> AttestationPlan.  The corpus a live node sees re-carries
# aggregates heavily (every attestation rides in the next two blocks;
# gossip re-delivery does the same), so most of a block's resolutions are
# repeats of work an earlier block already did — committee gather, bits
# unpack, attester sort.  Both root halves are memoized SSZ roots, so the
# key is content-addressed: distinct decoded copies of the same aggregate
# hit the same plan.  The ctx half is the committee computation's TRUE
# input set — (registry root, epoch, attester seed, geometry) — NOT the
# full randao_mixes root: the current epoch's mix changes every block
# (process_randao), while the seed reads a mix pinned epochs ago, so
# seed-keying is what makes plans live across the blocks that re-carry
# them (and across the epoch boundary's pending-attestation scans).
# Capacity covers two full mainnet epochs of unique aggregates
# (2 * 32 slots * 64 committees) with headroom.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 8192

# (ctx lookup key) -> (plan ctx key): maps the cheap memoized-root lookup
# identity onto the seed identity so repeat callers (the epoch kernel's
# per-pending scans) pay a dict probe, not a get_seed hash chain
_PLAN_CTX_LOOKUP: dict = {}


def plan_ctx_key(spec, state, epoch: int) -> tuple:
    """The plan key's context half for one (state, epoch): registry root +
    epoch + attester seed + geometry constants (CC02-covered through
    ``_ctx_lookup_key``'s transparency)."""
    lk = _ctx_lookup_key(spec, state, epoch)
    pk = _PLAN_CTX_LOOKUP.get(lk)
    if pk is None:
        seed = bytes(spec.get_seed(
            state, spec.Epoch(epoch), spec.DOMAIN_BEACON_ATTESTER))
        pk = (lk[0], int(epoch), seed, lk[3])
        _fifo_put(_PLAN_CTX_LOOKUP, lk, pk)
    return pk


def cached_plan_attesters(plan_ctx: tuple, data, bits):
    """The owner-side read seam for state-resident pending attestations
    (``ops/epoch.attesting_indices``): the epoch transition's
    per-pending scans resolve the very aggregates the block path already
    planned, so a probe on the content-addressed key replaces the
    committee gather + bits unpack.  ``plan_ctx`` is ``plan_ctx_key``
    computed ONCE per scan — recomputing it per pending would re-pay the
    two state-field view constructions 14k times per epoch.  Returns the
    SORTED attester array on a hit (callers are set-semantics scatters),
    or None."""
    plan = _PLAN_CACHE.get((plan_ctx,
                            bytes(data.hash_tree_root()),
                            bytes(bits.hash_tree_root())))
    return plan.attesters if plan is not None else None


class AttestationPlan(NamedTuple):
    """One aggregate's resolved application plan: everything about the
    attestation that is pure in (committee geometry, data, bits) — the
    per-block work left is the state-slot window checks, the justified-
    checkpoint compare, and the state writes themselves."""

    attesters: np.ndarray  # sorted attesting validator indices (readonly)
    data_root: bytes       # hash_tree_root(att.data) — signing-root input
    target_epoch: int      # int(data.target.epoch) — the apply loops'
    #                        current/previous discriminator, off the plan
    #                        instead of a per-attestation SSZ field chain


def resolve_block_attestations(spec, state) -> "_BlockResolver":
    return _BlockResolver(spec, state)


class _BlockResolver:
    """Resolves every attestation of one block against a fixed pre-ops
    state snapshot of the committee geometry."""

    def __init__(self, spec, state):
        self.spec = spec
        self.state = state
        self.previous_epoch = int(spec.get_previous_epoch(state))
        self.current_epoch = int(spec.get_current_epoch(state))
        self.state_slot = int(state.slot)
        self.min_delay = int(spec.MIN_ATTESTATION_INCLUSION_DELAY)
        self.slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
        # the two plan ctx keys a block can touch, computed once per
        # block instead of per attestation (memoized-root reads + tuple
        # build were the hit path's dominant cost)
        self._ctx_keys: dict = {}

    def _ctx_key(self, target_epoch: int) -> tuple:
        key = self._ctx_keys.get(target_epoch)
        if key is None:
            key = self._ctx_keys[target_epoch] = plan_ctx_key(
                self.spec, self.state, target_epoch)
        return key

    def resolve(self, attestations) -> List[AttestationPlan]:
        """One ``AttestationPlan`` per attestation, after the spec's
        structural asserts (process_attestation, beacon-chain.md:1686-1714)
        — target epoch window, slot inclusion window, committee index
        range, and bit-count/committee-size match.  State-dependent checks
        (epoch window, inclusion window) re-run per block; data-pure checks
        and the committee gather + bits unpack + attester sort are served
        from the plan memo (a hit proves they passed when the plan was
        built — any fast-path ordering difference is unobservable because
        EVERY violation routes to the same literal replay, which raises
        the spec's own exception at the spec's own point)."""
        spec, state = self.spec, self.state
        plans: List = [None] * len(attestations)
        cold = []
        for i, att in enumerate(attestations):
            _SITE_RESOLVE()
            data = att.data
            target_epoch = int(data.target.epoch)
            slot = int(data.slot)
            if target_epoch not in (self.previous_epoch, self.current_epoch):
                raise FastPathViolation("target epoch outside window")
            if not (slot + self.min_delay <= self.state_slot
                    <= slot + self.slots_per_epoch):
                raise FastPathViolation("inclusion window")
            plan_key = (self._ctx_key(target_epoch),
                        bytes(data.hash_tree_root()),
                        bytes(att.aggregation_bits.hash_tree_root()))
            plan = _PLAN_CACHE.get(plan_key)
            if plan is None:
                cold.append((i, att, plan_key, target_epoch))
            else:
                plans[i] = plan
        stats["plan_hits"] += len(attestations) - len(cold)
        stats["plan_misses"] += len(cold)
        if cold:
            self._resolve_cold(cold, plans)
        return plans

    def _resolve_cold(self, cold, plans) -> None:
        """Batched first-sight resolution: per-item structural checks +
        committee gathers, then ONE concatenated mask/segment-count/argsort
        pass over the whole cold set (the per-item ``np.sort``/``np.split``
        walk this replaces was the cold path's Python floor).  Committee
        members are unique by construction (permutation slices), so the
        per-segment sorted gather IS the spec's ``sorted(set(...))``."""
        spec, state = self.spec, self.state
        comms, bit_arrays = [], []
        for i, att, plan_key, target_epoch in cold:
            data = att.data
            slot = int(data.slot)
            if target_epoch != slot // self.slots_per_epoch:
                raise FastPathViolation("target epoch != epoch of slot")
            ctx = committee_context(spec, state, target_epoch)
            if int(data.index) >= ctx.committees_per_slot:
                raise FastPathViolation("committee index out of range")
            committee = ctx.committee(slot, int(data.index))
            bits = bulk.bitlist_to_numpy(att.aggregation_bits)
            if len(bits) != len(committee):
                raise FastPathViolation("aggregation bits != committee size")
            comms.append(committee)
            bit_arrays.append(bits)
        k = len(cold)
        lens = np.fromiter((len(b) for b in bit_arrays), np.int64, k)
        item_ids = np.repeat(np.arange(k, dtype=np.int64), lens)
        all_bits = np.concatenate(bit_arrays)
        counts = segment_sum(all_bits.astype(np.int64), item_ids, k)
        if not counts.all():
            raise FastPathViolation("empty attesting set")
        selected = np.concatenate(comms)[all_bits]
        # one argsort for the whole block: stable sort on (item, value)
        order = np.lexsort((selected, item_ids[all_bits]))
        parts = np.split(selected[order], np.cumsum(counts)[:-1])
        for (i, att, plan_key, target_epoch), attesters in zip(cold, parts):
            # probed on the attester set about to enter the memo: a
            # corrupted plan is consumed by THIS block (wrong members ->
            # failed batch or root mismatch -> replay) and the poisoned
            # insert pops with the block's cache transaction
            attesters = _SITE_PLAN_MEMO(attesters)
            attesters.setflags(write=False)
            plan = AttestationPlan(attesters, plan_key[1], target_epoch)
            plans[i] = plan
            _fifo_put(_PLAN_CACHE, plan_key, plan, cap=_PLAN_CACHE_MAX)


# -- telemetry ----------------------------------------------------------------


def _telemetry_provider() -> dict:
    """Plan-cache effectiveness + the sizes of every geometry memo this
    module owns (all FIFO-bounded; the soak harness asserts the sizes
    never exceed the caps)."""
    return {
        "plan_hits": stats["plan_hits"],
        "plan_misses": stats["plan_misses"],
        "plan_size": len(_PLAN_CACHE),
        "plan_cap": _PLAN_CACHE_MAX,
        "ctx_size": len(_CTX_CACHE),
        "ctx_lookup_size": len(_CTX_LOOKUP),
        "plan_ctx_lookup_size": len(_PLAN_CTX_LOOKUP),
        "active_size": len(_ACTIVE_CACHE),
        "proposer_size": len(_PROPOSER_CACHE),
        "geometry_cap": _CACHE_MAX,
    }


telemetry.register_provider("stf.plan_cache", _telemetry_provider,
                            replace=True)
