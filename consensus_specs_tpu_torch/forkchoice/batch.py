"""Vectorized attestation ingestion for the fork-choice engine.

The spec's ``on_attestation`` (specs/src/phase0.py:1644) handles one
attestation at a time: validate, materialize the target checkpoint state,
index the committee, then walk the attesting indices in a Python loop
updating ``store.latest_messages``.  A node serving heavy traffic sees
hundreds of thousands of (mostly unaggregated) attestations per slot;
here the whole batch is flattened into dense ``(validator_index,
target_epoch, attestation_id)`` arrays and the latest-message update
becomes one vectorized reduction.

Spec equivalence, by construction:

* every attestation passes the spec's own ``validate_on_attestation``
  (deduplicated by ``AttestationData`` identity — the checks depend only
  on the data and the store clock, which is constant within a batch), and
  target checkpoint states are materialized with the spec's own
  ``store_target_checkpoint_state``;
* signature validation goes through the spec's
  ``is_valid_indexed_attestation`` whenever BLS is active; with BLS off
  the structural residue (non-empty, sorted-unique indices — sorted and
  unique hold a priori for committee-selected indices) is applied
  vectorized;
* the sequential ``update_latest_messages`` fold — "last write wins only
  with a strictly larger target epoch" — resolves, per validator, to the
  *earliest batch entry carrying the maximum target epoch*, applied only
  when that epoch exceeds the stored one; the reduction computes exactly
  that via one lexsort.  Equivocating validators are skipped, as in the
  spec.

Batch semantics: validation of the WHOLE batch precedes any vote landing,
so an invalid attestation aborts the batch with no votes applied (target
checkpoint states materialized during validation remain, as they would
under the spec).  For single-attestation batches — how the differential
suites replay scenarios — this coincides exactly with the spec handler.

Exception safety: this module STAGES, it never commits.  The
returned ``StagedVotes`` carries the winning messages fully materialized;
``commit_votes`` applies them to ``store.latest_messages`` in a loop with
no failure modes left in it.  The engine fires the
``forkchoice.batch.apply`` fault probe between staging and commit and
lands the store fold and the proto-array weight update together — a fault
anywhere in ingestion leaves both exactly as they were (tests/test_torch_forkchoice.py).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from consensus_specs_tpu_torch import tracing
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.telemetry import timeline


class StagedVotes(NamedTuple):
    """A validated, reduced, NOT-yet-applied batch of latest-message
    updates: ``block_roots[att_ids[k]]`` is the LMD vote of
    ``validators[k]``; ``messages`` holds the prebuilt
    ``(ValidatorIndex, LatestMessage)`` pairs ``commit_votes`` applies."""

    validators: np.ndarray
    epochs: np.ndarray
    att_ids: np.ndarray
    block_roots: List
    messages: List


def commit_votes(store, staged: StagedVotes) -> None:
    """Apply a staged batch to ``store.latest_messages`` (the spec's
    ``update_latest_messages`` fold, precomputed): plain dict writes of
    prebuilt objects — nothing here can raise halfway."""
    messages = store.latest_messages
    for vi, msg in staged.messages:
        messages[vi] = msg


def ingest_attestations(
        spec, store, attestations, is_from_block: bool = False
) -> Optional[StagedVotes]:
    """Spec-equivalent batched ``on_attestation`` over ``store``.

    Validates every attestation and reduces the batch to its winning
    messages, WITHOUT applying them.  Returns a ``StagedVotes`` (commit
    with ``commit_votes``), or None when nothing would change.
    """
    attestations = list(attestations)
    if not attestations:
        return None

    # one batch-level timeline span carrying the ingest volume: the
    # index/reduce/stage tracing spans below auto-emit as its children
    # when CSTPU_TIMELINE is armed
    with timeline.span("fc/ingest", atts=len(attestations)):
        return _ingest_attestations(spec, store, attestations, is_from_block)


def _ingest_attestations(spec, store, attestations, is_from_block):
    """The ingest body (non-empty batch), under the caller's span."""
    # Validation + committee resolution, deduplicated by AttestationData
    # identity.  The dedup key is the data's immutable backing node:
    # unaggregated gossip shards one committee's data across hundreds of
    # single-bit attestations, and the shared node lets each of them skip
    # every SSZ field read (the dominant per-attestation cost) as well as
    # the revalidation the spec loop pays per attestation.  Validation of
    # the whole batch still precedes any vote application (the reduce /
    # commit phases below).
    #
    # The BLS-off residue is fully deferred: the loop only EXTENDS one
    # flat Python bit list (C-speed) and records per-attestation geometry;
    # bit->validator resolution then runs as ONE numpy pass over the whole
    # batch through a unique-committee indirection — at 100k unaggregated
    # attestations the per-attestation ``np.asarray`` + gather + append
    # walk this replaces was the batched path's Python floor.
    with tracing.span("forkchoice/ingest/index"):
        tstates = {}     # (target epoch, target root) -> checkpoint state
        committees = {}  # (target epoch, target root, slot, index) -> (ndarray, base)
        data_memo = {}   # id(data backing node) -> per-data tuple
        root_memo = {}   # data hash_tree_root -> per-data tuple
        comm_concat = []     # unique committee arrays, in first-sight order
        comm_concat_len = 0
        n_atts = len(attestations)
        att_epochs = np.empty(n_atts, dtype=np.int64)
        block_roots = []
        att_msgs = []
        LatestMessage = spec.LatestMessage
        verify_sigs = bls.bls_active
        if verify_sigs:
            parts_v = []
            att_counts = np.empty(n_atts, dtype=np.int64)
        else:
            flat_bits: list = []
            att_bases = np.empty(n_atts, dtype=np.int64)
            att_comm_lens = np.empty(n_atts, dtype=np.int64)
            att_comm_bases = np.empty(n_atts, dtype=np.int64)
        for a, att in enumerate(attestations):
            d = att.data
            node = d.get_backing()
            memo = data_memo.get(id(node))
            if memo is None:
                # identity missed: wire-DECODED gossip carries a distinct
                # backing per attestation even when the data is identical
                # (one committee's vote sharded across hundreds of
                # single-bit attestations), so fall through to a content
                # key — ~15 sha256 of a small fixed container, against
                # the full revalidation + committee re-resolution a miss
                # costs.  Sound for the same reason the identity dedup
                # is: validate_on_attestation depends only on the data
                # and the store clock, constant within a batch.  (The
                # node firehose exposed this: identity-only dedup never
                # fired on an SSZ-decoded corpus and throughput fell
                # ~6x vs the same corpus freshly built.)
                memo = root_memo.get(bytes(d.hash_tree_root()))
                if memo is not None:
                    data_memo[id(node)] = memo
            if memo is None:
                spec.validate_on_attestation(store, att, is_from_block)
                spec.store_target_checkpoint_state(store, d.target)
                tkey = (int(d.target.epoch), bytes(d.target.root))
                ckey = tkey + (int(d.slot), int(d.index))
                centry = committees.get(ckey)
                if centry is None:
                    target_state = tstates.get(tkey)
                    if target_state is None:
                        target_state = store.checkpoint_states[d.target]
                        tstates[tkey] = target_state
                    comm = np.fromiter(
                        spec.get_beacon_committee(target_state, d.slot, d.index),
                        dtype=np.int64)
                    centry = committees[ckey] = (comm, comm_concat_len)
                    if not verify_sigs:
                        # the concat/base bookkeeping feeds only the
                        # BLS-off bit-resolution gather below
                        comm_concat.append(comm)
                        comm_concat_len += len(comm)
                # the node rides in the memo value so its id can't be
                # recycled while the memo is alive; the prebuilt
                # LatestMessage (shared by every winner voting this data —
                # the fold only ever stores it) keeps the stage loop off
                # the SSZ view protocol entirely
                memo = (centry[0], centry[1], tkey, d.beacon_block_root,
                        LatestMessage(epoch=d.target.epoch,
                                      root=d.beacon_block_root), node)
                data_memo[id(node)] = memo
                root_memo[bytes(d.hash_tree_root())] = memo
            comm, comm_base, tkey, beacon_root, msg, _ = memo
            block_roots.append(beacon_root)
            att_msgs.append(msg)
            if verify_sigs:
                target_state = tstates[tkey]
                indexed = spec.get_indexed_attestation(target_state, att)
                assert spec.is_valid_indexed_attestation(target_state, indexed)
                idx = np.asarray(indexed.attesting_indices, dtype=np.int64)
                parts_v.append(idx)
                att_counts[a] = len(idx)
            else:
                bl = att.aggregation_bits
                bits = getattr(bl, "_bits", None)
                if bits is None:
                    bits = list(bl)
                if len(bits) < len(comm):
                    # the spec's bit indexing raises IndexError here
                    raise IndexError("aggregation bits shorter than committee")
                att_bases[a] = len(flat_bits)
                att_comm_lens[a] = len(comm)
                att_comm_bases[a] = comm_base
                flat_bits.extend(bits)
            att_epochs[a] = tkey[0]

    with tracing.span("forkchoice/ingest/reduce"):
        if verify_sigs:
            v = np.concatenate(parts_v)
            a = np.repeat(np.arange(n_atts, dtype=np.int64), att_counts)
        else:
            all_bits = np.asarray(flat_bits, dtype=bool)
            pos = np.nonzero(all_bits)[0]
            # position -> owning attestation (bases are sorted by build)
            a = np.searchsorted(att_bases, pos, side="right") - 1
            offset = pos - att_bases[a]
            # bits beyond the committee are ignored (the spec reads
            # bits[i] only for committee members)
            keep = offset < att_comm_lens[a]
            a, offset = a[keep], offset[keep]
            v = np.concatenate(comm_concat)[att_comm_bases[a] + offset]
            # residue of is_valid_indexed_attestation with BLS off: every
            # attestation must select at least one member
            att_counts = np.zeros(n_atts, dtype=np.int64)
            np.add.at(att_counts, a, 1)
            assert att_counts.all()
        e = att_epochs[a]
        if store.equivocating_indices:
            eq = np.fromiter(store.equivocating_indices, dtype=np.int64)
            live = ~np.isin(v, eq)
            v, e, a = v[live], e[live], a[live]
        if len(v) == 0:
            return None
        # per validator: earliest batch entry carrying the maximum epoch
        order = np.lexsort((a, -e, v))
        v_s = v[order]
        lead = np.ones(len(v_s), dtype=bool)
        lead[1:] = v_s[1:] != v_s[:-1]
        win = order[lead]
        wv, we, wa = v[win], e[win], a[win]
        # strictly-larger-epoch gate against the standing messages
        messages = store.latest_messages
        cur = np.fromiter(
            (int(messages[vi].epoch) if vi in messages else -1
             for vi in wv.tolist()),
            dtype=np.int64, count=len(wv))
        upd = we > cur
        if not upd.any():
            return None
        wv, we, wa = wv[upd], we[upd], wa[upd]

    with tracing.span("forkchoice/ingest/stage"):
        ValidatorIndex = spec.ValidatorIndex
        staged_messages = [(ValidatorIndex(vi), att_msgs[ai])
                           for vi, ai in zip(wv.tolist(), wa.tolist())]

    return StagedVotes(wv, we, wa, block_roots, staged_messages)
