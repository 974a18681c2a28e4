"""Resident validator-state columns.

The altair fast path and the epoch kernels both consume whole-registry
columns (participation flags, effective balances, balances) that the SSZ
tree only hands out one chunk walk at a time: before this module, EVERY
block's attestation scatter re-unpacked both participation columns from
the tree (``bulk.packed_uint8_to_numpy`` — a ~n/32-chunk walk each), and
every epoch-transition phase re-unpacked them again, so a 32-block epoch
paid ~70 full-column tree walks for data that changed only incrementally.
The balance column rides the same store (with
an identity fast path for freshly flushed, still-unhashed subtrees), and
registry/balance-derived *device* inputs of the epoch kernels upload once
per column version through ``device_buffer`` instead of re-staging per
kernel call.

This module keeps those columns *resident*:

* **host residency** — a content-addressed store keyed by the column's
  memoized SSZ tree root.  A flush registers the freshly written array
  under the column's new root, so the next reader (the following block's
  mirror read, or any epoch-transition phase) gets the SAME array back as
  a dict probe instead of a tree walk.  Root keying makes staleness
  impossible: any tree write the store did not see (a deposit appending a
  participation entry, the literal replay rewriting a column) produces a
  new root and the next read rebuilds honestly.  Cached arrays are
  READONLY; mutating readers take ``staged_view`` (an explicit copy — the
  numpy mirror demoted to a staged view per the HD01 contract).
* **device residency** — ``device_buffer`` uploads the epoch kernels'
  registry-derived inputs to a torch device once per root and serves the
  same tensor to every later consumer of that version; ``device_column``
  does the same for a participation column (the altair flag-deltas
  pass's input).  One card, so no mesh.

Insertions ride the block cache transaction (``staging.note_insert``)
like every other fast-path memo: a failed block's flush is popped with
the rollback, so the store can never serve a column version whose block
was rolled back (chaos-pinned via the engine's mirror probes).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from consensus_specs_tpu_torch import telemetry
from consensus_specs_tpu_torch._device import upload

from . import staging

# column tree root -> {"host": readonly ndarray}
_COLUMN_STORE: Dict[bytes, dict] = {}
_COLUMN_STORE_MAX = 8

# balances root -> readonly int64 ndarray (the balance half of
# the residency arc — every epoch phase that read the packed vector paid
# a ~n/4-chunk tree walk per phase before this)
_BALANCE_STORE: Dict[bytes, "np.ndarray"] = {}
_BALANCE_STORE_MAX = 4

# identity fast path for freshly flushed balances: (backing node, col).
# A flush leaves the subtree unhashed — keying by root there would FORCE
# the very re-merkleization the lazy write avoids — but the backing node
# object is identity-stable until the next mutation, so the next reader
# (the following epoch phase, or slot_roots' resident upload) matches on
# identity and skips both the hash and the walk.  A rolled-back block
# orphans the node; the identity probe then just misses, honestly.
_BALANCE_PENDING = None

# (content root, tag, ..., device) -> tensor: once-per-version uploads of
# registry/balance-derived kernel inputs (effective balance, eligibility,
# active/slashed masks), replacing the per-epoch-kernel-call re-staging
# ROADMAP item 3 named.  FIFO-bounded; root keying makes stale service
# impossible, exactly like the host stores.
_DEVICE_BUFFERS: Dict[tuple, object] = {}
_DEVICE_BUFFERS_MAX = 24

# residency effectiveness: a hit is a dict probe, a miss is
# a tree walk (host) or an upload (device) — the ratios are the module's
# whole value story
stats = {"hits": 0, "misses": 0,
         "balance_hits": 0, "balance_misses": 0,
         "device_hits": 0, "device_misses": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _bounded_put(cache: dict, cap: int, key, value):
    """THE FIFO store insert (evict oldest, insert, record with the
    block's cache transaction) — one definition for every bounded store
    here, so the eviction/transaction interplay can't drift per store."""
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value
    staging.note_insert(cache, key)
    return value


def _store_put(root: bytes, host: np.ndarray) -> dict:
    return _bounded_put(_COLUMN_STORE, _COLUMN_STORE_MAX, root,
                        {"host": host})


def _participation_view(state, current: bool):
    return (state.current_epoch_participation if current
            else state.previous_epoch_participation)


def _entry_for(view) -> dict:
    """The store entry of a packed-uint8 column view, keyed by its
    memoized tree root (cheap after any state-root computation; a fresh
    write pays one subtree hash that the block's own state-root check
    would have paid anyway)."""
    from consensus_specs_tpu_torch.ssz import bulk

    root = bytes(view.hash_tree_root())
    entry = _COLUMN_STORE.get(root)
    if entry is None:
        stats["misses"] += 1
        host = bulk.packed_uint8_to_numpy(view)
        host.setflags(write=False)
        entry = _store_put(root, host)
    else:
        stats["hits"] += 1
    return entry


def participation_column(state, current: bool) -> np.ndarray:
    """READONLY resident numpy column of one epoch's participation flags.
    Mutating consumers must copy (``staged_view``); read-only consumers
    (the epoch phases) use it directly."""
    return _entry_for(_participation_view(state, current))["host"]


def staged_view(state, current: bool) -> np.ndarray:
    """A mutable staged view (copy) of one participation column — the
    engine's per-block scatter target.  Hand it back via ``flush`` so the
    next reader hits residency instead of re-walking the tree."""
    return participation_column(state, current).copy()


def flush(state, current: bool, col: np.ndarray) -> None:
    """Write a staged column back into the state tree as ONE packed write
    and register the array under the column's new root — the resident
    half of the mirror-flush contract."""
    from consensus_specs_tpu_torch.ssz import bulk

    view = _participation_view(state, current)
    bulk.set_packed_uint8_from_numpy(view, col)
    col.setflags(write=False)
    _store_put(bytes(view.hash_tree_root()), col)


# -- resident balance column --------------------------------------------------


def balance_column(state) -> np.ndarray:
    """READONLY resident int64 numpy column of ``state.balances``.

    Lookup order: the identity fast path (a column this module just
    flushed, subtree still unhashed), then the root-keyed store (cheap
    once any state-root computation memoized the subtree), then an
    honest tree walk.  The walk result is registered only when the root
    is already memoized — keying an unhashed subtree would force a
    re-merkleization the lazy write exists to avoid.  Mutating consumers
    take ``staged_balances`` (copy) and hand it back via
    ``flush_balances`` (HD01 contract)."""
    from consensus_specs_tpu_torch.ssz import bulk

    view = state.balances
    backing = view.get_backing()
    pend = _BALANCE_PENDING
    if pend is not None and pend[0] is backing:
        stats["balance_hits"] += 1
        return pend[1]
    root = backing._root  # memoized by any prior root computation
    if root is not None:
        hit = _BALANCE_STORE.get(bytes(root))
        if hit is not None:
            stats["balance_hits"] += 1
            return hit
    stats["balance_misses"] += 1
    col = bulk.packed_uint64_to_numpy(view)
    col.setflags(write=False)
    if root is not None:
        _bounded_put(_BALANCE_STORE, _BALANCE_STORE_MAX, bytes(root), col)
    return col


def staged_balances(state) -> np.ndarray:
    """A mutable staged view (copy) of the resident balance column — the
    epoch phases' write target.  Hand it back via ``flush_balances``."""
    return balance_column(state).copy()


def flush_balances(state, col: np.ndarray) -> None:
    """Write a staged balance column back into the state tree as ONE
    packed rebuild and stage it on the identity fast path, so the next
    reader (the following epoch phase, the resident-merkle upload) gets
    the SAME array back without hashing or re-walking the subtree."""
    from consensus_specs_tpu_torch.ssz import bulk

    global _BALANCE_PENDING
    bulk.set_packed_uint64_from_numpy(state.balances, col)
    if col.dtype != np.int64:
        col = col.astype(np.int64)
    col.setflags(write=False)
    _BALANCE_PENDING = (state.balances.get_backing(), col)


# -- resident device buffers ---------------------------------------------------


def device_buffer(key: tuple, build_host, device):
    """The device twin of the host stores: a content-keyed once-per-
    version upload.  ``key`` must lead with the owning view's memoized
    tree root (staleness-impossible, like every store here) and bind
    every derivation parameter (tag, epoch, padding); the upload target
    ``device`` (a ``torch.device`` or its name) is bound here.
    ``build_host()`` produces the host array only on a miss — by the
    caller contract its output is pure in ``key`` (the RootKeyedCache
    build-function shape), so it is not key material."""
    key = key + (str(torch.device(device)),)
    # build_host is the miss-path constructor, pure in key (caller
    # contract above) — not key material
    hit = _DEVICE_BUFFERS.get(key)  # noqa: CC02
    if hit is not None:
        stats["device_hits"] += 1
        return hit
    stats["device_misses"] += 1
    buf = upload(build_host(), torch.device(device))
    return _bounded_put(_DEVICE_BUFFERS, _DEVICE_BUFFERS_MAX, key, buf)


def device_column(state, current: bool, device):
    """The resident participation column as a uint8 tensor on ``device``,
    uploaded once per column version and shared by every later consumer
    of that root (the altair flag-deltas pass's input)."""
    view = _participation_view(state, current)
    return device_buffer((bytes(view.hash_tree_root()), "participation"),
                         lambda: _entry_for(view)["host"], device)


def reset_caches() -> None:
    """Drop every resident column and device buffer (bench cold-start
    control and test isolation)."""
    global _BALANCE_PENDING
    _COLUMN_STORE.clear()
    _BALANCE_STORE.clear()
    _BALANCE_PENDING = None
    _DEVICE_BUFFERS.clear()
    reset_stats()


def _telemetry_provider() -> dict:
    return {**stats,
            "size": len(_COLUMN_STORE), "cap": _COLUMN_STORE_MAX,
            "balance_size": len(_BALANCE_STORE),
            "balance_cap": _BALANCE_STORE_MAX,
            "device_size": len(_DEVICE_BUFFERS),
            "device_cap": _DEVICE_BUFFERS_MAX}


telemetry.register_provider("stf.columns", _telemetry_provider, replace=True)
