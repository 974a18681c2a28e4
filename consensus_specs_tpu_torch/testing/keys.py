"""Deterministic test keypairs (reference: test/helpers/keys.py).

The list is materialized lazily per index.  Pubkeys come from the native
C++ ``SkToPk``: the main-path scenario derives all 8192 keys, which the
pure-Python oracle is too slow for.
"""
from __future__ import annotations

from typing import Dict

from consensus_specs_tpu_torch.crypto.bls import native as _bls

NUM_KEYS = 32 * 256

privkeys = [i + 1 for i in range(NUM_KEYS)]

pubkey_to_privkey: Dict[bytes, int] = {}


class _LazyPubkeys:
    """Sequence of SkToPk(privkeys[i]), computed & cached on demand."""

    __slots__ = ("_cache",)

    def __init__(self):
        self._cache: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return NUM_KEYS

    def _get(self, i: int) -> bytes:
        pk = self._cache.get(i)
        if pk is None:
            pk = _bls.SkToPk(privkeys[i])
            self._cache[i] = pk
            pubkey_to_privkey[pk] = privkeys[i]
        return pk

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._get(j) for j in range(*i.indices(NUM_KEYS))]
        i = int(i)
        if i < 0:
            i += NUM_KEYS
        if not 0 <= i < NUM_KEYS:
            raise IndexError(i)
        return self._get(i)

    def __iter__(self):
        for i in range(NUM_KEYS):
            yield self._get(i)


pubkeys = _LazyPubkeys()
