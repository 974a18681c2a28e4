"""Deterministic test keypairs (reference: test/helpers/keys.py).

One list for the whole port: the pubkeys of ``testing/keys.py``, derived
by the native C++ ``SkToPk``, which the main-path scenario also draws on.
The reference derives the same bytes with its pure-Python ciphersuite.
"""
from consensus_specs_tpu_torch.testing.keys import (  # noqa: F401
    NUM_KEYS,
    privkeys,
    pubkey_to_privkey,
    pubkeys,
)
