"""Block-path support the epoch transition reads.

This slice ports the pieces the spec module's substitutions reach:

* ``attestations`` — committee geometry off the cached shuffle
  permutation, and the attestation-plan memo the epoch scans probe;
* ``columns``      — root-keyed resident validator-state columns and the
  once-per-version device buffers of the epoch kernels' inputs;
* ``staging``      — the block cache transaction those memos record into.

The batched engine (``engine``, ``verify``, ``sync``, ``slot_roots``,
``pipeline``) comes with ROADMAP queue A, item 8.
"""
