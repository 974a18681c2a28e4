"""Batched and vectorized compute for the hot operations of the spec:
swap-or-not shuffling (numpy), SHA-256 merkle compression (a hand-written
CUDA kernel with a plain torch version), the phase0 epoch deltas with
the fused balance update and merkle root (torch, on the caller's device),
and the altair epoch's flag rewards, inactivity scores and flag rotation
(numpy, or torch on the spec's device for the flag deltas).
Each has a scalar spec twin and a differential test against the
reference package."""
