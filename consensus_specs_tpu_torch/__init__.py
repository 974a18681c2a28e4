"""consensus-specs on PyTorch and CUDA: the port of ``consensus_specs_tpu``.

The package keeps the reference's layout and module names, so each module
has a counterpart there.  It imports torch, numpy and the standard library
only: nothing of JAX and nothing of the reference package.

Layer map:
  ssz/        SSZ types and persistent-Merkle-tree hashing; the ``"torch"``
              layer hasher lives in ops/sha256.py
  config/     presets (mainnet/minimal) and runtime configs
  crypto/bls/ BLS12-381: pure-Python oracle and the native C++ backend
  ops/        SHA-256 (hand-written CUDA kernel + plain torch version),
              phase0 epoch deltas, the fused balance update + merkle root,
              the altair epoch functions
  stf/        the batched block engine (phase0 and altair lineages), its
              committee geometry, sync aggregates and resident columns
  specs/      the phase0 and altair spec modules built over the port's
              kernels
  testing/    deterministic test keys
  scenario    the main-path input builder (state + signed blocks)

Entry points take ``device=``; None is the CUDA card (``_device.py``).
"""

__version__ = "0.1.0"
