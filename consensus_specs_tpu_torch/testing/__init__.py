"""Test framework: decorator DSL, yield protocol, and helper library.

The port's copy of the JAX package's ``testing/`` (itself a rebuild of the
pyspec test framework, reference: tests/core/pyspec/eth2spec/test/), with
its imports rewritten to the port and its specs built by the port's
builder for the context's device (``context.set_spec_device``).  The DSL
surface is kept identical — @with_all_phases, @spec_state_test,
@with_presets, @always_bls, ... — so test bodies read the same, and
``reference_cases`` runs the JAX package's own spec cases on port-built
specs.  ``keys`` holds the deterministic test keys, derived by the native
BLS library.
"""
