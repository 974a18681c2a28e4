"""Generator runner mains (reference capability: tests/generators/*/main.py).

Each module is runnable:

    python -m consensus_specs_tpu_torch.gen.runners.<name> -o <dir> [-d cpu]

The state runners name their sources as case files of the JAX package's
``tests/spec/`` tree, relative to it; ``gen_from_tests`` loads them through
``testing.reference_cases`` so that their cases run on the port's specs.
Without ``-d`` the specs are built for the CUDA card.
"""
