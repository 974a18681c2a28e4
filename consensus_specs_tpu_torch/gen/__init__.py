"""L5 test-vector generators (reference capability:
eth2spec/gen_helpers — gen_base/gen_runner.py + gen_from_tests/gen.py).

The output-directory contract (L6, reference tests/formats/README.md):
    <preset>/<fork>/<runner>/<handler>/<suite>/<case>/
        meta.yaml      collected 'meta' parts (if any)
        <name>.yaml    'data' parts
        <name>.ssz_snappy  'ssz' parts, snappy block-compressed
An INCOMPLETE tag file marks in-progress cases; interrupted generation
resumes by regenerating exactly the tagged cases.

The port's copy of the JAX package's ``gen/``: the YAML parts go through
``vector_yaml`` (no PyYAML), the runners load their case files through
``testing.reference_cases``, and the generators and the consumer build
their specs for a device (None: the CUDA card).
"""
