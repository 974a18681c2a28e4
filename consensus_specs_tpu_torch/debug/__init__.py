"""Debug/vector tooling: YAML-shaped encoding and SSZ fuzzing.

Mirrors the capability of the reference's eth2spec/debug package
(encode.py, decode.py, random_value.py) on this framework's type system;
powers the generators' ``data`` parts and the ssz_static fuzz suites.
"""
