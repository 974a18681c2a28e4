"""Test helpers of the port: deterministic keys."""
