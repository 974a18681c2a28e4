class SkippedTest(Exception):
    """Raised in generator mode instead of pytest.skip (reference:
    eth2spec/test/exceptions.py)."""


class BlockNotFoundException(Exception):
    """A referenced block is missing from the store (reference:
    eth2spec/test/exceptions.py)."""
