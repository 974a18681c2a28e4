"""Mock PoW chains for bellatrix terminal-block tests (parity capability:
reference ``test/helpers/pow_block.py``)."""
from __future__ import annotations

from random import Random


class PowChain:
    def __init__(self, blocks):
        self.blocks = list(blocks)

    def __iter__(self):
        return iter(self.blocks)

    def head(self, offset=0):
        assert offset <= 0
        return self.blocks[offset - 1]

    def to_dict(self):
        return {block.block_hash: block for block in self.blocks}


# One shared default stream: successive no-rng calls must produce DISTINCT
# blocks (callers link them into chains by hash).
_default_rng = Random(3131)


def prepare_random_pow_block(spec, rng=None):
    rng = rng or _default_rng

    def _random_hash():
        return spec.hash(rng.getrandbits(256).to_bytes(32, "big"))

    return spec.PowBlock(
        block_hash=_random_hash(),
        parent_hash=_random_hash(),
        total_difficulty=0,
    )


def prepare_random_pow_chain(spec, length, rng=None) -> PowChain:
    assert length > 0
    rng = rng or _default_rng  # same shared stream as the block helper
    chain = []
    for _ in range(length):
        block = prepare_random_pow_block(spec, rng)
        if chain:
            block.parent_hash = chain[-1].block_hash
        chain.append(block)
    return PowChain(chain)
