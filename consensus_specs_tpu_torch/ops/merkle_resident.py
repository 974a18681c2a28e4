"""Device-resident merkleization of the balances subtree.

Port of ``consensus_specs_tpu/ops/merkle_resident.py``.  The epoch
transition's ``process_rewards_and_penalties`` rewrites the WHOLE
balances vector.  ``fused_epoch_balance_update`` runs the deltas, the
clipped balance update AND the full merkle reduction of the new vector on
one device — the new balances are consumed by the hasher on the device and
only the 32-byte root and the balances come back.  The spec substitution
(specs/builder.py ``_install_phase0_epoch_kernel``) then memoizes that
subtree root into the freshly written host backing via
``memoize_packed_u64_contents_root``, so the next ``hash_tree_root(state)``
skips the balances subtree entirely.

The reduction calls the SHA-256 compression once per tree level: K1
(``csrc/sha256.cu``) on CUDA, its plain torch version on the CPU
(``ops/sha256.sha256_block64``).  Words are int64 tensors holding uint32
values until they cross into the compression as int32 bit patterns.

Reference seams: eth2spec/utils/ssz/ssz_impl.py:12-13 (hash_tree_root =
backing.merkle_root()); merkleization rules ssz/simple-serialize.md:210-248
(pack / merkleize / mix_in_length).
"""
from __future__ import annotations

import numpy as np
import torch

from consensus_specs_tpu_torch._device import upload
from consensus_specs_tpu_torch.ssz.node import BranchNode, Node, ZERO_HASHES

from .sha256 import sha256_block64, to_int32_bits

_MASK = 0xFFFFFFFF


def _byteswap32(x: torch.Tensor) -> torch.Tensor:
    """uint32 little-endian value -> big-endian word (SHA-256 reads bytes);
    int64 tensors holding values in [0, 2^32)."""
    return (((x >> 24) & 0x000000FF) | ((x >> 8) & 0x0000FF00)
            | ((x << 8) & 0x00FF0000) | ((x << 24) & 0xFF000000))


def _reduce_to_root(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Full merkle reduction of a packed uint64 leaf array, on its device.

    ``lo``/``hi`` are the 32-bit halves of the (LE) uint64 values as int64
    tensors in [0, 2^32), length a multiple of 4 and a power of two in
    chunks.  Returns the [8] int32 (big-endian word bit patterns) root of
    the 2^k-chunk subtree.
    """
    # chunk words: per value the LE bytes are lo,hi; as BE words that is
    # byteswap(lo), byteswap(hi); 4 values -> 8 words -> one 32-byte chunk
    words = torch.stack([_byteswap32(lo), _byteswap32(hi)], dim=1).reshape(-1, 8)
    level = to_int32_bits(words)
    while level.shape[0] > 1:
        level = sha256_block64(level.reshape(level.shape[0] // 2, 16))
    return level[0]


def _add_u64(lo, hi, dlo, dhi):
    """(lo,hi) += (dlo,dhi) with carry, element-wise on uint32 halves held
    in int64 tensors; results masked back to 32 bits."""
    new_lo = (lo + dlo) & _MASK
    carry = (new_lo < lo).to(torch.int64)
    return new_lo, (hi + dhi + carry) & _MASK


RESIDENT_MIN = 16_384  # below this, host hashing of the subtree is trivial


def resident_device(n_validators: int, device):
    """The device the fused epoch+merkle program runs on for a registry of
    ``n_validators``, or None to stay on the host hashing path.  The
    reference picks between its backends by environment; here the spec's
    own device is the choice, the CPU included, and only the size gates."""
    return torch.device(device) if n_validators >= RESIDENT_MIN else None


def _fused_epoch_balances(balances, eff, eligible, source_part, target_part,
                          head_part, incl_delay, incl_proposer, scalars):
    from .epoch import _deltas_kernel

    rewards, penalties = _deltas_kernel(
        eff, eligible, source_part, target_part, head_part,
        incl_delay, incl_proposer, scalars)
    increased = balances + rewards
    new_bal = torch.where(penalties > increased, 0, increased - penalties)
    # padded lanes carry balance 0 and zero deltas, so the zero-padded
    # chunk tail the SSZ merkleization demands is preserved
    lo = new_bal & _MASK
    hi = new_bal >> 32
    return new_bal, _reduce_to_root(lo, hi)


def fused_epoch_balance_update(inp, balances: np.ndarray, device,
                               device_cache: tuple = None):
    """DeltaInputs + current balances -> (new balances [n] int64 numpy,
    padded-subtree root bytes), computed on ``device``; the root reduction
    reads the update's output tensor in place.  ``device_cache`` (from
    ``epoch.delta_device_cache``) serves the registry-derived inputs as
    resident device buffers — uploaded once per registry version
    (stf/columns.device_buffer), not per epoch call."""
    from .epoch import delta_scalars, pad_lanes, registry_inputs

    device = torch.device(device)
    n = balances.shape[0]
    n_pad = max(4, 1 << (n - 1).bit_length() if n > 1 else 1)

    def put(a, fill=0):
        return upload(pad_lanes(a, n_pad, fill), device)

    eff_dev, elig_dev = registry_inputs(inp, device, device_cache, n_pad)
    new_bal, root_words = _fused_epoch_balances(
        put(balances.astype(np.int64)),
        eff_dev,
        elig_dev,
        put(inp.source_part.astype(bool)),
        put(inp.target_part.astype(bool)),
        put(inp.head_part.astype(bool)),
        put(inp.incl_delay, fill=1),
        put(inp.incl_proposer),
        delta_scalars(inp),
    )
    stats["fused_epoch_updates"] += 1
    # host-sync: fused-update outputs (new balances + root) pulled once per
    # epoch
    return (new_bal[:n].cpu().numpy(),
            root_words.cpu().numpy().view(np.uint32).astype(">u4").tobytes())


def memoize_packed_u64_contents_root(view, padded_root: bytes) -> None:
    """Install a device-computed subtree root into a packed uint64 List
    view freshly rewritten by bulk.set_packed_uint64_from_numpy: fold the
    padded-power-of-two root up to the list's virtual contents depth with
    shared zero hashes (a handful of host hashes) and memoize it on the
    still-unhashed contents node.  hash_tree_root output is bit-identical
    to the host path — pinned by tests/test_torch_merkle_resident.py."""
    import hashlib

    cls = type(view)
    backing = view.get_backing()
    contents = backing.left
    if contents._root is not None:
        return  # already hashed (nothing to save)
    n = len(view)
    n_chunks = max((n + 3) // 4, 1)
    n_chunks_pad = 1 << (n_chunks - 1).bit_length() if n_chunks > 1 else 1
    root = padded_root
    for d in range((n_chunks_pad - 1).bit_length(), cls.contents_depth()):
        root = hashlib.sha256(root + ZERO_HASHES[d]).digest()
    contents._root = root
    stats["roots_memoized"] += 1


# engagement counters (bench/tests introspection)
stats = {"fused_epoch_updates": 0, "roots_memoized": 0}


def replace_field_subtree(backing: Node, field_index: int, depth: int,
                          new_node: Node) -> Node:
    """Rebuild the spine of a container backing with one field's subtree
    replaced (everything else structurally shared)."""
    if depth == 0:
        return new_node
    bit = (field_index >> (depth - 1)) & 1
    assert isinstance(backing, BranchNode)
    if bit:
        return BranchNode(backing.left, replace_field_subtree(
            backing.right, field_index, depth - 1, new_node))
    return BranchNode(replace_field_subtree(
        backing.left, field_index, depth - 1, new_node), backing.right)
