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

The reduction is ``packed_u64_root``: on CUDA it launches K2
(``csrc/sha256_tree.cu``), which packs the values into chunk words in its
load and reduces the whole tree in one launch up to 1,024 chunks, two up
to 2^20 and three up to 2^30 (the main path's 400k balances are 2^17
chunks).
On the CPU it runs the plain version, ``_reduce_to_root``, the reference's
shape: split, byteswap and pack in torch, then the SHA-256 compression once
per tree level (``ops/sha256.sha256_block64``).  Words there are int64
tensors holding uint32 values until they cross into the compression as
int32 bit patterns.  The callers (``resident_device``) take this route
on the CPU only when ``RESIDENT_ON_CPU`` asks for it, as the reference's
policy keeps its host backend on hashlib.

Reference seams: eth2spec/utils/ssz/ssz_impl.py:12-13 (hash_tree_root =
backing.merkle_root()); merkleization rules ssz/simple-serialize.md:210-248
(pack / merkleize / mix_in_length).
"""
from __future__ import annotations

import numpy as np
import torch

from consensus_specs_tpu_torch._device import upload
from consensus_specs_tpu_torch.ssz.node import (
    BranchNode,
    LeafNode,
    Node,
    ZERO_HASHES,
    merkle_root,
    uint_to_leaf,
)

from .sha256 import (
    KernelError,
    launch_u64_list_root,
    sha256_block64,
    to_int32_bits,
)

_MASK = 0xFFFFFFFF


def _byteswap32(x: torch.Tensor) -> torch.Tensor:
    """uint32 little-endian value -> big-endian word (SHA-256 reads bytes);
    int64 tensors holding values in [0, 2^32)."""
    return (((x >> 24) & 0x000000FF) | ((x >> 8) & 0x0000FF00)
            | ((x << 8) & 0x00FF0000) | ((x << 24) & 0xFF000000))


def _u64_halves(values: torch.Tensor) -> tuple:
    """int64 tensor of raw 64-bit patterns -> (lo, hi) 32-bit halves as
    int64 tensors in [0, 2^32)."""
    return values & _MASK, (values >> 32) & _MASK


def _chunk_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Packed uint64 halves -> [n_chunks, 8] int32 big-endian chunk words.

    Per value the LE bytes are lo,hi; as BE words that is byteswap(lo),
    byteswap(hi); 4 values -> 8 words -> one 32-byte chunk."""
    words = torch.stack([_byteswap32(lo), _byteswap32(hi)], dim=1).reshape(-1, 8)
    return to_int32_bits(words)


def _reduce_to_root(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Full merkle reduction of a packed uint64 leaf array, on its device.

    ``lo``/``hi`` are the 32-bit halves of the (LE) uint64 values as int64
    tensors in [0, 2^32), length a multiple of 4 and a power of two in
    chunks.  Returns the [8] int32 (big-endian word bit patterns) root of
    the 2^k-chunk subtree.  The plain version of K2, compressing one level
    per call (K1 on a CUDA tensor).
    """
    level = _chunk_words(lo, hi)
    while level.shape[0] > 1:
        level = sha256_block64(level.reshape(level.shape[0] // 2, 16))
    return level[0]


def packed_u64_root(values: torch.Tensor) -> torch.Tensor:
    """Merkle root of a packed uint64 list: a contiguous, 16-byte aligned
    int64 tensor of 4 * 2^k values (raw LE 64-bit patterns) -> [8] int32
    (big-endian word bit patterns) root of the 2^k-chunk subtree; one chunk
    is its own root.  CUDA launches K2; the CPU runs ``_reduce_to_root``."""
    if values.dtype != torch.int64:
        raise TypeError(f"packed_u64_root takes int64 values, got {values.dtype}")
    if values.dim() != 1 or not values.is_contiguous():
        raise ValueError("packed_u64_root takes a contiguous 1-d tensor")
    n_chunks, rest = divmod(values.shape[0], 4)
    if rest or n_chunks == 0 or n_chunks & (n_chunks - 1):
        raise ValueError(f"packed_u64_root takes 4 * 2^k values, got "
                         f"{values.shape[0]}")
    if values.data_ptr() % 16:
        raise ValueError("packed_u64_root needs a 16-byte aligned tensor")
    if values.device.type == "cuda":
        return launch_u64_list_root(values)
    if values.device.type == "cpu":
        return _reduce_to_root(*_u64_halves(values))
    raise ValueError(f"packed_u64_root runs on cuda or cpu, not {values.device}")


def _to_host(*tensors) -> list:
    """Device results as host numpy arrays.  The copy waits for the kernels
    that wrote them, so a fault of K2 that shows only on the device raises
    here, as the ``KernelError`` of a failed launch does."""
    try:
        return [t.cpu().numpy() for t in tensors]
    except RuntimeError as exc:
        raise KernelError(f"reading a device result back failed: {exc}") from exc


def _root_bytes(words: np.ndarray) -> bytes:
    return words.view(np.uint32).astype(">u4").tobytes()


def _add_u64(lo, hi, dlo, dhi):
    """(lo,hi) += (dlo,dhi) with carry, element-wise on uint32 halves held
    in int64 tensors; results masked back to 32 bits."""
    new_lo = (lo + dlo) & _MASK
    carry = (new_lo < lo).to(torch.int64)
    return new_lo, (hi + dhi + carry) & _MASK


def _join_u64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_u64_halves``: 32-bit halves -> int64 raw 64-bit
    patterns.  The high half is read as a signed 32-bit value first, so
    that no intermediate leaves the int64 range (torch's int64 overflow
    is not relied on)."""
    signed_hi = hi - ((hi >> 31) << 32)
    return signed_hi * (1 << 32) + lo


class ResidentPackedU64List:
    """A packed ``List[uint64, limit]`` whose leaves live on a torch
    device: one contiguous int64 tensor of raw 64-bit patterns, zero-padded
    to 4 * 2^k values (a power of two in chunks), 16-byte aligned as
    ``packed_u64_root`` needs.

    ``upload()`` once; mutate with ``apply_add()`` (device ops);
    ``root()`` runs the reduction on the device (K2 on CUDA) and reads
    back 32 bytes.  ``root()`` is bit-identical to ``hash_tree_root`` of
    the equivalent SSZ list."""

    def __init__(self, limit: int, device):
        assert limit % 4 == 0
        self.limit = limit
        self.chunk_limit = limit // 4
        self.contents_depth = max((self.chunk_limit - 1).bit_length(), 0)
        self.device = torch.device(device)
        self.length = 0
        self._values = None

    # -- data movement -------------------------------------------------------

    def upload(self, values) -> None:
        """Bulk upload of the full value array: a numpy vector (read as
        little-endian uint64) or an int64 tensor of raw 64-bit patterns."""
        if isinstance(values, torch.Tensor):
            if values.dtype != torch.int64:
                raise TypeError(f"upload takes an int64 tensor, got {values.dtype}")
            source = values.reshape(-1)
        else:
            host = np.ascontiguousarray(values, dtype="<u8").view(np.int64)
            source = torch.from_numpy(host.copy())
        self.length = source.shape[0]
        n_chunks = max((self.length + 3) // 4, 1)
        n_pad = 1 << (n_chunks - 1).bit_length()
        padded = torch.zeros(n_pad * 4, dtype=torch.int64, device=self.device)
        padded[: self.length] = source.to(self.device)
        self._values = padded

    def to_numpy(self) -> np.ndarray:
        """Download the current values as uint64 (verification path)."""
        return self._values[: self.length].cpu().numpy().view(np.uint64).copy()

    # -- device-side mutation ------------------------------------------------

    def apply_add(self, delta) -> None:
        """Add ``delta`` (a scalar, a numpy vector or an int64 tensor; may
        be negative) to every live element mod 2^64, on the device.  The
        add runs on the 32-bit halves with an explicit carry, as the
        reference's does, so the wraparound is exact."""
        assert self._values is not None, "upload() before apply_add()"
        full = torch.zeros_like(self._values)
        if isinstance(delta, torch.Tensor):
            # >> 32 must be an arithmetic shift so negative deltas carry a
            # sign-extended high half; only int64 guarantees that here
            if delta.dtype != torch.int64:
                raise TypeError(f"tensor delta must be int64, got {delta.dtype}")
            full[: self.length] = delta.to(self.device)
        elif np.isscalar(delta):
            full[: self.length] = int(np.array([delta], dtype=np.int64)[0])
        else:
            host = np.ascontiguousarray(np.asarray(delta, dtype=np.int64))
            full[: self.length] = torch.from_numpy(host.copy()).to(self.device)
        lo, hi = _add_u64(*_u64_halves(self._values), *_u64_halves(full))
        self._values = _join_u64(lo, hi)

    # -- roots ---------------------------------------------------------------

    def contents_subtree_root(self) -> bytes:
        """Root of the real-data subtree (padded to its power of two)."""
        assert self._values is not None, "upload() before reading roots"
        # host-sync: the resident tree's single root readback
        words, = _to_host(packed_u64_root(self._values))
        return _root_bytes(words)

    def as_backing_node(self) -> Node:
        """The list's backing as a fixed-root node pair (contents, length)
        — spliceable into a host-side container backing."""
        import hashlib

        node_root = self.contents_subtree_root()
        level = (self._values.shape[0] // 4 - 1).bit_length()
        for d in range(level, self.contents_depth):
            node_root = hashlib.sha256(node_root + ZERO_HASHES[d]).digest()
        return BranchNode(LeafNode(node_root), uint_to_leaf(self.length))

    def root(self) -> bytes:
        """Full SSZ ``hash_tree_root`` of the list (zero-hash fold up to
        the virtual depth, then mix in the length)."""
        return merkle_root(self.as_backing_node())


RESIDENT_MIN = 16_384  # below this, host hashing of the subtree is trivial

# Whether a CPU spec takes the resident route too.  Off by default, as the
# reference's CSTPU_RESIDENT_MERKLE="auto": on the CPU the torch reduction
# costs ~0.3 s at 16,384 validators where hashlib's incremental root costs
# a few ms.  True is the reference's "1": tests set it to drive the route
# on the CPU.
RESIDENT_ON_CPU = False


def resident_device(n_validators: int, device):
    """The device the fused epoch+merkle program runs on for a registry of
    ``n_validators``, or None to stay on the host hashing path: the spec's
    own device from ``RESIDENT_MIN`` validators on, unless that device is
    the CPU and ``RESIDENT_ON_CPU`` is False."""
    device = torch.device(device)
    if n_validators < RESIDENT_MIN:
        return None
    if device.type == "cpu" and not RESIDENT_ON_CPU:
        return None
    return device


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
    return new_bal, packed_u64_root(new_bal)


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
    new_host, root_host = _to_host(new_bal[:n], root_words)
    return new_host, _root_bytes(root_host)


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
