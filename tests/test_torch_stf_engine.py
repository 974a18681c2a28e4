"""The torch port's batched block engine (``consensus_specs_tpu_torch.stf``)
against the reference engine and against the port's literal
``spec.state_transition``, with BLS on.

States and blocks come from the reference's testing helpers and cross into
the port's types serialized (``encode_bytes`` / ``decode_bytes``).  Root
parity alone cannot tell a working engine from one that silently replays
every block through the literal spec, so every engine run also holds the
engine's counters: every block on the fast path, none replayed, the
breaker closed, the native BLS backend not degraded.

* minimal preset: two epochs of attestation-bearing blocks, roots equal
  after every block, pipeline on and off, then the whole walk in one call
  (the pipeline speculates across blocks);
* failure behavior: a bad signature and a wrong state root raise the
  reference engine's exception and leave an equal post-state root;
* ``slot_roots.process_slots`` against ``spec.process_slots``, on the
  minimal state and on a 16,384-validator mainnet-preset state where the
  resident balances root fires;
* a failing kernel (``KernelError``) is raised to the caller with the
  block's pre-state restored, never replayed on the host path;
* the 400,000-validator main path through the engine (``slow``).
"""
import pytest

from consensus_specs_tpu import stf as ref_stf
from consensus_specs_tpu.crypto import bls as ref_bls
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.stf import attestations as ref_attestations
from consensus_specs_tpu.stf import verify as ref_verify
from consensus_specs_tpu.testing.context import (
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu.testing.helpers.attestations import (
    next_slots_with_attestations,
)
from consensus_specs_tpu.testing.helpers.genesis import create_genesis_state
from consensus_specs_tpu.testing.helpers.state import next_epoch
from consensus_specs_tpu_torch import scenario, stf, tracing
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ops import merkle_resident
from consensus_specs_tpu_torch.ops.sha256 import KernelError
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import bulk
from consensus_specs_tpu_torch.stf import attestations, pipeline, slot_roots, verify

_CORPUS = {}


@pytest.fixture
def bls_on():
    """Native BLS with verification on in both packages, restored after."""
    saved = (ref_bls.bls_active, ref_bls.backend_name(),
             bls.bls_active, bls.backend_name())
    ref_bls.use_native()
    bls.use_native()
    ref_bls.bls_active = True
    bls.bls_active = True
    try:
        yield
    finally:
        ref_bls.bls_active, bls.bls_active = saved[0], saved[2]
        ref_bls.use_backend(saved[1])
        bls.use_backend(saved[3])


@pytest.fixture
def tracing_on():
    """The port's tracing counters on and zeroed, restored after."""
    was = tracing.enabled()
    tracing.enable()
    tracing.reset()
    try:
        yield
    finally:
        tracing.reset()
        if not was:
            tracing.disable()


def _to_port(port_type, ref_obj):
    return port_type.decode_bytes(bytes(ref_obj.encode_bytes()))


def _corpus():
    """(reference spec, port spec, reference pre-state, reference signed
    blocks): two epochs of blocks carrying attestations of the current and
    the previous epoch, signed with BLS on, from an epoch-aligned state."""
    if not _CORPUS:
        ref_spec = ref_get_spec("phase0", "minimal")
        state = create_genesis_state(ref_spec, default_balances(ref_spec),
                                     default_activation_threshold(ref_spec))
        next_epoch(ref_spec, state)
        _, blocks, _ = next_slots_with_attestations(
            ref_spec, state.copy(), 2 * int(ref_spec.SLOTS_PER_EPOCH),
            True, True)
        assert sum(len(b.message.body.attestations) for b in blocks) > 0
        _CORPUS.update(ref_spec=ref_spec, pre=state, blocks=blocks,
                       spec=get_spec("phase0", "minimal", device="cpu"))
    c = _CORPUS
    return c["ref_spec"], c["spec"], c["pre"], c["blocks"]


def _fresh_engines():
    """Both engines cold: counters zeroed, breaker closed, no degradation,
    empty verified-triple memo and geometry caches."""
    for engine, settle, plans in ((stf, verify, attestations),
                                  (ref_stf, ref_verify, ref_attestations)):
        engine.reset_stats()
        settle.reset_memo()
        settle.reset_degraded()
        plans.reset_caches()


def _assert_all_fast(n_blocks):
    """The engine counter contract: every block on the fast path."""
    assert stf.stats["fast_blocks"] == n_blocks, stf.stats
    assert stf.stats["replayed_blocks"] == 0, stf.stats["replay_reasons"]
    assert stf.stats["replay_reasons"] == {}
    assert stf.stats["breaker_trips"] == 0
    assert verify.stats["native_degraded"] == 0
    assert not verify.native_degraded()


@pytest.fixture(params=[True, False], ids=["pipeline-on", "pipeline-off"])
def pipelined(request, monkeypatch):
    """The overlapped pipeline on or off in both engines (the reference
    reads its switch from the environment, the port from a module
    attribute)."""
    monkeypatch.setenv("CSTPU_PIPELINE", "1" if request.param else "0")
    monkeypatch.setattr(pipeline, "ENABLED", request.param)
    return request.param


def test_engine_matches_reference_engine_and_literal(bls_on, pipelined):
    ref_spec, spec, pre, blocks = _corpus()
    port_blocks = [_to_port(spec.SignedBeaconBlock, b) for b in blocks]
    ref_state = pre.copy()
    engine_state = _to_port(spec.BeaconState, pre)
    literal_state = _to_port(spec.BeaconState, pre)
    _fresh_engines()
    for i, (ref_block, block) in enumerate(zip(blocks, port_blocks)):
        ref_stf.apply_signed_blocks(ref_spec, ref_state, [ref_block], True)
        stf.apply_signed_blocks(spec, engine_state, [block], True)
        spec.state_transition(literal_state, block, True)
        want = bytes(ref_state.hash_tree_root())
        assert bytes(engine_state.hash_tree_root()) == want, f"block {i}"
        assert bytes(literal_state.hash_tree_root()) == want, f"block {i}"
    _assert_all_fast(len(blocks))
    assert ref_stf.stats["fast_blocks"] == len(blocks)
    assert verify.stats["entries"] > 0
    assert bytes(engine_state.encode_bytes()) == bytes(ref_state.encode_bytes())

    # the whole walk in one call, from cold caches: with the pipeline on,
    # block N's batch is in flight while block N+1's host phases run
    _fresh_engines()
    whole = _to_port(spec.BeaconState, pre)
    stf.apply_signed_blocks(spec, whole, port_blocks, True)
    assert bytes(whole.hash_tree_root()) == bytes(literal_state.hash_tree_root())
    _assert_all_fast(len(blocks))
    # in flight at once: the window's two verdicts plus the current block's
    assert pipeline.stats["depth_max"] == (3 if pipelined else 0)


def _capture(fn, *args):
    try:
        fn(*args)
    except Exception as exc:  # noqa: B001 - parity harness captures anything
        return exc
    return None


@pytest.mark.parametrize("tamper", ["signature", "state_root"])
def test_invalid_block_fails_like_the_reference(bls_on, pipelined, tamper):
    """Two valid blocks, then an invalid one, in one call: both engines
    raise the same exception and leave equal post-states (the literal
    replay's partial state included)."""
    ref_spec, spec, pre, blocks = _corpus()
    bad = blocks[2].copy()
    if tamper == "signature":
        bad.message.body.attestations[0].signature = \
            ref_spec.BLSSignature(b"\x33" * 96)
    else:
        bad.message.state_root = ref_spec.Root(b"\x44" * 32)
    walk = list(blocks[:2]) + [bad]

    _fresh_engines()
    ref_state = pre.copy()
    ref_exc = _capture(ref_stf.apply_signed_blocks, ref_spec, ref_state,
                       walk, True)
    engine_state = _to_port(spec.BeaconState, pre)
    exc = _capture(stf.apply_signed_blocks, spec, engine_state,
                   [_to_port(spec.SignedBeaconBlock, b) for b in walk], True)
    assert ref_exc is not None, "the tampered block was accepted"
    assert type(exc) is type(ref_exc), (exc, ref_exc)
    assert str(exc) == str(ref_exc)
    assert bytes(engine_state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    # the valid blocks took the fast path; the invalid one was replayed
    assert stf.stats["fast_blocks"] == 2
    assert stf.stats["replayed_blocks"] == 1
    assert stf.stats["replay_reasons"] == {"FastPathViolation": 1}
    assert stf.stats["breaker_trips"] == 0
    assert verify.stats["native_degraded"] == 0


def test_slot_roots_match_spec_process_slots():
    """Empty-slot advancement across an epoch boundary, minimal preset."""
    _, spec, pre, _ = _corpus()
    state = _to_port(spec.BeaconState, pre)
    for jump in (1, 3, int(spec.SLOTS_PER_EPOCH) + 2):
        literal, replica = state.copy(), state.copy()
        target = literal.slot + jump
        spec.process_slots(literal, target)
        slot_roots.process_slots(spec, replica, target)
        assert bytes(replica.hash_tree_root()) == bytes(literal.hash_tree_root())
        state = literal
    with pytest.raises(AssertionError):
        slot_roots.process_slots(spec, state.copy(), state.slot)


@pytest.fixture
def resident_on_cpu(monkeypatch):
    """The resident route forced on the CPU (by default a CPU spec keeps
    the host hashing path, the reference's policy)."""
    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)


def test_slot_roots_resident_route_at_16384(tracing_on, monkeypatch):
    """A mainnet-preset state whose balances were bulk-written.  Under the
    default policy a CPU spec hashes them on the host and takes no
    resident root.  With the route forced, the first slot root reduces the
    balances subtree on the spec's device and memoizes it.  Either way the
    roots equal the host-hashed literal path's on an independent decode of
    the same state."""
    n = merkle_resident.RESIDENT_MIN
    spec = get_spec("phase0", "mainnet", device="cpu")
    state = scenario.build_state(spec, n)
    literal = spec.BeaconState.decode_bytes(bytes(state.encode_bytes()))
    assert state.balances.get_backing().left._root is None
    spec.process_slots(literal, literal.slot + 2)

    memoized = merkle_resident.stats["roots_memoized"]
    # balances bulk-written again: a plain copy would share (and so hash)
    # the subtree the forced run below needs unhashed
    default = state.copy()
    bulk.set_packed_uint64_from_numpy(
        default.balances, bulk.packed_uint64_to_numpy(state.balances))
    assert default.balances.get_backing().left._root is None
    slot_roots.process_slots(spec, default, default.slot + 2)
    assert tracing.report()["counters"].get("stf.resident_slot_root") is None
    assert merkle_resident.stats["roots_memoized"] == memoized
    assert bytes(default.hash_tree_root()) == bytes(literal.hash_tree_root())

    monkeypatch.setattr(merkle_resident, "RESIDENT_ON_CPU", True)
    slot_roots.process_slots(spec, state, state.slot + 2)
    assert tracing.report()["counters"].get("stf.resident_slot_root") == 1
    assert merkle_resident.stats["roots_memoized"] == memoized + 1
    assert bytes(state.hash_tree_root()) == bytes(literal.hash_tree_root())


def test_slot_roots_raise_on_a_failing_reduction(monkeypatch, resident_on_cpu):
    """A device reduction that fails raises; there is no host fallback
    that would hide it."""
    spec = get_spec("phase0", "mainnet", device="cpu")
    state = scenario.build_state(spec, merkle_resident.RESIDENT_MIN)

    def broken(values):
        raise KernelError("reduction failed")

    monkeypatch.setattr(merkle_resident, "packed_u64_root", broken)
    with pytest.raises(KernelError, match="reduction failed"):
        slot_roots.state_root(spec, state)


def _assert_no_replay():
    """A kernel error is not a fast-path miss: nothing replayed, nothing
    counted against the breaker."""
    assert stf.stats["replayed_blocks"] == 0, stf.stats["replay_reasons"]
    assert stf.stats["replay_reasons"] == {}
    assert stf.stats["fast_path_errors"] == 0
    assert stf.stats["breaker_trips"] == 0
    assert stf.stats["breaker_state"] == "closed"


def test_engine_raises_a_failing_kernel(bls_on, pipelined, monkeypatch,
                                       resident_on_cpu):
    """K2 failing in the first block's slot root, on a 16,384-validator
    state with bulk-written balances: the engine raises the error with the
    pre-state restored, and replays nothing on the host path."""
    spec = get_spec("phase0", "mainnet", device="cpu")
    state = scenario.build_state(spec, merkle_resident.RESIDENT_MIN)
    assert state.balances.get_backing().left._root is None
    pre = bytes(state.encode_bytes())
    block = spec.SignedBeaconBlock(
        message=spec.BeaconBlock(slot=state.slot + 1))

    def broken(values):
        raise KernelError("K2 launch failed")

    monkeypatch.setattr(merkle_resident, "packed_u64_root", broken)
    _fresh_engines()
    with pytest.raises(KernelError, match="K2 launch failed"):
        stf.apply_signed_blocks(spec, state, [block], True)
    _assert_no_replay()
    assert stf.stats["fast_blocks"] == 0
    assert bytes(state.encode_bytes()) == pre


def test_kernel_error_mid_window_settles_the_blocks_before(
        bls_on, pipelined, monkeypatch):
    """A kernel error in block 2's slot processing, with blocks 0 and 1
    still awaiting their verdicts when the pipeline is on: both commit, the
    error is raised, and the state is the literal post-state of block 1."""
    ref_spec, spec, pre, blocks = _corpus()
    port_blocks = [_to_port(spec.SignedBeaconBlock, b) for b in blocks[:4]]
    literal = _to_port(spec.BeaconState, pre)
    for block in port_blocks[:2]:
        spec.state_transition(literal, block, True)
    failing_slot = port_blocks[2].message.slot
    process_slots = slot_roots.process_slots

    def failing(spec_, state_, slot):
        if slot == failing_slot:
            raise KernelError("K2 launch failed")
        process_slots(spec_, state_, slot)

    monkeypatch.setattr(slot_roots, "process_slots", failing)
    _fresh_engines()
    state = _to_port(spec.BeaconState, pre)
    with pytest.raises(KernelError, match="K2 launch failed"):
        stf.apply_signed_blocks(spec, state, port_blocks, True)
    _assert_no_replay()
    assert stf.stats["fast_blocks"] == 2
    assert bytes(state.hash_tree_root()) == bytes(literal.hash_tree_root())
    assert pipeline.stats["drain_reasons"] == (
        {"kernel_error": 1} if pipelined else {})


@pytest.mark.slow
def test_main_path_at_400k_through_the_engine(bls_on, resident_on_cpu):
    """The main path on the CPU: 32 signed blocks at 400,000 validators
    through the engine in one call, root equal to the literal path's; the
    fused epoch route forced on the CPU, as the card takes it."""
    spec = get_spec("phase0", "mainnet", device="cpu")
    state = scenario.build_main_path_state(spec, 400_000)
    blocks = scenario.build_epoch_blocks(spec, state)
    literal = state.copy()
    for signed in blocks:
        spec.state_transition(literal, signed, True)
    _fresh_engines()
    fused = merkle_resident.stats["fused_epoch_updates"]
    engine_state = state.copy()
    stf.apply_signed_blocks(spec, engine_state, blocks, True)
    _assert_all_fast(len(blocks))
    assert merkle_resident.stats["fused_epoch_updates"] == fused + 1
    assert bytes(engine_state.hash_tree_root()) == bytes(literal.hash_tree_root())
