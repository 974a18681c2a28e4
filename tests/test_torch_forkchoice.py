"""The port's fork-choice engine (``forkchoice/``) and ``segment_sum``
against the JAX package's, at the minimal preset, BLS off in both.

* ``segment_sum``: the ``"torch"`` branch on the CPU equals the numpy
  branch and the reference's, and the environment variable selects it;
* seeded random block DAGs (forks off random known states, skip slots,
  partial-committee votes, some of them aged out of the spec's window)
  delivered to the port's engine, the reference's engine and the
  reference's literal spec store: the same verdict for every delivery
  and, after each one, the same head and checkpoints in all three;
* a finalizing chain (justified refresh and the proto-array prune) with a
  competing fork and a vote after it, delivered the same way;
* the batched latest-message fold against the sequential spec fold, a
  fault between staging and commit that lands no vote, and an engine
  wrapped around a warm store.

Every comparison is exact: heads, checkpoints and vote tables are bytes
and integers.
"""
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.forkchoice import ForkChoiceEngine as RefEngine
from consensus_specs_tpu.ops.segment import segment_sum as ref_segment_sum
from consensus_specs_tpu.testing.helpers.attestations import (
    get_valid_attestation,
    next_epoch_with_attestations,
    sign_attestation,
)
from consensus_specs_tpu.testing.helpers.block import build_empty_block
from consensus_specs_tpu.testing.helpers.state import (
    next_epoch,
    state_transition_and_sign_block,
)
from consensus_specs_tpu_torch import faults
from consensus_specs_tpu_torch.forkchoice import ForkChoiceEngine, ProtoArray
from consensus_specs_tpu_torch.forkchoice import engine as fc_engine
from consensus_specs_tpu_torch.ops import segment
from tests.torch_node_common import bls_off, pair, to_port  # noqa: F401


def _rows(seed, n=5000, segments=37):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32_000_000_000, n), rng.integers(0, segments, n),
            segments)


@pytest.mark.parametrize("seed", [3, 4])
def test_segment_sum_torch_on_the_cpu_equals_numpy_and_the_reference(seed):
    values, ids, n = _rows(seed)
    host = segment.segment_sum(values, ids, n, backend="numpy")
    dev = segment.segment_sum(values, ids, n, backend="torch", device="cpu")
    ref = ref_segment_sum(values, ids, n, backend="numpy")
    assert host.dtype == dev.dtype == np.int64
    assert np.array_equal(host, dev)
    assert np.array_equal(host, ref)


def test_segment_backend_comes_from_the_environment(monkeypatch):
    values, ids, n = _rows(5)
    assert segment.backend_in_use() == "numpy"
    monkeypatch.setenv("CSTPU_SEGMENT_BACKEND", "torch")
    assert segment.backend_in_use() == "torch"
    got = segment.segment_sum(values, ids, n, device="cpu")
    assert np.array_equal(got, segment.segment_sum(values, ids, n, "numpy"))
    with pytest.raises(ValueError):
        segment.segment_sum(values, ids, n, backend="jax")


def test_segment_torch_without_a_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    values, ids, n = _rows(6, n=10)
    with pytest.raises(RuntimeError):
        segment.segment_sum(values, ids, n, backend="torch")


def test_proto_array_weights_under_the_torch_backend(monkeypatch):
    """The proto-array's vote deltas through the ``"torch"`` branch (the
    CPU named through a wrapper) give the numpy branch's weights."""
    def build():
        proto = ProtoArray()
        proto.insert(b"\x01" * 32, b"\x00" * 32, 0, (0, b""), (0, b""))
        for k in range(2, 8):
            proto.insert(bytes([k]) * 32, bytes([k // 2]) * 32, k,
                         (0, b""), (0, b""))
        proto.set_balances(np.arange(1, 65, dtype=np.int64) * 10**9)
        rng = np.random.default_rng(9)
        for _ in range(3):
            v = rng.choice(64, 20, replace=False)
            proto.apply_vote_changes(v, rng.integers(-1, 7, 20),
                                     np.full(20, 1, dtype=np.int64))
        return proto.weights

    host = build()
    real = segment.segment_sum
    monkeypatch.setattr(
        "consensus_specs_tpu_torch.forkchoice.proto_array.segment_sum",
        lambda v, i, n: real(v, i, n, backend="torch", device="cpu"))
    assert build() == host


# -- three-way delivery: port engine, reference engine, literal spec ---------


class _Three:
    """The port's engine, the reference's engine and the reference's spec
    store over one anchor; every delivery goes to all three."""

    def __init__(self, ref_spec, spec, ref_state):
        anchor = ref_spec.BeaconBlock(state_root=ref_state.hash_tree_root())
        self.ref_spec, self.spec = ref_spec, spec
        self.store = ref_spec.get_forkchoice_store(ref_state.copy(), anchor)
        self.ref = RefEngine(
            ref_spec, ref_spec.get_forkchoice_store(ref_state.copy(), anchor))
        self.port = ForkChoiceEngine(spec, spec.get_forkchoice_store(
            to_port(spec.BeaconState, ref_state),
            to_port(spec.BeaconBlock, anchor)))
        self.verdicts = []

    def _all(self, spec_call, ref_call, port_call):
        outcome = []
        for call in (spec_call, ref_call, port_call):
            try:
                call()
                outcome.append(True)
            except AssertionError:
                outcome.append(False)
        assert len(set(outcome)) == 1, f"verdicts differ: {outcome}"
        self.verdicts.append(outcome[0])
        self.check()

    def tick(self, time):
        if self.store.time < time:
            self._all(lambda: self.ref_spec.on_tick(self.store, time),
                      lambda: self.ref.on_tick(time),
                      lambda: self.port.on_tick(time))

    def slot_time(self, slot):
        return int(self.store.genesis_time) + int(slot) * int(
            self.ref_spec.config.SECONDS_PER_SLOT)

    def block(self, signed):
        self.tick(self.slot_time(signed.message.slot))
        port_block = to_port(self.spec.SignedBeaconBlock, signed)
        self._all(lambda: self.ref_spec.on_block(self.store, signed),
                  lambda: self.ref.on_block(signed),
                  lambda: self.port.on_block(port_block))

    def vote(self, att):
        self.tick(self.slot_time(int(att.data.slot) + 1))
        port_att = to_port(self.spec.Attestation, att)
        self._all(lambda: self.ref_spec.on_attestation(self.store, att),
                  lambda: self.ref.on_attestations([att]),
                  lambda: self.port.on_attestations([port_att]))

    def check(self):
        spec, store = self.ref_spec, self.store
        spec.store_target_checkpoint_state(store, store.justified_checkpoint)
        head = bytes(spec.get_head(store))
        assert bytes(self.ref.get_head()) == head
        assert bytes(self.port.get_head()) == head
        for name in ("justified_checkpoint", "finalized_checkpoint"):
            want = getattr(store, name)
            got = getattr(self.port.store, name)
            assert (int(got.epoch), bytes(got.root)) == (
                int(want.epoch), bytes(want.root)), name
        assert {int(v): (int(m.epoch), bytes(m.root))
                for v, m in self.port.store.latest_messages.items()} == {
            int(v): (int(m.epoch), bytes(m.root))
            for v, m in store.latest_messages.items()}


def _branch(ref_spec, base, slot, graffiti=None):
    post = base.copy()
    block = build_empty_block(ref_spec, post, slot=slot)
    if graffiti is not None:
        block.body.graffiti = graffiti
    return state_transition_and_sign_block(ref_spec, post, block), post


def _vote(ref_spec, rng, post, signed):
    att = get_valid_attestation(
        ref_spec, post, slot=post.slot, signed=False,
        filter_participant_set=lambda comm: set(
            sorted(comm)[:rng.randint(1, max(1, len(comm) // 2))]))
    att.data.beacon_block_root = signed.message.hash_tree_root()
    sign_attestation(ref_spec, post, att)
    return att


@pytest.mark.parametrize("seed", range(6))
def test_random_dag_same_heads_at_every_delivery(bls_off, seed):
    ref_spec, spec, ref_state, _ = pair()
    rng = random.Random(seed)
    three = _Three(ref_spec, spec, ref_state)
    three.tick(three.slot_time(ref_state.slot))
    blocks, bases = [], [ref_state.copy()]
    for _ in range(3):
        for _ in range(rng.randint(2, 4)):
            base = rng.choice(bases)
            signed, post = _branch(ref_spec, base,
                                   int(base.slot) + rng.randint(1, 3))
            blocks.append((signed, post))
            bases.append(post)
            three.block(signed)
        for _ in range(rng.randint(1, 3)):
            signed, post = rng.choice(blocks)
            three.vote(_vote(ref_spec, rng, post, signed))
    assert any(three.verdicts)
    assert fc_engine.stats["on_block"] > 0


def test_finalizing_chain_prunes_with_the_same_heads(bls_off):
    """Full-participation epochs until finality moves: the justified
    refresh and the proto-array prune on the port's engine, then a
    competing fork off the head and a vote for it."""
    ref_spec, spec, ref_state, _ = pair()
    three = _Three(ref_spec, spec, ref_state)
    state = ref_state.copy()
    next_epoch(ref_spec, state)
    three.tick(three.slot_time(state.slot))
    fc_engine.reset_stats()
    for _ in range(4):
        _, blocks, state = next_epoch_with_attestations(
            ref_spec, state, True, True)
        for signed in blocks:
            three.block(signed)
    assert int(three.store.finalized_checkpoint.epoch) > 0
    assert fc_engine.stats["prunes"] >= 1
    assert fc_engine.stats["justified_refreshes"] >= 2
    head = three.store.block_states[ref_spec.get_head(three.store)]
    signed, post = _branch(ref_spec, head.copy(), int(head.slot) + 1)
    three.block(signed)
    three.vote(_vote(ref_spec, random.Random(1), post, signed))
    assert all(three.verdicts)


def test_batched_fold_equals_the_sequential_fold(bls_off):
    """A batch with repeated validators across two target epochs and
    varying LMD roots: ``on_attestations`` on the port leaves the vote
    table the reference's sequential ``on_attestation`` fold leaves."""
    ref_spec, spec, ref_state, _ = pair()
    three = _Three(ref_spec, spec, ref_state)
    st = ref_state.copy()
    blocks, posts = [], []
    spe = int(ref_spec.SLOTS_PER_EPOCH)
    for _ in range(2 * spe):
        signed, st = _branch(ref_spec, st, int(st.slot) + 1)
        blocks.append(signed)
        posts.append(st)
    for signed in blocks:
        three.block(signed)
    three.tick(three.slot_time(int(blocks[-1].message.slot) + 1))
    rng = random.Random(7)
    atts = []
    for _ in range(10):
        i = rng.randint(spe - 1, 2 * spe - 1)
        epoch_start = ((i + 1) // spe) * spe - 1
        att = get_valid_attestation(
            ref_spec, posts[i], slot=i + 1, signed=False,
            filter_participant_set=lambda comm: set(
                rng.sample(sorted(comm), max(1, len(comm) // 2))))
        att.data.beacon_block_root = \
            blocks[rng.randint(epoch_start, i)].message.hash_tree_root()
        sign_attestation(ref_spec, posts[i], att)
        atts.append(att)
    rng.shuffle(atts)
    for att in atts:
        ref_spec.on_attestation(three.store, att)
    three.ref.on_attestations(atts)
    three.port.on_attestations([to_port(spec.Attestation, a) for a in atts])
    three.check()


def test_batch_fault_leaves_no_partial_votes(bls_off):
    """The port's ``forkchoice.batch.apply`` site fires after staging and
    before the commit: no vote lands, and the retry lands the whole batch
    as the spec's sequential fold does."""
    ref_spec, spec, ref_state, _ = pair()
    three = _Three(ref_spec, spec, ref_state)
    st = ref_state.copy()
    blocks = []
    for _ in range(int(ref_spec.SLOTS_PER_EPOCH)):
        signed, st = _branch(ref_spec, st, int(st.slot) + 1)
        blocks.append((signed, st))
        three.block(signed)
    three.tick(three.slot_time(int(st.slot) + 1))
    rng = random.Random(3)
    atts = [_vote(ref_spec, rng, post, signed) for signed, post in blocks[-3:]]
    port_atts = [to_port(spec.Attestation, a) for a in atts]
    votes_before = three.port.proto.vote_node.copy()
    with faults.inject(faults.FaultPlan(
            [faults.Fault("forkchoice.batch.apply")])):
        with pytest.raises(faults.InjectedFault):
            three.port.on_attestations(port_atts)
    assert dict(three.port.store.latest_messages) == {}
    assert np.array_equal(three.port.proto.vote_node, votes_before)
    three.check()
    three.port.on_attestations(port_atts)
    for att in atts:
        ref_spec.on_attestation(three.store, att)
    three.ref.on_attestations(atts)
    three.check()


def test_engine_wraps_a_warm_store(bls_off):
    """An engine built around a store that already holds a standing vote
    seeds it: the head is the voted fork, not the tie-break's."""
    ref_spec, spec, ref_state, port_state = pair()
    base = port_state.copy()
    anchor = spec.BeaconBlock(state_root=base.hash_tree_root())
    store = spec.get_forkchoice_store(base.copy(), anchor)
    ref_store = ref_spec.get_forkchoice_store(
        ref_state.copy(), ref_spec.BeaconBlock(
            state_root=ref_state.hash_tree_root()))
    sides = [_branch(ref_spec, ref_state.copy(), int(ref_state.slot) + 1,
                     graffiti=bytes([g]) * 32) for g in (0, 1)]
    sides.sort(key=lambda s: bytes(s[0].message.hash_tree_root()))
    t = int(store.genesis_time) + (int(spec.SLOTS_PER_EPOCH) + 2) * int(
        spec.config.SECONDS_PER_SLOT)
    for s in (store, ref_store):
        (spec if s is store else ref_spec).on_tick(s, t)
    for signed, _post in sides:
        ref_spec.on_block(ref_store, signed)
        spec.on_block(store, to_port(spec.SignedBeaconBlock, signed))
    signed_a, post_a = sides[0]
    att = get_valid_attestation(ref_spec, post_a, slot=post_a.slot,
                                signed=False)
    att.data.beacon_block_root = signed_a.message.hash_tree_root()
    sign_attestation(ref_spec, post_a, att)
    ref_spec.on_attestation(ref_store, att)
    spec.on_attestation(store, to_port(spec.Attestation, att))
    want = bytes(signed_a.message.hash_tree_root())
    assert bytes(ref_spec.get_head(ref_store)) == want
    assert bytes(ForkChoiceEngine(spec, store).get_head()) == want
    assert bytes(RefEngine(ref_spec, ref_store).get_head()) == want
