"""Test-vector consumer: replay generated vectors against a spec build.

The reference publishes vectors (consensus-spec-tests) that *client*
test runners consume per the format contract (reference:
tests/formats/*/README.md).  This module is that client-side half for
this framework: it walks an output tree produced by ``gen_runner``
(``<preset>/<fork>/<runner>/<handler>/<suite>/<case>``), decodes each
case's parts (``meta.yaml``, ``*.yaml``, ``*.ssz_snappy``) and replays
them through a freshly built spec module, asserting byte-identical
results.  Running generate→consume end-to-end pins both directions of
the format contract.

The contract each runner's replay enforces is documented field-by-field
in ``docs/formats/<runner>/README.md``; this module is the executable
counterpart of those documents.

Conventions handled (mirroring the reference formats):

* ``post`` absent => the operation/blocks must fail (assert/exception);
* ``meta.yaml: bls_setting`` 2 => BLS forced off; 1 or absent/0
  ("optional") => replayed BLS-on, since generation runs BLS-on;
* list parts appear as ``<name>_<i>.ssz_snappy`` plus ``<name>_count``;
* INCOMPLETE-tagged case dirs are skipped (consumer contract).

The specs are built for one device, ``consume_tree``'s ``device`` (CLI
``--device``): None is the CUDA card, and a host without one raises before
any case is read; the CPU runs only when asked for.  The BLS cases call
whichever backend the selector holds; under ``"torch"`` their pairing
checks run on ``ops.bls``'s device.  YAML parts are read by
``vector_yaml``, which needs no PyYAML.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from consensus_specs_tpu_torch._device import resolve_device
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.specs.builder import get_spec

from . import vector_yaml
from .snappy import decompress


class VectorFailure(AssertionError):
    pass


def _load_meta(case_dir: Path) -> Dict[str, Any]:
    meta = case_dir / "meta.yaml"
    if not meta.exists():
        return {}
    return vector_yaml.load(meta.read_text()) or {}


def _load_ssz(case_dir: Path, name: str, typ):
    path = case_dir / f"{name}.ssz_snappy"
    if not path.exists():
        return None
    return typ.decode_bytes(decompress(path.read_bytes()))


def _load_ssz_list(case_dir: Path, name: str, count: int, typ):
    return [_load_ssz(case_dir, f"{name}_{i}", typ) for i in range(count)]


def _expect_failure(fn):
    from consensus_specs_tpu_torch.testing.exceptions import BlockNotFoundException

    try:
        fn()
    except (AssertionError, IndexError, ValueError, KeyError, OverflowError,
            BlockNotFoundException):
        return
    raise VectorFailure("invalid case executed without error")


def _check_post(spec, state, case_dir: Path, context: str):
    post = _load_ssz(case_dir, "post", spec.BeaconState)
    if post is None:
        raise VectorFailure(f"{context}: post part missing")
    if bytes(state.hash_tree_root()) != bytes(post.hash_tree_root()):
        raise VectorFailure(f"{context}: post state root mismatch")


# operations/<handler> -> (input part name, input type attr, apply)
OPERATION_HANDLERS = {
    "attestation": ("attestation", "Attestation",
                    lambda spec, s, op, m: spec.process_attestation(s, op)),
    "attester_slashing": ("attester_slashing", "AttesterSlashing",
                          lambda spec, s, op, m: spec.process_attester_slashing(s, op)),
    "block_header": ("block", "BeaconBlock",
                     lambda spec, s, op, m: spec.process_block_header(s, op)),
    "deposit": ("deposit", "Deposit",
                lambda spec, s, op, m: spec.process_deposit(s, op)),
    "proposer_slashing": ("proposer_slashing", "ProposerSlashing",
                          lambda spec, s, op, m: spec.process_proposer_slashing(s, op)),
    "voluntary_exit": ("voluntary_exit", "SignedVoluntaryExit",
                       lambda spec, s, op, m: spec.process_voluntary_exit(s, op)),
    "sync_aggregate": ("sync_aggregate", "SyncAggregate",
                       lambda spec, s, op, m: spec.process_sync_aggregate(s, op)),
    "execution_payload": ("execution_payload", "ExecutionPayload",
                          lambda spec, s, op, m: spec.process_execution_payload(
                              s, op, spec.EXECUTION_ENGINE)),
    "withdrawals": ("execution_payload", "ExecutionPayload",
                    lambda spec, s, op, m: spec.process_withdrawals(s, op)),
    "bls_to_execution_change": ("address_change", "SignedBLSToExecutionChange",
                                lambda spec, s, op, m:
                                spec.process_bls_to_execution_change(s, op)),
}


def run_operations_case(spec, handler: str, case_dir: Path, meta) -> None:
    part, type_name, apply = OPERATION_HANDLERS[handler]
    pre = _load_ssz(case_dir, "pre", spec.BeaconState)
    op = _load_ssz(case_dir, part, getattr(spec, type_name))
    if pre is None or op is None:
        raise VectorFailure(f"operations/{handler}: missing parts")
    execution = case_dir / "execution.yaml"
    if execution.exists():
        valid = vector_yaml.load(execution.read_text()).get("execution_valid", True)
        if not valid:  # engine rejects: stub a refusing engine
            engine = spec.NoopExecutionEngine()
            engine.notify_new_payload = lambda payload: False
            apply = (lambda spec_, s, o, m,
                     _e=engine: spec_.process_execution_payload(s, o, _e))
    if (case_dir / "post.ssz_snappy").exists():
        apply(spec, pre, op, meta)
        _check_post(spec, pre, case_dir, f"operations/{handler}")
    else:
        _expect_failure(lambda: apply(spec, pre, op, meta))


def run_blocks_case(spec, case_dir: Path, meta) -> None:
    pre = _load_ssz(case_dir, "pre", spec.BeaconState)
    count = int(meta.get("blocks_count", 0))
    blocks = _load_ssz_list(case_dir, "blocks", count, spec.SignedBeaconBlock)

    def apply_all():
        for signed in blocks:
            block = signed.message
            # client semantics: advance slots only when behind the block
            # (the spec helper transition_unsigned_block does the same;
            # bare state_transition rejects same-slot blocks)
            if int(pre.slot) < int(block.slot):
                spec.process_slots(pre, block.slot)
            assert spec.verify_block_signature(pre, signed)
            spec.process_block(pre, block)
            assert bytes(block.state_root) == bytes(pre.hash_tree_root())

    if (case_dir / "post.ssz_snappy").exists():
        apply_all()
        _check_post(spec, pre, case_dir, "sanity/blocks")
    else:
        _expect_failure(apply_all)


def run_slots_case(spec, case_dir: Path, meta) -> None:
    pre = _load_ssz(case_dir, "pre", spec.BeaconState)
    slots = int(meta["slots"])
    spec.process_slots(pre, pre.slot + slots)
    _check_post(spec, pre, case_dir, "sanity/slots")


def run_epoch_processing_case(spec, handler: str, case_dir: Path, meta) -> None:
    pre = _load_ssz(case_dir, "pre", spec.BeaconState)
    # meta names the exact sub-transition (grouped handlers); otherwise
    # the handler dir uses the reference naming (sub-transition sans prefix)
    name = meta.get("sub_transition", f"process_{handler}")
    sub = getattr(spec, name, None) or getattr(spec, handler)
    if (case_dir / "post.ssz_snappy").exists():
        sub(pre)
        _check_post(spec, pre, case_dir, f"epoch_processing/{handler}")
    else:
        _expect_failure(lambda: sub(pre))


def run_rewards_case(spec, case_dir: Path, meta) -> None:
    from consensus_specs_tpu_torch.testing.helpers.rewards import Deltas

    pre = _load_ssz(case_dir, "pre", spec.BeaconState)
    # altair+ specs inherit phase0's component functions through the fork
    # chain, so detect the flag layout FIRST (its state has participation
    # flags, not pending attestations)
    if not hasattr(spec, "get_flag_index_deltas"):  # phase0 component layout
        components = {
            "source_deltas": spec.get_source_deltas,
            "target_deltas": spec.get_target_deltas,
            "head_deltas": spec.get_head_deltas,
            "inclusion_delay_deltas": spec.get_inclusion_delay_deltas,
            "inactivity_penalty_deltas": spec.get_inactivity_penalty_deltas,
        }
    else:  # altair+ flag layout
        components = {
            "source_deltas": lambda s: spec.get_flag_index_deltas(
                s, int(spec.TIMELY_SOURCE_FLAG_INDEX)),
            "target_deltas": lambda s: spec.get_flag_index_deltas(
                s, int(spec.TIMELY_TARGET_FLAG_INDEX)),
            "head_deltas": lambda s: spec.get_flag_index_deltas(
                s, int(spec.TIMELY_HEAD_FLAG_INDEX)),
            "inactivity_penalty_deltas": spec.get_inactivity_penalty_deltas,
        }
    for name, fn in components.items():
        expected = _load_ssz(case_dir, name, Deltas)
        if expected is None:
            continue
        rewards, penalties = fn(pre)
        got = Deltas(rewards=rewards, penalties=penalties)
        if bytes(got.hash_tree_root()) != bytes(expected.hash_tree_root()):
            raise VectorFailure(f"rewards component {name} mismatch")


def run_shuffling_case(spec, case_dir: Path, meta) -> None:
    data = vector_yaml.load((case_dir / "mapping.yaml").read_text())
    seed = bytes.fromhex(data["seed"][2:] if str(data["seed"]).startswith("0x")
                         else data["seed"])
    count = int(data["count"])
    mapping = [int(x) for x in data["mapping"]]
    got = [int(spec.compute_shuffled_index(i, count, seed)) for i in range(count)]
    if got != mapping:
        raise VectorFailure("shuffling mapping mismatch")


def run_ssz_static_case(spec, handler: str, case_dir: Path, meta) -> None:
    typ = getattr(spec, handler, None)
    if typ is None:
        raise VectorFailure(f"unknown container {handler}")
    serialized = decompress((case_dir / "serialized.ssz_snappy").read_bytes())
    roots = vector_yaml.load((case_dir / "roots.yaml").read_text())
    value = typ.decode_bytes(serialized)
    if bytes(value.encode_bytes()) != serialized:
        raise VectorFailure(f"ssz_static/{handler}: reserialization mismatch")
    root = roots["root"]
    root = bytes.fromhex(root[2:] if root.startswith("0x") else root)
    if bytes(value.hash_tree_root()) != root:
        raise VectorFailure(f"ssz_static/{handler}: root mismatch")


def run_genesis_case(spec, handler: str, case_dir: Path, meta) -> None:
    if handler == "validity":
        genesis = _load_ssz(case_dir, "genesis", spec.BeaconState)
        expected = bool(meta["is_valid"])
        if bool(spec.is_valid_genesis_state(genesis)) != expected:
            raise VectorFailure("genesis validity mismatch")
        return
    # initialization
    eth1_block_hash = decompress(
        (case_dir / "eth1_block_hash.ssz_snappy").read_bytes())
    count = int(meta.get("deposits_count", 0))
    deposits = _load_ssz_list(case_dir, "deposits", count, spec.Deposit)
    state = _load_ssz(case_dir, "state", spec.BeaconState)
    kwargs = {}
    if hasattr(spec, "ExecutionPayloadHeader"):
        header = _load_ssz(case_dir, "execution_payload_header",
                           spec.ExecutionPayloadHeader)
        if header is not None:
            kwargs["execution_payload_header"] = header
    got = spec.initialize_beacon_state_from_eth1(
        spec.Hash32(eth1_block_hash), spec.uint64(int(state.genesis_time)
                                                  - int(spec.config.GENESIS_DELAY)),
        deposits, **kwargs)
    if bytes(got.hash_tree_root()) != bytes(state.hash_tree_root()):
        raise VectorFailure("genesis initialization mismatch")


def _hex_bytes(value: str) -> bytes:
    return bytes.fromhex(value[2:] if value.startswith("0x") else value)


def run_bls_case(handler: str, case_dir: Path, device=None) -> None:
    """BLS handler vectors: data.yaml {input, output}; output null means
    the operation must fail (reference: tests/formats/bls/)."""
    data = vector_yaml.load((case_dir / "data.yaml").read_text())
    inp, expected = data["input"], data["output"]

    def run():
        if handler == "sign":
            return "0x" + bls.Sign(int(inp["privkey"], 16),
                                   _hex_bytes(inp["message"])).hex()
        if handler == "verify":
            return bls.Verify(_hex_bytes(inp["pubkey"]),
                              _hex_bytes(inp["message"]),
                              _hex_bytes(inp["signature"]))
        if handler == "aggregate":
            return "0x" + bytes(bls.Aggregate(
                [_hex_bytes(s) for s in inp])).hex()
        if handler == "fast_aggregate_verify":
            return bls.FastAggregateVerify(
                [_hex_bytes(p) for p in inp["pubkeys"]],
                _hex_bytes(inp["message"]), _hex_bytes(inp["signature"]))
        if handler == "aggregate_verify":
            return bls.AggregateVerify(
                [_hex_bytes(p) for p in inp["pubkeys"]],
                [_hex_bytes(m) for m in inp["messages"]],
                _hex_bytes(inp["signature"]))
        if handler == "eth_aggregate_pubkeys":
            spec = get_spec("altair", "minimal", device)
            return "0x" + bytes(spec.eth_aggregate_pubkeys(
                [spec.BLSPubkey(_hex_bytes(p)) for p in inp])).hex()
        if handler == "eth_fast_aggregate_verify":
            spec = get_spec("altair", "minimal", device)
            return spec.eth_fast_aggregate_verify(
                [spec.BLSPubkey(_hex_bytes(p)) for p in inp["pubkeys"]],
                _hex_bytes(inp["message"]), _hex_bytes(inp["signature"]))
        raise VectorFailure(f"unknown bls handler {handler}")

    if expected is None:
        _expect_failure(run)
        return
    got = run()
    if isinstance(expected, str):
        ok = got.lower() == expected.lower()
    else:
        ok = bool(got) == bool(expected)
    if not ok:
        raise VectorFailure(f"bls/{handler}: {got!r} != {expected!r}")


# the builder's fork topology covers experimental branches too
from consensus_specs_tpu_torch.specs.builder import FORK_PARENTS as _FORK_PARENT  # noqa: E402


def _build(fork: str, preset: str, config=None, device=None):
    """Spec for fork x preset on ``device``, honoring a recorded config
    override."""
    if config is None:
        return get_spec(fork, preset, device)
    from consensus_specs_tpu_torch.specs.builder import build_spec

    return build_spec(fork, preset, device, config=config)


def run_transition_case(case_dir: Path, meta, preset: str,
                        config=None, device=None) -> None:
    """Cross-fork transition: apply mixed pre/post-fork blocks, upgrading
    at the fork epoch (reference: tests/formats/transition/)."""
    # with_meta_tags-style modules record "fork"; with_fork_metas-driven
    # modules record "post_fork" (the reference transition format's key)
    post_fork = meta.get("post_fork", meta.get("fork"))
    fork_epoch = int(meta["fork_epoch"])
    pre_spec = _build(_FORK_PARENT[post_fork], preset, config, device)
    post_spec = _build(post_fork, preset, config, device)
    state = _load_ssz(case_dir, "pre", pre_spec.BeaconState)
    count = int(meta.get("blocks_count", 0))
    upgraded = False
    for i in range(count):
        raw = decompress((case_dir / f"blocks_{i}.ssz_snappy").read_bytes())
        try:
            signed = (post_spec if upgraded else pre_spec) \
                .SignedBeaconBlock.decode_bytes(raw)
        except Exception:
            signed = post_spec.SignedBeaconBlock.decode_bytes(raw)
        spec = post_spec if upgraded else pre_spec
        block = signed.message
        if not upgraded and int(spec.compute_epoch_at_slot(
                int(block.slot))) >= fork_epoch:
            boundary = fork_epoch * int(spec.SLOTS_PER_EPOCH)
            if int(state.slot) < boundary:
                spec.process_slots(state, spec.Slot(boundary))
            state = getattr(post_spec, f"upgrade_to_{post_fork}")(state)
            upgraded = True
            spec = post_spec
            signed = post_spec.SignedBeaconBlock.decode_bytes(raw)
            block = signed.message
        if int(state.slot) < int(block.slot):
            spec.process_slots(state, block.slot)
        assert spec.verify_block_signature(state, signed)
        spec.process_block(state, block)
        assert bytes(block.state_root) == bytes(state.hash_tree_root())
    _check_post(post_spec, state, case_dir, "transition")


def run_fork_choice_case(spec, case_dir: Path, meta) -> None:
    """Step-scripted fork-choice replay (reference format:
    tests/formats/fork_choice/): rebuild the store from the anchor, apply
    each tick/block/attestation/attester_slashing step (a block step
    implies its attestations and slashings, matching the generator), and
    compare every ``checks`` snapshot."""
    anchor_state = _load_ssz(case_dir, "anchor_state", spec.BeaconState)
    anchor_block = _load_ssz(case_dir, "anchor_block", spec.BeaconBlock)
    if anchor_state is None or anchor_block is None:
        raise VectorFailure("fork_choice: missing anchor parts")
    store = spec.get_forkchoice_store(anchor_state, anchor_block)
    steps = vector_yaml.load((case_dir / "steps.yaml").read_text()) or []

    # on_merge_block cases deliver PowBlocks; resolve them through the
    # spec's get_pow_block seam for the duration of the replay
    pow_blocks: Dict[bytes, Any] = {}
    original_get_pow_block = getattr(spec, "get_pow_block", None)
    if original_get_pow_block is not None:
        from consensus_specs_tpu_torch.testing.exceptions import BlockNotFoundException

        def _get_pow_block(block_hash):
            try:
                return pow_blocks[bytes(block_hash)]
            except KeyError:
                raise BlockNotFoundException()

        spec.get_pow_block = _get_pow_block
    try:
        _replay_fork_choice_steps(spec, store, steps, case_dir, pow_blocks)
    finally:
        if original_get_pow_block is not None:
            spec.get_pow_block = original_get_pow_block


def _replay_fork_choice_steps(spec, store, steps, case_dir, pow_blocks) -> None:
    for step in steps:
        if "tick" in step:
            spec.on_tick(store, int(step["tick"]))
        elif "pow_block" in step:
            pow_block = _load_ssz(case_dir, step["pow_block"], spec.PowBlock)
            pow_blocks[bytes(pow_block.block_hash)] = pow_block
        elif "block" in step:
            signed = _load_ssz(case_dir, step["block"], spec.SignedBeaconBlock)

            if step.get("valid", True):
                spec.on_block(store, signed)
                for attestation in signed.message.body.attestations:
                    spec.on_attestation(store, attestation, is_from_block=True)
                for slashing in signed.message.body.attester_slashings:
                    spec.on_attester_slashing(store, slashing)
            else:
                # the generator records valid:false when on_block itself
                # rejects; implied attestations never run in that case
                _expect_failure(lambda: spec.on_block(store, signed))
        elif "attestation" in step:
            attestation = _load_ssz(case_dir, step["attestation"],
                                    spec.Attestation)
            if step.get("valid", True):
                spec.on_attestation(store, attestation, is_from_block=False)
            else:
                _expect_failure(lambda: spec.on_attestation(
                    store, attestation, is_from_block=False))
        elif "attester_slashing" in step:
            slashing = _load_ssz(case_dir, step["attester_slashing"],
                                 spec.AttesterSlashing)
            if step.get("valid", True):
                spec.on_attester_slashing(store, slashing)
            else:
                _expect_failure(lambda: spec.on_attester_slashing(
                    store, slashing))
        elif "checks" in step:
            _run_store_checks(spec, store, step["checks"])
        else:
            raise VectorFailure(f"fork_choice: unknown step {step!r}")


def _run_store_checks(spec, store, checks) -> None:
    def _hex(b):
        return "0x" + bytes(b).hex()

    def fail(name, got, want):
        raise VectorFailure(f"fork_choice check {name}: {got!r} != {want!r}")

    for name, want in checks.items():
        if name == "time":
            got = int(store.time)
            if got != int(want):
                fail(name, got, want)
        elif name == "head":
            head = spec.get_head(store)
            got = {"slot": int(store.blocks[head].slot), "root": _hex(head)}
            if got != want:
                fail(name, got, want)
        elif name == "proposer_boost_root":
            got = _hex(store.proposer_boost_root)
            if got != want:
                fail(name, got, want)
        elif name == "genesis_time":
            got = int(store.genesis_time)
            if got != int(want):
                fail(name, got, want)
        elif name == "justified_checkpoint_root":
            got = _hex(store.justified_checkpoint.root)
            if got != want:
                fail(name, got, want)
        elif name.endswith("_checkpoint"):
            cp = getattr(store, name)
            got = {"epoch": int(cp.epoch), "root": _hex(cp.root)}
            if got != want:
                fail(name, got, want)
        else:
            # an unverified check must never pass vacuously
            raise VectorFailure(f"fork_choice: unknown check {name!r}")


def run_ssz_generic_case(handler: str, suite: str, case_dir: Path) -> None:
    """Replay per docs/formats/ssz_generic/README.md: suite ``valid``
    demands decode + byte-identical re-encode + root match; suite
    ``invalid`` demands the decode FAIL."""
    from consensus_specs_tpu_torch.gen.runners.ssz_generic import resolve_case_type
    from consensus_specs_tpu_torch.ssz.impl import hash_tree_root, serialize

    typ = resolve_case_type(handler, case_dir.name)
    raw = decompress((case_dir / "serialized.ssz_snappy").read_bytes())
    if suite == "invalid":
        try:
            typ.decode_bytes(raw)
        except Exception:
            return
        raise VectorFailure(
            f"ssz_generic/{handler}/{case_dir.name}: invalid encoding accepted")
    value = typ.decode_bytes(raw)
    if serialize(value) != raw:
        raise VectorFailure(
            f"ssz_generic/{handler}/{case_dir.name}: reserialization mismatch")
    roots = vector_yaml.load((case_dir / "roots.yaml").read_text())
    if "0x" + hash_tree_root(value).hex() != roots["root"]:
        raise VectorFailure(f"ssz_generic/{handler}/{case_dir.name}: root mismatch")
    # the third artifact of the format contract: the human-readable
    # value.yaml must describe the same value the bytes decode to
    value_path = case_dir / "value.yaml"
    if value_path.exists():
        from consensus_specs_tpu_torch.debug.encode import encode

        want = vector_yaml.load(value_path.read_text())
        got = vector_yaml.load(vector_yaml.dump(encode(value)))  # normalize
        if got != want:
            raise VectorFailure(
                f"ssz_generic/{handler}/{case_dir.name}: value.yaml mismatch")


def run_fork_case(fork: str, case_dir: Path, meta, preset: str,
                  config=None, device=None) -> None:
    pre_spec = _build(_FORK_PARENT[fork], preset, config, device)
    post_spec = _build(fork, preset, config, device)
    pre = _load_ssz(case_dir, "pre", pre_spec.BeaconState)
    post = _load_ssz(case_dir, "post", post_spec.BeaconState)
    got = getattr(post_spec, f"upgrade_to_{fork}")(pre)
    if bytes(got.hash_tree_root()) != bytes(post.hash_tree_root()):
        raise VectorFailure(f"fork upgrade to {fork} mismatch")


def run_case(preset: str, fork: str, runner: str, handler: str,
             case_dir: Path, device=None) -> str:
    """Replay one case directory on specs built for ``device``.  Returns
    'pass' or 'skip'."""
    if (case_dir / "INCOMPLETE").exists():
        return "skip"
    meta = _load_meta(case_dir)
    bls_setting = meta.get("bls_setting", 0)

    if runner == "bls":  # preset-independent ("general"); needs no spec
        old_bls = bls.bls_active
        bls.bls_active = True
        try:
            run_bls_case(handler, case_dir, device)
        finally:
            bls.bls_active = old_bls
        return "pass"

    if runner == "ssz_generic":  # pure type-system cases; needs no spec
        run_ssz_generic_case(handler, case_dir.parent.name, case_dir)
        return "pass"

    config_part = case_dir / "config.yaml"
    override_config = None
    if config_part.exists():
        # the case ran under overridden config values; rebuild the spec
        # with the recorded effective config (format: ints, 0x-hex, str)
        from consensus_specs_tpu_torch.specs.builder import _typed_config

        raw = {}
        for key, value in vector_yaml.load(config_part.read_text()).items():
            if isinstance(value, str) and value.startswith("0x"):
                raw[key] = bytes.fromhex(value[2:])
            else:
                raw[key] = value
        override_config = _typed_config(raw)
    # fork/transition replays build their own pre/post specs
    spec = (None if runner in ("fork", "forks", "transition")
            else _build(fork, preset, override_config, device))
    old_bls = bls.bls_active
    # Reference semantics (formats/README): 1 = required on, 2 = required
    # off, 0/absent = optional.  Vectors are *generated* BLS-on, so a real
    # client treats "optional" as verifiable; replay the same way instead of
    # silently stubbing signature checks for the majority of cases.
    bls.bls_active = (bls_setting != 2)
    try:
        if runner == "operations":
            run_operations_case(spec, handler, case_dir, meta)
        elif runner in ("sanity", "random", "finality"):
            if handler == "slots":
                run_slots_case(spec, case_dir, meta)
            else:
                run_blocks_case(spec, case_dir, meta)
        elif runner == "epoch_processing":
            run_epoch_processing_case(spec, handler, case_dir, meta)
        elif runner == "rewards":
            run_rewards_case(spec, case_dir, meta)
        elif runner == "shuffling":
            run_shuffling_case(spec, case_dir, meta)
        elif runner == "ssz_static":
            run_ssz_static_case(spec, handler, case_dir, meta)
        elif runner == "genesis":
            run_genesis_case(spec, handler, case_dir, meta)
        elif runner in ("fork", "forks"):
            run_fork_case(fork, case_dir, meta, preset, override_config,
                          device)
        elif runner == "transition":
            run_transition_case(case_dir, meta, preset, override_config,
                                device)
        elif runner == "fork_choice":
            run_fork_choice_case(spec, case_dir, meta)
        elif runner == "merkle":
            run_merkle_case(spec, case_dir, meta)
        else:
            return "skip"
    finally:
        bls.bls_active = old_bls
    return "pass"


def run_merkle_case(spec, case_dir: Path, meta) -> None:
    """single_proof format (docs/formats/merkle/single_proof.md): verify
    the recorded branch against the state root, and re-derive the branch
    ourselves (a prover-side client check the format explicitly invites)."""
    state = _load_ssz(case_dir, "state", spec.BeaconState)
    proof = vector_yaml.load((case_dir / "proof.yaml").read_text())
    leaf = _hex_bytes(proof["leaf"])
    gindex = int(proof["leaf_index"])
    branch = [_hex_bytes(node) for node in proof["branch"]]
    if not spec.is_valid_merkle_branch(
            leaf=leaf, branch=branch,
            depth=spec.floorlog2(gindex),
            index=spec.get_subtree_index(gindex),
            root=state.hash_tree_root()):
        raise VectorFailure("merkle branch does not verify against state root")
    from consensus_specs_tpu_torch.ssz.gindex import build_proof as _build_proof
    rebuilt = [bytes(n) for n in _build_proof(state.get_backing(), gindex)]
    if rebuilt != branch:
        raise VectorFailure("self-generated proof differs from recorded branch")


def consume_tree(root: Path, preset: Optional[str] = None,
                 fork: Optional[str] = None,
                 runners: Optional[set] = None,
                 device=None) -> Dict[str, int]:
    """Walk a generated vector tree, replaying every consumable case on
    specs built for ``device`` (None: the CUDA card; without one this
    raises).  Raises VectorFailure on the first divergence; returns
    counts."""
    resolve_device(device)
    stats = {"pass": 0, "skip": 0}
    root = Path(root)
    for preset_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        if preset and preset_dir.name != preset:
            continue
        for fork_dir in sorted(p for p in preset_dir.iterdir() if p.is_dir()):
            if fork and fork_dir.name != fork:
                continue
            for runner_dir in sorted(p for p in fork_dir.iterdir() if p.is_dir()):
                if runners and runner_dir.name not in runners:
                    continue
                for handler_dir in sorted(p for p in runner_dir.iterdir()
                                          if p.is_dir()):
                    for suite_dir in sorted(p for p in handler_dir.iterdir()
                                            if p.is_dir()):
                        for case_dir in sorted(p for p in suite_dir.iterdir()
                                               if p.is_dir()):
                            try:
                                result = run_case(
                                    preset_dir.name, fork_dir.name,
                                    runner_dir.name, handler_dir.name, case_dir,
                                    device)
                            except VectorFailure:
                                raise
                            except Exception as exc:
                                raise VectorFailure(
                                    f"{case_dir}: consumer error: {exc!r}"
                                ) from exc
                            stats[result] += 1
    return stats


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Replay generated test vectors against the spec")
    parser.add_argument("tree", help="vector output root")
    parser.add_argument("--preset", default=None)
    parser.add_argument("--fork", default=None)
    parser.add_argument("--runner", action="append", default=None)
    parser.add_argument("--device", default=None,
                        help="device the specs are built for (default: the "
                             "CUDA card; 'cpu' runs on the host)")
    args = parser.parse_args(argv)
    stats = consume_tree(Path(args.tree), args.preset, args.fork,
                         set(args.runner) if args.runner else None,
                         args.device)
    print(f"consumed: {stats['pass']} passed, {stats['skip']} skipped")


if __name__ == "__main__":
    main()
