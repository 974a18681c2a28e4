"""The port's ``debug/``, ``gen/snappy`` and ``config/config_util`` against
the JAX package's.

* ``debug.random_value`` draws the same objects from the same seed in
  every ``RandomizationMode`` (and with chaos) for every container type of
  the phase0, altair, bellatrix and capella minimal specs, the port's
  built for ``"cpu"``: the same serialization and root as the reference's
  object, the same ``encode`` output (with and without roots), and
  ``decode`` gives the object back;
* ``gen.snappy`` writes the reference's bytes on seeded inputs of 0, 1,
  65,535, 65,536 and about 200,000 bytes, random and compressible, and
  reads them back;
* ``config.config_util`` parses the same preset and config files (the
  reference's layout, comments, quoted strings, hex, lists) into the same
  values, and refuses duplicates as the reference does.
"""
import random

import pytest

from consensus_specs_tpu.config import config_util as ref_config_util
from consensus_specs_tpu.debug import random_value as ref_random_value
from consensus_specs_tpu.debug.encode import encode as ref_encode
from consensus_specs_tpu.gen import snappy as ref_snappy
from consensus_specs_tpu.specs.builder import get_spec as ref_get_spec
from consensus_specs_tpu.ssz.types import Container as RefContainer
from consensus_specs_tpu_torch.config import config_util
from consensus_specs_tpu_torch.debug import random_value
from consensus_specs_tpu_torch.debug.decode import decode
from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.gen import snappy
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch.ssz.types import Container

FORKS = ("phase0", "altair", "bellatrix", "capella")
MODES = [mode.name for mode in random_value.RandomizationMode]


def _containers(spec, base):
    return [(name, getattr(spec, name)) for name in sorted(dir(spec))
            if isinstance(getattr(spec, name), type)
            and issubclass(getattr(spec, name), base)
            and getattr(spec, name) is not base]


@pytest.mark.parametrize("fork", FORKS)
@pytest.mark.parametrize("mode,chaos", [(m, False) for m in MODES]
                         + [("mode_random", True)])
def test_random_objects_equal_the_reference(fork, mode, chaos):
    port_types = _containers(get_spec(fork, "minimal", "cpu"), Container)
    ref_types = _containers(ref_get_spec(fork, "minimal"), RefContainer)
    assert [n for n, _ in port_types] == [n for n, _ in ref_types]
    seed = 1000 * FORKS.index(fork) + 10 * MODES.index(mode) + chaos
    rng, ref_rng = random.Random(seed), random.Random(seed)
    for (name, typ), (_, ref_typ) in zip(port_types, ref_types):
        obj = random_value.get_random_ssz_object(
            rng, typ, 64, 4, random_value.RandomizationMode[mode], chaos)
        ref_obj = ref_random_value.get_random_ssz_object(
            ref_rng, ref_typ, 64, 4, ref_random_value.RandomizationMode[mode],
            chaos)
        assert serialize(obj) == bytes(ref_obj.encode_bytes()), name
        assert hash_tree_root(obj) == bytes(ref_obj.hash_tree_root()), name
        assert encode(obj) == ref_encode(ref_obj), name
        back = decode(encode(obj, include_hash_tree_roots=True), typ)
        assert serialize(back) == serialize(obj), name
    # both generators drew the same number of values
    assert rng.random() == ref_rng.random()


def _snappy_inputs():
    rng = random.Random(20)
    out = []
    for n in (0, 1, 65_535, 65_536, 200_003):
        out.append(bytes(rng.getrandbits(8) for _ in range(n)))
        runs = b"".join(bytes([rng.randrange(4)]) * rng.randint(1, 90)
                        for _ in range(n // 30 + 1))
        out.append((runs + bytes(rng.getrandbits(8) for _ in range(n // 7)))[:n])
    return out


@pytest.mark.parametrize("index", range(10))
def test_snappy_bytes_equal_the_reference(index):
    data = _snappy_inputs()[index]
    packed = snappy.compress(data)
    assert packed == ref_snappy.compress(data)
    assert snappy.decompress(packed) == data
    assert snappy.decompress(packed) == ref_snappy.decompress(packed)


_PRESET_FILES = {
    "phase0.yaml": """# Minimal preset - Phase0

# Misc
# ---------------------------------------------------------------
# [customized] Just 4 committees for slot for testing purposes
MAX_COMMITTEES_PER_SLOT: 4
# [customized] unsecure, but fast
TARGET_COMMITTEE_SIZE: 4   # per slot
SHUFFLE_ROUND_COUNT: 10
""",
    "altair.yaml": """# Minimal preset - Altair
SYNC_COMMITTEE_SIZE: 32
EPOCHS_PER_SYNC_COMMITTEE_PERIOD: 8
""",
    "empty.yaml": "# nothing here yet\n",
}
_CONFIG = """# Minimal config
PRESET_BASE: 'minimal'
CONFIG_NAME: "minimal"
TERMINAL_TOTAL_DIFFICULTY: 115792089237316195423570985008687907853269984665640564039457584007913129638912
TERMINAL_BLOCK_HASH: 0x0000000000000000000000000000000000000000000000000000000000000000
GENESIS_FORK_VERSION: 0x00000001
DEPOSIT_CONTRACT_ADDRESS: 0x1234567890123456789012345678901234567890
MIN_GENESIS_TIME: 1578009600
FORK_LIST: [1, 2, altair]
BLOCK_LIST:
  - 7
  - x
"""


def test_config_util_equals_the_reference(tmp_path):
    preset_dir = tmp_path / "presets"
    preset_dir.mkdir()
    for name, text in _PRESET_FILES.items():
        (preset_dir / name).write_text(text)
    (tmp_path / "config.yaml").write_text(_CONFIG)
    presets = sorted(preset_dir.glob("*.yaml"))
    assert config_util.load_preset(presets) == ref_config_util.load_preset(presets)
    preset = config_util.load_preset_dir(preset_dir)
    assert preset == ref_config_util.load_preset_dir(preset_dir)
    assert preset["SYNC_COMMITTEE_SIZE"] == 32
    config = config_util.load_config_file(tmp_path / "config.yaml")
    assert config == ref_config_util.load_config_file(tmp_path / "config.yaml")
    assert config["GENESIS_FORK_VERSION"] == b"\x00\x00\x00\x01"
    assert config["FORK_LIST"] == [1, 2, "altair"]
    with (tmp_path / "config.yaml").open() as f, \
            (tmp_path / "config.yaml").open() as g:
        assert config_util.load_config_file(f) == ref_config_util.load_config_file(g)
    raw = {"PRESET_BASE": "minimal", "SLOTS_PER_EPOCH": "8",
           "GENESIS_FORK_VERSION": "0x00000001", "SOME_LIST": ["1", "2", "x"]}
    assert config_util.parse_config_vars(raw) == ref_config_util.parse_config_vars(raw)


def test_config_util_refuses_duplicates_as_the_reference(tmp_path):
    (tmp_path / "a.yaml").write_text("SLOTS_PER_EPOCH: 8\n")
    (tmp_path / "b.yaml").write_text("SLOTS_PER_EPOCH: 16\n")
    for module in (config_util, ref_config_util):
        with pytest.raises(Exception, match="duplicate"):
            module.load_preset_dir(tmp_path)
