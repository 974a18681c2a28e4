"""``gen/vector_yaml``: the port's YAML writer and reader against PyYAML.

The writer must give the bytes of the reference's ``gen_runner._dump_yaml``
(PyYAML's ``SafeDumper``, ``default_flow_style=None``, ``sort_keys=False``,
no anchors) and the reader must give ``yaml.safe_load``'s values:

* on every ``.yaml`` part of the tier-1 vector tree of
  ``test_torch_vector_roundtrip.py`` (``bls``, one ``ssz_static``
  provider, ``sanity/slots``, one ``epoch_processing`` handler), written
  by the reference;
* on a seeded hypothesis strategy over the subset (dicts, lists, ints,
  booleans, None, printable-ASCII strings, nested, long enough to wrap);
* in ``strings`` mode, on preset and config files of the reference's
  layout, against ``yaml.BaseLoader``.

A value outside the subset raises ``ValueError`` in both directions.
"""
import yaml
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from consensus_specs_tpu.gen.gen_runner import _dump_yaml
from consensus_specs_tpu.testing import context as ref_context
from consensus_specs_tpu_torch.gen import vector_yaml
from tests.test_torch_vector_roundtrip import generate_reference_tree


@pytest.fixture(scope="module")
def reference_parts(tmp_path_factory):
    tree = tmp_path_factory.mktemp("reference")
    saved = ref_context.is_pytest
    try:
        generate_reference_tree(tree)
    finally:
        ref_context.is_pytest = saved
    return sorted(tree.rglob("*.yaml"))


def _reference_bytes(data, tmp_path) -> str:
    path = tmp_path / "part.yaml"
    _dump_yaml(data, path, "w")
    return path.read_text()


def test_corpus_parts_written_and_read_as_the_reference(reference_parts):
    kinds = {p.name for p in reference_parts}
    # data parts of every runner in the tree, and meta parts
    assert {"data.yaml", "roots.yaml", "value.yaml", "meta.yaml"} <= kinds
    assert len(reference_parts) > 100
    for path in reference_parts:
        text = path.read_text()
        data = yaml.safe_load(text)
        assert vector_yaml.dump(data) == text, path
        assert vector_yaml.load(text) == data, path


# printable ASCII, weighted to the shapes vectors hold and to the strings
# that must be quoted (hex, decimal, YAML keywords, indicators, spaces)
_WORDS = st.sampled_from([
    "0x", "0x00", "0x" + "ab" * 48, "123", "-7", "1_000", "0o17", "0b101",
    "1:20", "1.5", ".inf", "2020-01-01", "true", "No", "on", "null", "~", "",
    "=", "<<", "-", "- x", "? x", "?x", ":x", "x: y", "x:y", "a,b", "[x",
    "#x", "x #y", "it's", "'q'", '"q"', "---", "...", " lead", "trail ",
    "pubkey", "validator_index", "a b c d e f g h i j k l m n o p q r s t",
])
_TEXT = st.one_of(_WORDS, st.text(st.characters(min_codepoint=0x20,
                                                max_codepoint=0x7E),
                                  max_size=120))
_SCALARS = st.one_of(st.none(), st.booleans(),
                     st.integers(min_value=-2**70, max_value=2**260), _TEXT)
_KEYS = st.one_of(_WORDS, st.text(st.characters(min_codepoint=0x20,
                                                max_codepoint=0x7E),
                                  min_size=1, max_size=40)).filter(
    lambda k: 0 < len(k) < 128)
_VALUES = st.recursive(
    _SCALARS,
    lambda inner: st.one_of(st.lists(inner, max_size=40),
                            st.dictionaries(_KEYS, inner, max_size=8)),
    max_leaves=120)


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(value=_VALUES)
def test_subset_written_and_read_as_the_reference(value, tmp_path):
    text = _reference_bytes(value, tmp_path)
    assert vector_yaml.dump(value) == text
    assert vector_yaml.load(text) == yaml.safe_load(text)


def test_flow_lists_wrap_at_the_reference_width(tmp_path):
    value = {"mapping": list(range(0, 10_000, 7)),
             "roots": ["0x" + f"{i:064x}" for i in range(5)],
             "nested": [{"slot": 1, "root": "0x" + "ff" * 32}, [[], {}]]}
    text = _reference_bytes(value, tmp_path)
    assert vector_yaml.dump(value) == text
    assert max(map(len, text.splitlines())) > 80  # it did wrap, past 80
    assert vector_yaml.load(text) == value


@pytest.mark.parametrize("value", [0, -3, 2**64, True, None, "plain", "0x12",
                                   "", [], {}])
def test_top_level_scalars_and_empty_collections(value, tmp_path):
    text = _reference_bytes(value, tmp_path)
    assert vector_yaml.dump(value) == text
    assert vector_yaml.load(text) == value


_PRESET = """# Mainnet preset - Phase0

# Misc
# ---------------------------------------------------------------
# 2**6 (= 64)
MAX_COMMITTEES_PER_SLOT: 64
TARGET_COMMITTEE_SIZE: 128   # a trailing comment
PRESET_BASE: 'mainnet'
CONFIG_NAME: "mainnet"
GENESIS_FORK_VERSION: 0x00000000
DEPOSIT_CONTRACT_ADDRESS: 0x00000000219ab540356cBB839Cbe05303d7705Fa
TERMINAL_TOTAL_DIFFICULTY: 58750000000000000000000
FLOW_LIST: [1, 2, x]
BLOCK_LIST:
  - 1
  - 'two'
INDENTLESS:
- 3
EMPTY:
NULLISH: null
"""


@pytest.mark.parametrize("text", [_PRESET, "", "# only a comment\n",
                                  "---\nA: 1\n...\n", "A: 'it''s'\nB: \"a\\tb\"\n",
                                  "A:\n  B:\n    - [1, 2]\n    - {c: d}\n"])
def test_strings_mode_reads_as_the_base_loader(text):
    assert vector_yaml.load(text, strings=True) == yaml.load(
        text, Loader=yaml.BaseLoader)
    assert vector_yaml.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("value", [1.5, b"\x00", {1: 2}, {"": 1}, {"k" * 128: 1},
                                   "tab\there", "caf\u00e9", object()])
def test_values_outside_the_subset_raise(value):
    with pytest.raises(ValueError):
        vector_yaml.dump(value)


def test_uint_views_raise_as_the_reference_refuses_them():
    from consensus_specs_tpu_torch.ssz.types import uint64

    with pytest.raises(ValueError):
        vector_yaml.dump({"slot": uint64(3)})
    with pytest.raises(yaml.representer.RepresenterError):
        yaml.dump({"slot": uint64(3)}, Dumper=yaml.SafeDumper)


@pytest.mark.parametrize("text", ["a: 1.5\n", "a: &x 1\nb: *x\n", "a: !!str 1\n",
                                  "a: |\n  text\n", "? a\n: b\n", "%YAML 1.1\n---\na: 1\n",
                                  "a: 1\n---\nb: 2\n", "a: [1, 2\n", "a: 2020-01-01\n"])
def test_documents_outside_the_subset_raise(text):
    with pytest.raises(ValueError):
        vector_yaml.load(text)
