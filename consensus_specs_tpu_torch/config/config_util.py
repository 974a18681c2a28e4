"""Runtime YAML preset/config loader (reference capability:
eth2spec/config/config_util.py:6-63): downstream consumers point this at
a presets directory / config file in the reference's YAML layout and get
the parsed var dicts — the same data the baked-in ``presets.py`` /
``configs.py`` carry for the standard networks.

Values follow the reference's parsing rules: ``0x…`` strings become
bytes, lists keep int-looking items as ints, everything but
``PRESET_BASE``/``CONFIG_NAME`` becomes an int.  Duplicate preset vars
across fork files are an error.  The files are read by
``gen.vector_yaml`` with every scalar kept a string (PyYAML's
``BaseLoader``), so no YAML package is needed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterable, Union

from consensus_specs_tpu_torch.gen import vector_yaml

_STRING_KEYS = ("PRESET_BASE", "CONFIG_NAME")


def parse_config_vars(conf: Dict[str, Any]) -> Dict[str, Any]:
    """Parse basic str/int YAML values into their runtime types."""
    out: Dict[str, Any] = {}
    for key, value in conf.items():
        if isinstance(value, list):
            out[key] = [
                int(item) if str(item).isdigit() else item for item in value
            ]
        elif isinstance(value, str) and value.startswith("0x"):
            out[key] = bytes.fromhex(value[2:])
        elif key not in _STRING_KEYS:
            out[key] = int(value)
        else:
            out[key] = str(value)
    return out


def _load_yaml(source: Union[Path, str, Any]) -> Dict[str, Any]:
    if isinstance(source, (str, Path)):
        text = Path(source).read_text()
    else:  # file-like
        text = source.read()
        if isinstance(text, bytes):
            text = text.decode()
    # every scalar a string (the reference's YAML(typ='base')): unquoted
    # 0x… must reach parse_config_vars as text, not a pre-parsed hex integer
    data = vector_yaml.load(text, strings=True)
    return {} if data is None else {str(k): v for k, v in data.items()}


def load_preset(preset_files: Iterable[Union[Path, str, Any]]) -> Dict[str, Any]:
    """Merge a directory's per-fork preset files into one preset dict.
    Duplicate vars across files are fatal (they would silently shadow)."""
    preset: Dict[str, Any] = {}
    for fork_file in preset_files:
        fork_preset = _load_yaml(fork_file)
        if not fork_preset:
            continue
        duplicates = set(fork_preset).intersection(preset)
        if duplicates:
            raise Exception(
                "duplicate config var(s) in preset files: "
                + ", ".join(sorted(duplicates)))
        preset.update(fork_preset)
    assert preset != {}
    return parse_config_vars(preset)


def load_preset_dir(preset_dir: Union[Path, str]) -> Dict[str, Any]:
    """Convenience: every ``*.yaml`` under a preset directory."""
    return load_preset(sorted(Path(preset_dir).glob("*.yaml")))


def load_config_file(config_path: Union[Path, str, Any]) -> Dict[str, Any]:
    """Load one runtime-config YAML file."""
    return parse_config_vars(_load_yaml(config_path))
