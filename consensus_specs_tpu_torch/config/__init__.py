"""Preset & config data + loading machinery.

The reference keeps three config tiers (SURVEY §5 "Config / flag system"):
compile-time *presets* (`presets/{mainnet,minimal}/<fork>.yaml`), runtime
*configs* (`configs/{mainnet,minimal}.yaml`), and test flags.  Here the
first two tiers are Python data (`presets.py`, `configs.py`) consumed by
the spec builder, which injects preset vars as module globals and wraps
config vars in a ``Config`` namespace — mirroring the reference's split
where preset vars become constants and config vars live on a
``Configuration`` NamedTuple (reference: setup.py:632-639).
"""
from .presets import get_preset, PRESET_NAMES
from .configs import get_config, Config

__all__ = ["get_preset", "get_config", "Config", "PRESET_NAMES"]
