"""Executable consensus specs over the port's kernels.

``get_spec(fork, preset, device=None)`` returns a module-like spec object
exposing the executable spec API for that fork×preset, with its device
work on ``device`` (None: the CUDA card).  The port builds the mainline
ladder phase0 -> altair -> bellatrix -> capella (``available_forks``) and
the research forks eip4844, sharding, custody_game and das.
"""
from .builder import available_forks, get_spec

__all__ = ["get_spec", "available_forks"]
