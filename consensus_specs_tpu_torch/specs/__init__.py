"""Executable consensus specs over the port's kernels.

``get_spec(fork, preset, device=None)`` returns a module-like spec object
exposing the executable spec API for that fork×preset, with its device
work on ``device`` (None: the CUDA card).  The port builds phase0 and
altair.
"""
from .builder import available_forks, get_spec

__all__ = ["get_spec", "available_forks"]
