"""The paper's eigenproblem configurations, built on the port's
``FDConfig`` (the port's copies of ``repro.configs``' eigen configs; the LM
configs come with the LM side). ``get_config(name)`` returns the full
configuration, ``get_smoke_config(name)`` a reduced one of the same family
for CPU tests. Each is a dict with ``matrix`` (the family and its
parameters) and ``fd`` (an :class:`~repro_torch.core.FDConfig`). The FD
fields are the reference's, multi-device options included; the port's
solver runs one device in the stack layout, so a caller on one card sets
``layout="stack"`` and the default halo engine.
"""
from __future__ import annotations

import importlib

EIGEN_CONFIGS = ["exciton200", "hubbard16", "roadnet48k", "hubnet48k"]


def _mod(name: str):
    if name not in EIGEN_CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {EIGEN_CONFIGS}")
    return importlib.import_module(f".{name}", __package__)


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke_config(name: str):
    return _mod(name).SMOKE
