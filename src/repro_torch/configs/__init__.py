"""Configuration registry: the ten LM architectures of the pool (each a
:class:`~repro_torch.models.ModelConfig`) and the paper's eigenproblem
configurations, the port's copies of ``repro.configs``.
``get_config(name)`` returns the full configuration,
``get_smoke_config(name)`` a reduced one of the same family for CPU tests.

An eigen config is a dict with ``matrix`` (the family and its parameters)
and ``fd`` (an :class:`~repro_torch.core.FDConfig`). The FD fields are
the reference's, multi-device options included; the port's solver runs
one device in the stack layout, so a caller on one card sets
``layout="stack"`` and the default halo engine.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "deepseek-67b",
    "qwen3-0.6b",
    "qwen2.5-32b",
    "nemotron-4-15b",
    "internvl2-1b",
    "granite-moe-3b-a800m",
    "arctic-480b",
    "hymba-1.5b",
    "hubert-xlarge",
    "rwkv6-1.6b",
]

EIGEN_CONFIGS = ["exciton200", "hubbard16", "roadnet48k", "hubnet48k"]

_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "qwen3-0.6b": "qwen3_0p6b",
    "qwen2.5-32b": "qwen2p5_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "internvl2-1b": "internvl2_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "arctic-480b": "arctic_480b",
    "hymba-1.5b": "hymba_1p5b",
    "hubert-xlarge": "hubert_xlarge",
    "rwkv6-1.6b": "rwkv6_1p6b",
    **{name: name for name in EIGEN_CONFIGS},
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown config {name!r}; available: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke_config(name: str):
    return _mod(name).SMOKE
