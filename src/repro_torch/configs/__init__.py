"""Architecture registry: ``get(name)`` -> full ArchConfig,
``get_reduced(name)`` -> CPU-test-scale config of the same family.

Only ``tinyllama-1.1b`` is ported; the other names of the JAX package's
registry raise ``NotImplementedError``.
"""
from __future__ import annotations

from importlib import import_module

ARCHS = (
    "llava-next-34b", "tinyllama-1.1b", "stablelm-12b", "nemotron-4-15b",
    "qwen3-8b", "mamba2-370m", "whisper-large-v3", "hymba-1.5b",
    "olmoe-1b-7b", "deepseek-v2-lite-16b",
)
PORTED = ("tinyllama-1.1b",)


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(f"{name}: not ported yet")
    return import_module(f".{name.replace('-', '_').replace('.', '_')}",
                         __package__)


def get(name: str):
    return _module(name).config()


def get_reduced(name: str):
    return _module(name).reduced()
