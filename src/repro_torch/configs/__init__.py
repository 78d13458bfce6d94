"""Configurations of the port: the paper's benchmark grid (the port's copy
of ``repro.configs.paper_rid``) and the architecture registry
``get_config(arch)`` / ``get_smoke_config(arch)`` (counterpart of
``repro.configs``), with the same names and aliases.

Only the architectures whose models are ported have modules here
(``PORTED``); asking for another assigned one raises an error that names
it and the ported ones.
"""
from __future__ import annotations

import importlib

from .paper_rid import (PAPER_GRID, PAPER_PROCS, PAPER_TABLE5_ERRORS,
                        SMALL_GRID, RIDCase)

__all__ = ["RIDCase", "PAPER_GRID", "SMALL_GRID", "PAPER_PROCS",
           "PAPER_TABLE5_ERRORS", "ARCHS", "ALIASES", "PORTED",
           "get_config", "get_smoke_config"]

ARCHS = (
    "granite_3_2b",
    "qwen3_8b",
    "h2o_danube_1_8b",
    "qwen2_7b",
    "phi35_moe",
    "qwen2_moe_a2_7b",
    "qwen2_vl_2b",
    "whisper_tiny",
    "jamba_v01_52b",
    "xlstm_125m",
)

# The architectures the port's models run so far: the attention-only text
# stacks, dense or MoE.
PORTED = ("granite_3_2b", "qwen3_8b", "h2o_danube_1_8b", "qwen2_7b",
          "phi35_moe", "qwen2_moe_a2_7b")

# CLI aliases (assignment ids -> module names)
ALIASES = {
    "granite-3-2b": "granite_3_2b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-7b": "qwen2_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-tiny": "whisper_tiny",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-125m": "xlstm_125m",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(ARCHS)} "
                         f"(aliases: {sorted(ALIASES)})")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{list(PORTED)}")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE
