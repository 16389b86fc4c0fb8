"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

One module per assigned architecture lives in this package; each exposes
``CONFIG`` (full-size, exact assigned hyperparameters) and ``smoke()``
(a reduced same-family config for CPU tests)."""

from __future__ import annotations

import importlib

from .base import ModelCfg, SHAPES, ShapeCfg

ARCHS = (
    "deepseek_v2_lite_16b",
    "qwen2_moe_a2_7b",
    "recurrentgemma_9b",
    "llama_3_2_vision_90b",
    "tinyllama_1_1b",
    "qwen2_7b",
    "smollm_360m",
    "qwen2_5_14b",
    "mamba2_780m",
    "seamless_m4t_medium",
)

# canonical assignment ids -> module names
_ALIASES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2-7b": "qwen2_7b",
    "smollm-360m": "smollm_360m",
    "qwen2.5-14b": "qwen2_5_14b",
    "mamba2-780m": "mamba2_780m",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def _module(arch: str):
    name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name not in ARCHS:
        raise KeyError(f"arch {arch!r} is unknown or not ported yet; ported: {sorted(_ALIASES)}")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelCfg:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelCfg:
    return _module(arch).smoke()


def list_archs() -> list[str]:
    return sorted(_ALIASES)


def get_shape(name: str) -> ShapeCfg:
    return SHAPES[name]


def sub_quadratic(cfg: ModelCfg) -> bool:
    """True if every sequence mixer is sub-quadratic (windowed / recurrent):
    the ``long_500k`` cell runs only for these archs."""
    kinds = {k for s in cfg.segments for k in s.pattern}
    quad = {"attn", "mla", "enc_attn"}
    return not (kinds & quad)


def cell_supported(cfg: ModelCfg, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell, with the reason if not."""
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return False, "full quadratic attention at 524k: skipped per assignment"
    return True, ""
