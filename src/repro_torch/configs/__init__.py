"""Architecture registry: --arch <id> resolution for launchers/tests.

Every architecture of the reference is ported: the dense family
(``minicpm-2b``, ``qwen3-14b``, ``starcoder2-7b``, ``gemma2-9b``), the
moe family (``qwen2-moe-a2.7b``, ``arctic-480b``), ``mamba2-130m``
(ssm), ``zamba2-1.2b`` (hybrid), ``paligemma-3b`` (vlm) and
``musicgen-medium`` (audio).
"""
from importlib import import_module

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "qwen3-14b": "qwen3_14b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma2-9b": "gemma2_9b",
    "mamba2-130m": "mamba2_130m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "arctic-480b": "arctic_480b",
    "paligemma-3b": "paligemma_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "musicgen-medium": "musicgen_medium",
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    mod = import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
