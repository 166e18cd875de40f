"""Architecture registry: --arch <id> resolution for launchers/tests.

Every architecture of the reference is listed; only ``minicpm-2b`` is
ported so far, and the others raise ``NotImplementedError``.
"""
from importlib import import_module

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "qwen3-14b": None,
    "starcoder2-7b": None,
    "gemma2-9b": None,
    "mamba2-130m": None,
    "qwen2-moe-a2.7b": None,
    "arctic-480b": None,
    "paligemma-3b": None,
    "zamba2-1.2b": None,
    "musicgen-medium": None,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    if _MODULES[name] is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported to torch yet (ported: "
            f"{', '.join(a for a, m in _MODULES.items() if m)})")
    mod = import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
