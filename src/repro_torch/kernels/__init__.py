"""The port's hand-written CUDA kernels (``*/csrc``), built and bound by
``build``; each kernel module holds a wrapper and its plain version."""
from __future__ import annotations

from typing import Dict

import torch

_sms: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of CUDA ``device``, read once per device (the kernels'
    split rules take it)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]
