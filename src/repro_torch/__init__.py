"""PyTorch/CUDA port of the hybrid digital/analog C-CIM macro stack.

Mirrors the JAX package ``repro`` module for module; the macro GEMMs run
through hand-written CUDA kernels for Hopper (``kernels/ccim_matmul``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``, which selects the plain PyTorch reference path.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  With no GPU present the default raises instead of quietly
    carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch reference path on the CPU")
    return torch.device("cuda")
