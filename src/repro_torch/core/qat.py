"""CIM linear layer on packed weights, forward only.

Counterpart of ``repro/core/qat.py::cim_linear_packed``.  The
straight-through-estimator backward arrives with training; serving needs
only the forward.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .ccim import CCIMConfig, DEFAULT_CONFIG
from .engine import PackedCimWeights, packed_cim_matmul


def _cim_linear_packed_impl(x, packed, noise_key, cfg, fidelity, use_kernel,
                            noise_segments=None):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = packed_cim_matmul(x2.to(torch.float32), packed, cfg,
                          noise_key=noise_key, fidelity=fidelity,
                          use_kernel=use_kernel,
                          noise_segments=noise_segments)
    return y.reshape(*lead, packed.n_dim).to(x.dtype)


def cim_linear_packed(x: torch.Tensor, packed: PackedCimWeights,
                      noise_key=None, cfg: CCIMConfig = DEFAULT_CONFIG,
                      fidelity: str = "fast",
                      use_kernel: Optional[bool] = None,
                      noise_segments: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """(..., K) @ packed -> (..., N) through the macro, in x's dtype;
    ``noise_key`` (per segment with ``noise_segments``) adds the analog
    noise, drawn over the flattened rows as the reference draws it."""
    return _cim_linear_packed_impl(x, packed, noise_key, cfg, fidelity,
                                   use_kernel, noise_segments)
