"""CIM linear layers, forward only: on raw float weights (quantized per
call) and on packed weights.

Counterpart of ``repro/core/qat.py::cim_linear``, ``cim_linear_packed``
and ``maybe_cim_linear``.  The straight-through-estimator backward
arrives with training; serving and the planner need only the forward.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .ccim import CCIMConfig, DEFAULT_CONFIG, cim_matmul
from .engine import PackedCimWeights, packed_cim_matmul


def _cim_linear_impl(x, w, noise_key, cfg, fidelity, use_kernel,
                     noise_segments=None):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = cim_matmul(x2.to(torch.float32), w.to(torch.float32), cfg,
                   noise_key=noise_key, fidelity=fidelity,
                   use_kernel=use_kernel, noise_segments=noise_segments)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)


def cim_linear(x: torch.Tensor, w: torch.Tensor, noise_key=None,
               cfg: CCIMConfig = DEFAULT_CONFIG, fidelity: str = "fast",
               use_kernel: Optional[bool] = None,
               noise_segments: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
    """(..., K) @ w (K, N) through the macro, in x's dtype: the float32
    weights are quantized per call (per-channel SMF scale), then the
    macro GEMM of ``ccim.cim_matmul`` runs -- at the prototype's numerics
    the unpacked kernel, at any other design point inside the prepacked
    kernels' envelope a pack made for the call.  Bit-identical to
    ``cim_linear_packed`` on the pack of ``w``.  ``noise_key`` (per
    segment with ``noise_segments``) adds the analog noise."""
    return _cim_linear_impl(x, w, noise_key, cfg, fidelity, use_kernel,
                            noise_segments)


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


def maybe_cim_linear(x: torch.Tensor, w, cim_cfg: Optional[CCIMConfig],
                     noise_key=None) -> torch.Tensor:
    """A dense matmul unless a CIM config is given; packed weights always
    run on the macro (they are array contents)."""
    if isinstance(w, PackedCimWeights):
        return cim_linear_packed(x, w, noise_key, cim_cfg or DEFAULT_CONFIG,
                                 "fast")
    if cim_cfg is None:
        from ..models.layers import matmul
        return matmul(x, w)
    return cim_linear(x, w, noise_key, cim_cfg, "fast")
