"""CIM linear layers with straight-through-estimator (STE) gradients,
on raw float weights (quantized per call) and on packed weights.

Counterpart of ``repro/core/qat.py``: ``cim_linear``,
``cim_linear_packed`` and ``maybe_cim_linear``.  The forward runs the
emulated macro (kernel row 6 on the card at the prototype's numerics);
where autograd records, the backward is the STE's: ``gx = g @ w.T`` in
x's dtype and ``gw = x.T @ g`` in w's dtype, and through a pack ``gx``
from the dequantized weights while the pack itself gets no gradient
(its bit-cell contents are integers).  With a telemetry tap collector
open the forward runs without the autograd wrapper, as the reference's
does (its taps cannot leave a custom_vjp's primal).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..obs import taps
from .ccim import CCIMConfig, DEFAULT_CONFIG, cim_matmul
from .engine import PackedCimWeights, packed_cim_matmul


def _ste_matmul(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b of the STE's backward in ``dtype``: on the CPU a float32 GEMM
    rounded once (the reference's bf16 einsum), on CUDA in the operands'
    dtype with float32 accumulation (cuBLAS)."""
    if a.is_cuda:
        return (a.to(b.dtype) @ b).to(dtype)
    return (a.to(torch.float32) @ b.to(torch.float32)).to(dtype)


def _grad_enabled(*ts) -> bool:
    return (torch.is_grad_enabled() and not taps.active()
            and any(t.requires_grad for t in ts))


def _cim_linear_impl(x, w, noise_key, cfg, fidelity, use_kernel,
                     noise_segments=None):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = cim_matmul(x2.to(torch.float32), w.to(torch.float32), cfg,
                   noise_key=noise_key, fidelity=fidelity,
                   use_kernel=use_kernel, noise_segments=noise_segments)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)


class _CimLinearSTE(torch.autograd.Function):
    """The macro forward, the STE backward (reference ``_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, noise_key, cfg, fidelity, use_kernel,
                noise_segments):
        ctx.save_for_backward(x, w)
        return _cim_linear_impl(x, w, noise_key, cfg, fidelity, use_kernel,
                                noise_segments)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _ste_matmul(g, w.T, x.dtype)
        if ctx.needs_input_grad[1]:
            gw = _ste_matmul(x.reshape(-1, x.shape[-1]).T,
                             g.reshape(-1, g.shape[-1]), w.dtype)
        return gx, gw, None, None, None, None, None


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
    segment with ``noise_segments``) adds the analog noise.  STE
    gradients where autograd records (not under a tap collector)."""
    if _grad_enabled(x, w):
        return _CimLinearSTE.apply(x, w, noise_key, cfg, fidelity,
                                   use_kernel, noise_segments)
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


class _CimLinearPackedSTE(torch.autograd.Function):
    """The packed macro forward, the STE backward through the dequantized
    weights (reference ``_fwd_packed``/``_bwd_packed``); the pack gets no
    gradient (``_zero_cotangent``: it is not a differentiable input)."""

    @staticmethod
    def forward(ctx, x, packed, noise_key, cfg, fidelity, use_kernel,
                noise_segments):
        ctx.save_for_backward(x)
        ctx.packed = packed
        return _cim_linear_packed_impl(x, packed, noise_key, cfg, fidelity,
                                       use_kernel, noise_segments)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        gx = _ste_matmul(g, ctx.packed.dequantized().T, x.dtype)
        return gx, None, None, None, None, None, None


def cim_linear_packed(x: torch.Tensor, packed: PackedCimWeights,
                      noise_key=None, cfg: CCIMConfig = DEFAULT_CONFIG,
                      fidelity: str = "fast",
                      use_kernel: Optional[bool] = None,
                      noise_segments: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """(..., K) @ packed -> (..., N) through the macro, in x's dtype;
    ``noise_key`` (per segment with ``noise_segments``) adds the analog
    noise, drawn over the flattened rows as the reference draws it.  STE
    gradients for x where autograd records (not under a tap collector)."""
    if _grad_enabled(x):
        return _CimLinearPackedSTE.apply(x, packed, noise_key, cfg, fidelity,
                                         use_kernel, noise_segments)
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
