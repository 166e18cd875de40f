"""Complex MAC on the hybrid macro: the paper's headline feature.

Counterpart of ``repro/core/complex_mac.py``.  The complex bit-cell
co-locates Re and Im of each weight in the same 6T array, so one weight
residency serves all four real sub-MACs of

    (a + bi)(c + di) = (ac - bd) + (ad + bc)i

and the Re and Im outputs come out of one array pass.  At the
prototype's numerics, noise-free 'fast', the fused kernels of
``kernels/ccim_complex`` do exactly that (on the CPU their plain
versions); every other design point and fidelity takes four real macro
GEMMs through ``ccim.cim_matmul_int`` ('bit_true' on one die: the
sequenced sub-MACs share its mismatch).  A noise key (``core.prng``)
also takes the four-GEMM route, each sub-MAC drawing under its own
quarter of ``split(noise_key, 4)`` in the order ac, bd, ad, bc, as the
reference draws them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ccim, prng
from .ccim import CCIMConfig, DEFAULT_CONFIG, MacroInstance
from .engine import PackedComplexCimWeights, pack_compatible


def quantize_complex(v: torch.Tensor, dim: int,
                     cfg: CCIMConfig = DEFAULT_CONFIG
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q_re, q_im, scale): Re and Im of complex ``v`` quantized to SMF
    ints with one shared scale along ``dim``, max(|re|, |im|) (keepdim)."""
    v = v.resolve_conj()
    re, im = v.real, v.imag
    s = ccim.smf_scale(torch.maximum(re.abs(), im.abs()), dim=dim,
                       keepdim=True, cfg=cfg)
    return ccim.quantize_smf(re, s, cfg), ccim.quantize_smf(im, s, cfg), s


def complex_cim_matmul_int(
    x_re: torch.Tensor, x_im: torch.Tensor,    # (M, K) ints in [-127, 127]
    w_re, w_im=None,                           # (K, N) ints, or a packed pair
    cfg: CCIMConfig = DEFAULT_CONFIG,
    noise_key=None,
    fidelity: str = "fast",
    *,
    use_kernel: Optional[bool] = None,
    macro: Optional[MacroInstance] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer complex GEMM -> (y_re, y_im) int32 at scale ``dcim_lsb``.

    Noise-free 'fast' GEMMs at the prototype's numerics go to the fused
    complex kernels: one weight residency serves the four real sub-MACs
    and emits Re and Im together, as in the silicon.  Other design points
    and fidelities, and noisy GEMMs, run four real macro GEMMs sharing
    the same weights (and, at 'bit_true', the die ``macro``); with
    ``noise_key`` sub-MAC i draws under ``split(noise_key, 4)[i]``.

    ``w_re`` may be a ``PackedComplexCimWeights`` (``w_im`` then omitted):
    the co-located pair is packed once and served from storage --
    bit-identical to passing the raw integer pair.  ``use_kernel`` None
    launches the CUDA kernels on CUDA tensors and runs their plain
    versions on CPU tensors; False forces the plain versions.
    """
    packed = w_re if isinstance(w_re, PackedComplexCimWeights) else None
    if (packed is None) == (w_im is None):
        raise ValueError("pass a raw (w_re, w_im) pair or one "
                         "PackedComplexCimWeights as w_re")
    if packed is not None and not pack_compatible(packed.re.cfg, cfg):
        raise ValueError(f"complex pack made for {packed.re.cfg}, served "
                         f"with {cfg}")
    if (fidelity == "fast" and noise_key is None
            and ccim._kernel_numerics_match(cfg)):
        from ..kernels.ccim_complex import ops as cops
        if packed is not None:
            re, im = packed.re, packed.im
            return cops.ccim_complex_matmul_int_prepacked(
                x_re, x_im, re.kernel_w, im.kernel_w, re.kernel_planes,
                im.kernel_planes, k_dim=re.k_dim, n_dim=re.n_dim,
                use_kernel=use_kernel)
        return cops.ccim_complex_matmul_int(x_re, x_im, w_re, w_im,
                                            use_kernel=use_kernel)
    if packed is not None:
        w_re, w_im = packed.re, packed.im      # cim_matmul_int takes packs

    keys = ((None,) * 4 if noise_key is None
            else prng.split(noise_key, 4).unbind(-2))

    def mm(a, b, key):
        return ccim.cim_matmul_int(a, b, cfg, key, fidelity,
                                   use_kernel=use_kernel, macro=macro)
    # four real sub-MACs sharing the same weight arrays (no duplication)
    ac, bd = mm(x_re, w_re, keys[0]), mm(x_im, w_im, keys[1])
    ad, bc = mm(x_re, w_im, keys[2]), mm(x_im, w_re, keys[3])
    return ac - bd, ad + bc


def complex_cim_matmul(
    x: torch.Tensor,                           # (M, K) complex
    w,                                         # (K, N) complex, or packed
    cfg: CCIMConfig = DEFAULT_CONFIG,
    noise_key=None,
    fidelity: str = "fast",
    use_kernel: Optional[bool] = None,
    macro: Optional[MacroInstance] = None,
) -> torch.Tensor:
    """Float complex (M, K) @ (K, N) through the macro, complex64.

    Re and Im of each operand share one scale (the array's full scale),
    per row of x and per column of w.  ``w`` may be a
    ``PackedComplexCimWeights`` from ``pack_complex_cim_weights`` --
    bit-identical, the weight conditioning amortized across calls.  The
    dequantization forms ``sx * sw`` first, then multiplies, as the
    reference does (in float32 the order shows in the last bit)."""
    xr, xi, sx = quantize_complex(x, -1, cfg)
    if isinstance(w, PackedComplexCimWeights):
        yr, yi = complex_cim_matmul_int(xr, xi, w, None, cfg, noise_key,
                                        fidelity, use_kernel=use_kernel,
                                        macro=macro)
        sw = w.re.scale
    else:
        wr, wi, sw = quantize_complex(w, 0, cfg)
        yr, yi = complex_cim_matmul_int(xr, xi, wr, wi, cfg, noise_key,
                                        fidelity, use_kernel=use_kernel,
                                        macro=macro)
    scale = sx * sw.reshape(1, -1)
    return torch.complex(yr * scale, yi * scale)


def complex_mac_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 software oracle (the paper's comparison target in Fig. S3)."""
    return x @ w
