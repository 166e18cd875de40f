"""Noise-free numerics of the hybrid digital/analog C-CIM macro, in torch.

Counterpart of ``repro/core/ccim.py``, noise-free subset:

  * 8-bit signed-magnitude (SMF) operands:  v = (-1)^s * m,  m in [0,127].
  * Per ``acc_len``-element accumulate (one ADC conversion):
      - DCIM: the top-k bit-products computed exactly (folded weight
        planes, one per distinct activation bit j);
      - ACIM: the remaining bit-products, ideal analog sum;
      - ADC:  code = clip(floor(acim / lsb + 1/2), -half, half - 1);
      - y8 = DCIM + code, accumulated digitally at weight ``dcim_lsb``.

Analog noise, mismatch draws and the bit-true fidelities are later
slices: every function here refuses a noise key.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CCIMConfig:
    """Static configuration of the macro (defaults = the 28nm prototype).

    Field for field the reference config, so configs convert both ways
    with ``dataclasses.asdict``; the analog-noise fields are carried but
    not read until noisy serving is ported."""

    n_mag_bits: int = 7
    acc_len: int = 16
    n_dcim_products: int = 3
    adc_bits: int = 7
    sigma_unit: float = 0.0296
    adc_lsb_units: int = 16
    mismatch_granularity: str = "per_unit"
    adc_mismatch_model: str = "conservative"
    comparator_noise_lsb: float = 0.45
    sigma_vref_pol: float = 0.002
    use_split_dac: bool = True

    @property
    def max_mag(self) -> int:
        return (1 << self.n_mag_bits) - 1

    @property
    def dcim_products(self) -> Tuple[Tuple[int, int], ...]:
        """The top-k (j, k) bit-product cells ordered by significance."""
        cells = [(j, k) for j in range(self.n_mag_bits)
                 for k in range(self.n_mag_bits)]
        cells.sort(key=lambda jk: (-(jk[0] + jk[1]), -jk[0]))
        return tuple(cells[: self.n_dcim_products])

    @property
    def dcim_lsb(self) -> int:
        """Significance of the least weighted DCIM product; 2^11 when the
        split is all-analog.  Always a power of two."""
        if not self.dcim_products:
            return 1 << (2 * self.n_mag_bits - 3)
        return 1 << min(j + k for j, k in self.dcim_products)

    @property
    def adc_half_range(self) -> int:
        return 1 << (self.adc_bits - 1)

    @property
    def dcim_max(self) -> int:
        """Max |DCIM| for a full accumulate."""
        per_elem = sum((1 << (j + k)) // self.dcim_lsb
                       for j, k in self.dcim_products)
        return self.acc_len * per_elem


DEFAULT_CONFIG = CCIMConfig()


def _no_noise(noise_key) -> None:
    if noise_key is not None:
        raise NotImplementedError(
            "analog-noise emulation is not ported yet; the torch macro "
            "path is noise-free (pass noise_key=None)")


# ---------------------------------------------------------------------------
# SMF quantization
# ---------------------------------------------------------------------------


def quantize_smf(x: torch.Tensor, scale: torch.Tensor,
                 cfg: CCIMConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """float -> integer in [-127, 127]; ``torch.round`` rounds half to
    even, as the reference does."""
    q = torch.round(x / scale)
    return torch.clamp(q, -cfg.max_mag, cfg.max_mag).to(torch.int32)


def smf_scale(x: torch.Tensor, dim=None, keepdim: bool = False,
              cfg: CCIMConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Symmetric max-abs scale so that max |q| = 127.

    Written as a multiply by the float32 reciprocal, exactly as the
    reference writes it: the last bit of the scale (and so an occasional
    rounded magnitude) depends on the form."""
    a = x.abs()
    amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=keepdim)
    # a Python float multiplies a float32 tensor in float32; the value is
    # a float32 number, so the cast is exact (and no device copy is made)
    inv = float(np.float32(1.0) / np.float32(cfg.max_mag))
    return torch.clamp_min(amax, 1e-12) * inv


def split_sign_mag(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMF decomposition: sign in {-1,+1} (sign(0) = +1), magnitude."""
    one = torch.ones((), dtype=torch.int32, device=q.device)
    return torch.where(q < 0, -one, one), q.abs().to(torch.int32)


# ---------------------------------------------------------------------------
# Folded DCIM planes and the chunked fast GEMM
# ---------------------------------------------------------------------------


def _dcim_by_j(cfg: CCIMConfig) -> dict:
    """dcim_products grouped by the x bit-plane index j (insertion order)."""
    by_j: dict = {}
    for j, k in cfg.dcim_products:
        by_j.setdefault(j, []).append(k)
    return by_j


def fold_dcim_planes(wq: torch.Tensor,
                     cfg: CCIMConfig = DEFAULT_CONFIG) -> List[torch.Tensor]:
    """Folded signed DCIM planes of integer weights, one per distinct j:
    Plane_j = sign(w) * sum_{k in ks(j)} (2^(j+k)/dcim_lsb) * bit_k(|w|).
    Values fit int8 (at most 7 for splits up to top-6)."""
    sw, mw = split_sign_mag(wq)
    planes = []
    for j, ks in _dcim_by_j(cfg).items():
        wsum = torch.zeros_like(mw)
        for k in ks:
            wsum = wsum + ((mw >> k) & 1) * ((1 << (j + k)) // cfg.dcim_lsb)
        planes.append(sw * wsum)
    return planes


def fast_gemm_weight_ops(wq: torch.Tensor, cfg: CCIMConfig = DEFAULT_CONFIG
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, L, N) integer weights -> (wf, w_planes): the float32 weight copy
    and the folded planes concatenated along L, (C, J*L, N) float32."""
    wf = wq.to(torch.float32)
    planes = [p.to(torch.float32) for p in fold_dcim_planes(wq, cfg)]
    C, _, N = wq.shape
    w_pl = (torch.cat(planes, dim=1) if planes
            else torch.zeros((C, 0, N), dtype=torch.float32,
                             device=wq.device))
    return wf, w_pl


# elements of one (chunk block, M, N) float32 partial: bounds the plain
# path's working set at full width (int32 sums make any block size give
# the same result)
_PARTIAL_ELEMS = 1 << 25


def fast_gemm_int(xq: torch.Tensor, wf: torch.Tensor, w_pl: torch.Tensor,
                  x_bits: Sequence[int], dcim_lsb: int, adc_half: int,
                  chunk_block: Optional[int] = None) -> torch.Tensor:
    """sum_c y8_c as (M, N) int32 (unscaled), for the split described by
    ``x_bits`` (one activation bit per folded plane), ``dcim_lsb`` and
    ``adc_half``.  xq (M, C, L) ints; wf (C, L, N) and w_pl (C, J*L, N)
    float32.

    Float32 batched dots are exact here: every partial is an integer
    below 2^24 (|chunk dot| <= 64 * 127^2).  TF32 would break that, so it
    is switched off for both matmul back ends before the dots run.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M, C, L = xq.shape
    N = wf.shape[-1]
    sx, mx = split_sign_mag(xq)
    xf = xq.transpose(0, 1).to(torch.float32)                 # (C, M, L)
    sxf, mxT = sx.transpose(0, 1).to(torch.float32), mx.transpose(0, 1)
    x_pl = [sxf * ((mxT >> j) & 1).to(torch.float32) for j in x_bits]
    lsb, half = float(dcim_lsb), adc_half
    cb = chunk_block or max(1, min(C, _PARTIAL_ELEMS // max(M * N, 1)))
    acc = torch.zeros((M, N), dtype=torch.int32, device=xq.device)
    for c0 in range(0, C, cb):
        c1 = min(C, c0 + cb)
        a_real = torch.bmm(xf[c0:c1], wf[c0:c1])               # (cb, M, N)
        if x_pl:
            xcat = torch.cat([p[c0:c1] for p in x_pl], dim=-1)
            dcim = torch.bmm(xcat, w_pl[c0:c1])
        else:
            dcim = torch.zeros_like(a_real)
        a_real = a_real - dcim * lsb                            # ideal ACIM
        code = torch.clamp(torch.floor(a_real / lsb + 0.5), -half, half - 1)
        acc += (dcim + code).to(torch.int32).sum(dim=0, dtype=torch.int32)
    return acc


def hybrid_mac_fast_gemm_prepacked(
    xq: torch.Tensor,                 # (M, C, L) ints in [-127, 127]
    wf: torch.Tensor,                 # (C, L, N) float32 weight copy
    w_pl: torch.Tensor,               # (C, J*L, N) concatenated planes
    noise_key=None,
    cfg: CCIMConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Fast-path GEMM on prepacked weight operands; (M, N) int32 sum of
    the per-conversion y8 (unscaled).  Noise-free only."""
    _no_noise(noise_key)
    return fast_gemm_int(xq, wf, w_pl, tuple(_dcim_by_j(cfg)), cfg.dcim_lsb,
                         cfg.adc_half_range)


def hybrid_mac_fast_gemm(xq: torch.Tensor, wq: torch.Tensor, noise_key=None,
                         cfg: CCIMConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Chunked fast-path GEMM on raw (C, L, N) integer weights."""
    wf, w_pl = fast_gemm_weight_ops(wq, cfg)
    return hybrid_mac_fast_gemm_prepacked(xq, wf, w_pl, noise_key, cfg)


# ---------------------------------------------------------------------------
# Macro-tiled integer matmul
# ---------------------------------------------------------------------------


def _pad_to_chunks(k: int, acc_len: int) -> int:
    return (k + acc_len - 1) // acc_len


def _kernel_numerics_match(cfg: CCIMConfig) -> bool:
    """True when ``cfg`` matches the constants the unpacked and the fused
    complex kernels hardcode (prototype accumulate length, SMF width,
    top-3 DCIM split, 7-bit ADC)."""
    d = DEFAULT_CONFIG
    return (cfg.acc_len == d.acc_len and cfg.n_mag_bits == d.n_mag_bits
            and cfg.dcim_products == d.dcim_products
            and cfg.adc_bits == d.adc_bits)


def cim_matmul_int(x_q: torch.Tensor, w_q,
                   cfg: CCIMConfig = DEFAULT_CONFIG, noise_key=None,
                   fidelity: str = "fast", *,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Integer GEMM through the macro: (M, K) @ (K, N) -> (M, N) int32 at
    product scale (already times ``dcim_lsb``).  'fast' fidelity only.

    ``w_q`` may be raw integer weights or an ``engine.PackedCimWeights``.
    Raw weights at the prototype's numerics run the unpacked GEMM
    (``kernels/ccim_matmul/ops.py::ccim_matmul_int``: its CUDA kernel on
    a CUDA device, its plain version on the CPU), which decomposes the
    weights itself.  At any other design point raw weights are packed for
    the call and served by the prepacked kernels, which take every design
    point -- bit-identical, since packing is a caching transform."""
    from .engine import (PackedCimWeights, pack_quantized_cim_weights,
                         packed_cim_matmul_int)
    if not isinstance(w_q, PackedCimWeights):
        _no_noise(noise_key)
        if fidelity == "fast" and _kernel_numerics_match(cfg):
            from ..kernels.ccim_matmul import ops as kops
            return kops.ccim_matmul_int(x_q, w_q, use_kernel=use_kernel)
        one = torch.ones((1, w_q.shape[-1]), dtype=torch.float32,
                         device=w_q.device)
        w_q = pack_quantized_cim_weights(w_q, one, cfg)
    return packed_cim_matmul_int(x_q, w_q, cfg, noise_key, fidelity,
                                 use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# Float-in/float-out CIM matmul (quantize -> macro GEMM -> dequantize)
# ---------------------------------------------------------------------------


def cim_matmul(x: torch.Tensor, w, cfg: CCIMConfig = DEFAULT_CONFIG,
               noise_key=None, fidelity: str = "fast",
               per_channel: bool = True,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """float (M, K) @ (K, N) through the emulated macro, dequantized to
    float32.  ``w`` may be an ``engine.PackedCimWeights``; activation
    quantization then runs per call while the weight conditioning is
    served prepacked."""
    from .engine import PackedCimWeights, packed_cim_matmul
    if isinstance(w, PackedCimWeights):
        return packed_cim_matmul(x, w, cfg, noise_key, fidelity,
                                 use_kernel=use_kernel)
    sx = smf_scale(x, dim=-1, keepdim=True, cfg=cfg)            # per row
    sw = (smf_scale(w, dim=0, keepdim=True, cfg=cfg) if per_channel
          else smf_scale(w, cfg=cfg))
    y = cim_matmul_int(quantize_smf(x, sx, cfg), quantize_smf(w, sw, cfg),
                       cfg, noise_key, fidelity, use_kernel=use_kernel)
    return y.to(torch.float32) * sx * sw.reshape(1, -1)
