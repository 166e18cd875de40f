"""Prepacked-weight CIM execution engine: quantize/decompose once, serve many.

Counterpart of ``repro/core/engine.py``.  ``pack_cim_weights`` runs the
weight conditioning once (per-channel SMF scale -> integer quantization
-> folded MSB DCIM planes -> the kernels' layout) and
``packed_cim_matmul`` serves every later call with activation-only work.

Storage carried by ``PackedCimWeights`` -- only what the kernels read:

  scale           (1, N) float32 per-channel SMF scale
  kernel_w        (N, Kp) int8 quantized weights, K contiguous per output
                  column (the layout rule is kernels.ccim_matmul.ops.
                  weight_layout)
  kernel_planes   (n_j, N, Kp) int8 folded signed DCIM planes

The reference pack also holds sign/magnitude arrays and float32 chunked
copies (``gemm_w``/``gemm_planes``).  Here they are derived from
``kernel_w`` on demand: at full model width the float32 copies alone
would be 12 bytes per weight.  A leading layer axis is allowed (stacked
layer weights); ``layer(i)`` selects one layer's pack.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .ccim import (CCIMConfig, DEFAULT_CONFIG, _dcim_by_j, _no_noise,
                   _pad_to_chunks, fold_dcim_planes, quantize_smf, smf_scale,
                   split_sign_mag)
from ..kernels.ccim_matmul import ops as kops
from ..kernels.ccim_matmul.kernel import chunked_operands


@dataclasses.dataclass(frozen=True)
class PackedCimWeights:
    """One weight matrix (or a stack of them), conditioned once."""

    scale: torch.Tensor               # (..., 1, N) float32
    kernel_w: torch.Tensor            # (..., N, Kp) int8
    kernel_planes: torch.Tensor       # (..., n_j, N, Kp) int8
    k_dim: int                        # logical K
    n_dim: int                        # logical N
    cfg: CCIMConfig                   # the macro config packed FOR

    def layer(self, i: int) -> "PackedCimWeights":
        """Layer ``i`` of a stacked pack (views, no copy)."""
        return dataclasses.replace(self, scale=self.scale[i],
                                   kernel_w=self.kernel_w[i],
                                   kernel_planes=self.kernel_planes[i])

    def wq(self) -> torch.Tensor:
        """The raw integer SMF weights, (..., K, N) int32."""
        return self.kernel_w[..., :self.k_dim].transpose(-1, -2).to(
            torch.int32)

    @property
    def sign(self) -> torch.Tensor:
        """(..., K, N) int8 in {-1, +1} (the bit-cell sign contents)."""
        return split_sign_mag(self.wq())[0].to(torch.int8)

    @property
    def mag(self) -> torch.Tensor:
        """(..., K, N) int8 in [0, 127]."""
        return split_sign_mag(self.wq())[1].to(torch.int8)

    def gemm_operands(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The float32 chunked operands of the fast GEMM, (C, L, N) and
        (C, J*L, N) with C = ceil(K / acc_len): what the reference pack
        stores as ``gemm_w``/``gemm_planes``, derived here per call."""
        return chunked_operands(self.kernel_w, self.kernel_planes,
                                self.cfg.acc_len,
                                _pad_to_chunks(self.k_dim, self.cfg.acc_len))


@dataclasses.dataclass(frozen=True)
class FusedPackedCimWeights:
    """A horizontally fused projection group packed as ONE wide array.

    Projections that consume the same input activation (QKV, gate/up)
    concatenate along N and pack once; ``seg_names``/``seg_dims`` split
    the wide output back into per-projection results, bit-identical to
    unfused calls (scales, quantization and the GEMM are column-local)."""

    packed: PackedCimWeights
    seg_names: Tuple[str, ...]
    seg_dims: Tuple[int, ...]

    def layer(self, i: int) -> "FusedPackedCimWeights":
        return dataclasses.replace(self, packed=self.packed.layer(i))


# ---------------------------------------------------------------------------
# Packing (the write-the-array step; run once per weight matrix)
# ---------------------------------------------------------------------------


def pack_quantized_cim_weights(wq: torch.Tensor, scale: torch.Tensor,
                               cfg: CCIMConfig = DEFAULT_CONFIG
                               ) -> PackedCimWeights:
    """Pack already-quantized (K, N) integer weights into the kernels'
    layout: transposed to K-contiguous rows, K padded per weight_layout."""
    K, N = wq.shape
    Kp, _ = kops.weight_layout(K, N, cfg.acc_len)
    lay = lambda v: F.pad(v.t().to(torch.int8), (0, Kp - K)).contiguous()
    planes = fold_dcim_planes(wq, cfg)
    kernel_planes = (torch.stack([lay(p) for p in planes]) if planes
                     else torch.zeros((0, N, Kp), dtype=torch.int8,
                                      device=wq.device))
    return PackedCimWeights(scale=scale, kernel_w=lay(wq),
                            kernel_planes=kernel_planes, k_dim=K, n_dim=N,
                            cfg=cfg)


def _stack(packs: List[PackedCimWeights]) -> PackedCimWeights:
    p0 = packs[0]
    return dataclasses.replace(
        p0, scale=torch.stack([p.scale for p in packs]),
        kernel_w=torch.stack([p.kernel_w for p in packs]),
        kernel_planes=torch.stack([p.kernel_planes for p in packs]))


def pack_cim_weights(w: torch.Tensor, cfg: CCIMConfig = DEFAULT_CONFIG,
                     per_channel: bool = True) -> PackedCimWeights:
    """Quantize + decompose float weights once: (K, N), or (L, K, N) for a
    stack of layers, packed one layer at a time to bound the transient
    int32/float32 working set.  Same scale and rounding as the reference
    ``pack_cim_weights``."""
    if w.dim() == 3:
        return _stack([pack_cim_weights(w[i], cfg, per_channel)
                       for i in range(w.shape[0])])
    w = w.to(torch.float32)
    sw = (smf_scale(w, dim=0, keepdim=True, cfg=cfg) if per_channel
          else smf_scale(w, cfg=cfg))
    return pack_quantized_cim_weights(quantize_smf(w, sw, cfg), sw, cfg)


# ---------------------------------------------------------------------------
# Packed execution (the serve-many step)
# ---------------------------------------------------------------------------


def _prepacked_kernel_supported(cfg: CCIMConfig) -> bool:
    """Configs the prepacked kernels serve: 7 magnitude bits (int8
    storage), folded planes for splits up to top-6, and an accumulate
    length the kernels tile (8..64)."""
    d = DEFAULT_CONFIG
    return (cfg.n_mag_bits == d.n_mag_bits
            and cfg.n_dcim_products <= 6
            and cfg.acc_len in (8, 16, 32, 64))


def pack_compatible(packed_cfg: CCIMConfig, cfg: CCIMConfig) -> bool:
    """True when weights packed under ``packed_cfg`` can be served under
    ``cfg`` without repacking: equal configs, or an all-analog subset
    (no DCIM products, same n_mag_bits and acc_len; any ADC width) that
    never reads the folded planes."""
    if packed_cfg == cfg:
        return True
    return (cfg.n_dcim_products == 0
            and dataclasses.replace(
                cfg, n_dcim_products=packed_cfg.n_dcim_products,
                adc_bits=packed_cfg.adc_bits) == packed_cfg)


def packed_cim_matmul_int(
    x_q: torch.Tensor,                # (M, K) ints in [-127, 127]
    packed: PackedCimWeights,
    cfg: CCIMConfig = DEFAULT_CONFIG,
    noise_key=None,
    fidelity: str = "fast",
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Integer GEMM against prepacked weights -> (M, N) int32 at product
    scale; bit-identical to the reference's noise-free 'fast' path.

    ``use_kernel`` None launches the CUDA kernels on CUDA tensors and
    runs their plain version on CPU tensors; False forces the plain
    version."""
    _no_noise(noise_key)
    if fidelity != "fast":
        raise NotImplementedError(
            f"fidelity {fidelity!r} is not ported yet; packed serving runs "
            "the 'fast' fidelity")
    if packed.kernel_w.dim() != 2:
        raise ValueError("stacked pack: select a layer with .layer(i)")
    M, K = x_q.shape
    if K != packed.k_dim:
        raise ValueError(f"activation K {K} != packed K {packed.k_dim}")
    if not pack_compatible(packed.cfg, cfg):
        raise ValueError(
            "PackedCimWeights were packed for a different CCIMConfig than "
            f"they are being served with: packed for {packed.cfg}, serving "
            f"{cfg}. Re-pack for the serving config, or serve an all-analog "
            "subset (n_dcim_products=0, same n_mag_bits and acc_len).")
    if not _prepacked_kernel_supported(cfg):
        raise NotImplementedError(
            f"the prepacked kernels do not serve {cfg} (need n_mag_bits=7, "
            "n_dcim_products <= 6, acc_len in 8/16/32/64)")
    x_bits = tuple(_dcim_by_j(cfg))
    # analog-subset serving of a hybrid pack reads no planes
    planes = packed.kernel_planes[:len(x_bits)]
    return kops.ccim_matmul_int_prepacked(
        x_q, packed.kernel_w, planes, k_dim=packed.k_dim,
        n_dim=packed.n_dim, acc_len=cfg.acc_len, x_bits=x_bits,
        dcim_lsb=cfg.dcim_lsb, adc_bits=cfg.adc_bits, use_kernel=use_kernel)


def packed_cim_matmul(
    x: torch.Tensor,                  # (M, K) float activations
    packed: PackedCimWeights,
    cfg: CCIMConfig = DEFAULT_CONFIG,
    noise_key=None,
    fidelity: str = "fast",
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """float (M, K) @ packed -> (M, N) float32: per-row activation
    quantization is the only conditioning left on the hot path."""
    sx = smf_scale(x, dim=-1, keepdim=True, cfg=cfg)
    xq = quantize_smf(x, sx, cfg)
    y_int = packed_cim_matmul_int(xq, packed, cfg, noise_key, fidelity,
                                  use_kernel=use_kernel)
    return y_int.to(torch.float32) * sx * packed.scale.reshape(1, -1)


# ---------------------------------------------------------------------------
# The engine handle (what model configs resolve to)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CimEngine:
    """Execution-policy handle: macro config + fidelity + kernel routing.

    ``use_kernel`` None: CUDA kernels for CUDA tensors, their plain
    version for CPU tensors; False: the plain version everywhere."""

    cfg: CCIMConfig = DEFAULT_CONFIG
    fidelity: str = "fast"
    use_kernel: Optional[bool] = None

    def pack(self, w: torch.Tensor, per_channel: bool = True
             ) -> PackedCimWeights:
        return pack_cim_weights(w, self.cfg, per_channel)

    def matmul(self, x: torch.Tensor, w, noise_key=None) -> torch.Tensor:
        """(..., K) @ w -> (..., N); w packed or a fused packed group."""
        from .qat import cim_linear_packed
        if isinstance(w, FusedPackedCimWeights):
            w = w.packed
        if isinstance(w, PackedCimWeights):
            return cim_linear_packed(x, w, noise_key, self.cfg, self.fidelity,
                                     self.use_kernel)
        raise NotImplementedError(
            "unpacked (per-call) CIM execution is not ported yet; pack the "
            "weights (lm.pack_cim_params / CimEngine.pack)")
