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

``PackedComplexCimWeights`` is a co-located (Re, Im) pair of such packs
sharing one scale (``pack_complex_cim_weights``); the fused complex
kernels read both packs as stored.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .ccim import (CCIMConfig, DEFAULT_CONFIG, MacroInstance, _dcim_by_j,
                   _pad_to_chunks, fold_dcim_planes,
                   hybrid_mac_fast_gemm_prepacked, quantize_smf, smf_scale,
                   split_sign_mag)
from ..kernels.ccim_matmul import ops as kops
from ..kernels.ccim_matmul.kernel import chunked_operands
from ..resilience import faults


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

    def dequantized(self) -> torch.Tensor:
        """float32 (..., K, N) dequantized weights, sign * mag * scale
        (the STE backward's weights through the pack)."""
        return self.wq().to(torch.float32) * self.scale

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
        w, planes = self.gemm_views()
        f32 = lambda v: v.to(torch.float32)
        return f32(w), (torch.cat([f32(p) for p in planes], dim=1) if planes
                        else w.new_zeros((w.shape[0], 0, self.n_dim),
                                         dtype=torch.float32))

    def gemm_views(self) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """The fast GEMM's chunked operands as int8 views of the pack, no
        copy: w (C, L, N) and one (C, L, N) view per folded plane."""
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


@dataclasses.dataclass(frozen=True)
class PackedComplexCimWeights:
    """Co-located (Re, Im) weight pair packed once, with one shared
    full scale: two real packs in the kernels' layout.

    Mirrors the complex bit-cell: both components live in the same array
    and share the bitline full scale, so one pack serves all four real
    sub-MACs of (a + bi)(c + di)."""

    re: PackedCimWeights
    im: PackedCimWeights


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


def stack_layers(pack_layer: Callable[[int], PackedCimWeights],
                 n_layers: int) -> PackedCimWeights:
    """ONE stacked pack of ``n_layers`` layers, ``pack_layer(i)`` packing
    layer i: each layer's pack is written into tensors allocated once for
    the stack and dropped, so the working set is one layer's pack and
    transients beside the stacked pack (a list of per-layer packs and its
    stacked copy would hold the pack twice)."""
    fields = ("scale", "kernel_w", "kernel_planes")
    p = pack_layer(0)
    out = dataclasses.replace(p, **{
        f: getattr(p, f).new_empty((n_layers, *getattr(p, f).shape))
        for f in fields})
    for i in range(n_layers):
        if i:
            p = pack_layer(i)
        for f in fields:
            getattr(out, f)[i].copy_(getattr(p, f))
        del p
    return out


def pack_cim_layers(layer: Callable[[int], torch.Tensor], n_layers: int,
                    cfg: CCIMConfig = DEFAULT_CONFIG,
                    per_channel: bool = True) -> PackedCimWeights:
    """Pack a stack of ``n_layers`` (K, N) float weights, ``layer(i)``
    giving layer i (a view, or a fused group's one-layer concatenation),
    one layer at a time: bit for bit the per-layer packs, stacked."""
    return stack_layers(
        lambda i: pack_cim_weights(layer(i), cfg, per_channel), n_layers)


def pack_cim_weights(w: torch.Tensor, cfg: CCIMConfig = DEFAULT_CONFIG,
                     per_channel: bool = True) -> PackedCimWeights:
    """Quantize + decompose float weights once: (K, N), or (L, K, N) for a
    stack of layers, packed one layer at a time to bound the transient
    int32/float32 working set (``pack_cim_layers``).  Same scale and
    rounding as the reference ``pack_cim_weights``."""
    if w.dim() == 3:
        return pack_cim_layers(lambda i: w[i], w.shape[0], cfg, per_channel)
    w = w.to(torch.float32)
    sw = (smf_scale(w, dim=0, keepdim=True, cfg=cfg) if per_channel
          else smf_scale(w, cfg=cfg))
    return pack_quantized_cim_weights(quantize_smf(w, sw, cfg), sw, cfg)


def pack_complex_cim_weights(w_re: torch.Tensor, w_im: torch.Tensor,
                             cfg: CCIMConfig = DEFAULT_CONFIG
                             ) -> PackedComplexCimWeights:
    """Pack a co-located complex (K, N) weight pair with one shared full
    scale per column, max(|w_re|, |w_im|) (Re and Im share the array's
    bitlines in silicon).  Same scale and rounding as the reference."""
    w_re, w_im = w_re.to(torch.float32), w_im.to(torch.float32)
    sw = smf_scale(torch.maximum(w_re.abs(), w_im.abs()), dim=0,
                   keepdim=True, cfg=cfg)
    return PackedComplexCimWeights(
        re=pack_quantized_cim_weights(quantize_smf(w_re, sw, cfg), sw, cfg),
        im=pack_quantized_cim_weights(quantize_smf(w_im, sw, cfg), sw, cfg))


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
    macro: Optional[MacroInstance] = None,
    noise_segments: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Integer GEMM against prepacked weights -> (M, N) int32 at product
    scale; bit-identical to the reference at every fidelity.

    'fast' runs the prepacked kernels: ``use_kernel`` None launches the
    CUDA kernels on CUDA tensors and runs their plain version on CPU
    tensors; False forces the plain version.  With a ``noise_key`` (one
    per segment of N with ``noise_segments``), or at a design point
    outside the kernels' envelope (``_prepacked_kernel_supported``),
    'fast' runs ``ccim.hybrid_mac_fast_gemm_prepacked`` on int8 views of
    the pack instead, as the reference routes such GEMMs off its
    kernels; so does an armed fault model (``resilience/faults.py``),
    whose drifted conversion epilogue the kernels do not model.
    The other fidelities rebuild the raw ints (one O(K*N) copy, dwarfed
    by their own work) and take ``ccim.cim_matmul_int``."""
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
    if fidelity != "fast":
        from .ccim import cim_matmul_int
        return cim_matmul_int(x_q, packed.wq(), cfg, noise_key, fidelity,
                              use_kernel=use_kernel, macro=macro,
                              noise_segments=noise_segments)
    x_bits = tuple(_dcim_by_j(cfg))
    if (noise_key is not None or not _prepacked_kernel_supported(cfg)
            or faults.active()):
        # off the kernels, as the reference: the chunked fast GEMM on
        # int8 views of the pack (a design point outside the kernels'
        # envelope takes it noise-free)
        L = cfg.acc_len
        w, planes = packed.gemm_views()
        C = w.shape[0]
        xq = F.pad(x_q.to(torch.int32), (0, C * L - K)).reshape(M, C, L)
        return hybrid_mac_fast_gemm_prepacked(
            xq, w, planes[:len(x_bits)], noise_key, cfg,
            noise_segments) * cfg.dcim_lsb
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
    macro: Optional[MacroInstance] = None,
    noise_segments: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """float (M, K) @ packed -> (M, N) float32: per-row activation
    quantization is the only conditioning left on the hot path."""
    sx = smf_scale(x, dim=-1, keepdim=True, cfg=cfg)
    xq = quantize_smf(x, sx, cfg)
    y_int = packed_cim_matmul_int(xq, packed, cfg, noise_key, fidelity,
                                  use_kernel=use_kernel, macro=macro,
                                  noise_segments=noise_segments)
    return y_int.to(torch.float32) * sx * packed.scale.reshape(1, -1)


# ---------------------------------------------------------------------------
# The engine handle (what model configs resolve to)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CimEngine:
    """Execution-policy handle: macro config + fidelity + kernel routing.

    ``use_kernel`` None: CUDA kernels for CUDA tensors, their plain
    version for CPU tensors; False: the plain version everywhere.
    ``macro`` is the die ``matmul_int`` hands the 'bit_true' fidelity.
    ``matmul`` dispatches on the weight: raw floats (quantized per call,
    ``qat.cim_linear``), a pack or a fused packed group."""

    cfg: CCIMConfig = DEFAULT_CONFIG
    fidelity: str = "fast"
    use_kernel: Optional[bool] = None
    macro: Optional[MacroInstance] = None

    def pack(self, w: torch.Tensor, per_channel: bool = True
             ) -> PackedCimWeights:
        return pack_cim_weights(w, self.cfg, per_channel)

    def pack_complex(self, w_re: torch.Tensor, w_im: torch.Tensor
                     ) -> PackedComplexCimWeights:
        return pack_complex_cim_weights(w_re, w_im, self.cfg)

    def matmul(self, x: torch.Tensor, w, noise_key=None,
               noise_segments: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
        """(..., K) @ w -> (..., N); w raw, packed or a fused packed group
        (a group's noise key is then a tuple of per-segment keys, drawn
        per segment of its ``seg_dims``; for raw or packed w,
        ``noise_segments`` gives the segments' N sizes)."""
        from .qat import cim_linear, cim_linear_packed
        if isinstance(w, FusedPackedCimWeights):
            segs = w.seg_dims if noise_key is not None else None
            return cim_linear_packed(x, w.packed, noise_key, self.cfg,
                                     self.fidelity, self.use_kernel, segs)
        if isinstance(w, PackedCimWeights):
            return cim_linear_packed(x, w, noise_key, self.cfg, self.fidelity,
                                     self.use_kernel, noise_segments)
        return cim_linear(x, w, noise_key, self.cfg, self.fidelity,
                          self.use_kernel, noise_segments)

    def matmul_int(self, x_q: torch.Tensor, w, noise_key=None
                   ) -> torch.Tensor:
        """(M, K) ints @ w (raw (K, N) ints or a pack) -> (M, N) int32 at
        product scale, under the engine's config, fidelity and die."""
        if isinstance(w, PackedCimWeights):
            return packed_cim_matmul_int(x_q, w, self.cfg, noise_key,
                                         self.fidelity,
                                         use_kernel=self.use_kernel,
                                         macro=self.macro)
        from .ccim import cim_matmul_int
        return cim_matmul_int(x_q, w, self.cfg, noise_key, self.fidelity,
                              use_kernel=self.use_kernel, macro=self.macro)
