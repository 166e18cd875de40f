"""Numerics of the hybrid digital/analog C-CIM macro, in torch.

Counterpart of ``repro/core/ccim.py``:

  * 8-bit signed-magnitude (SMF) operands:  v = (-1)^s * m,  m in [0,127].
  * Per ``acc_len``-element accumulate (one ADC conversion):
      - DCIM: the top-k bit-products computed exactly (folded weight
        planes, one per distinct activation bit j);
      - ACIM: the remaining bit-products, summed on the 2-D capacitor
        array -- ideal in the 'fast' fidelities, with a fabricated die's
        frozen cap mismatch in 'bit_true' (``MacroInstance``);
      - ADC:  code = clip(floor(acim / lsb + 1/2), -half, half - 1), or
        the SAR search against the die's mismatched CDAC weights;
      - y8 = DCIM + code, accumulated digitally at weight ``dcim_lsb``.

Fidelities of ``cim_matmul_int``: 'fast' (chunked GEMMs; the CUDA
kernels on the card), 'fast_broadcast' (the elementwise model),
'bit_true' (every bit-product with the die's mismatch) and 'exact' (the
integer dot).

Random draws are ``core.prng``'s, so each equals the reference's
``jax.random`` draw bit for bit: a die (``fabricate`` from a key), the
SAR's comparator noise (one key per ADC bit, in ``sar_adc`` and so in
the bit-true model) and the fast model's matched Gaussian
(``hybrid_mac_fast`` and the chunked fast GEMM, ``_fast_gemm_noise``);
'exact' ignores a noise key.  The noise-free CUDA kernels do not take
one: a noisy GEMM runs in torch at every fidelity, as the reference's
noisy GEMMs leave its Pallas kernels for XLA.  Where a model evaluates
a draw in blocks, each block draws its elements at their flat indices
in the whole draw (``prng.bits_at``), so any blocking gives the same
numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import prng
from ..obs import taps
from ..resilience import faults


@dataclasses.dataclass(frozen=True)
class CCIMConfig:
    """Static configuration of the macro (defaults = the 28nm prototype).

    Field for field the reference config, so configs convert both ways
    with ``dataclasses.asdict``."""

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
    def fast_noise_correction(self) -> float:
        """Variance correction of the fast path's matched noise under the
        split-DAC, whose LSB section floors a cell's effective unit count
        at 2^ceil(s/2): sum(2^2s / eff) / sum(2^s) over the ACIM cells."""
        if not self.use_split_dac:
            return 1.0
        num = den = 0.0
        for j in range(self.n_mag_bits):
            for k in range(self.n_mag_bits):
                if (j, k) in self.dcim_products:
                    continue
                s = j + k
                eff = min(2.0 ** s, 2.0 ** math.ceil(s / 2))
                num += (2.0 ** (2 * s)) / eff
                den += 2.0 ** s
        return num / den

    def noise_var_terms(self) -> Tuple[float, float]:
        """(coefficient, floor) of the fast path's noise variance
        ``coefficient * |acim| + floor``, each a float32 value: the cap
        mismatch per unit of ACIM magnitude, and the comparator noise."""
        coef = np.float32(self.sigma_unit ** 2 * self.fast_noise_correction)
        floor = np.float32((self.comparator_noise_lsb * self.dcim_lsb) ** 2)
        return float(coef), float(floor)

    def dcim_weight_table(self) -> np.ndarray:
        """(7, 7) integer table: 2^(j+k)/dcim_lsb on DCIM cells, 0 elsewhere."""
        t = np.zeros((self.n_mag_bits, self.n_mag_bits), np.int32)
        for j, k in self.dcim_products:
            t[j, k] = (1 << (j + k)) // self.dcim_lsb
        return t

    def acim_weight_table(self) -> np.ndarray:
        """(7, 7) integer table: 2^(j+k) on ACIM cells, 0 on DCIM cells."""
        t = np.array([[1 << (j + k) for k in range(self.n_mag_bits)]
                      for j in range(self.n_mag_bits)], np.int64)
        for j, k in self.dcim_products:
            t[j, k] = 0
        return t

    @property
    def dcim_max(self) -> int:
        """Max |DCIM| for a full accumulate."""
        per_elem = sum((1 << (j + k)) // self.dcim_lsb
                       for j, k in self.dcim_products)
        return self.acc_len * per_elem


DEFAULT_CONFIG = CCIMConfig()


# ---------------------------------------------------------------------------
# Fabrication: the static analog error pattern of one die
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MacroInstance:
    """Frozen mismatch draws for one fabricated macro (float32 tensors).

    eps_array : relative cap error of each 2-D array cell, (acc_len, 7, 7)
        for 'per_unit', (7, 7) for 'per_macro'.
    adc_cap_eps : relative error of each binary CDAC capacitor, (adc_bits,).
    vref_pol_eps : 0-d, the +/- reference path gain asymmetry.
    """

    eps_array: torch.Tensor
    adc_cap_eps: torch.Tensor
    vref_pol_eps: torch.Tensor

    def to(self, device) -> "MacroInstance":
        return MacroInstance(*(t.to(device) for t in (
            self.eps_array, self.adc_cap_eps, self.vref_pol_eps)))


def _eps_shape(cfg: CCIMConfig) -> Tuple[int, ...]:
    nb = cfg.n_mag_bits
    return ((cfg.acc_len, nb, nb) if cfg.mismatch_granularity == "per_unit"
            else (nb, nb))


def _die_sigmas(cfg: CCIMConfig, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(sig2d (7, 7), sig_bit (adc_bits,)): the relative sigma of each
    array cell and CDAC capacitor, float32, evaluated as the reference
    evaluates them (true divisions, correctly rounded square roots)."""
    nb = cfg.n_mag_bits
    jk = torch.arange(nb, dtype=torch.float32, device=device)
    cells = (2.0 ** jk)[:, None] * (2.0 ** jk)[None, :]
    if cfg.use_split_dac:
        # the LSB section sits behind an attenuation cap: the effective
        # unit count of low-significance cells stops growing
        cells = torch.minimum(cells, 2.0 ** torch.ceil(
            (jk[:, None] + jk[None, :]) / 2.0))
    sigma = torch.full((), cfg.sigma_unit, dtype=torch.float32,
                       device=device)
    bits = 2.0 ** torch.arange(cfg.adc_bits, dtype=torch.float32,
                               device=device)
    if cfg.adc_mismatch_model != "conservative":
        bits = cfg.adc_lsb_units * bits
    return sigma / prng.sqrt(cells), sigma / prng.sqrt(bits)


def fabricate(source, cfg: CCIMConfig = DEFAULT_CONFIG,
              device=None) -> MacroInstance:
    """Monte-Carlo 'tape-out': draw the static mismatch of one macro
    (standard normals times the reference's sigmas), then move it to
    ``device`` (default: stay where it was drawn).

    ``source`` is a ``core.prng`` key or a ``torch.Generator``.  A key
    draws the reference's die bit for bit: it is split in three, for
    ``eps_array``, ``adc_cap_eps`` and ``vref_pol_eps`` (on the key's
    device).  A generator draws torch's own normals, on its device."""
    dev = source.device
    shapes = (_eps_shape(cfg), (cfg.adc_bits,), ())
    if isinstance(source, torch.Generator):
        eps, adc, vref = (torch.randn(s, generator=source, device=dev)
                          for s in shapes)
    else:
        eps, adc, vref = (prng.normal(k, s) for k, s in zip(
            prng.split(source, 3).unbind(-2), shapes))
    sig2d, sig_bit = _die_sigmas(cfg, dev)
    sig_vref = torch.full((), cfg.sigma_vref_pol, dtype=torch.float32,
                          device=dev)
    macro = MacroInstance(eps * sig2d, adc * sig_bit, vref * sig_vref)
    return macro if device is None else macro.to(device)


def ideal_macro(cfg: CCIMConfig = DEFAULT_CONFIG, device="cpu"
                ) -> MacroInstance:
    """A die without mismatch: bit-true then equals ADC rounding alone."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return MacroInstance(z(*_eps_shape(cfg)), z(cfg.adc_bits), z())


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


def bit_planes(mag: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(...,) int magnitudes -> (..., n_bits) {0, 1} int32 planes, LSB
    first."""
    shifts = torch.arange(n_bits, dtype=torch.int32, device=mag.device)
    return (mag[..., None].to(torch.int32) >> shifts) & 1


def _signed_bits(q: torch.Tensor, cfg: CCIMConfig) -> torch.Tensor:
    """(..., L) ints -> (..., L, n_bits) sign-carrying bit planes in
    {-1, 0, 1}, int8."""
    s, m = split_sign_mag(q)
    return (s[..., None] * bit_planes(m, cfg.n_mag_bits)).to(torch.int8)


# ---------------------------------------------------------------------------
# 7-bit SAR ADC with CDAC mismatch (bipolar, samples mid-scale 0x40)
# ---------------------------------------------------------------------------


def _flat_index(shape, offset: int, device) -> torch.Tensor:
    """The flat indices of a block of ``shape`` that starts at element
    ``offset`` of a larger draw whose trailing axes it shares."""
    return offset + torch.arange(math.prod(shape), dtype=torch.int64,
                                 device=device).reshape(shape)


def sar_adc(v_lsb: torch.Tensor, adc_cap_eps: torch.Tensor,
            cfg: CCIMConfig = DEFAULT_CONFIG, noise_key=None, *,
            draw_offset: int = 0) -> torch.Tensor:
    """Convert ``v_lsb`` (float32, in ideal-LSB units, signed) to a code in
    [-half, half - 1], int32: successive approximation, MSB first, against
    the die's float32 trial weights 2^b (1 + eps_b), a bit kept where the
    sample is >= the trial level.  The code is the ideal-binary reading of
    the decided bits, which is how CDAC mismatch becomes DNL/INL.

    With ``noise_key`` the comparator sees the sample plus
    ``comparator_noise_lsb`` standard normals: ``split(noise_key,
    adc_bits)``, key b drawing over ``v_lsb``'s shape for bit b, as the
    reference draws them.  The sum is formed as the reference's compiled
    code forms it (``prng.scaled_normal_fma``: one fused multiply-add);
    op by op the reference rounds the product first, which can move a
    sample across a trial level only where it sits within an ulp of it.
    ``draw_offset`` places a block of a larger conversion batch: its
    draws are those of the flat indices from ``draw_offset`` on."""
    half = cfg.adc_half_range
    x = torch.clamp(v_lsb, -half, half - 1) + half + 0.5   # two roundings
    real_w = (2.0 ** torch.arange(cfg.adc_bits, dtype=torch.float32,
                                  device=v_lsb.device)
              ) * (1.0 + adc_cap_eps.to(v_lsb.device))
    keys = None
    if noise_key is not None and cfg.comparator_noise_lsb > 0:
        keys = prng.split(noise_key, cfg.adc_bits)
        idx = _flat_index(x.shape, draw_offset, x.device)
    acc = torch.zeros_like(x)
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for b in range(cfg.adc_bits - 1, -1, -1):
        cmp_in = x
        if keys is not None:
            cmp_in = prng.scaled_normal_fma(prng.bits_at(keys[b], idx),
                                            cfg.comparator_noise_lsb, x)
        bit = cmp_in >= acc + real_w[b]
        acc = acc + bit.to(torch.float32) * real_w[b]
        code = code + bit.to(torch.int32) * (1 << b)
    return code - half


# ---------------------------------------------------------------------------
# Elementwise macro models: bit-true (the oracle), ideal, fast
# ---------------------------------------------------------------------------


def _isum(t: torch.Tensor) -> torch.Tensor:
    """int32 sum over the trailing axis (torch would widen it to int64;
    the reference's sums stay int32, and no conversion overflows it)."""
    return t.sum(-1, dtype=torch.int32)


def _dcim_terms(x_q: torch.Tensor, w_q: torch.Tensor, cfg: CCIMConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-element signed DCIM value, signed ideal ACIM value and signed
    product x * w (no bit planes); broadcasting x_q against w_q.  The
    DCIM value is sum_j (sign(x) bit_j(|x|)) * Plane_j(w), each factor
    built on its own operand, so only the products broadcast."""
    sx, mx = split_sign_mag(x_q)
    prod = x_q * w_q
    d_elem = torch.zeros_like(prod)
    for j, plane in zip(_dcim_by_j(cfg), fold_dcim_planes(w_q, cfg)):
        d_elem = d_elem + (sx * ((mx >> j) & 1)) * plane
    return d_elem, prod - d_elem * cfg.dcim_lsb, prod


def _a_real(xb: torch.Tensor, wb: torch.Tensor, real_w: torch.Tensor
            ) -> torch.Tensor:
    """sum over (L, 7, 7) of the signed bit-products times the die's cap
    weights, float32, summed one term at a time in (l, j, k) order: the
    order the reference's compiled CPU reduction takes.  A mismatched
    weight makes the sum's last bit order-dependent, and the SAR's
    mismatched thresholds can turn that bit into a code.  Every product
    is exact (the bit-products are -1, 0 or 1)."""
    L, nb = xb.shape[-2], xb.shape[-1]
    acc = None
    for l in range(L):
        t = (xb[..., l, :, None] * wb[..., l, None, :]).to(torch.float32)
        t = t * real_w[l]                                # (..., nb, nb)
        for j in range(nb):
            for k in range(nb):
                acc = t[..., j, k] if acc is None else acc + t[..., j, k]
    return acc


def hybrid_mac_bit_true(x_q: torch.Tensor, w_q: torch.Tensor,
                        macro: MacroInstance,
                        cfg: CCIMConfig = DEFAULT_CONFIG,
                        noise_key=None, *, draw_offset: int = 0) -> dict:
    """One macro conversion per trailing ``acc_len`` axis of ``x_q`` and
    ``w_q`` (ints in [-127, 127], leading axes broadcast), on the die
    ``macro``.  Returns dict(y8, dcim, adc_code, a_real, a_ideal, exact):
    ``exact`` the integer dot, ``y8`` the macro's 8-bit output (y8 * 2^11
    approximates ``exact``).  ``noise_key`` adds the SAR's comparator
    noise over the broadcast output shape (``sar_adc``, with
    ``draw_offset``)."""
    dev = x_q.device
    d_elem, a_elem, prod = _dcim_terms(x_q.to(torch.int32),
                                       w_q.to(torch.int32), cfg)
    dcim, a_ideal = _isum(d_elem), _isum(a_elem)
    acim_w = torch.from_numpy(cfg.acim_weight_table().astype(np.float32))
    eps = macro.eps_array.to(dev)
    real_w = (acim_w.to(dev) * (1.0 + eps)).expand(
        cfg.acc_len, cfg.n_mag_bits, cfg.n_mag_bits)
    a_real = _a_real(_signed_bits(x_q, cfg), _signed_bits(w_q, cfg), real_w)
    # VREFCLK polarity-path asymmetry: +/- conversions see slightly
    # different reference gains
    a_real = a_real * (1.0 + macro.vref_pol_eps.to(dev) * torch.sign(a_real))
    adc_code = sar_adc(a_real / cfg.dcim_lsb, macro.adc_cap_eps, cfg,
                       noise_key, draw_offset=draw_offset)
    return dict(y8=dcim + adc_code, dcim=dcim, adc_code=adc_code,
                a_real=a_real, a_ideal=a_ideal, exact=_isum(prod))


def _adc_round(a: torch.Tensor, cfg: CCIMConfig) -> torch.Tensor:
    """The ideal ADC: clip(floor(a / lsb + 1/2)) of a float32 analog sum
    (exact: a is an integer below 2^24 and lsb a power of two)."""
    half = cfg.adc_half_range
    return torch.clamp(torch.floor(a / cfg.dcim_lsb + 0.5), -half,
                       half - 1).to(torch.int32)


def hybrid_mac_ideal(x_q: torch.Tensor, w_q: torch.Tensor,
                     cfg: CCIMConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Mismatch-free macro output y8 (only ADC rounding and clipping)."""
    d_elem, a_elem, _ = _dcim_terms(x_q.to(torch.int32), w_q.to(torch.int32),
                                    cfg)
    return _isum(d_elem) + _adc_round(_isum(a_elem).to(torch.float32), cfg)


def _noisy(a_real: torch.Tensor, a_mag: torch.Tensor, draw: torch.Tensor,
           cfg: CCIMConfig) -> torch.Tensor:
    """a_real + sqrt(coef * |acim| + floor) * draw in float32, with the
    two multiply-adds fused as the reference's compiled CPU code fuses
    them (``prng._fma``) and a correctly rounded square root."""
    coef, floor = cfg.noise_var_terms()
    var = prng.fma(a_mag.to(torch.float32), coef, floor)
    return prng.fma(prng.sqrt(var), draw, a_real)


def hybrid_mac_fast(x_q: torch.Tensor, w_q: torch.Tensor, noise_key=None,
                    cfg: CCIMConfig = DEFAULT_CONFIG, *,
                    draw_offset: int = 0) -> dict:
    """The moment-matched macro model: exact ints, one matched Gaussian
    per conversion (a ``core.prng`` key, drawn over the broadcast output
    shape as the reference draws it, from flat index ``draw_offset`` on;
    none without a key) and the ideal ADC.  Same dict keys as
    ``hybrid_mac_bit_true``."""
    x_q, w_q = x_q.to(torch.int32), w_q.to(torch.int32)
    d_elem, a_elem, prod = _dcim_terms(x_q, w_q, cfg)
    dcim, a_ideal = _isum(d_elem), _isum(a_elem)
    a_real = a_ideal.to(torch.float32)
    if noise_key is not None:
        idx = _flat_index(a_real.shape, draw_offset, a_real.device)
        a_real = _noisy(a_real, _isum(a_elem.abs()),
                        prng.normal_from_bits(prng.bits_at(noise_key, idx)),
                        cfg)
    code = _adc_round(a_real, cfg)
    return dict(y8=dcim + code, dcim=dcim, adc_code=code, a_real=a_real,
                a_ideal=a_ideal, exact=_isum(prod))


def contribution_table(cfg: CCIMConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Fig. 2 analysis: fractional contribution of each (j, k) bit
    product (float64)."""
    nb = cfg.n_mag_bits
    w = np.array([[2.0 ** (j + k) for k in range(nb)] for j in range(nb)])
    return w / w.sum()


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
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(C, L, N) integer weights -> (wf, w_planes): the float32 weight copy
    and one (C, L, N) float32 folded plane per distinct j."""
    return (wq.to(torch.float32),
            [p.to(torch.float32) for p in fold_dcim_planes(wq, cfg)])


# elements of one (chunk block, M, N) float32 partial: bounds the plain
# path's working set at full width (int32 sums make any block size give
# the same result)
_PARTIAL_ELEMS = 1 << 25

# the profiler range of every noise draw (``_fast_gemm_noise``), by which
# a trace attributes device time to the draws
NOISE_RANGE = "ccim.fast_gemm_noise"


def _fast_gemm_noise(noise_key, M: int, N: int, C: int,
                     noise_segments: Optional[Sequence[int]] = None,
                     c0: int = 0, c1: Optional[int] = None) -> torch.Tensor:
    """The fast path's (C, M, N) mismatch/comparator noise, chunks
    [c0, c1) of it: float32 (c1 - c0, M, N).

    The reference draws ``normal(key, (M, N, C))`` (the broadcast model's
    layout) and transposes it; each element here is drawn at its flat
    index in that layout (``prng.bits_at``), so a block of chunks costs
    only its own draws.  For a fused projection group ``noise_key`` is a
    sequence of per-segment keys and ``noise_segments`` their N sizes:
    each segment draws its own (M, n, C) stream -- the draw of its
    unfused projection -- and the segments concatenate along N."""
    c1 = C if c1 is None else c1
    if noise_segments is None:
        keys, segs = (noise_key,), (N,)
    else:
        keys, segs = tuple(noise_key), tuple(noise_segments)
        if len(keys) != len(segs) or sum(segs) != N:
            raise ValueError(f"noise segments {segs} do not split N={N} "
                             f"among {len(keys)} keys")
    dev = keys[0].device
    with torch.profiler.record_function(NOISE_RANGE):
        ar = lambda *a: torch.arange(*a, dtype=torch.int64, device=dev)
        c, m = ar(c0, c1)[:, None, None], ar(M)[None, :, None]
        draws = []
        for key, n in zip(keys, segs):
            j = ar(n)[None, None, :]
            draws.append(prng.normal_from_bits(
                prng.bits_at(key, (m * n + j) * C + c)))
        return draws[0] if len(draws) == 1 else torch.cat(draws, dim=-1)


def fast_gemm_int(xq: torch.Tensor, wf: torch.Tensor,
                  w_planes: Sequence[torch.Tensor],
                  x_bits: Sequence[int], dcim_lsb: int, adc_half: int,
                  chunk_block: Optional[int] = None, *,
                  noise_key=None, noise_segments=None,
                  cfg: Optional[CCIMConfig] = None,
                  clips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_c y8_c as (M, N) int32 (unscaled), for the split described by
    ``x_bits`` (one activation bit per folded plane), ``dcim_lsb`` and
    ``adc_half``.  xq (M, C, L) ints; wf (C, L, N) weights and
    ``w_planes`` one (C, L, N) folded plane per entry of ``x_bits``, in
    any dtype holding integers (int8 views of the pack are cast one chunk
    block at a time).

    With ``noise_key`` (and ``cfg``, whose noise terms it reads) each
    conversion adds the matched Gaussian of ``_fast_gemm_noise`` to its
    analog sum before the ADC, its variance from the |x|.|w| magnitude
    dots.  Float32 batched dots are exact here: every partial is an
    integer below 2^24 (|chunk dot| <= 64 * 127^2).  TF32 would break
    that, so it is switched off for both matmul back ends first.

    ``clips`` (one int32 element on the device; by default the open
    telemetry collector's ``adc_clip`` buffer, ``obs/taps.py``) gets the
    count of conversions whose ADC code clipped, ``raw < -half`` or
    ``raw > half - 1``, as the reference's fast path counts them; with
    neither, nothing is counted.

    An armed fault model (``resilience/faults.py``) perturbs the analog
    quantities only, as the reference does: the ACIM partial takes the
    per-column gain and offset drift (``a * gain + off * lsb``, one fused
    multiply-add, as XLA's CPU compiler evaluates it), the conversion the
    global ADC offset, and the clip range shrinks to ``half_eff =
    max(1, floor(half * range_scale))``, by which the clips are counted
    too.  The DCIM sum is never touched.  With no model armed not one op
    is added.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    M, C, L = xq.shape
    N = wf.shape[-1]
    sx, mx = split_sign_mag(xq)
    xf = xq.transpose(0, 1).to(f32)                            # (C, M, L)
    sxf, mxT = sx.transpose(0, 1).to(f32), mx.transpose(0, 1)
    x_bit = [((mxT >> j) & 1).to(f32) for j in x_bits]
    x_pl = [sxf * b for b in x_bit]
    noisy = noise_key is not None
    lsb, half = float(dcim_lsb), adc_half
    cb = chunk_block or max(1, min(C, _PARTIAL_ELEMS // max(M * N, 1)))
    acc = torch.zeros((M, N), dtype=torch.int32, device=xq.device)
    if clips is None:
        clips = taps.sink("adc_clip", xq.device)
    fault = faults.active()
    if fault:
        f_gain, f_off, f_adc_off, f_scale = faults.epilogue_terms(
            N, xq.device)
        f_off = f_off * lsb
        half_eff = torch.clamp_min(torch.floor(f_scale * half), 1.0)
        lo, hi = -half_eff, half_eff - 1
    for c0 in range(0, C, cb):
        c1 = min(C, c0 + cb)
        wb = wf[c0:c1].to(f32)
        a_real = torch.bmm(xf[c0:c1], wb)                      # (cb, M, N)
        if x_pl:
            # the block's planes side by side along L: one dot for all
            wpl = torch.cat([p[c0:c1] for p in w_planes], dim=1).to(f32)
            dcim = torch.bmm(torch.cat([p[c0:c1] for p in x_pl], -1), wpl)
        else:
            dcim = torch.zeros_like(a_real)
        a_real = a_real - dcim * lsb                            # ideal ACIM
        if noisy:
            # |folded signed plane| is the magnitude plane (the fold
            # weights are non-negative)
            a_mag = torch.bmm(xf[c0:c1].abs(), wb.abs())
            if x_pl:
                a_mag = a_mag - lsb * torch.bmm(
                    torch.cat([b[c0:c1] for b in x_bit], -1), wpl.abs())
            a_real = _noisy(a_real, a_mag, _fast_gemm_noise(
                noise_key, M, N, C, noise_segments, c0, c1), cfg)
        if fault:
            # capacitor-array drift on the analog partial, then the ADC's
            # conversion offset and its escalated clip
            a_real = prng.fma(a_real, f_gain, f_off)
            raw = torch.floor(a_real / lsb + 0.5 + f_adc_off)
            if clips is not None:
                clips.add_(((raw < lo) | (raw > hi)).sum(dtype=torch.int32))
            code = torch.minimum(torch.maximum(raw, lo), hi)
        else:
            raw = torch.floor(a_real / lsb + 0.5)
            if clips is not None:
                clips.add_(((raw < -half) | (raw > half - 1)).sum(
                    dtype=torch.int32))
            code = torch.clamp(raw, -half, half - 1)
        acc += (dcim + code).to(torch.int32).sum(dim=0, dtype=torch.int32)
    return acc


def hybrid_mac_fast_gemm_prepacked(
    xq: torch.Tensor,                 # (M, C, L) ints in [-127, 127]
    wf: torch.Tensor,                 # (C, L, N) float32 weight copy
    w_planes: Sequence[torch.Tensor],  # J folded planes, (C, L, N) each
    noise_key=None,
    cfg: CCIMConfig = DEFAULT_CONFIG,
    noise_segments: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Fast-path GEMM on prepacked weight operands; (M, N) int32 sum of
    the per-conversion y8 (unscaled), with the analog noise of
    ``noise_key`` (per segment with ``noise_segments``) if given."""
    return fast_gemm_int(xq, wf, w_planes, tuple(_dcim_by_j(cfg)),
                         cfg.dcim_lsb, cfg.adc_half_range,
                         noise_key=noise_key, noise_segments=noise_segments,
                         cfg=cfg)


def hybrid_mac_fast_gemm(xq: torch.Tensor, wq: torch.Tensor, noise_key=None,
                         cfg: CCIMConfig = DEFAULT_CONFIG,
                         noise_segments: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
    """Chunked fast-path GEMM on raw (C, L, N) integer weights; with
    ``noise_segments`` each segment of N draws from its own key."""
    wf, w_planes = fast_gemm_weight_ops(wq, cfg)
    return hybrid_mac_fast_gemm_prepacked(xq, wf, w_planes, noise_key, cfg,
                                          noise_segments)


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


def int_matmul_exact(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The full-precision integer dot (M, K) @ (K, N) -> (M, N) int32.
    On the CPU it accumulates in int64; torch has no integer GEMM on
    CUDA, so there it accumulates in float64, exact below 2^53 (never
    float32: K * 127^2 passes 2^24 from K = 1,041)."""
    if x_q.is_cuda:
        acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    else:
        acc = x_q.to(torch.int64) @ w_q.to(torch.int64)
    return acc.to(torch.int32)


def _chunk_operands(x_q: torch.Tensor, w_q: torch.Tensor, acc_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) and (K, N) ints -> (M, C, L) and (C, L, N) int32, K
    zero-padded to whole ``acc_len`` chunks."""
    C = _pad_to_chunks(x_q.shape[1], acc_len)
    pad = C * acc_len - x_q.shape[1]
    return (F.pad(x_q.to(torch.int32), (0, pad)).reshape(
                x_q.shape[0], C, acc_len),
            F.pad(w_q.to(torch.int32), (0, 0, 0, pad)).reshape(
                C, acc_len, w_q.shape[1]))


# elements of one broadcast (rows, N, C, L) block of the elementwise
# fidelities: bounds their working set (output rows are independent)
_BROADCAST_ELEMS = 1 << 22


def _elementwise_gemm(x_q: torch.Tensor, w_q: torch.Tensor, cfg: CCIMConfig,
                      fidelity: str, macro: Optional[MacroInstance],
                      noise_key=None) -> torch.Tensor:
    """sum_c y8_c (unscaled, int32) of the elementwise models on the
    (M, 1, C, L) x (1, N, C, L) broadcast of the chunked operands, a
    block of rows at a time.  A noise key draws over the whole (M, N, C)
    output, as the reference draws it: a block of rows is the contiguous
    run of flat indices that starts at its first row."""
    xq, wq = _chunk_operands(x_q, w_q, cfg.acc_len)
    M, C, L = xq.shape
    N = wq.shape[-1]
    wc = wq.permute(2, 0, 1).contiguous()[None]                 # (1, N, C, L)
    rows = max(1, _BROADCAST_ELEMS // max(N * C * L, 1))
    out = []
    for m0 in range(0, M, rows):
        xc = xq[m0:m0 + rows, None]                             # (r, 1, C, L)
        if fidelity == "fast_broadcast":
            res = hybrid_mac_fast(xc, wc, noise_key, cfg,
                                  draw_offset=m0 * N * C)
        else:
            res = hybrid_mac_bit_true(xc, wc, macro, cfg, noise_key,
                                      draw_offset=m0 * N * C)
        out.append(res["y8"].sum(-1, dtype=torch.int32))
    return torch.cat(out)


def cim_matmul_int(x_q: torch.Tensor, w_q,
                   cfg: CCIMConfig = DEFAULT_CONFIG, noise_key=None,
                   fidelity: str = "fast", *,
                   use_kernel: Optional[bool] = None,
                   macro: Optional[MacroInstance] = None,
                   noise_segments: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
    """Integer GEMM through the macro: (M, K) @ (K, N) -> (M, N) int32 at
    product scale (already times ``dcim_lsb``).  K is tiled into
    ``acc_len`` chunks, one ADC conversion each.

    fidelity:
      'fast'            chunked GEMMs with the ideal ADC (the hot path)
      'fast_broadcast'  the same numbers from the elementwise model
      'bit_true'        every bit-product on the die ``macro`` (required)
      'exact'           the full-precision integer dot (no macro)

    ``w_q`` may be raw integer weights or an ``engine.PackedCimWeights``.
    At 'fast', raw weights at the prototype's numerics run the unpacked
    GEMM (``kernels/ccim_matmul/ops.py::ccim_matmul_int``: its CUDA
    kernel on a CUDA device, its plain version on the CPU), which
    decomposes the weights itself; at any other design point raw weights
    are packed for the call and served by the prepacked kernels, which
    take every design point -- bit-identical, since packing is a caching
    transform; a design point outside their envelope runs the chunked
    fast GEMM in torch.  The other fidelities are plain torch on any
    device.

    ``noise_key`` adds the macro's analog noise, as the reference draws
    it, and takes the GEMM off the kernels: at 'fast' the chunked fast
    GEMM in torch (on a pack, ``engine.packed_cim_matmul_int`` reads its
    int8 views), at 'fast_broadcast' the matched Gaussian of
    ``hybrid_mac_fast``, at 'bit_true' the SAR's comparator noise;
    'exact' ignores it.  ``noise_segments`` (the N sizes of a fused
    projection group, with one key per segment) draws each segment's own
    stream; it is defined for 'fast' and 'exact' only, as in the
    reference."""
    from .engine import (PackedCimWeights, _prepacked_kernel_supported,
                         pack_quantized_cim_weights, packed_cim_matmul_int)
    if isinstance(w_q, PackedCimWeights):
        return packed_cim_matmul_int(x_q, w_q, cfg, noise_key, fidelity,
                                     use_kernel=use_kernel, macro=macro,
                                     noise_segments=noise_segments)
    if x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x_q.shape)} @ w {tuple(w_q.shape)}")
    if noise_segments is not None and fidelity not in ("fast", "exact"):
        raise ValueError(
            "per-segment noise streams (fused projection groups) are only "
            f"defined for the 'fast'/'exact' fidelities, got {fidelity!r}")
    # an armed fault model (resilience/faults.py) lives in the fast
    # GEMM's epilogue only: the kernels model the nominal macro
    if fidelity == "fast" and (noise_key is not None
                               or not _prepacked_kernel_supported(cfg)
                               or faults.active()):
        xq, wq = _chunk_operands(x_q, w_q, cfg.acc_len)
        return hybrid_mac_fast_gemm(xq, wq, noise_key, cfg,
                                    noise_segments) * cfg.dcim_lsb
    if fidelity == "fast":
        if _kernel_numerics_match(cfg):
            from ..kernels.ccim_matmul import ops as kops
            return kops.ccim_matmul_int(x_q, w_q, use_kernel=use_kernel)
        one = torch.ones((1, w_q.shape[-1]), dtype=torch.float32,
                         device=w_q.device)
        return packed_cim_matmul_int(
            x_q, pack_quantized_cim_weights(w_q, one, cfg), cfg,
            use_kernel=use_kernel)
    if fidelity == "exact":
        return int_matmul_exact(x_q, w_q)
    if fidelity not in ("fast_broadcast", "bit_true"):
        raise ValueError(f"unknown fidelity {fidelity!r}")
    if fidelity == "bit_true" and macro is None:
        raise ValueError("the 'bit_true' fidelity needs a MacroInstance "
                         "(fabricate or ideal_macro)")
    return _elementwise_gemm(x_q, w_q, cfg, fidelity, macro,
                             noise_key) * cfg.dcim_lsb


# ---------------------------------------------------------------------------
# Float-in/float-out CIM matmul (quantize -> macro GEMM -> dequantize)
# ---------------------------------------------------------------------------


def cim_matmul(x: torch.Tensor, w, cfg: CCIMConfig = DEFAULT_CONFIG,
               noise_key=None, fidelity: str = "fast",
               per_channel: bool = True,
               use_kernel: Optional[bool] = None,
               macro: Optional[MacroInstance] = None,
               noise_segments: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
    """float (M, K) @ (K, N) through the emulated macro, dequantized to
    float32.  ``w`` may be an ``engine.PackedCimWeights``; activation
    quantization then runs per call while the weight conditioning is
    served prepacked.  ``macro`` is the die of the 'bit_true' fidelity;
    ``noise_segments`` as in ``cim_matmul_int``."""
    from .engine import PackedCimWeights, packed_cim_matmul
    if isinstance(w, PackedCimWeights):
        return packed_cim_matmul(x, w, cfg, noise_key, fidelity,
                                 use_kernel=use_kernel, macro=macro,
                                 noise_segments=noise_segments)
    sx = smf_scale(x, dim=-1, keepdim=True, cfg=cfg)            # per row
    sw = (smf_scale(w, dim=0, keepdim=True, cfg=cfg) if per_channel
          else smf_scale(w, cfg=cfg))
    y = cim_matmul_int(quantize_smf(x, sx, cfg), quantize_smf(w, sw, cfg),
                       cfg, noise_key, fidelity, use_kernel=use_kernel,
                       macro=macro, noise_segments=noise_segments)
    return y.to(torch.float32) * sx * sw.reshape(1, -1)
