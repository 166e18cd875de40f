"""Deterministic analog-substrate fault injection (the chaos half).

Counterpart of ``repro/resilience/faults.py``.  The paper's 0.435 % RMS
is a nominal-conditions number: a deployed charge-domain macro degrades
under capacitor mismatch drift, ADC offset/clip drift and SRAM bit-cell
faults.  This module emulates those degradations deterministically
(seeded, schedulable), so the watchdog and the failover ladder can be
tested in closed loop.

Two injection surfaces, where the faults live in silicon:

  weights   ``apply_weight_faults``: stuck-at sign/magnitude bit-cells.
            A transform of the packed params tree; the faulted integer
            weights are re-packed through ``engine.pack_quantized_cim_
            weights``, so every serving path (the kernels, the fast GEMM's
            int8 views, the exact ``wq()`` reconstruction) reads the same
            faulted cells.
  epilogue  per-column capacitor gain/offset drift, ADC conversion
            offset and clip escalation, applied in the analog conversion
            epilogue of ``core.ccim.fast_gemm_int``.  They exist only
            while an ``inject()`` frame is open: with none open
            ``active()`` is False, the GEMMs take the kernels and run not
            one op more (``obs/fingerprint.py`` holds the op sequence and
            the captured graphs to that).

Time.  Drift is scheduled against an iteration clock ``t``: an int for a
one-shot call, or a 0-d int32 DEVICE tensor (the scheduler's clock,
bound with ``clock()``), which the severity reads with tensor ops.  A
CUDA graph captured under the frame reads the tensor at every replay,
so one captured step covers the whole drift schedule, as one compiled
executable does in the reference.

The reference evaluates the epilogue under ``jax.jit``, and XLA rewrites
it: a division by a constant becomes a multiply by its float32
reciprocal, ``exp2(x)`` becomes ``exp(x * ln 2)`` with the constants
multiplied together in float32, and the CPU compiler fuses the
multiply-adds ``sev * gain_amp * g + 1`` and ``a * gain + off * lsb``.
A tensor clock follows that compiled form; an int clock computes the
severity as the reference does eagerly (a true float32 division).

Every draw is keyed from ``FaultModel.seed`` alone (and the shapes and
tree paths): the same model gives the same faults everywhere.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import prng

FAULT_SCHEDULES = ("step", "ramp", "burst")
STUCK_MODES = ("mag_msb", "sign")

_F32 = np.float32
_LN2 = _F32(math.log(2.0))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One seeded, schedulable fault scenario (hashable).

    Severity ``s(t)`` in [0, 1] follows ``schedule`` from ``onset``;
    every analog amplitude below scales linearly with it.  Stuck-at
    cell faults do not depend on time (a failed cell stays failed)."""

    seed: int = 0
    # SRAM bit-cell faults (weights; apply_weight_faults)
    stuck_frac: float = 0.0        # fraction of cells faulted
    stuck_mode: str = "mag_msb"    # "mag_msb": magnitude MSB stuck at 1;
                                   # "sign": sign bit flipped
    # capacitor-array drift (per output column, analog epilogue)
    gain_amp: float = 0.0          # relative per-column gain error
    offset_lsb: float = 0.0        # per-column conversion offset, ADC LSBs
    # ADC drift (analog epilogue)
    adc_offset_lsb: float = 0.0    # global conversion offset, ADC LSBs
    adc_clip_bits: float = 0.0     # the SAR range shrinks by up to this
                                   # many bits
    # schedule
    schedule: str = "step"         # step | ramp | burst
    onset: int = 0                 # iteration the fault switches on
    period: int = 64               # ramp rise length / burst period
    duty: float = 0.5              # burst: on-fraction of each period

    def __post_init__(self):
        if self.schedule not in FAULT_SCHEDULES:
            raise ValueError(f"schedule {self.schedule!r} not in "
                             f"{FAULT_SCHEDULES}")
        if self.stuck_mode not in STUCK_MODES:
            raise ValueError(f"stuck_mode {self.stuck_mode!r} not in "
                             f"{STUCK_MODES}")
        if not (0.0 <= self.stuck_frac <= 1.0):
            raise ValueError(f"stuck_frac {self.stuck_frac} outside [0, 1]")
        if self.period < 1:
            raise ValueError(f"period {self.period} < 1")

    @property
    def touches_epilogue(self) -> bool:
        """True when the model perturbs the analog conversion epilogue."""
        return any(v != 0.0 for v in (self.gain_amp, self.offset_lsb,
                                      self.adc_offset_lsb,
                                      self.adc_clip_bits))

    def severity(self, t: Union[int, torch.Tensor], device=None
                 ) -> torch.Tensor:
        """Schedule value s(t) in [0, 1], a 0-d float32 tensor: on the
        clock's device for a tensor clock (tensor ops, the compiled
        form), else on ``device`` (the reference's eager arithmetic)."""
        if not isinstance(t, torch.Tensor):
            return torch.tensor(self._severity_eager(int(t)),
                                dtype=torch.float32, device=device)
        tf = t.to(torch.float32)
        on = float(_F32(self.onset))
        if self.schedule == "step":
            return (tf >= on).to(torch.float32)
        if self.schedule == "ramp":
            inv = float(_F32(1.0) / _F32(self.period))
            return torch.clamp((tf - on) * inv, 0.0, 1.0)
        phase = torch.remainder(tf - on, float(self.period))
        live = (tf >= on) & (phase < float(_F32(self.duty * self.period)))
        return live.to(torch.float32)

    def _severity_eager(self, t: int) -> np.float32:
        tf, on = _F32(t), _F32(self.onset)
        if self.schedule == "step":
            return _F32(tf >= on)
        if self.schedule == "ramp":
            return _F32(np.clip((tf - on) / _F32(self.period), _F32(0),
                                _F32(1)))
        phase = np.mod(tf - on, _F32(self.period))
        return _F32((tf >= on) & (phase < _F32(self.duty * self.period)))

    def column_patterns(self, n: int, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-column (gain, offset) unit patterns, float32 (n,) each in
        [-1, 1): the frozen mismatch signature of one capacitor array.
        Depends only on (seed, n); kept per (seed, n, device), since a
        captured graph reads them."""
        dev = torch.device(device if device is not None else "cpu")
        key = (self.seed, n, str(dev))
        got = _PATTERNS.get(key)
        if got is None:
            k = prng.fold_in(prng.PRNGKey(self.seed, dev), 0x44524946)
            kg, ko = prng.split(k)                              # "DRIF"
            got = _PATTERNS[key] = (prng.uniform(kg, (n,), -1.0, 1.0),
                                    prng.uniform(ko, (n,), -1.0, 1.0))
        return got

    @classmethod
    def parse(cls, spec: str) -> "FaultModel":
        """Build from a CLI spec: comma-separated ``key=value`` pairs,
        e.g. ``schedule=ramp,gain_amp=0.3,onset=32,period=64,seed=7``.
        Unknown keys error with the known field list."""
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        kw = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"fault spec item {part!r} is not "
                                 "key=value")
            k, v = part.split("=", 1)
            if k not in fields:
                raise ValueError(f"unknown fault field {k!r}; known: "
                                 f"{sorted(fields)}")
            kw[k] = v if k in ("schedule", "stuck_mode") else (
                int(v) if k in ("seed", "onset", "period") else float(v))
        return cls(**kw)


# (seed, n, device) -> a model's column patterns
_PATTERNS: Dict[Tuple[int, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


@dataclasses.dataclass
class _Site:
    """One open injection frame: the model and its current clock."""
    model: FaultModel
    t: Union[int, torch.Tensor]


# stack of open injection frames (innermost last)
_STACK: List[_Site] = []


def active() -> bool:
    """True while some ``inject()`` frame is open whose model perturbs
    the conversion epilogue (a plain Python bool)."""
    return bool(_STACK) and _STACK[-1].model.touches_epilogue


def site() -> Optional[_Site]:
    """The innermost open injection frame (None when none is open)."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def inject(model: FaultModel, t: Union[int, torch.Tensor] = 0
           ) -> Iterator[_Site]:
    """Arm ``model`` for every GEMM run (or captured) inside this
    context, at clock ``t`` (rebind it with ``clock``)."""
    s = _Site(model, t)
    _STACK.append(s)
    try:
        yield s
    finally:
        _STACK.pop()


@contextlib.contextmanager
def clock(t: Union[int, torch.Tensor]) -> Iterator[None]:
    """Rebind the innermost frame's clock for the enclosed region; a
    no-op (nothing run, nothing touched) when no frame is open.  The
    scheduler binds its device clock here for a run under a model."""
    if not _STACK:
        yield
        return
    frame = _STACK[-1]
    old = frame.t
    frame.t = t
    try:
        yield
    finally:
        frame.t = old


def epilogue_terms(n_cols: int, device=None):
    """The fault terms the analog conversion epilogue folds in; called
    by ``core.ccim`` only under ``active()``.  Returns float32 ``(gain,
    offset_lsb, adc_off_lsb, range_scale)``: gain and offset (n_cols,),
    the global ADC offset and the SAR range multiplier
    ``2^-(sev * adc_clip_bits)`` 0-d, all severity-scaled at the frame's
    clock, in the reference's compiled arithmetic (module docstring)."""
    frame = _STACK[-1]
    m = frame.model
    dev = frame.t.device if isinstance(frame.t, torch.Tensor) else device
    sev = m.severity(frame.t, dev)
    gcol, ocol = m.column_patterns(n_cols, dev)
    gain = prng.fma(sev * float(_F32(m.gain_amp)), gcol, 1.0)
    off = (sev * float(_F32(m.offset_lsb))) * ocol
    adc_off = sev * float(_F32(m.adc_offset_lsb))
    range_scale = prng.exp(-sev * float(_F32(m.adc_clip_bits) * _LN2))
    return gain, off, adc_off, range_scale


# ---------------------------------------------------------------------------
# Weight-side stuck-at faults (a params transform; no frame involved)
# ---------------------------------------------------------------------------


def _leaf_key(model: FaultModel, path_tag: int, device=None) -> torch.Tensor:
    k = prng.fold_in(prng.PRNGKey(model.seed, device), 0x53545543)  # "STUC"
    return prng.fold_in(k, path_tag)


def stuck_mask(model: FaultModel, shape: Tuple[int, ...], path_tag: int,
               device=None, layer: Optional[int] = None) -> torch.Tensor:
    """Deterministic boolean fault map of one cell array of ``shape``
    ((K, N), or (layers, K, N) for a stacked leaf: one draw over the
    stack).  ``layer`` returns that layer's (K, N) slice of the stack's
    draw alone, drawing only its own elements."""
    key = _leaf_key(model, path_tag, device)
    p = float(_F32(model.stuck_frac))
    if layer is None:
        return prng.bernoulli(key, model.stuck_frac, shape)
    kn = math.prod(shape[1:])
    idx = torch.arange(layer * kn, (layer + 1) * kn, dtype=torch.int64,
                       device=key.device).reshape(shape[1:])
    return prng.uniform_from_bits(prng.bits_at(key, idx)) < p


def faulted_wq(model: FaultModel, sign: torch.Tensor, mag: torch.Tensor,
               path_tag: int, n_mag_bits: int = 7,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply stuck-at cell faults to raw signed-magnitude storage and
    return the faulted integer weights (int32).  ``mask`` (default: the
    model's ``stuck_mask`` of ``sign``'s shape) picks the faulted
    cells."""
    if mask is None:
        mask = stuck_mask(model, tuple(sign.shape), path_tag, sign.device)
    sign = sign.to(torch.int32)
    mag = mag.to(torch.int32)
    if model.stuck_mode == "mag_msb":
        mag = torch.where(mask, mag | (1 << (n_mag_bits - 1)), mag)
    else:                                   # "sign": the cell flips polarity
        sign = torch.where(mask, -sign, sign)
    return sign * mag


def path_tag(path: Tuple[str, ...]) -> int:
    """The fault tag of a params-tree path: crc32 of the reference's
    path string, each key spelled as jax spells a dict key
    (``['layers']/['mlp']/['w2']``)."""
    return zlib.crc32("/".join(f"['{k}']" for k in path).encode())


def _fault_pack(model: FaultModel, packed, tag: int):
    """A ``PackedCimWeights`` with its cells faulted, re-packed (a stack
    one layer at a time, each layer's slice of one draw over the
    stack)."""
    from ..core.engine import pack_quantized_cim_weights, stack_layers
    if packed.kernel_w.dim() == 2:
        wq = faulted_wq(model, packed.sign, packed.mag, tag,
                        packed.cfg.n_mag_bits)
        return pack_quantized_cim_weights(wq, packed.scale, packed.cfg)
    n_layers = packed.kernel_w.shape[0]
    shape = (n_layers, packed.k_dim, packed.n_dim)

    def layer(i):
        one = packed.layer(i)
        mask = stuck_mask(model, shape, tag, one.kernel_w.device, layer=i)
        wq = faulted_wq(model, one.sign, one.mag, tag, one.cfg.n_mag_bits,
                        mask=mask)
        return pack_quantized_cim_weights(wq, one.scale, one.cfg)
    return stack_layers(layer, n_layers)


def apply_weight_faults(model: FaultModel, params):
    """A params tree whose every packed leaf (``PackedCimWeights`` or the
    pack of a ``FusedPackedCimWeights``) has ``stuck_frac`` of its cells
    faulted, keyed by (seed, the leaf's tree path) as the reference keys
    them, and re-packed: the kernel operands, the ``gemm_views`` and
    ``wq()`` all read the same faulted cells, as every execution path
    reads the same cells in silicon.  Other leaves pass through."""
    from ..core.engine import FusedPackedCimWeights, PackedCimWeights
    if model.stuck_frac <= 0.0:
        return params

    def walk(v, path):
        if isinstance(v, dict):
            return {k: walk(x, path + (k,)) for k, x in v.items()}
        if isinstance(v, FusedPackedCimWeights):
            return dataclasses.replace(
                v, packed=_fault_pack(model, v.packed, path_tag(path)))
        if isinstance(v, PackedCimWeights):
            return _fault_pack(model, v, path_tag(path))
        return v

    return walk(params, ())
