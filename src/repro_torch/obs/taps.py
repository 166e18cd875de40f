"""Value taps: let inner GEMMs export telemetry counts.

Counterpart of ``repro/obs/taps.py``.  The interesting health signals --
how many ADC codes the macro GEMM's conversions clipped -- are born deep
inside a serving step, and threading a "stats" output through every
model and kernel signature would contaminate dozens of APIs for a value
that exists only when telemetry is on.  Instead the GEMMs ``emit(name,
value)`` into a module-level stack of collector frames that is populated
only while a ``collect()`` context is open:

  * a frame maps a name to an int32 DEVICE tensor that the caller owns
    (``collect(adc_clip=buf)``); emissions add into it in place, and
    kernels that count on the device take its pointer (``sink``) and
    add into it themselves.  Under CUDA-graph capture that pointer is
    baked into the graph, so a caller that captures passes one static
    buffer for the whole run (the scheduler: a view of its
    ``ctr[CTR_ADC_CLIP]`` ring slot), never a tensor made per call.  A
    name the caller gave no buffer gets one at its first emission.
  * ``active()`` is a plain Python bool: with no frame open ``emit`` is
    a no-op, ``sink`` is None, and the GEMM paths compute and launch
    nothing extra (the kernels take their counter-off instance).

The reference also has ``scan`` and ``switch``, which relay emissions
across ``lax.scan`` / ``lax.switch`` trace boundaries (a value emitted
inside a scan body is a tracer of that body and may not leak out).  The
port's layers and rungs loop in Python (``models/lm.py``), so every
emission lands in the caller's frame directly and no relay exists.

Emissions are summed per name; every tap value must be an additive
count (int32, as the reference's rings).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch

# stack of live collector frames (innermost last)
_STACK: List[Dict[str, torch.Tensor]] = []


def active() -> bool:
    """True while some ``collect()`` frame is open."""
    return bool(_STACK)


def sink(name: str, device=None) -> Optional[torch.Tensor]:
    """The innermost frame's int32 buffer for ``name`` (a 0-d or
    one-element tensor a kernel adds into), made on ``device`` at first
    use; None with no frame open."""
    if not _STACK:
        return None
    frame = _STACK[-1]
    buf = frame.get(name)
    if buf is None:
        buf = frame[name] = torch.zeros((), dtype=torch.int32, device=device)
    return buf


def emit(name: str, value) -> None:
    """Add ``value`` (a count, tensor or int) to ``name`` in the
    innermost collector; a no-op with no frame open.  Guard any extra
    computation of ``value`` with ``active()``."""
    if _STACK:
        dev = value.device if isinstance(value, torch.Tensor) else None
        sink(name, dev).add_(value)


@contextlib.contextmanager
def collect(**buffers: torch.Tensor) -> Iterator[Dict[str, torch.Tensor]]:
    """Open a collector frame over the caller's int32 ``buffers`` (name
    -> tensor); yields the frame dict (name -> buffer)."""
    for name, buf in buffers.items():
        if buf.dtype != torch.int32 or buf.numel() != 1:
            raise ValueError(f"tap buffer {name!r} must be one int32 "
                             f"element, got {buf.dtype} {tuple(buf.shape)}")
    frame: Dict[str, torch.Tensor] = dict(buffers)
    _STACK.append(frame)
    try:
        yield frame
    finally:
        _STACK.pop()


def drain_sum(frame: Dict[str, torch.Tensor], name: str,
              dtype=torch.int32) -> torch.Tensor:
    """Everything emitted under ``name`` in ``frame`` (0 if nothing):
    the frame's buffer, as a 0-d tensor of ``dtype``."""
    buf = frame.get(name)
    if buf is None:
        return torch.zeros((), dtype=dtype)
    return buf.reshape(()).to(dtype)
