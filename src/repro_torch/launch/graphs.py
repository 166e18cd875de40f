"""CUDA graphs of the serving loop's step bodies.

The reference never serves op by op: it compiles its decode step, a
whole speculative round and the scheduler's pooled step into one
executable each (``repro/launch/serve.py``, ``repro/launch/scheduler.py``)
and runs them on the device.  The port's counterpart is a CUDA graph of
the same body, captured once at fixed shapes and replayed.

``StepGraph(body, device)`` wraps a step body: a function of no
arguments that reads and writes a fixed set of tensors in place (the
drivers' static state) and returns its outputs.  Its first call runs the
body eagerly on a side stream; that call is a real step, and it also
does whatever a kernel does once (the kernels set their shared-memory
attributes at first launch, which must come before capture).  The body
is then captured into a graph with a memory pool of its own, and every
later call replays the graph and returns the captured outputs, which the
next replay overwrites.  The graph holds the cached rope tables and
analog-noise keys its body read (``models.layers.hold_tables``), which
their bounded caches may drop while the graph still replays.  A failed capture or replay raises; no
caller falls back to the eager body.

Launch counts.  Each kernel wrapper adds one to its ``.launches`` when
Python calls it, so the count ticks while a body is captured (no kernel
runs) and not while a graph replays (every captured kernel runs).  A
``StepGraph`` takes the counts before capture, puts them back after it,
keeps the difference as the graph's per-replay launches, and credits
them at every replay: ``.launches`` keeps counting the launches the
device ran.  ``chip_smoke.py`` holds that credit to the graph's kernel
nodes, read back by name, and to a profiler trace of a replay.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from ..kernels.ccim_complex import kernel as _CK
from ..kernels.ccim_matmul import kernel as _K
from ..kernels.int8_matmul import kernel as _IK
from ..kernels.paged_attn import kernel as _PK
from ..models.layers import hold_tables


def use_graphs(graphs: Optional[bool], device: torch.device) -> bool:
    """Whether a driver replays captured graphs: ``None`` means yes on a
    CUDA device and no elsewhere; ``True`` off CUDA raises."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}; "
                         "pass graphs=None or False")
    return bool(graphs)


def kernel_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches in ``.launches``."""
    return (_K.ccim_matmul_prepacked_skinny_cuda,
            _K.ccim_matmul_prepacked_general_cuda,
            _K.ccim_matmul_unpacked_cuda,
            _CK.ccim_complex_prepacked_skinny_cuda,
            _CK.ccim_complex_prepacked_general_cuda,
            _CK.ccim_complex_unpacked_cuda,
            _PK.paged_attention_cuda,
            _IK.int8_w8a8_cuda)


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


class StepGraph:
    """A step body replayed from one CUDA graph (module docstring).

    ``capture_s`` (seconds to capture), ``pool_bytes`` (device memory the
    graph's private pool reserved), ``launches`` (kernel launches per
    replay, by wrapper name) and ``replays`` describe the graph once it
    exists."""

    def __init__(self, body: Callable[[], object], device: torch.device,
                 counters: Optional[Sequence] = None):
        self.body = body
        self.device = torch.device(device)
        self.counters = tuple(counters if counters is not None
                              else kernel_wrappers())
        self.graph = None
        self.outputs = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self._credit: Dict[object, int] = {}
        self._held: Dict = {}      # cached tensors the graph reads
        self._stream = None

    @property
    def launches(self) -> Dict[str, int]:
        return {c.__name__: n for c, n in self._credit.items() if n}

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            for c, n in self._credit.items():
                c.launches += n
            self.replays += 1
            return self.outputs
        out = self._warm()
        before = [c.launches for c in self.counters]
        t0 = time.perf_counter()
        with hold_tables() as self._held:
            self.graph, self.outputs = self._record()
        self.capture_s = time.perf_counter() - t0
        # the capture ran no kernel: its ticks become each replay's credit
        for c, n in zip(self.counters, before):
            self._credit[c] = c.launches - n
            c.launches = n
        return out

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm(self):
        """The first step, run eagerly on the stream the graph is captured
        on (the libraries' per-stream state is set up there)."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.body()
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def _record(self):
        """Capture the body into a new graph with a private pool; returns
        (graph, the body's outputs as captured)."""
        # torch.cuda.graph empties the allocator's cache on entry; doing
        # it first leaves only the private pool in the difference below
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # the graph is kept beside its executable, so that its kernel
        # nodes can be read back by name (``chip_smoke.py`` counts them)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, stream=self._side_stream()):
            out = self.body()
        g.instantiate()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return g, out
