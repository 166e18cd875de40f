"""Op-sequence and graph fingerprints: the off switch, made checkable.

Counterpart of ``repro/obs/fingerprint.py``, whose sha256 is taken over
the scheduler's lowered StableHLO.  The port has no lowering; what it
runs is the sequence of aten ops each loop branch dispatches and, on
the card, the kernel nodes its captured step graphs hold.  So:

  * ``scheduler_fingerprint(sched, n_queue)`` is the sha256 of the aten
    op sequence of one execution of each branch body (harvest, admit,
    prefill, step) over a small queue, recorded eagerly with a
    ``TorchDispatchMode``: each op's overload name and its tensor
    arguments' dtypes and shapes.  It runs on the CPU and on the card.
    A metrics-on scheduler adds ring ops to its bodies (on != off), and
    the ring capacities are part of their shapes (capacity-sensitive);
    two metrics-off schedulers of one configuration give one hash.
  * ``graph_fingerprint(graph)`` is the sha256 of a captured
    ``StepGraph``'s device nodes (kernel names, memsets and copies, in
    graph order), read back with the driver API (``graph_nodes``).

Both are comparable only between hosts that ``hostinfo.host_matches``.
"""
from __future__ import annotations

import hashlib
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def hlo_fingerprint(text: str) -> str:
    """sha256 of a text (the reference's name, kept for its callers)."""
    return hashlib.sha256(text.encode()).hexdigest()


def _tensor_sig(v) -> str:
    return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"


class OpLog(TorchDispatchMode):
    """Records every aten op dispatched under it as one line: the
    overload name and the dtype and shape of each tensor argument.
    ``target`` is the list the next ops go to (None: dropped)."""

    def __init__(self):
        super().__init__()
        self.target: Optional[List[str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.target is not None:
            sig = [_tensor_sig(v) for v in tree_leaves((args, kwargs))
                   if isinstance(v, torch.Tensor)]
            self.target.append(" ".join([str(func)] + sig))
        return func(*args, **kwargs)


def branch_ops(sched, n_queue: int) -> Dict[str, List[str]]:
    """The aten ops of the first execution of each branch body of
    ``sched`` serving ``n_queue`` requests of all-zero prompts (two
    tokens each, or the scheduler's cap), run eagerly (a replayed graph
    dispatches nothing).  The workload runs once unrecorded first, so
    that the caches a first run fills (rope tables, ring constants) do
    not enter the record."""
    from ..launch.scheduler import Request
    reqs = [Request(rid=i, prompt=np.zeros(sched.prompt_len, np.int32),
                    max_new_tokens=min(2, sched.cap))
            for i in range(n_queue)]
    per: Dict[str, List[str]] = {}
    log = OpLog()

    def on_branch(name: Optional[str]) -> None:
        if name is None or name in per:
            log.target = None
        else:
            log.target = per[name] = []

    graphs, sched.graphs = sched.graphs, False
    try:
        sched.run(reqs)
        log.target = None
        with log:
            sched.run(reqs, on_branch=on_branch)
    finally:
        sched.graphs = graphs
    return per


def scheduler_fingerprint(sched, n_queue: int) -> str:
    """sha256 of the aten op sequence of one execution of each of
    ``sched``'s branch bodies (``branch_ops``), in branch order."""
    per = branch_ops(sched, n_queue)
    text = "\n".join(f"{b}: {op}" for b in sorted(per) for op in per[b])
    return hlo_fingerprint(text)


def fingerprint_variants(make_sched: Callable, n_queue: int = 2
                         ) -> Dict[str, str]:
    """Fingerprint a set of scheduler variants.  ``make_sched`` maps a
    variant name from ``VARIANTS`` to a built scheduler."""
    return {name: scheduler_fingerprint(make_sched(name), n_queue)
            for name in VARIANTS}


#: the serve-loop variants the fingerprints cover
VARIANTS = ("contiguous", "paged", "speculative")


# -- captured graphs ----------------------------------------------------------

# CUgraphNodeType: kernel, memcpy, memset (the nodes that run on the device)
_NODE_KINDS = {0: None, 1: "memcpy", 2: "memset"}


def graph_node_names(graph) -> List[str]:
    """A captured ``StepGraph``'s device nodes in graph order: each kernel
    node's function name, ``memcpy`` or ``memset``, read from the kept
    graph with the driver API (``cuGraphGetNodes``, ``cuFuncGetName``)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} returned {rc}")

    h = ctypes.c_void_p(graph.graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", h, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", h, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value not in _NODE_KINDS:
            continue
        if kind.value != 0:
            names.append(_NODE_KINDS[kind.value])
            continue
        params = (ctypes.c_byte * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), params)
        func = ctypes.c_void_p.from_buffer(params).value   # its first field
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(func))
        names.append(name.value.decode())
    return names


def graph_nodes(graph, patterns: Dict[str, "re.Pattern"]
                ) -> Tuple[Dict[str, int], int]:
    """A captured ``StepGraph``'s kernel nodes counted by the names of
    ``patterns`` (name -> regex over the kernel's name), and its count
    of nodes that run on the device (kernels, copies, memsets)."""
    names = graph_node_names(graph)
    symbols = {sym: sum(bool(pat.search(n)) for n in names)
               for sym, pat in patterns.items()}
    return symbols, len(names)


def graph_fingerprint(graph) -> str:
    """sha256 of a captured ``StepGraph``'s device nodes, in order."""
    return hlo_fingerprint("\n".join(graph_node_names(graph)))
