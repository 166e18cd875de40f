"""Integer oracle for the fused complex CIM kernels: the four-call
reference.

Counterpart of ``repro/kernels/ccim_complex/ref.py``: four independent
hybrid GEMMs (one per real sub-MAC of (a + bi)(c + di)), combined
digitally, each the integer oracle ``ccim_matmul/ref.py::ccim_matmul_ref``
-- not the kernel module -- so the tests compare two independent
implementations of the dataflow.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ccim_matmul.ref import ccim_matmul_ref


def ccim_complex_matmul_ref(
    x_re: torch.Tensor, x_im: torch.Tensor,
    w_re: torch.Tensor, w_im: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) x 2 @ (K, N) x 2 ints -> (y_re, y_im) int32 at x 2^11."""
    ac = ccim_matmul_ref(x_re, w_re)
    bd = ccim_matmul_ref(x_im, w_im)
    ad = ccim_matmul_ref(x_re, w_im)
    bc = ccim_matmul_ref(x_im, w_re)
    return ac - bd, ad + bc
