"""Measure the float32 sum order of XLA-CPU's lm_head dot in the
reference's ``_logits``, by shape, against ``layers.lm_head_order``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_head_dot_probe.py \
        [--shapes K,N ...] [--max-rows 256] [--logit-rows 8192]

The reference's head is a bf16 dot that XLA-CPU runs as a float32 dot
of the converted operands, rounded once to bf16; what XLA fuses into
the dot (the final norm, a transposed copy of a tied embedding) changes
its order at one row.  For each (K, N) (by default
``layers.LM_HEAD_SHAPES``: d_model 128 over a vocabulary of 512, every
smoke config's head), for an untied head (``x @ lm_head``) and a tied
one (``x @ embed.T``), and for every row count M from 1 to
``--max-rows``, it runs the reference's final norm and that float32 dot
under one ``jax.jit``, as ``_logits`` does, on seeded bf16 values, and
the port's norm and ``layers.head_sums`` in each named order; the order
whose float32 sums all equal XLA's is the shape's (``[]`` where none
does).  Each is held to ``layers.lm_head_order``.  Then the reference's
jitted ``_logits`` and the port's ``lm._logits`` run on
``--logit-rows`` rows of seeded hidden states at a few row counts, and
their bf16 logits must be ``==``.  Exits 1 where any differs.  The
orders are the host's: run it on the CPU the port's tests run on
(``layers.bf16_dot_host``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

ORDERS = ("seq", "halves", "vec", "gemv", "torch")
LOGIT_ROWS = (1, 2, 4, 18, 32, 50, 51, 160)
EPS = 1e-6


def _bf16(rng, shape, scale=1.0):
    return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32)
                                  * scale, jnp.bfloat16).astype(jnp.float32))


def probe(M: int, K: int, N: int, tied: bool, seed: int = 0):
    """The orders of ``ORDERS`` whose float32 sums equal XLA-CPU's head
    dot after the final norm at M rows (one draw of M x N sums tells
    them apart)."""
    rng = np.random.default_rng(seed)
    x, g = _bf16(rng, (1, M, K)), _bf16(rng, (K,), 0.1)
    w = _bf16(rng, (N, K) if tied else (K, N), 0.05)

    def ref(x, g, w):
        xn = jL.rms_norm(x, g, EPS).astype(jnp.float32)
        return xn @ (w.T if tied else w).astype(jnp.float32)
    B = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax.jit(ref)(B(x), B(g), B(w)))[0]
    T = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    xn = tL.rms_norm(T(x), T(g), EPS)[0].to(torch.float32)
    tw = torch.from_numpy(w)
    tw = tw.T if tied else tw
    return [o for o in ORDERS
            if np.array_equal(tL.head_sums(xn, tw, o).numpy(), want)]


def logits_equal(M: int, tied: bool, rows: int) -> int:
    """Logits of the reference's jitted ``_logits`` and the port's
    ``lm._logits`` apart, over ``rows`` rows of seeded hidden states in
    M-row calls (the minicpm-2b smoke head, tied or not)."""
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True),
                               tie_embeddings=tied)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True),
                               tie_embeddings=tied)
    D, V = tcfg.d_model, tcfg.vocab_size
    f = jax.jit(lambda p, x: jlm._logits(p, jcfg, x))
    bad, s = 0, 0
    while s * M < rows:
        rng = np.random.default_rng(1000 + s)
        p = {"ln_f": _bf16(rng, (D,), 0.1),
             ("embed" if tied else "lm_head"):
                 _bf16(rng, (V, D) if tied else (D, V), 0.05)}
        x = _bf16(rng, (1, M, D))
        want = np.asarray(f({k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in p.items()},
                            jnp.asarray(x, jnp.bfloat16)))
        tp = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in p.items()}
        got = tlm._logits(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16))
        bad += int((got.numpy() != want).sum())
        s += 1
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", default=None, metavar="K,N",
                    help="head shapes (default: layers.LM_HEAD_SHAPES)")
    ap.add_argument("--max-rows", type=int, default=256,
                    help="row counts M probed: 1 to this")
    ap.add_argument("--logit-rows", type=int, default=1 << 13,
                    help="rows of the end-to-end _logits comparison")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    print("bf16_dot_host:", tL.bf16_dot_host())
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes]
              if args.shapes else sorted(tL.LM_HEAD_SHAPES))
    off = 0
    for K, N in shapes:
        for tied in (False, True):
            runs = []                  # (first M, last M, orders)
            for M in range(1, args.max_rows + 1):
                hit = probe(M, K, N, tied)
                want = tL.lm_head_order(M, K, N, tied)
                if want not in hit:
                    off += 1
                    print(f"K {K} N {N} tied {tied} M {M}: {hit} "
                          f"(table: {want})", flush=True)
                if runs and runs[-1][2] == hit:
                    runs[-1][1] = M
                else:
                    runs.append([M, M, hit])
            for lo, hi, hit in runs:
                print(f"K {K} N {N} tied {tied} M {lo}-{hi}: {hit}",
                      flush=True)
    if not args.shapes:
        for tied in (False, True):
            for M in LOGIT_ROWS:
                n = logits_equal(M, tied, args.logit_rows)
                off += n > 0
                print(f"_logits tied {tied} M {M}: {n} of "
                      f"{args.logit_rows} rows' logits apart", flush=True)
    print(f"{off} differences from layers.lm_head_order")
    return 1 if off else 0


if __name__ == "__main__":
    sys.exit(main())
