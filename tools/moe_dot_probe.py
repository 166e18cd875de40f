"""Measure the order of XLA-CPU's bf16 expert einsums in the reference's
MoE layer, by dot shape, against the port's ``_expert_matmul``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_dot_probe.py \
        [--shapes E,C,K,N ...] [--rows 1048576]

For each shape (E experts, C buffer rows an expert, contracting K, N
outputs; by default ``MEASURED``, every expert dot the port's CPU tests
run) it runs ``jnp.einsum("ecd,edf->ecf")`` on bf16 operands under
``jax.jit`` and the port's candidates on the same numpy inputs: its
``layers._expert_matmul`` (a float32 GEMM rounded once to bf16) and the
float32 sums of ``layers._ordered_sum``'s orders, each rounded once.  A
bf16 result hides most of a float32 sum order's last bits, so each
shape is drawn over enough seeds to reach ``--rows`` outputs, and an
order matches where none of them differs.  It prints the mismatches of
each candidate by shape and exits 1 where ``_expert_matmul`` has any.
The orders are the host's: run it on the CPU the port's tests run on.
"""
from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models import layers as tL

ORDERS = ("pairs", "blocks", "lanes")
# (E, C, K, N) of the expert einsums the port's CPU tests run: the smoke
# configs' 8 experts, d_model 128, moe_d_ff 64 (w1 and w3: K 128 -> N 64;
# w2: 64 -> 128), C = T * K on the exact path (T tokens, top 2), and
# the grouped path's capacities ceil(S * 2 / 8 * 1.25)
MEASURED = tuple((8, c, k, n) for c in (2, 8, 16, 20, 32, 64, 160, 256,
                                         320, 344, 657)
                 for k, n in ((128, 64), (64, 128)))


def probe(E: int, C: int, K: int, N: int, rows: int, seed: int = 0):
    """{candidate: mismatching outputs}, and the outputs compared."""
    f = jax.jit(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b))
    bad = dict.fromkeys(("port",) + ORDERS, 0)
    n_out, s = 0, seed
    while n_out < rows:
        rng = np.random.default_rng(s)
        a = jnp.asarray(rng.standard_normal((E, C, K), np.float32),
                        jnp.bfloat16)
        b = jnp.asarray(rng.standard_normal((E, K, N), np.float32)
                        / np.sqrt(K), jnp.bfloat16)
        want = np.asarray(f(a, b).astype(jnp.float32))
        ta = torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
        tb = torch.from_numpy(np.asarray(b.astype(jnp.float32))).to(
            torch.bfloat16)
        got = tL._expert_matmul(ta, tb).float().numpy()
        bad["port"] += int((got != want).sum())
        prod = ta.float()[..., :, None, :] * tb.float().transpose(1, 2)[
            :, None]
        for o in ORDERS:
            y = tL._ordered_sum(prod, o).to(torch.bfloat16).float().numpy()
            bad[o] += int((y != want).sum())
        n_out += want.size
        s += 1
    return bad, n_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="E,C,K,N (default: every measured shape)")
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="outputs compared a shape")
    args = ap.parse_args(argv)
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes]
              if args.shapes else MEASURED)
    torch.set_num_threads(1)
    fail = False
    for sh in shapes:
        bad, n = probe(*sh, rows=args.rows)
        print(f"E,C,K,N {sh}: {n} outputs; mismatches {bad}")
        fail |= bad["port"] > 0
    print("port order", "DIFFERS" if fail else "matches", "at every shape")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
