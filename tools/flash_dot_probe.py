"""Measure the order of XLA-CPU's two bf16 dots in the reference's flash
prefill, by dot shape, against the port's named orders.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/flash_dot_probe.py \
        [--shapes M,DH,BLK ...] [--arch gemma2-9b] [--table]

For each shape (M = G * Sq query rows a kv head, head dim, key block;
by default ``MEASURED``, every flash the port's CPU tests run) it runs
the reference's ``models.layers._flash_fwd`` under ``jax.jit`` on one
key block of seeded bf16 inputs, and the port's ``_flash_fwd`` with
each score order and each P.V order of ``layers._ordered_sum``.  The
score order is the one whose running max and sum (m, l) equal the
reference's; the P.V order the one whose output then does.  A shape
that no order matches prints ``None``.  Each shape's orders are held to
``layers.flash_orders`` (the script exits 1 where any differs);
``--table`` prints the dots that take the two-lane blocks, as
``layers.FLASH_BLOCK_DOTS`` entries.  The orders are the host's: run it
on the CPU the table is for (``layers.bf16_dot_host``).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import layers as jL
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as tL

S_ORDERS = ("lanes", "pairs", "blocks", "torch")
# (M, Dh, blk) of every flash prefill the port's CPU tests run
MEASURED = ((4, 32, 8), (4, 32, 16), (4, 32, 20), (4, 32, 24), (8, 32, 8),
            (8, 32, 10), (8, 32, 11), (8, 32, 12), (8, 32, 13), (8, 32, 14),
            (8, 32, 15), (8, 32, 16), (8, 32, 17), (8, 32, 18), (8, 32, 19),
            (8, 32, 24), (8, 32, 25), (8, 32, 26), (8, 32, 27), (8, 32, 28),
            (8, 32, 44), (12, 32, 12), (16, 32, 16), (16, 32, 20),
            (16, 32, 22), (16, 32, 23), (16, 32, 24), (16, 32, 26),
            (16, 32, 25), (16, 32, 28), (16, 32, 37), (16, 32, 40),
            (16, 32, 48), (16, 32, 57), (16, 32, 64), (20, 32, 20),
            (20, 32, 24), (24, 32, 24), (24, 32, 32), (32, 32, 26),
            (32, 32, 40), (32, 32, 42), (32, 32, 44), (32, 32, 48),
            (32, 32, 64), (48, 32, 12), (64, 32, 18), (64, 32, 37),
            (64, 32, 48), (80, 32, 24), (96, 32, 24), (96, 32, 32),
            (128, 32, 64), (160, 32, 64), (288, 32, 64))
PV_ORDERS = ("torch", "pairs", "blocks", "lanes")


def probe(G: int, Sq: int, Dh: int, blk: int, B: int = 2, Hkv: int = 2,
          arch: str = "minicpm-2b", seed: int = 0):
    """(score order, P.V order) of the reference's flash at one shape,
    each None where no order of the port's matches.  ``arch``'s smoke
    config gives the softcap around the score dot."""
    jcfg = dataclasses.replace(jget(arch, smoke=True), flash_block=blk)
    tcfg = dataclasses.replace(tget(arch, smoke=True), flash_block=blk)
    rng = np.random.default_rng(seed)
    bf = lambda *s: np.asarray(jnp.asarray(
        rng.standard_normal(s, np.float32) * 2, jnp.bfloat16).astype(
        jnp.float32))
    q, k, v = bf(B, Sq, Hkv * G, Dh), bf(B, blk, Hkv, Dh), bf(B, blk, Hkv, Dh)
    # the query rows sit after the keys: every key is attended
    q_pos = np.broadcast_to(np.arange(blk, blk + Sq), (B, Sq)).astype(
        np.int32)
    k_pos = np.broadcast_to(np.arange(blk), (B, blk)).astype(np.int32)
    J = lambda a: jnp.asarray(a, jnp.bfloat16)
    jo, jm, jl = jax.jit(lambda a, b, c, d, e: jL._flash_fwd(
        jcfg, 0, a, b, c, d, e, False))(J(q), J(k), J(v), jnp.asarray(q_pos),
                                        jnp.asarray(k_pos))
    jo, jm, jl = (np.asarray(t) for t in (jo, jm, jl))
    T = lambda a: torch.tensor(a).to(torch.bfloat16)
    tq, tk, tv = T(q), T(k), T(v)
    tp, tkp = torch.tensor(q_pos).long(), torch.tensor(k_pos).long()
    s_hit = pv_hit = None
    for so, po in itertools.product(S_ORDERS, PV_ORDERS):
        if s_hit is not None and so != s_hit:
            continue
        o, m, l = tL._flash_fwd(tcfg, 0, tq, tk, tv, tp, tkp, False,
                                orders=(so, po))
        if np.array_equal(m.numpy(), jm) and np.array_equal(l.numpy(), jl):
            s_hit = so
            if np.array_equal(o.numpy(), jo):
                pv_hit = po
                break
    return s_hit, pv_hit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", metavar="M,DH,BLK",
                    help="dot shapes: M query rows a kv head (G * Sq), "
                         "head dim, key block (default: MEASURED)")
    ap.add_argument("--arch", default="minicpm-2b",
                    help="smoke config (gemma2-9b: the score softcap)")
    ap.add_argument("--table", action="store_true",
                    help="print the measured orders as table entries")
    args = ap.parse_args()
    torch.set_num_threads(1)
    print("bf16_dot_host:", tL.bf16_dot_host())
    shapes = (sorted(tuple(map(int, sh.split(","))) for sh in args.shapes)
              if args.shapes else MEASURED)
    rows, off = [], 0
    for M, Dh, blk in shapes:
        # the order depends on M = G * Sq alone (measured at G 1, 2, 4)
        so, po = probe(1, M, Dh, blk, arch=args.arch)
        want = tL.flash_orders(M, Dh, blk)
        off += (so, po) != want
        print(f"M {M} Dh {Dh} blk {blk}: scores {so}, P.V {po}"
              f"{'' if (so, po) == want else f' (table: {want})'}",
              flush=True)
        rows.append((M, Dh, blk, so, po))
    if args.table:
        for M, Dh, blk, so, po in rows:
            for dot, order in ((("s", M, Dh, blk), so),
                               (("pv", M, blk, Dh), po)):
                if order == "blocks":
                    print(f"    {dot},")
    print(f"{off} of {len(rows)} shapes differ from layers.flash_orders")
    return 1 if off else 0


if __name__ == "__main__":
    raise SystemExit(main())
