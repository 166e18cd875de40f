"""Measure XLA-CPU's float32 rsqrt against the correctly rounded value and
write the correction table the port's CPU ``rms_norm`` applies.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rsqrt_table.py \
        [--out src/repro_torch/models/rsqrt_xla_cpu.bin] [--check]

It runs ``jax.lax.rsqrt`` under ``jax.jit`` over every float32 input of
[1, 4) (2^24 of them: two exponents, 23 mantissa bits) and compares it,
as float32 bit patterns, with the correctly rounded rsqrt (float64 and
one rounding).  The difference is -1, 0 or +1 in the last place.  The
function is invariant under scaling by 4 (rsqrt(4x) = rsqrt(x) / 2 and
the estimate's table is indexed by the exponent's parity and the
mantissa), which the script checks at x 4 and x 2^-20; so the
difference at any normal input is read at index (exponent parity,
mantissa).  The table stores it in 2 bits an entry (0: none, 1: +1,
2: -1), four to a byte, zlib-compressed: ``layers.xla_rsqrt`` reads it.
``--check`` recomputes the sweep and fails unless the committed table
equals it.  The table is the host's: XLA-CPU's rsqrt is the processor's
estimate and a Newton step, and ``layers.xla_rsqrt`` applies it only on
a host with AVX-512F, where it was measured.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np

OUT = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
       / "models" / "rsqrt_xla_cpu.bin")
_ONE_BITS = 0x3F800000        # 1.0f: the sweep's first input
N = 1 << 24                   # float32 inputs in [1, 4)


def sweep(scale: float = 1.0) -> np.ndarray:
    """(2^24,) int8: XLA-CPU's rsqrt of ``scale`` x every float32 of
    [1, 4), minus the correctly rounded one, in float32 bit steps."""
    x = (np.arange(N, dtype=np.uint32) + _ONE_BITS).view(np.float32)
    x = (x * np.float32(scale)).astype(np.float32)
    got = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    d = got.view(np.int32).astype(np.int64) - exact.view(np.int32)
    if np.abs(d).max() > 1:
        raise SystemExit(f"rsqrt differs by {np.abs(d).max()} ulps at "
                         f"scale {scale}: not a 2-bit table")
    return d.astype(np.int8)


def encode(d: np.ndarray) -> bytes:
    """2 bits an entry (0, +1 -> 1, -1 -> 2), four a byte, zlib level 9."""
    code = np.where(d == 1, 1, np.where(d == -1, 2, 0)).astype(np.uint8)
    q = code.reshape(-1, 4)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return zlib.compress(packed.astype(np.uint8).tobytes(), 9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--check", action="store_true",
                    help="fail unless the table at --out equals the sweep")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    d = sweep()
    for s in (4.0, 2.0 ** -20):
        if not np.array_equal(sweep(s), d):
            print(f"rsqrt is not invariant under scaling by {s}")
            return 1
    blob = encode(d)
    print(f"inputs {N}: -1 ulp {int((d == -1).sum())}, +1 ulp "
          f"{int((d == 1).sum())} ({100 * float((d != 0).mean()):.2f} %); "
          f"scale-invariant at x4 and x2^-20; table {len(blob)} bytes; "
          f"{time.perf_counter() - t0:.1f} s")
    out = pathlib.Path(args.out)
    if args.check:
        same = out.exists() and out.read_bytes() == blob
        print("committed table", "equals" if same else "DIFFERS from",
              "the sweep")
        return 0 if same else 1
    out.write_bytes(blob)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
