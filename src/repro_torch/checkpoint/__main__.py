"""``python -m repro_torch.checkpoint --verify <dir>``: checkpoint
integrity CLI.

Fully decompresses every stored leaf (a truncated archive fails HERE, not
deep inside a later restore), validates meta.json, and prints a summary.
Exit status 0 = intact, 1 = corrupt/mismatched, 2 = no checkpoint found.
"""
from __future__ import annotations

import argparse
import sys

from .manager import CheckpointError, latest_step, verify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.checkpoint")
    ap.add_argument("ckpt_dir", help="checkpoint directory (holds step_* "
                    "subdirectories)")
    ap.add_argument("--verify", action="store_true",
                    help="round-trip every stored leaf and validate "
                    "meta.json (the default and only action for now)")
    ap.add_argument("--step", type=int, default=None,
                    help="step to check (default: latest)")
    args = ap.parse_args(argv)

    try:
        report = verify(args.ckpt_dir, step=args.step)
    except FileNotFoundError as e:
        print(f"NOT FOUND: {e}", file=sys.stderr)
        return 2
    except CheckpointError as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        return 1
    print(f"OK: step {report['step']} of {args.ckpt_dir} -- "
          f"{report['n_leaves']} leaves, {report['n_bytes']} bytes, "
          f"meta {report['meta']}")
    latest = latest_step(args.ckpt_dir)
    if latest != report["step"]:
        print(f"    (latest step in dir is {latest})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
