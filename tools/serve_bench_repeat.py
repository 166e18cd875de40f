#!/usr/bin/env python3
"""The serve_bench twin's in-process gates, run again and again on the CPU.

  PYTHONPATH=src python3 tools/serve_bench_repeat.py --runs 6
  PYTHONPATH=<other checkout>/src python3 tools/serve_bench_repeat.py \\
      --runs 6 --telemetry-repeats 24

Runs ``repro_torch.launch.serve_bench.run`` with the settings of
``tests/test_torch_serve_bench.py`` (smoke size, one torch thread, the
gates checked but not raised) ``--runs`` times and prints one JSON line a
run: its seconds, the gates that failed, and the ratios they read (paged
/ contiguous tok/s, KV reduction, the two stall factors, metrics-on /
metrics-off tok/s).  Started beside other busy processes, it shows how
often a shared CPU moves those ratios past their floors; pointed at
another checkout's ``src`` it measures that tree's twin the same way.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--telemetry-repeats", type=int, default=48,
                    help="the test's telemetry_repeats (48; 24 before "
                         "the gates took medians of paired runs)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    from repro_torch.launch import serve_bench as SB
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            t0 = time.time()
            out = SB.run(smoke=True, batch=2, prompt_len=8, gen=6,
                         repeats=1, draft_k=2, gate=False, device="cpu",
                         sweep_bits=(None, 5),
                         telemetry_repeats=args.telemetry_repeats,
                         prom_path=os.path.join(tmp, f"{i}.prom"))
            mt, tel = out["multi_tenant"], out["telemetry"]
            print(json.dumps(dict(
                run=i, seconds=round(time.time() - t0, 1),
                failed=SB.check_gates(out),
                paged_vs_contiguous_tok_s=mt["paged_vs_contiguous_tok_s"],
                kv_reduction=mt["kv_reduction"],
                stall_paged=mt["paged"]["stall_factor"],
                stall_contiguous=mt["contiguous"]["stall_factor"],
                on_off_tok_s_ratio=tel["on_off_tok_s_ratio"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
