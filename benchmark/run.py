#!/usr/bin/env python3
"""The benchmark of nerfloc_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding BENCHMARK.json. Cells, configurations,
traffic mixes and metrics are found by name (benchmark/harness/spec.py).
The last line of standard output is the result's JSON object. Without a
CUDA device the run prints no result and exits non-zero.
"""
import os
import time


def _process_start() -> float:
    """perf_counter() at this process's start (/proc/self/stat), or now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the benchmark's own modules, then the checkout's root, which holds the port
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from harness import runner
    return runner.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
