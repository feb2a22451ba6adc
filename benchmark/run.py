"""Run one cell of BENCHMARK.json on this machine and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and last the numbers compared with their limits, which also end
standard error.  Without the CUDA devices the cell asks for, or with a JAX
module loaded once the window has closed, it prints no result and exits
non-zero.  See harness.py.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout (the program's
# own CUDA libraries go to build/of_dis_tpu_torch/, fixed in its code).
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
              "TRITON_CACHE_DIR": "build/benchmark/triton",
              "CUDA_CACHE_PATH": "build/benchmark/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for k, rel in CACHE_DIRS.items():
        os.environ[k] = str(ROOT / rel)
    import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  T_START)
    except (harness.NoDevice, harness.Forbidden) as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
