"""The readings a cell's `correct` limit is set from, in one process on the
card: the compared number (epe_worst) of sound runs of the program over
many seeds, each a short window at the cell's own load and size, and of the
control (the reference computed in bfloat16, in the program's place) over
a few seeds.  Not run by the benchmark's own runs.

    python3 benchmark/calibrate.py --workload op2_gray.batch32 \
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 101,102,103 --seconds 2

Prints one JSON line per reading: {"kind": "program" | "control", "seed",
"epe_worst", "pairs"}, a program reading also "correct".
"""

import argparse
import json
import sys
import time

import torch

import harness


def program_reading(c, seed: int, seconds: float, device: str) -> dict:
    """A run of the cell with a short window: its compared number."""
    r = harness.run_cell(c.name, seed, seconds, False, time.perf_counter(), device=device)
    return {"kind": "program", "seed": seed, "epe_worst": r["checks"]["epe_worst"]["value"],
            "correct": r["correct"], "pairs": r["attempted"]}


def control_reading(c, seed: int, device: str) -> dict:
    """As many answers as a run checks, drawn from the seed's pool."""
    run = harness.make_run(c, seed, False, device)
    t = c.traffic
    if t["driver"] == "batch":
        b = t["batch"]
        img1, img2 = run.make_pairs(b * t["pool_batches"])
        n = min(t["check_answers"], t["pool_batches"]) * b
    else:
        img1, img2 = run.make_pairs(t["pool_pairs"])
        n = min(t["check_answers"], t["pool_pairs"])
    idx = list(range(n))
    control = harness.reference_flows(run, img1, img2, idx, harness.CONTROL_DTYPE)
    epe = harness.worst_epe(run, img1, img2, [(idx, control)])
    return {"kind": "control", "seed": seed, "epe_worst": epe, "pairs": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help="cpu to rehearse the script")
    args = ap.parse_args(argv)
    c = harness.cell(harness.manifest(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for s in seeds:
        t0 = time.perf_counter()
        r = program_reading(c, s, args.seconds, args.device)
        print(json.dumps({**r, "cell": c.name, "s": time.perf_counter() - t0}), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    for s in controls:
        t0 = time.perf_counter()
        r = control_reading(c, s, args.device)
        print(json.dumps({**r, "cell": c.name, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
