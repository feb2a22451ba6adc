"""Time builds of refine_inner.cu against each other on one CUDA card.

    python scripts/refine_inner_ab.py [--out DIR] label=path/to/refine_inner.cu[:old] ...

Each source is compiled as of_dis_tpu_torch/ops/build.py compiles the
package's own (same nvcc flags, the package's csrc/ on the include path)
into build/refine_inner_ab/, its ptxas report and SASS written to
DIR/<label>.{ptxas,sass} (DIR defaults to that directory).  ":old" marks a source
whose refine_inner_launch takes no pair count (the single-pair ABI before
the batch axis).  At op2's and op4's level shapes (C = 1, and C = 3 at
op2's; seeded fields; op2's n_inner and solver_it), every launch variant
the level allows runs in every build: the outputs must be bit-equal across builds, and each build's
time per launch (CUDA events around 50 back-to-back launches, the builds
interleaved over 9 rounds, median) and SOR half-step cost ((t(n, 5) -
t(n, 1)) / (8 n)) are printed as one JSON line per shape and variant.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from of_dis_tpu_torch.ops import build, kernels  # noqa: E402

LIB_DIR = ROOT / "build" / "refine_inner_ab"
CASES = ((14, 32, 6, 1), (28, 64, 5, 1), (56, 128, 4, 1), (96, 128, 4, 1), (112, 256, 3, 1),
         (14, 32, 6, 3), (28, 64, 5, 3), (56, 128, 4, 3))  # h, w, n_inner, C
ROUNDS, LAUNCHES = 9, 50


def compile_lib(label: str, src: Path, out: Path):
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    lib = LIB_DIR / f"lib{label}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"{label}.ptxas").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed\n{r.stdout}{r.stderr}")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    (out / f"{label}.sass").write_text(sass.stdout + sass.stderr)
    return ctypes.CDLL(str(lib)).refine_inner_launch


def main() -> int:
    dev = torch.device("cuda", 0)
    args = sys.argv[1:]
    out = LIB_DIR
    if args[:1] == ["--out"]:
        out, args = Path(args[1]), args[2:]
    builds = []
    for arg in args:
        label, path = arg.split("=", 1)
        old = path.endswith(":old")
        fn = compile_lib(label, Path(path.removesuffix(":old")), out)
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * (5 if old else 6)
                       + [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        builds.append((label, fn, old))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(nvidia_smi=smi, builds=[b[0] for b in builds])), flush=True)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    omega, qa, hd3, hg3 = 1.6, 2.5, 5.0 * 0.5 / 3.0, 10.0 * 0.5 / 3.0
    for h, w, n_inner, c in CASES:
        rng = np.random.RandomState(h * w)

        def f(*shape, s=1.0):
            return torch.as_tensor((rng.randn(*shape) * s).astype(np.float32), device=dev)

        wx, wy = f(h, w), f(h, w)
        mask = torch.as_tensor((rng.rand(h, w) > 0.05).astype(np.float32), device=dev)
        derivs = [f(h, w, c, s=s) for s in (5.0, 5.0, 10.0, 2.0, 2.0, 2.0, 3.0, 3.0)]
        scratch = torch.empty((10, h, w), device=dev)
        for variant in kernels.refine_variants(h, w):
            n_ctas = kernels.refine_cluster_ctas(h, w) if variant == "cluster" else 0
            vi = kernels.REFINE_VARIANTS.index(variant)
            outs = {}

            def launcher(fn, old, uu, vv, ni, si):
                ptrs = [t.data_ptr() for t in (wx, wy, mask, *derivs, uu, vv, scratch)]
                head = [] if old else [1]
                args = (*ptrs, *head, h, w, c, ni, si, omega, qa, hd3, hg3, vi, n_ctas, stream)
                return lambda: fn(*args)

            def timed(call):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(LAUNCHES):
                    call()
                e.record()
                e.synchronize()
                return s.elapsed_time(e) * 1e3 / LAUNCHES

            calls = {}
            for label, fn, old in builds:
                uu, vv = torch.empty((h, w), device=dev), torch.empty((h, w), device=dev)
                full = launcher(fn, old, uu, vv, n_inner, 3)
                if full() != 0:
                    raise RuntimeError(f"{label}: launch failed at {h}x{w} {variant}")
                torch.cuda.synchronize()
                outs[label] = (uu.clone(), vv.clone())
                calls[label] = (full, launcher(fn, old, uu, vv, n_inner, 1),
                                launcher(fn, old, uu, vv, n_inner, 5))
            ref = outs[builds[0][0]]
            equal = {k: bool(torch.equal(u, ref[0]) and torch.equal(v, ref[1]))
                     for k, (u, v) in outs.items()}
            t = {k: {"full": [], "s1": [], "s5": []} for k in calls}
            for _ in range(ROUNDS):
                for k, (full, s1, s5) in calls.items():
                    t[k]["full"].append(timed(full))
                    t[k]["s1"].append(timed(s1))
                    t[k]["s5"].append(timed(s5))
            line = dict(hw=[h, w], c=c, n_inner=n_inner, variant=variant, n_ctas=n_ctas,
                        bit_equal_to_first=equal,
                        us_per_launch={k: float(np.median(v["full"])) for k, v in t.items()},
                        us_per_sor_half_step={
                            k: float((np.median(v["s5"]) - np.median(v["s1"])) / (8 * n_inner))
                            for k, v in t.items()},
                        us_per_launch_all={k: v["full"] for k, v in t.items()})
            print(json.dumps(line), flush=True)
            if not all(equal.values()):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
