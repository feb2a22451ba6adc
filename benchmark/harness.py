"""The benchmark of of_dis_tpu_torch: one cell of BENCHMARK.json per run.

    python3 benchmark/run.py --workload op2_gray.stream --seed 7 --seconds 10 --trace 0

A run finds its cell, the cell's configuration file and traffic mix by
name, makes its input pairs on the card from the seed, lets the traffic
mix's driver (benchmark/traffic/<driver>.py) warm the program up and drive
it for the window, then checks a seeded sample of the answers the window
produced against the plain reference (benchmark/reference/), and prints
one JSON line.  With --trace 1 the window runs under torch.profiler
instead, for a bounded number of calls (after an untraced window of the
full length where one of the cell's per-layer metrics reads the host
clock), and the line carries the cell's per-layer metrics, each read by its own file benchmark/metrics/<name>.py,
and the breakdown.  Nothing here is specific to one cell: a new
configuration, traffic mix or metric is a new file found by its name.

`correct` holds when the worst sampled answer's mean end-point error
against the reference (computed in float32 after the window, once the
program's executables are released) is within the configuration's limit.
The control (CONTROL_DTYPE) puts the reference computed in bfloat16 in
the program's place (calibrate.py).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:  # the benchmark's own modules: inputs, devtrace, reference
    sys.path.insert(0, str(BENCH))
FORBIDDEN = ("jax", "jaxlib", "flax", "of_dis_tpu")
PORT = "of_dis_tpu_torch"
CONTROL_DTYPE = torch.bfloat16


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Forbidden(RuntimeError):
    """A JAX module is loaded in the process."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_file(path: Path) -> ModuleType:
    """A module from a file found by name (metrics and drivers, whose names
    may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    name = f"bench_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items: List[dict], name: str, what: str) -> dict:
    found = [x for x in items if x["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix's file
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(man: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`, with its configuration and traffic files."""
    w = _named(man["workloads"], workload, "workload")
    conf = _named(man["configs"], w["config"], "config")
    return Cell(
        name=workload, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if _applies(m, workload)])


def driver(traffic: dict) -> ModuleType:
    return load_file(BENCH / "traffic" / f"{traffic['driver']}.py")


def reader_path(metric: str) -> Path:
    """metrics/<metric>.py, or else the file of the name without its last
    dotted part (the traffic it is split by): `torch_ops_ms_per_pair.batch`
    and `.stream` share metrics/torch_ops_ms_per_pair.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    base = metric.rpartition(".")[0]
    return path if path.is_file() or not base else BENCH / "metrics" / f"{base}.py"


def reader(metric: str) -> ModuleType:
    return load_file(reader_path(metric))


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"reference.{name}")


class Reservoir:
    """A uniform sample of k of the items of a window, drawn from the seed
    (reservoir sampling): which answers get checked.  `slot()` is asked once
    per item, in order, and says where to keep it (None: not kept); the
    driver copies the answer into storage it made in set-up, so keeping it
    allocates nothing in the window and holds none of the program's
    memory."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0

    def slot(self) -> Optional[int]:
        n, self.seen = self.seen, self.seen + 1
        if n < self.k:
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.k else None


@dataclass
class Run:
    """What a driver needs: the program, its configuration, the seed."""
    cell: Cell
    seed: int
    device: torch.device
    port: ModuleType
    cfg: Any              # the program's DISConfig
    params: Any           # the reference's Params
    trace: bool
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def width(self) -> int:
        return self.cell.config["width"]

    @property
    def height(self) -> int:
        return self.cell.config["height"]

    def make_pairs(self, n: int, seed_offset: int = 0):
        """n seeded pairs on the device, (n, H, W[, C]) uint8 each; the
        peak memory count restarts after them, so the scratch of making
        them is not the program's."""
        from inputs import make_pairs

        c = self.cell.config
        t0 = time.perf_counter()
        pairs = make_pairs(n, c["height"], c["width"], c["params"]["channels"],
                           c["params"]["mode"], self.seed + seed_offset, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.extra["inputs_s"] = time.perf_counter() - t0
        return pairs

    def span(self, name: str):
        """A host span in the traced window; nothing untraced."""
        return torch.profiler.record_function(name) if self.trace else nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def epe_per_answer(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean end-point error of each answer (k, H, W, nop); a non-finite
    answer reads inf."""
    e = torch.sqrt(((prog.float() - ref.float()) ** 2).sum(-1)).mean(dim=(1, 2))
    return torch.where(torch.isfinite(e), e, torch.full_like(e, float("inf")))


def reference_flows(run: Run, img1: torch.Tensor, img2: torch.Tensor, ids: List[int],
                    dtype=torch.float32) -> torch.Tensor:
    """The reference's answers (k, H, W, nop) for pool pairs `ids`, computed
    in `dtype` on the run's device (in blocks, reference/dis.py::run)."""
    sel = torch.as_tensor(ids, device=img1.device)
    return reference(run.cell.config["reference"]).run(
        run.params, img1[sel].to(run.device), img2[sel].to(run.device), dtype)


def worst_epe(run: Run, img1: torch.Tensor, img2: torch.Tensor, answers) -> float:
    """The worst mean end-point error over `answers`, a list of (indices
    into the pool img1 / img2, (k, H, W, nop) outputs), against the
    float32 reference, computed once per distinct pool pair."""
    want = sorted({int(i) for idx, _ in answers for i in idx})
    if not want:
        return float("inf")
    refs = dict(zip(want, reference_flows(run, img1, img2, want)))
    worst = 0.0
    for idx, out in answers:
        ref = torch.stack([refs[int(i)] for i in idx])
        prog = torch.as_tensor(out).to(run.device).reshape(ref.shape)
        worst = max(worst, float(epe_per_answer(prog, ref).max()))
    return worst


def import_port(root: Path = ROOT) -> ModuleType:
    """The program, from this checkout and nowhere else."""
    pkg = root / PORT
    if not pkg.is_dir():
        raise ImportError(f"{PORT} is not in the checkout {root}")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    port = importlib.import_module(PORT)
    if Path(port.__file__).resolve().parent != pkg.resolve():
        raise ImportError(f"{PORT} imported from {port.__file__}, not from {pkg}")
    return port


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def make_run(c: Cell, seed: int, trace: bool, device: str) -> Run:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoDevice(f"cell {c.name} needs {c.chips} CUDA device(s); {n} available")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    port = import_port()
    from reference.params import from_dict

    params = c.config["params"]
    run = Run(cell=c, seed=seed, device=dev, port=port, cfg=port.DISConfig(**params).validate(),
              params=from_dict(params), trace=trace)
    run.extra["device_name"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                else dev.type)
    return run


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", man: Optional[dict] = None, err=sys.stderr) -> dict:
    """One run of a cell; returns the result line's object.  Raises NoDevice
    without the cards, Forbidden when JAX is loaded after the window."""
    man = manifest() if man is None else man
    c = cell(man, workload)
    t_begin = time.perf_counter()
    run = make_run(c, seed, trace, device)
    t_run = time.perf_counter()
    drv = driver(c.traffic)
    state = drv.prepare(run)
    run.sync()
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    print(f"setup: {setup_s:.3f} s = interpreter and imports {t_begin - t_start:.3f} + device and "
          f"program {t_run - t_begin:.3f} + inputs {run.extra['inputs_s']:.3f} + warm-up "
          f"{t_end - t_run - run.extra['inputs_s']:.3f}", file=err)
    sample = Reservoir(state["keep"].shape[0], seed)
    clocked = None
    if trace and any(m["source"] == "host_clock" for m in c.per_layer):
        # A per-layer metric on the host clock reads an untraced window of the
        # cell's length, run before the traced one; its answers are sampled too.
        clocked = drv.window(run, state, seconds, sample, None)
        run.extra["clocked"] = clocked["e2e"]
        print("untraced window: " + ", ".join(f"{k} {v}" for k, v in clocked["e2e"].items()),
              file=err)
    if trace:
        from devtrace import TraceView, WINDOW, profiler

        with profiler() as prof:
            with torch.profiler.record_function(WINDOW):
                win = drv.window(run, state, seconds, sample, c.traffic["trace_calls"])
        view = TraceView.from_profile(prof, pairs=win["pairs"], calls=win["calls"])
        print(f"trace: {len(view.device)} device operations, {len(view.host)} host spans, "
              f"{view.host_calls()} dispatching host calls in {view.window_s:.6f} s", file=err)
    else:
        win = drv.window(run, state, seconds, sample, None)
        print("window: " + ", ".join(f"{k} {v}" for k, v in win["e2e"].items()), file=err)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    from of_dis_tpu_torch.ops import graphs

    run.extra["executables"] = [(ex.capture_ms, ex.pool_bytes) for ex in graphs.cache.entries()]
    metrics: Dict[str, dict] = {}
    result: Dict[str, Any] = {}
    if trace:
        for m in c.per_layer:
            v = reader(m["name"]).read(view, run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": view.top_device_ops(), "idle_gaps": view.idle_gaps()}
    else:
        values = dict(win["e2e"], setup_s=setup_s)
        for m in c.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"cell {workload} reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    # Free the program's state, then check the sampled answers.
    answers = drv.answers(run, state)
    img1, img2 = drv.pool(run, state)
    del state
    graphs.cache.clear()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    epe = worst_epe(run, img1, img2, answers)
    limit = c.config["check"]["epe_worst"]
    pairs = win["pairs"] + (clocked["pairs"] if clocked else 0)
    failed = win["failed"] + (clocked["failed"] if clocked else 0)
    correct = bool(win["pairs"] > 0 and epe <= limit)
    device_info = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
                   "kind": run.extra["device_name"],
                   "count": c.chips, "memory_peak_bytes": int(peak)}
    if run.device.type == "cuda":
        device_info["power_limit"] = power_limit()
    if trace:
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
    checks = {"epe_worst": {"value": epe, "limit": limit}}
    print(f"checked {sum(len(i) for i, _ in answers)} answers of the {pairs} pairs "
          f"({win['calls']} calls in the last window) against the reference", file=err)
    for k, v in checks.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=err)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded after the window: {', '.join(found)}")
    return {"correct": correct, "attempted": pairs, "failed": failed,
            "metrics": metrics,
            "device": device_info, **result, "checks": checks}
