"""The harness end to end on the CPU: every cell of BENCHMARK.json at its
configuration's size (1024x436) with its traffic mix cut to a few pairs, in
a copy of the benchmark beside the program.  A sound run is `correct`; the
timed path broken underneath (state left unchanged, half the batch left
out, an answer altered) and the control (the reference in bfloat16 put in
the program's place) are not; a new configuration, traffic kind, cell and
per-layer metric are found by name as new files; and a run in a directory
without the program, or with JAX loaded, prints no result."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT

SMALL_MIXES = {
    "batch32": dict(batch=2, pool_batches=2, warm_calls=1, check_answers=2, trace_calls=3),
    "stream": dict(pool_pairs=3, warm_calls=1, check_answers=2, trace_calls=3),
}
SECONDS = 0.4
SEED = 2**31 + 101


def _copy_tree(dst):
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A checkout of the benchmark with the program beside it (a link) and
    the traffic mixes cut to a few pairs."""
    root = tmp_path_factory.mktemp("checkout")
    _copy_tree(root)
    os.symlink(ROOT / "of_dis_tpu_torch", root / "of_dis_tpu_torch")
    for name, kw in SMALL_MIXES.items():
        p = root / "benchmark" / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **kw}))
    return root


@pytest.fixture(scope="module")
def harness(tree):
    sys.path.insert(0, str(tree / "benchmark"))
    import importlib.util

    spec = importlib.util.spec_from_file_location("harness_under_test", tree / "benchmark" / "harness.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["harness_under_test"] = mod
    spec.loader.exec_module(mod)
    return mod


def _run(harness, cell, trace=False):
    return harness.run_cell(cell, SEED, SECONDS, trace, time.perf_counter(), device="cpu")


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(harness, cell):
    r = _run(harness, cell)
    assert r["correct"] is True
    assert r["checks"]["epe_worst"]["value"] == 0.0
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    man = harness.manifest()
    want = {m["name"] for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("cell", ["op2_gray.stream", "stereo_gray.batch32"])
def test_traced_run(harness, cell):
    r = _run(harness, cell, trace=True)
    assert r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    # the CPU has no device trace and no CUDA graphs: only the host clock's
    # readers find something, in the untraced window run before the trace
    clocked = {m["name"] for m in harness.manifest()["per_layer"]
               if m["source"] == "host_clock" and cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == clocked
    assert all(v["value"] > 0 for v in r["metrics"].values())
    if clocked:  # the untraced window's pairs count with the traced one's
        assert r["attempted"] >= 2


def _broken(real, fault):
    """The program's entry with a fault planted where its answer is made."""
    def entry(a, b, cfg, device=None, **kw):
        out = real(a, b, cfg, device=device, **kw)
        if fault == "unchanged":            # the flow left at its initial state
            return torch.zeros_like(out)
        if fault == "half_batch":           # half the batch left out, the rest's answers in its place
            half = out.shape[0] // 2
            return torch.cat([out[:half], out[:out.shape[0] - half]])
        if fault == "altered":              # the (first) answer moved by a pixel
            out = out.clone()
            if out.ndim == 4:                   # a batch: its first pair's
                out[0] += 1.0
            else:
                out += 1.0
            return out
        raise ValueError(fault)
    return entry


@pytest.mark.parametrize("cell,entry,fault", [
    ("op2_gray.batch32", "batched_flow", "unchanged"),
    ("op2_gray.batch32", "batched_flow", "half_batch"),
    ("op2_gray.batch32", "batched_flow", "altered"),
    ("stereo_gray.batch32", "batched_flow", "half_batch"),
    ("op2_gray.stream", "dis_flow", "unchanged"),
    ("op2_gray.stream", "dis_flow", "altered"),
    ("stereo_gray.stream", "dis_stereo", "altered"),
])
def test_fault_is_not_correct(harness, monkeypatch, cell, entry, fault):
    import of_dis_tpu_torch as port

    monkeypatch.setattr(port, entry, _broken(getattr(port, entry), fault))
    r = _run(harness, cell)
    assert r["correct"] is False
    assert r["checks"]["epe_worst"]["value"] > r["checks"]["epe_worst"]["limit"]


@pytest.mark.parametrize("cell,entry", [
    ("op2_gray.batch32", "batched_flow"),
    ("stereo_gray.batch32", "batched_flow"),
    ("op2_gray.stream", "dis_flow"),
    ("stereo_gray.stream", "dis_stereo"),
])
def test_control_is_not_correct(harness, monkeypatch, cell, entry):
    """The reference computed in bfloat16, in the program's place, at the
    configuration's size: on the card's uint8 batches, or on one pair of
    host arrays whose answer goes back through to_host."""
    import of_dis_tpu_torch as port
    from reference import dis as ref_dis
    from reference.params import from_dict

    def control(a, b, cfg, device=None):
        if entry == "batched_flow":
            return ref_dis.run(from_dict(dataclasses.asdict(cfg)), a, b, harness.CONTROL_DTYPE)
        a, b = (torch.from_numpy(x)[None].to(device) for x in (a, b))
        out = ref_dis.run(from_dict(dataclasses.asdict(cfg)), a, b, harness.CONTROL_DTYPE)[0]
        return out[..., 0] if entry == "dis_stereo" else out

    monkeypatch.setattr(port, entry, control)
    r = _run(harness, cell)
    assert r["correct"] is False
    assert r["checks"]["epe_worst"]["value"] > r["checks"]["epe_worst"]["limit"]


@pytest.mark.parametrize("when", ["before the run", "in the reference check"])
def test_jax_loaded_after_the_window_prints_nothing(harness, monkeypatch, when):
    if when == "before the run":
        monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    else:
        real = harness.worst_epe

        def loads_jax(*a, **kw):
            monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
            return real(*a, **kw)

        monkeypatch.setattr(harness, "worst_epe", loads_jax)
    with pytest.raises(harness.Forbidden):
        _run(harness, "op2_gray.stream")


def test_forbidden_names_compare_whole(harness, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", type(sys)("jaxtyping_like"))
    monkeypatch.setitem(sys.modules, "of_dis_tpu_like", type(sys)("of_dis_tpu_like"))
    assert "of_dis_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "of_dis_tpu.models", type(sys)("of_dis_tpu.models"))
    assert harness.forbidden_modules() == ["of_dis_tpu"]


def test_new_files_found_by_name(tree, harness):
    """A configuration, a traffic kind and mix, a cell and a per-layer
    metric added as new files only, with their entries in BENCHMARK.json."""
    from of_dis_tpu_torch import operating_point

    b = tree / "benchmark"
    conf = json.loads((b / "configs" / "sintel_op2_gray.json").read_text())
    conf.update(name="dummy_op1_gray", params=dataclasses.asdict(operating_point(1, 1024)))
    (b / "configs" / "dummy_op1_gray.json").write_text(json.dumps(conf))
    (b / "traffic" / "dummy_kind.py").write_text(
        (b / "traffic" / "stream.py").read_text().replace("Traffic driver `stream`", "A copy"))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {**json.loads((b / "traffic" / "stream.json").read_text()), **SMALL_MIXES["stream"],
         "driver": "dummy_kind"}))
    (b / "metrics" / "dummy.pairs_in_window.py").write_text(
        "def read(view, run):\n    return float(view.pairs)\n")
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_op1_gray", "source": "test",
                           "file": "benchmark/configs/dummy_op1_gray.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "dummy.cell", "config": "dummy_op1_gray",
                             "traffic": "dummy_mix", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "dummy.pairs_in_window", "unit": "pairs", "better": "higher",
                             "source": "program_counter", "layer": "entry (models/dis.py)",
                             "moves": "pair_ms_p50", "workloads": ["dummy.cell"]})
    for m in man["end_to_end"]:
        if m["name"].startswith("pair_ms_"):
            m["workloads"].append("dummy.cell")
    try:
        (tree / "BENCHMARK.json").write_text(json.dumps(man))
        r = harness.run_cell("dummy.cell", SEED, SECONDS, True, time.perf_counter(), device="cpu")
        assert r["correct"] is True
        assert r["metrics"]["dummy.pairs_in_window"]["value"] == r["attempted"] > 0
        r = _run(harness, "dummy.cell")
        assert set(r["metrics"]) == {"pair_ms_p50", "pair_ms_mean", "setup_s"}
    finally:
        _copy_tree_manifest_back(tree)


def _copy_tree_manifest_back(tree):
    shutil.copy(ROOT / "BENCHMARK.json", tree / "BENCHMARK.json")


@pytest.mark.parametrize("with_program", [False, True])
def test_command_fails_without_the_program_or_the_card(tmp_path, with_program):
    """In a directory that holds only BENCHMARK.json and the benchmark (or
    on a machine without the card) the command prints no result."""
    _copy_tree(tmp_path)
    if with_program:
        os.symlink(ROOT / "of_dis_tpu_torch", tmp_path / "of_dis_tpu_torch")
        if torch.cuda.is_available():
            pytest.skip("a card is present: the command would run")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(man["command"] + ["--workload", "op2_gray.stream", "--seed", "1",
                                            "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.gpu
def test_cell_on_the_card(cuda, harness):
    """A short window of the main cell on the card, the full harness."""
    r = harness.run_cell("op2_gray.stream", SEED, 1.0, False, time.perf_counter(), device="cuda")
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
