"""BENCHMARK.json against the benchmark's contract, the files it names,
the imports of the benchmark's modules, and the trace reading."""

import ast
import json
import re

import harness
import pytest

from conftest import BENCH, ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "of_dis_tpu"}


def _imports(path):
    """Top-level names of every module a file imports (relative imports
    excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    assert "of_dis_tpu_torch" not in FORBIDDEN  # compared whole


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert _imports(f) <= {"__future__", "dataclasses", "math", "typing", "numpy",
                               "torch"}, f


def test_manifest_keys_and_limits():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"]
    assert MAN["command"] == ["python3", "benchmark/run.py"] and MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 10 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] == 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in MAN["configs"]] + [c["source"] for c in MAN["configs"]]
                 + [w["why"] for w in MAN["workloads"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
    for m in MAN["per_layer"]:
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if _reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(w["name"], m) for m in MAN["per_layer"]), w["name"]


def test_moves_is_reported_by_every_cell_listed():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
        for c in cells:
            assert _reports(c, e2e[m["moves"]]), (m["name"], c)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 5


def test_files_found_by_name():
    cells = {w["name"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.resolve().is_relative_to(BENCH.resolve())
        conf = json.loads(f.read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (BENCH / "reference" / f"{conf['reference']}.py").is_file()
        assert conf["check"]["epe_worst"] > 0
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])
    for w in MAN["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "traffic" / f"{mix['driver']}.py").is_file()
    for m in MAN["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= cells


def test_check_budget_fits():
    """A full check: 2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s a
    cell to compile, 1200 s spare, within 43200 s at 24 cells."""
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


# -- the trace reading, on a synthetic window ---------------------------------

def test_trace_view_busy_union_and_idle_labels():
    from devtrace import TraceView, dispatches

    ms = 1_000_000
    device = [("k1", 0, 4 * ms), ("k2", 2 * ms, 7 * ms),  # overlap: union 7 ms
              ("Memcpy HtoD (Pinned -> Device)", 8 * ms, 9 * ms),
              ("void level_search_kernel<8, 1, 2>(LevelParams)", 9 * ms, 10 * ms)]
    host = [("bench.call", 0, 10 * ms), ("cudaGraphLaunch", 6 * ms, 8 * ms),
            ("cudaMemcpyAsync", 8 * ms, 8 * ms + 10), ("aten::add", 1 * ms, 2 * ms)]
    v = TraceView(device, host, 0, 10 * ms, pairs=2, calls=2)
    assert v.busy_s == pytest.approx(0.009) and v.window_s == pytest.approx(0.010)
    assert v.host_calls() == 2 and dispatches("cudaLaunchKernel") and not dispatches("aten::mul")
    assert v.idle_gaps() == [["cudaGraphLaunch", pytest.approx(0.001)]]
    assert v.kernel_seconds("level_search") == pytest.approx(0.001)
    assert v.kernel_seconds("refine_inner") is None
    assert v.torch_op_seconds() == pytest.approx(0.009)
    assert v.top_device_ops(1) == [["k2", pytest.approx(0.005)]]


def test_rooflines_stay_under_100_percent_at_the_kernels_recorded_times():
    """The kernels' recorded device times per pair at B = 32 (PERF.md's kernel table)
    give shares of a few percent, far under 100."""
    import dataclasses

    from devtrace import TraceView, roofline
    from of_dis_tpu_torch import operating_point
    from reference.params import from_dict

    class Run:
        params = from_dict(dataclasses.asdict(operating_point(2, 1024)))
        width, height = 1024, 436
        extra = {"device_name": "NVIDIA H100 80GB HBM3"}

    ns = 1e6  # per ms
    for stage, ms in (("level_search", 0.00426), ("refine_inner", 0.00686)):
        name = {"level_search": "level_search_kernel", "refine_inner": "refine_inner_kernel"}[stage]
        v = TraceView([(name, 0, int(32 * ms * ns))], [], 0, int(40 * ns), pairs=32, calls=1)
        assert 1.0 < roofline(v, Run, stage) < 10.0
