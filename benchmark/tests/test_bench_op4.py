"""Operating point 4 in the benchmark (configuration sintel_op4_gray, cell
op4_gray.stream): the program agrees with the plain reference at op4 on
small seeded pairs with a level on the GN route, the reference holds the
upstream binary's full-resolution op4 golden (on the card: the CPU takes
minutes at 1024x436 with 128 iterations), and the cell's two readers,
search_roofline and gn_route_levels, read what they should and nothing
where there is nothing to read."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from inputs import make_pairs
from reference import dis as ref_dis
from reference.params import from_dict

from conftest import BENCH, ROOT

FULLRES = ROOT / "tests" / "goldens" / "fullres"
GOLDEN_EPE = 0.08  # tests/test_golden_fullres.py's bound
H100 = "NVIDIA H100 80GB HBM3"


def _epe(a, b) -> float:
    return float(np.mean(np.sqrt(np.sum((np.asarray(a) - np.asarray(b)) ** 2, axis=-1))))


def _reader(name):
    import harness

    return harness.reader(name)


@pytest.mark.parametrize("entry", ["dis_flow", "batched_flow"])
def test_program_agrees_with_reference_at_op4(entry):
    """The program's plain path on the CPU and the reference on seeded
    128x96 pairs at op4 (12-px patches, 128 iterations): the same
    arithmetic, so agreement to rounding, as at op2; level 0 takes the GN
    route at this size, and the route counter shows it."""
    import of_dis_tpu_torch as port
    from of_dis_tpu_torch.ops import kernels

    img1, img2 = make_pairs(2, 96, 128, 1, "flow", seed=2**31 + 17, device="cpu")
    cfg = port.operating_point(4, 128)
    kernels.reset_launches()
    if entry == "batched_flow":
        prog = port.batched_flow(img1.numpy(), img2.numpy(), cfg, device="cpu")
    else:
        prog = torch.stack([port.dis_flow(a.numpy(), b.numpy(), cfg, device="cpu")
                            for a, b in zip(img1, img2)])
    ref = ref_dis.run(from_dict(dataclasses.asdict(cfg)), img1, img2)
    assert prog.shape == ref.shape
    assert _epe(prog, ref) < 1e-3
    assert float(ref.abs().max()) > 0.5  # the pairs move
    assert kernels.routes["gn"] >= 1


@pytest.mark.gpu
def test_reference_holds_op4_fullres_golden(cuda):
    """The reference at op4 on the upstream binary's full-resolution output
    (run_OF_INT ... 4 on Sintel-size frames), on the card."""
    from of_dis_tpu_torch import io, operating_point

    c = {x["case"]: x for x in json.loads((FULLRES / "manifest.json").read_text())["cases"]}
    c = c["of_int_op4"]
    img1 = io.load_image(FULLRES / c["img1"], c["channels"])
    img2 = io.load_image(FULLRES / c["img2"], c["channels"])
    p = from_dict(dataclasses.asdict(operating_point(4, img1.shape[1])))
    a, b = (torch.from_numpy(x)[None].to(cuda) for x in (img1, img2))
    flow = ref_dis.run(p, a, b)[0].cpu()
    golden = np.load(FULLRES / c["out"])["ref"].astype(np.float32)
    assert flow.shape == golden.shape
    assert _epe(flow, golden) < GOLDEN_EPE


class _Run:
    """What a reader takes from a run: op4's parameters, the size, the card."""

    def __init__(self, device_name=H100):
        from of_dis_tpu_torch import operating_point

        self.params = from_dict(dataclasses.asdict(operating_point(4, 1024)))
        self.width, self.height = 1024, 436
        self.extra = {"device_name": device_name}


@pytest.mark.parametrize("kernels,device_name,want", [
    # PERF.md's kernel table: gn_search 5.5976 ms an op4 pair; level_search
    # at op2's 0.0536 ms, more than op4's two coarse levels take
    ((("gn_search_kernel", 5.5976), ("level_search_kernel", 0.0536)), H100, (1.0, 10.0)),
    ((("gn_search_kernel", 5.5976),), H100, (1.0, 10.0)),
    ((("refine_inner_kernel", 1.0),), H100, None),     # neither search kernel ran
    ((("gn_search_kernel", 5.5976),), "cpu", None),    # no peaks for the device
])
def test_search_roofline(kernels, device_name, want):
    from devtrace import TraceView

    ns, pairs = 1e6, 4
    device, t = [], 0
    for name, ms in kernels:
        device.append((f"void {name}<12, 1, 2>(Params)", t, t + int(pairs * ms * ns)))
        t = device[-1][2]
    v = TraceView(device, [], 0, t + int(ns), pairs=pairs, calls=pairs)
    got = _reader("search_roofline").read(v, _Run(device_name))
    if want is None:
        assert got is None
    else:
        assert want[0] < got < want[1]


@pytest.mark.parametrize("held,want", [
    ([{"level": 2, "gn": 4}], 4.0),
    ([{"level": 3}, {"level": 2, "gn": 4}], 4.0),   # the most recently used
    ([{"level": 2, "gn": 4}, {"level": 3}], 0.0),
    ([None], None),                                  # a program without route counts
    ([], None),                                      # no executable (the CPU)
])
def test_gn_route_levels(monkeypatch, held, want):
    from of_dis_tpu_torch.ops import graphs

    entries = [types.SimpleNamespace(capture_ms=1.0) if r is None
               else types.SimpleNamespace(capture_ms=1.0, routes=r) for r in held]
    monkeypatch.setattr(graphs.cache, "entries", lambda device=None: entries)
    assert _reader("gn_route_levels").read(None, _Run()) == want


def test_configuration_is_operating_point_4():
    """The configuration's parameters are the program's op4 at Sintel's
    width, nothing reduced, and its limit is set."""
    from of_dis_tpu_torch import operating_point

    conf = json.loads((BENCH / "configs" / "sintel_op4_gray.json").read_text())
    assert conf["params"] == dataclasses.asdict(operating_point(4, 1024))
    assert (conf["width"], conf["height"], conf["reduced"]) == (1024, 436, [])
    assert conf["check"]["epe_worst"] > 0
