"""The benchmark's plain reference and input generator: the reference
holds the upstream binaries' full-resolution goldens, agrees with the
program's plain path on small seeded pairs, and the generator is
deterministic per seed."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from inputs import make_pairs
from reference import dis as ref_dis
from reference.params import from_dict

from conftest import ROOT

FULLRES = ROOT / "tests" / "goldens" / "fullres"
GOLDEN_EPE = 0.08  # tests/test_golden_fullres.py's bound


def _params(**kw):
    from of_dis_tpu_torch import operating_point

    return from_dict(dataclasses.asdict(operating_point(**kw)))


def _epe(a, b) -> float:
    return float(np.mean(np.sqrt(np.sum((np.asarray(a) - np.asarray(b)) ** 2, axis=-1))))


@pytest.mark.parametrize("case", ["of_int_op2", "de_int_op2"])
def test_reference_holds_fullres_golden(case):
    from of_dis_tpu_torch import io

    c = {x["case"]: x for x in json.loads((FULLRES / "manifest.json").read_text())["cases"]}[case]
    img1 = io.load_image(FULLRES / c["img1"], c["channels"])
    img2 = io.load_image(FULLRES / c["img2"], c["channels"])
    p = _params(op=c["op"], width=img1.shape[1], mode=c["mode"], channels=c["channels"])
    flow = ref_dis.run(p, torch.from_numpy(img1)[None], torch.from_numpy(img2)[None])[0]
    golden = np.load(FULLRES / c["out"])["ref"].astype(np.float32)
    assert flow.shape == golden.shape
    assert _epe(flow, golden) < GOLDEN_EPE


@pytest.mark.parametrize("mode,channels", [("flow", 1), ("stereo", 1), ("flow", 3)])
def test_reference_agrees_with_program_plain_path(mode, channels):
    """The program's plain path on the CPU and the reference on seeded
    pairs; the same arithmetic, so agreement to rounding."""
    from of_dis_tpu_torch import batched_flow, operating_point

    img1, img2 = make_pairs(2, 96, 128, channels, mode, seed=2**31 + 11, device="cpu")
    cfg = operating_point(2, 128, mode=mode, channels=channels)
    prog = batched_flow(img1.numpy(), img2.numpy(), cfg, device="cpu")
    ref = ref_dis.run(from_dict(dataclasses.asdict(cfg)), img1, img2)
    assert prog.shape == ref.shape
    assert _epe(prog, ref) < 1e-3
    assert float(ref.abs().max()) > 0.5  # the pairs move


def test_reference_batch_invariant():
    """A pair's answer does not depend on the pairs it is computed with."""
    p = _params(op=2, width=128)
    img1, img2 = make_pairs(3, 96, 128, 1, "flow", seed=5, device="cpu")
    both = ref_dis.run(p, img1, img2, block=3)
    alone = torch.cat([ref_dis.run(p, img1[i:i + 1], img2[i:i + 1]) for i in range(3)])
    assert torch.equal(both, alone)


@pytest.mark.parametrize("mode,channels", [("flow", 1), ("stereo", 1), ("flow", 3)])
def test_generator_deterministic_per_seed(mode, channels):
    a1, b1 = make_pairs(3, 40, 56, channels, mode, seed=2**33 + 7, device="cpu", chunk=2)
    a2, b2 = make_pairs(3, 40, 56, channels, mode, seed=2**33 + 7, device="cpu", chunk=2)
    a3, _ = make_pairs(3, 40, 56, channels, mode, seed=2**33 + 8, device="cpu", chunk=2)
    shape = (3, 40, 56) if channels == 1 else (3, 40, 56, 3)
    assert a1.shape == b1.shape == shape and a1.dtype == torch.uint8
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3)
    assert not torch.equal(a1[0], a1[1])  # each pair its own frame
    assert int(a1.max()) > 200 and int(a1.min()) < 60


def test_generator_stereo_disparity_range():
    """Stereo pairs move horizontally by 2-6 px: the reference's median
    disparity lies in that range, with the left camera's sign."""
    p = _params(op=2, width=256, mode="stereo")
    img1, img2 = make_pairs(1, 160, 256, 1, "stereo", seed=3, device="cpu")
    d = ref_dis.run(p, img1, img2)[0, 16:-16, 16:-16, 0]
    assert -6.0 < float(d.median()) < -2.0
