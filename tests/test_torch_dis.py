"""Port (of_dis_tpu_torch) end to end on the CPU: against the JAX package
(with and without the forward-backward merge), against the reference
binaries' small goldens (the per-case rule of tests/test_golden.py; flow,
stereo and fb-merge), against the true flow of the textured pair, and
through its CLI (the -v 2 stage table, --viz)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from golden_util import GOLD, cfg_for_case, epe, load_manifest
from of_dis_tpu import DISConfig, dis_flow as jax_dis_flow, dis_stereo as jax_dis_stereo
from of_dis_tpu_torch import dis_flow, dis_raw, dis_stereo, io, operating_point
from of_dis_tpu_torch.cli import main as cli_main
from of_dis_tpu_torch.config import from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CASES = {c["case"]: c for c in load_manifest()["cases"]}
# Every small golden case on the port's paths (flow op1-4, stereo op2 and
# the forward-backward merge, usefbcon 1).
SLICE_CASES = [
    "of_int_op1", "of_int_op2", "of_rgb_op2", "of_grad_op2",
    "of_tex_op1", "of_tex_op2", "of_rot_op2", "of_big_op2",
    "of_int_l1", "of_int_huber", "of_int_nonorm",
    "de_int_op2", "de_rgb_op2", "of_int_op3", "of_int_op4", "of_int_psz12",
    "of_int_fbcon", "of_rgb_fbcon", "de_int_fbcon",
]
# tests/test_golden.py:25-34: max(2 x epe_captured, 0.02), and 0.30 where
# few-ULP differences flip equally valid GN trajectories on raw texture.
_CASE_TOL = {"of_tex_op1": 0.30}


@pytest.fixture(scope="module")
def port_outputs():
    """Port outputs by case name, computed once per module."""
    cache = {}

    def run(name):
        if name not in cache:
            case = _CASES[name]
            ch = 3 if case["binary"].endswith("RGB") else 1
            img1 = io.load_image(os.path.join(GOLD, case["img1"]), ch)
            img2 = io.load_image(os.path.join(GOLD, case["img2"]), ch)
            cfg, _, gradmag = cfg_for_case(case, img1.shape[1])
            ours = dis_raw(img1, img2, from_reference(dataclasses.asdict(cfg)),
                           gradmag_input=gradmag, device="cpu").numpy()
            path = os.path.join(GOLD, case["out"])
            # a .pfm holds the disparity negated (run_dense.cpp:75)
            golden = (io.read_pfm(path, negate=True)[..., None] if path.endswith(".pfm")
                      else io.read_flo(path))
            cache[name] = (ours, golden)
        return cache[name]

    return run


def test_dis_flow_matches_jax(smooth_pair):
    """The small config of tests/test_flow_e2e.py:142 on the smooth pair."""
    img1, img2, _ = smooth_pair
    cfg = DISConfig(mode="flow", channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                    patch_size=8, overlap=0.4, use_tv_refine=True).validate()
    ref = np.asarray(jax_dis_flow(img1, img2, cfg))
    ours = dis_flow(img1, img2, from_reference(dataclasses.asdict(cfg)), device="cpu").numpy()
    assert ours.shape == ref.shape
    assert epe(ours, ref) <= 0.01


@pytest.mark.parametrize("mode", ["flow", "stereo"])
def test_fb_merge_matches_jax(mode, smooth_pair):
    """dis_flow / dis_stereo with use_fb_merge on the small config of
    test_dis_flow_matches_jax, on a 48x64 cut of the smooth pair (stereo:
    the left image and itself moved 3 px left)."""
    img1, img2, _ = smooth_pair
    if mode == "stereo":
        img2 = img1[:, 3:]
    img1, img2 = img1[24:72, 32:96], img2[24:72, 32:96]
    cfg = DISConfig(mode=mode, channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                    patch_size=8, overlap=0.4, use_tv_refine=True,
                    use_fb_merge=True).validate()
    jax_fn, port_fn = (jax_dis_flow, dis_flow) if mode == "flow" else (jax_dis_stereo, dis_stereo)
    ref = np.asarray(jax_fn(img1, img2, cfg)).reshape(48, 64, -1)
    ours = port_fn(img1, img2, from_reference(dataclasses.asdict(cfg)),
                   device="cpu").numpy().reshape(48, 64, -1)
    assert epe(ours, ref) <= 0.01


@pytest.mark.parametrize("name", SLICE_CASES)
def test_golden_replay(name, port_outputs):
    ours, golden = port_outputs(name)
    assert ours.shape == golden.shape
    e = epe(ours, golden)
    assert np.isfinite(e)
    tol = _CASE_TOL.get(name, max(2.0 * _CASES[name]["epe_captured"], 0.02))
    assert e < tol, f"{name}: mean EPE {e:.4f} (tol {tol:.4f})"


@pytest.mark.parametrize("name", ["of_tex_op1", "of_tex_op2"])
def test_golden_textured_quality(name, port_outputs):
    """As tests/test_golden.py: no further from the true flow than the
    reference binary, within 5 % + 0.02 px."""
    ours, golden = port_outputs(name)
    gt = io.read_flo(os.path.join(GOLD, "tx_gt.flo"))
    inner = np.s_[8:-8, 8:-8]
    assert epe(ours[inner], gt[inner]) <= epe(golden[inner], gt[inner]) * 1.05 + 0.02


def test_cli_writes_library_output(tmp_path, smooth_pair):
    img1, img2, _ = smooth_pair
    np.save(tmp_path / "a.npy", img1)
    np.save(tmp_path / "b.npy", img2)
    out = tmp_path / "out.flo"
    proc = subprocess.run(
        [sys.executable, "-m", "of_dis_tpu_torch.cli", str(tmp_path / "a.npy"),
         str(tmp_path / "b.npy"), str(out), "--op", "2", "--device", "cpu", "-v", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TIME (O.Flow Run-Time   )" in proc.stdout
    lib = dis_flow(img1, img2, operating_point(2, img1.shape[1]), device="cpu").numpy()
    np.testing.assert_array_equal(io.read_flo(out), lib)


def test_cli_params_and_init_flow(tmp_path, smooth_pair):
    """Explicit 20 parameters (reference variant 3) and a .flo warm start."""
    img1, img2, (tu, tv) = smooth_pair
    np.save(tmp_path / "a.npy", img1)
    np.save(tmp_path / "b.npy", img2)
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    params = "1 0 4 4 0.05 0.95 0 8 0.4 0 1 0 1 10 10 5 1 3 1.6 0".split()
    out1, out2 = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    assert cli_main([a, b, out1, "--params", *params, "--device", "cpu", "-v", "0"]) == 0
    assert cli_main([a, b, out2, "--params", *params, "--device", "cpu", "-v", "0",
                     "--init-flow", out1]) == 0
    inner = io.read_flo(out2)[16:-16, 16:-16]
    assert abs(np.median(inner[..., 0]) - tu) < 0.2
    assert abs(np.median(inner[..., 1]) - tv) < 0.2


def test_cli_verbosity2_table_and_viz(tmp_path, smooth_pair, capsys):
    """-v 2 prints the reference's per-scale stage table (oflow.cpp:296-304)
    and writes the -v 0 file bit for bit; --viz writes a non-constant
    colour image of the flow's size (fb-merge on: 20 explicit parameters)."""
    img1, img2, _ = smooth_pair
    np.save(tmp_path / "a.npy", img1[24:72, 32:96])
    np.save(tmp_path / "b.npy", img2[24:72, 32:96])
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    params = "1 0 4 4 0.05 0.95 0 8 0.4 1 1 0 1 10 10 5 1 3 1.6 2".split()
    out0, out2, vz = (str(tmp_path / n) for n in ("q.flo", "v.flo", "o.ppm"))
    assert cli_main([a, b, out0, "--params", *params, "--device", "cpu", "-v", "0",
                     "--viz", vz]) == 0
    assert cli_main([a, b, out2, "--params", *params, "--device", "cpu", "-v", "2"]) == 0
    text = capsys.readouterr().out
    assert "TIME (Pyramide+Gradients)" in text
    assert text.count("pconst, pinit, poptim, cflow, tvopt, total") == 2  # one per scale
    assert "TIME (O.Flow Run-Time   )" in text
    assert open(out2, "rb").read() == open(out0, "rb").read()
    img = io._read_pnm_numpy(vz)
    assert img.shape == (48, 64, 3)
    assert img.std() > 0
