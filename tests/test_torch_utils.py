"""Port (of_dis_tpu_torch) utilities on the CPU: the instrumented driver
(`utils/instrument.py::dis_flow_timed`) against dis_raw (exact), and the
port's copies of `utils/viz.py` and `utils/eval.py` against the JAX
package's on seeded arrays and tests/goldens/tx_gt.flo (exact)."""

import os

import numpy as np
import pytest
import torch

from golden_util import GOLD
from of_dis_tpu.utils import eval as jeval
from of_dis_tpu.utils import viz as jviz
from of_dis_tpu_torch import DISConfig, dis_raw, io, viz
from of_dis_tpu_torch.utils import eval as teval
from of_dis_tpu_torch.utils.instrument import dis_flow_timed


@pytest.mark.parametrize("mode,fb", [("flow", False), ("flow", True), ("stereo", True)])
def test_dis_flow_timed_equals_dis_raw(mode, fb, smooth_pair, capsys):
    """The stage-by-stage run returns dis_raw's bits, one stats row per
    scale, and prints the reference's table (sc_l = 1: the final upscale
    runs too)."""
    img1, img2, _ = smooth_pair
    img1, img2 = img1[24:72, 32:96], img2[24:72, 32:96]
    cfg = DISConfig(mode=mode, sc_f=2, sc_l=1 if mode == "flow" else 0, max_iter=4,
                    min_iter=4, use_fb_merge=fb)
    out, stats = dis_flow_timed(img1, img2, cfg, verbosity=2, device="cpu")
    assert torch.equal(out, dis_raw(img1, img2, cfg, device="cpu"))
    assert [s["sc"] for s in stats] == list(range(cfg.sc_f, cfg.sc_l - 1, -1))
    assert all(s["total"] > 0 and s["n_patches"] > 0 for s in stats)
    text = capsys.readouterr().out
    assert "TIME (Pyramide+Gradients)" in text
    assert text.count("pconst, pinit, poptim, cflow, tvopt, total") == len(stats)
    assert "TIME (O.Flow Run-Time   )" in text


def test_viz_matches_jax():
    rng = np.random.RandomState(7)
    flow = rng.randn(9, 11, 2).astype(np.float32) * 4
    flow[0, 0] = np.nan
    disp = -np.abs(rng.randn(9, 11)).astype(np.float32) * 6
    disp[1, 2] = np.inf
    for max_flow in (None, 3.0):
        np.testing.assert_array_equal(viz.flow_to_color(flow, max_flow),
                                      jviz.flow_to_color(flow, max_flow))
    for d in (disp, disp[..., None], -disp):
        np.testing.assert_array_equal(viz.disparity_to_gray(d), jviz.disparity_to_gray(d))
    np.testing.assert_array_equal(viz._WHEEL, jviz._WHEEL)


@pytest.mark.parametrize("ext", [".ppm", ".png"])
def test_viz_save_image_bytes_match_jax(tmp_path, ext):
    img = viz.flow_to_color(np.random.RandomState(8).randn(6, 5, 2))
    viz.save_image(tmp_path / f"t{ext}", img)
    jviz.save_image(tmp_path / f"j{ext}", img)
    assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()


def test_eval_matches_jax():
    """epe, flow_error_stats and disparity_error_stats on synthetic arrays
    (with and without a valid mask) and on the textured pair's true flow."""
    rng = np.random.RandomState(9)
    gt = io.read_flo(os.path.join(GOLD, "tx_gt.flo"))
    cases = [(rng.randn(4, 5, 2) * 3, rng.randn(4, 5, 2)),
             (gt + rng.randn(*gt.shape).astype(np.float32) * 0.7, gt)]
    for flow, ref in cases:
        valid = rng.rand(*ref.shape[:2]) > 0.3
        for v in (None, valid):
            assert teval.epe(flow, ref, v) == jeval.epe(flow, ref, v)
            assert teval.flow_error_stats(flow, ref, v) == jeval.flow_error_stats(flow, ref, v)
            d, dg = flow[..., 0], ref[..., 0]
            assert (teval.disparity_error_stats(d, dg, v)
                    == jeval.disparity_error_stats(d, dg, v))
    fl = np.zeros((4, 5, 2))
    fl[0, 0] = [3, 4]  # error 5 at one pixel (tests/test_misc.py::test_epe_and_stats)
    assert teval.epe(fl, np.zeros_like(fl)) == pytest.approx(0.25)
