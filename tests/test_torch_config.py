"""Port (of_dis_tpu_torch) vs JAX package: configuration, grid geometry,
file I/O, import isolation and the device default."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import of_dis_tpu.config as jcfg
import of_dis_tpu.io as jio
import of_dis_tpu.models.grid as jgrid
import of_dis_tpu_torch.config as tcfg
import of_dis_tpu_torch.io as tio
import of_dis_tpu_torch.models.grid as tgrid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("width", [64, 256, 1023, 1024])
@pytest.mark.parametrize("mode", ["flow", "stereo"])
@pytest.mark.parametrize("op", [1, 2, 3, 4])
def test_config_and_geometry_match(op, mode, width):
    ref = jcfg.operating_point(op, width, mode=mode)
    ours = tcfg.operating_point(op, width, mode=mode)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.nop, ours.steps, ours.novals, ours.n_scales) == (
        ref.nop, ref.steps, ref.novals, ref.n_scales)
    assert tcfg.auto_first_scale(width, 5, ref.patch_size) == jcfg.auto_first_scale(
        width, 5, ref.patch_size)
    height = max(1, (width * 436) // 1024)
    scf = 1 << ref.sc_f
    hp, wp = height + (-height) % scf, width + (-width) % scf
    for sl in range(ref.sc_f, ref.sc_l - 1, -1):
        g_ref = jgrid.level_geometry(wp >> sl, hp >> sl, ref)
        g = tgrid.level_geometry(wp >> sl, hp >> sl, ours)
        assert (g.w, g.h, g.nopw, g.noph, g.n_patches) == (
            g_ref.w, g_ref.h, g_ref.nopw, g_ref.noph, g_ref.n_patches)
        np.testing.assert_array_equal(g.pt_ref, g_ref.pt_ref)
        np.testing.assert_array_equal(g.coarse_idx, g_ref.coarse_idx)


def test_from_reference_round_trip():
    ref = jcfg.DISConfig(mode="flow", channels=3, sc_f=4, sc_l=1, cost=2,
                         patch_norm=False, tv_sor=1.5)
    ours = tcfg.from_reference(dataclasses.asdict(ref))
    assert isinstance(ours, tcfg.DISConfig)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert tcfg.from_reference(dataclasses.asdict(ours)) == ours
    with pytest.raises(ValueError):
        tcfg.from_reference({**dataclasses.asdict(ref), "unknown_field": 1})


def test_flo_pfm_bytes_identical(tmp_path):
    rng = np.random.RandomState(5)
    flow = rng.randn(7, 5, 2).astype(np.float32)
    disp = -np.abs(rng.randn(6, 4).astype(np.float32))
    tio.write_flo(tmp_path / "t.flo", flow)
    jio.write_flo(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tio.read_flo(tmp_path / "j.flo"), flow)
    tio.write_pfm(tmp_path / "t.pfm", disp)
    jio.write_pfm(tmp_path / "j.pfm", disp)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(tio.read_pfm(tmp_path / "j.pfm", negate=True), disp)


def test_port_imports_neither_jax_nor_jax_package():
    code = (
        "import sys\n"
        "import of_dis_tpu_torch, of_dis_tpu_torch.cli, of_dis_tpu_torch.ops.kernels\n"
        "import of_dis_tpu_torch.ops.build, of_dis_tpu_torch.utils.timing\n"
        "import of_dis_tpu_torch.utils.instrument, of_dis_tpu_torch.utils.eval\n"
        "import of_dis_tpu_torch.parallel.video\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'of_dis_tpu' or m.startswith('of_dis_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    from of_dis_tpu_torch import dis_flow, dis_stereo
    from of_dis_tpu_torch.models.dis import resolve_device

    img = np.zeros((32, 32), np.float32)
    for op in (2, 4):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dis_flow(img, img, tcfg.operating_point(op, 32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dis_stereo(img, img, tcfg.DISConfig(mode="stereo", sc_f=1, sc_l=0))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("mode", ["flow", "stereo"])
def test_fb_merge_runs_through_dis_raw(mode):
    """use_fb_merge, refused before it was ported, runs in both modes: a
    finite field of the input's size that the merge changes."""
    from scipy.ndimage import gaussian_filter

    from of_dis_tpu_torch import dis_raw

    base = gaussian_filter(np.random.RandomState(2).rand(40, 56) * 255, 2.0).astype(np.float32)
    img1, img2 = base[4:36, 4:52], base[4:36, 7:55]
    cfg = tcfg.DISConfig(mode=mode, sc_f=1, sc_l=0, max_iter=4, min_iter=4)
    fb = dis_raw(img1, img2, dataclasses.replace(cfg, use_fb_merge=True), device="cpu")
    assert fb.shape == (32, 48, cfg.nop) and bool(torch.isfinite(fb).all())
    assert not torch.equal(fb, dis_raw(img1, img2, cfg, device="cpu"))
