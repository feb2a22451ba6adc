"""Port (of_dis_tpu_torch) vs JAX package: stereo (nop = 1) and the two
red-black SOR solvers.

The SOR plain versions (the specs of csrc/sor_rb.cu) are held against the
JAX package's Pallas kernels, which run in interpret mode on the CPU, at
1e-5; a stereo refine_level, whose JAX side runs sor_scalar_rb_pallas the
same way, at 1e-4 (tests/test_torch_refine.py's tolerance); dis_stereo end
to end at mean EPE <= 0.01; and the CLI's .pfm byte for byte against
io.write_pfm of the library's output.  Warps are held to the JAX package's
4-tap path, as in tests/test_torch_refine.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_util import epe
from of_dis_tpu import DISConfig, dis_stereo as jax_dis_stereo
from of_dis_tpu.models import refine as jrf
from of_dis_tpu.ops.pallas_kernels import sor_coupled_rb_pallas, sor_scalar_rb_pallas
from of_dis_tpu_torch import dis_stereo, io, operating_point
from of_dis_tpu_torch.cli import main as cli_main
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import refine as trf
from of_dis_tpu_torch.ops import kernels


def _system(h, w, seed):
    """A seeded SOR system: positive diagonals, edge weights with the zero
    last column / row that compute_smoothness gives."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    wh = (rng.rand(h, w) * 2 + 0.1).astype(np.float32)
    wv = (rng.rand(h, w) * 2 + 0.1).astype(np.float32)
    wh[:, -1] = 0.0
    wv[-1, :] = 0.0
    return dict(du=f(h, w) * 0.3, dv=f(h, w) * 0.3,
                a11=(rng.rand(h, w) * 3 + 0.5).astype(np.float32),
                a12=f(h, w) * 0.2,
                a22=(rng.rand(h, w) * 3 + 0.5).astype(np.float32),
                b1=f(h, w), b2=f(h, w), wh=wh, wv=wv)


@pytest.mark.parametrize("h,w", [(13, 17), (56, 128)])
def test_sor_plain_matches_pallas(h, w):
    s = _system(h, w, seed=h + w)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    j = {k: jnp.asarray(v) for k, v in s.items()}
    names = ("du", "a11", "b1", "wh", "wv")
    ours = kernels.sor_scalar(*[t[k] for k in names], 3, 1.6)  # CPU: the plain version
    ref = sor_scalar_rb_pallas(*[j[k] for k in names], 3, 1.6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    names = ("du", "dv", "a11", "a12", "a22", "b1", "b2", "wh", "wv")
    ours = kernels.sor_coupled(*[t[k] for k in names], 3, 1.6)
    ref = sor_coupled_rb_pallas(*[j[k] for k in names], 3, 1.6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("camlr", [0, 1])
def test_refine_level_stereo_matches_jax(camlr, smooth_pair, monkeypatch):
    """The 48x64 crop of tests/test_torch_refine.py, one disparity field of
    the camera's sign."""
    monkeypatch.setattr(jrf, "WARP_MATMUL_MAX_FLOPS", 0)
    img1, img2, _ = smooth_pair
    im1, im2 = img1[:48, :64, None], img2[:48, :64, None]
    d = np.abs(np.random.RandomState(7).randn(48, 64, 1).astype(np.float32)) * 1.5
    flow = -d if camlr == 0 else d
    cfg = DISConfig(mode="stereo", channels=1, sc_f=0, sc_l=0, camlr=camlr)
    ref = jrf.refine_level(jnp.asarray(flow), jnp.asarray(im1), jnp.asarray(im2), 2, cfg,
                           camlr=camlr)
    ours = trf.refine_level(torch.as_tensor(flow), torch.as_tensor(im1), torch.as_tensor(im2),
                            2, from_reference(dataclasses.asdict(cfg)), camlr=camlr)
    assert ours.shape == (48, 64, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert (ours <= 0).all() if camlr == 0 else (ours >= 0).all()


def _stereo_pair(smooth_pair):
    """A rectified pair cut from the smooth image: the right view is the
    left one moved 3 px left (true disparity -3 for the left camera)."""
    img1, _, _ = smooth_pair
    return img1[:, :120].copy(), img1[:, 3:123].copy()


def test_dis_stereo_matches_jax(smooth_pair):
    left, right = _stereo_pair(smooth_pair)
    cfg = DISConfig(mode="stereo", channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                    patch_size=8, overlap=0.4, use_tv_refine=True).validate()
    ref = np.asarray(jax_dis_stereo(left, right, cfg))
    ours = dis_stereo(left, right, from_reference(dataclasses.asdict(cfg)), device="cpu").numpy()
    assert ours.shape == ref.shape == left.shape
    assert epe(ours[..., None], ref[..., None]) <= 0.01
    assert abs(np.median(ours[16:-16, 16:-16]) + 3.0) < 0.2


def test_cli_writes_library_pfm(tmp_path, smooth_pair):
    left, right = _stereo_pair(smooth_pair)
    np.save(tmp_path / "l.npy", left)
    np.save(tmp_path / "r.npy", right)
    out = tmp_path / "out.pfm"
    assert cli_main([str(tmp_path / "l.npy"), str(tmp_path / "r.npy"), str(out),
                     "--device", "cpu", "-v", "0"]) == 0
    lib = dis_stereo(left, right, operating_point(2, left.shape[1], mode="stereo"),
                     device="cpu").numpy()
    io.write_pfm(tmp_path / "lib.pfm", lib)
    assert out.read_bytes() == (tmp_path / "lib.pfm").read_bytes()
    assert io.read_pfm(out).min() >= 0.0  # the file holds the disparity negated
