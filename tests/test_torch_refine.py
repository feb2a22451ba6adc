"""Port (of_dis_tpu_torch) vs JAX package: TV refinement.  The step
functions agree at rtol/atol 1e-5; a whole refine_level — whose JAX side
runs refine_inner_pallas in interpret mode on the CPU — at 1e-4 (the JAX
package's own Pallas-vs-XLA tolerance, tests/test_refine.py).

The port warps with the direct 4-tap gather (of_dis_tpu/models/refine.py
:157-168), so the JAX side is held to that path too: its one-hot matmul
warp, a TPU workaround, rounds differently on the ~3e4-valued test images."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu import DISConfig
from of_dis_tpu.models import refine as jrf
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import refine as trf


def _close(ours, ref, tol=1e-5):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _pair(smooth_pair, c):
    img1, img2, _ = smooth_pair
    img1, img2 = img1[:48, :64], img2[:48, :64]
    if c == 3:
        return (np.stack([img1, img1 * 0.7 + 20, img1 * 0.5 + 9], -1),
                np.stack([img2, img2 * 0.7 + 20, img2 * 0.5 + 9], -1))
    return img1[..., None], img2[..., None]


@pytest.fixture(scope="module")
def flow48():
    return np.random.RandomState(0).randn(48, 64, 2).astype(np.float32) * 0.5


@pytest.mark.parametrize("c", [1, 3])
def test_warp_derivatives_data_match_jax(c, smooth_pair, flow48, monkeypatch):
    monkeypatch.setattr(jrf, "WARP_MATMUL_MAX_FLOPS", 0)
    im1, im2 = _pair(smooth_pair, c)
    flow = flow48 * 4.0  # reaches past the borders: exercises the mask and clamps
    wx, wy = flow[..., 0], flow[..., 1]
    w_ref, m_ref = jrf.image_warp(jnp.asarray(im2), jnp.asarray(wx), jnp.asarray(wy))
    w_ours, m_ours = trf.image_warp(torch.as_tensor(im2), torch.as_tensor(wx), torch.as_tensor(wy))
    np.testing.assert_allclose(w_ours.numpy(), np.asarray(w_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(m_ours.numpy(), np.asarray(m_ref))

    d_ref = jrf.get_derivatives(jnp.asarray(im1), w_ref)
    d_ours = trf.get_derivatives(torch.as_tensor(im1), torch.as_tensor(np.array(w_ref)))
    for a, b in zip(d_ours, d_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    rng = np.random.RandomState(1)
    du, dv = (rng.randn(2, 48, 64) * 0.3).astype(np.float32)
    derivs_np = [np.array(d) for d in d_ref]
    sys_ref = jrf.compute_data(jnp.asarray(du), jnp.asarray(dv), m_ref,
                               [jnp.asarray(d) for d in derivs_np], 5 / 6, 5 / 3, 2)
    sys_ours = trf.compute_data(torch.as_tensor(du), torch.as_tensor(dv),
                                torch.as_tensor(np.array(m_ref)),
                                [torch.as_tensor(d) for d in derivs_np], 5 / 6, 5 / 3, 2)
    for a, b in zip(sys_ours, sys_ref):
        _close(a, b)


def test_smoothness_laplacian_sor_match_jax(flow48):
    uu, vv = flow48[..., 0], flow48[..., 1]
    wh_r, wv_r = jrf.compute_smoothness(jnp.asarray(uu), jnp.asarray(vv), 2.5)
    wh, wv = trf.compute_smoothness(torch.as_tensor(uu), torch.as_tensor(vv), 2.5)
    _close(wh, wh_r)
    _close(wv, wv_r)
    rng = np.random.RandomState(2)
    b = rng.randn(48, 64).astype(np.float32)
    _close(trf.sub_laplacian(torch.as_tensor(b), torch.as_tensor(uu), wh, wv),
           jrf.sub_laplacian(jnp.asarray(b), jnp.asarray(uu), wh_r, wv_r))
    a11, a22 = (rng.rand(2, 48, 64) * 3 + 0.5).astype(np.float32)
    a12 = (rng.randn(48, 64) * 0.2).astype(np.float32)
    b1, b2 = rng.randn(2, 48, 64).astype(np.float32)
    zero = np.zeros((48, 64), np.float32)
    args = (zero, zero, a11, a12, a22, b1, b2)
    ours = trf.sor_coupled_rb(*[torch.as_tensor(a) for a in args], wh, wv, 3, 1.6)
    ref = jrf.sor_coupled_rb(*[jnp.asarray(a) for a in args], wh_r, wv_r, 3, 1.6)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_sor_coupled_rb_rounds_as_the_tpu_kernel():
    """One sweep of the plain coupled SOR on a seeded 13x17 system equals,
    bit for bit, a float32 recomputation in the order of the TPU kernel
    (of_dis_tpu/ops/pallas_kernels.py:58-91) and of the CUDA kernels: the
    weights summed first, inv = omega / (a + sum) in one true division, du
    before dv in each colour, dv with the new du."""
    h, w, omega = 13, 17, 1.6
    rng = np.random.RandomState(5)
    f = lambda scale, off=0.0: (rng.randn(h, w) * scale + off).astype(np.float32)  # noqa: E731
    du, dv = f(0.3), f(0.3)
    a11, a12, a22 = np.abs(f(0.5, 2.0)), f(0.2), np.abs(f(0.5, 2.0))
    b1, b2 = f(1.0), f(1.0)
    wh, wv = np.abs(f(0.5, 1.0)), np.abs(f(0.5, 1.0))
    wh[:, -1] = 0.0
    wv[-1, :] = 0.0
    ours = trf.sor_coupled_rb(*[torch.as_tensor(a) for a in
                                (du, dv, a11, a12, a22, b1, b2, wh, wv)], 1, omega)

    up = lambda x: np.concatenate([np.zeros_like(x[:1]), x[:-1]], 0)  # noqa: E731
    down = lambda x: np.concatenate([x[1:], np.zeros_like(x[:1])], 0)  # noqa: E731
    left = lambda x: np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], 1)  # noqa: E731
    right = lambda x: np.concatenate([x[:, 1:], np.zeros_like(x[:, :1])], 1)  # noqa: E731
    nb = lambda x: up(wv * x) + left(wh * x) + wv * down(x) + wh * right(x)  # noqa: E731
    sum_dpsis = up(wv) + left(wh) + wv + wh
    inv11 = np.float32(omega) / (a11 + sum_dpsis)
    inv22 = np.float32(omega) / (a22 + sum_dpsis)
    keep = np.float32(1.0 - omega)
    red = (np.arange(h)[:, None] + np.arange(w)[None, :]) % 2 == 0
    for colour in (red, ~red):
        du = np.where(colour, keep * du + inv11 * ((b1 + nb(du)) - a12 * dv), du)
        dv = np.where(colour, keep * dv + inv22 * ((b2 + nb(dv)) - a12 * du), dv)
    assert du.dtype == dv.dtype == np.float32
    np.testing.assert_array_equal(ours[0].numpy(), du)
    np.testing.assert_array_equal(ours[1].numpy(), dv)


def test_compute_smoothness_rounds_as_the_kernels():
    """The edge weights on a seeded 13x17 flow equal, bit for bit, a float32
    recomputation in the order of the CUDA kernel (csrc/refine_inner.cu::
    smoothness): central differences with replicate borders, then
    qa / sqrt(ux² + uy² + vx² + vy² + eps) in one true division.  The root
    is torch.sqrt's, which on the CPU is not always correctly rounded."""
    rng = np.random.RandomState(6)
    uu, vv = (rng.randn(2, 13, 17) * 2.0).astype(np.float32)
    wh, wv = trf.compute_smoothness(torch.as_tensor(uu), torch.as_tensor(vv), 2.5)

    def grads(f):
        xr, xl = np.minimum(np.arange(17) + 1, 16), np.maximum(np.arange(17) - 1, 0)
        yd, yu = np.minimum(np.arange(13) + 1, 12), np.maximum(np.arange(13) - 1, 0)
        half = np.float32(0.5)
        return half * (f[:, xr] - f[:, xl]), half * (f[yd] - f[yu])

    (ux, uy), (vx, vy) = grads(uu), grads(vv)
    root = torch.sqrt(torch.as_tensor(ux * ux + uy * uy + vx * vx + vy * vy
                                      + np.float32(0.001 * 0.001))).numpy()
    s = np.float32(2.5) / root
    ref_wh = np.concatenate([s[:, :-1] + s[:, 1:], np.zeros_like(s[:, :1])], 1)
    ref_wv = np.concatenate([s[:-1] + s[1:], np.zeros_like(s[:1])], 0)
    assert ref_wh.dtype == ref_wv.dtype == np.float32
    np.testing.assert_array_equal(wh.numpy(), ref_wh)
    np.testing.assert_array_equal(wv.numpy(), ref_wv)


def test_refine_level_matches_jax(smooth_pair, flow48, monkeypatch):
    """The 48x64 crop of tests/test_refine.py::test_refine_inner_pallas_matches_xla."""
    monkeypatch.setattr(jrf, "WARP_MATMUL_MAX_FLOPS", 0)
    im1, im2 = _pair(smooth_pair, 1)
    cfg = DISConfig(mode="flow", channels=1, sc_f=0, sc_l=0)
    ref = jrf.refine_level(jnp.asarray(flow48), jnp.asarray(im1), jnp.asarray(im2), 2, cfg)
    ours = trf.refine_level(torch.as_tensor(flow48), torch.as_tensor(im1),
                            torch.as_tensor(im2), 2, from_reference(dataclasses.asdict(cfg)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
