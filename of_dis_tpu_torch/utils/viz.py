"""Flow / disparity visualization (Middlebury color coding), the port's own
copy of of_dis_tpu/utils/viz.py (NumPy only, so the port imports nothing of
the JAX package).

Replaces the reference's commented-out DISVISUAL debug display
(oflow.cpp:307-335, patchgrid.cpp:143-193) with the standard flow-to-color
encoding (Baker et al., "A Database and Evaluation Methodology for Optical
Flow", IJCV 2011 — the encoding every flow viewer understands), so results
can be inspected as images from the API and the CLI (`--viz`).  Pure NumPy;
PNG via PIL when available, binary PNM fallback otherwise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["flow_to_color", "disparity_to_gray", "save_image"]


def _color_wheel() -> np.ndarray:
    """Standard Middlebury 55-color wheel: six arcs (RY, YG, GC, CB, BM, MR)
    with (15, 6, 4, 11, 13, 6) interpolation steps, RGB rows in 0..255."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    n = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((n, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _color_wheel()


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """Encode a (H, W, 2) flow field as (H, W, 3) uint8 RGB.

    Hue encodes direction, saturation encodes magnitude relative to
    `max_flow` (default: the field's own max, so the largest motion is fully
    saturated; pass an explicit value to keep colors comparable across the
    frames of a sequence — magnitudes beyond it render darkened, the
    Middlebury out-of-range convention).  Non-finite vectors render black.
    """
    flow = np.asarray(flow, np.float64)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"expected (H, W, 2) flow, got {flow.shape}")
    u, v = flow[..., 0], flow[..., 1]
    bad = ~(np.isfinite(u) & np.isfinite(v))
    u = np.where(bad, 0.0, u)
    v = np.where(bad, 0.0, v)
    rad = np.sqrt(u * u + v * v)
    if max_flow is None:
        max_flow = rad.max()
    scale = 1.0 / max(max_flow, 1e-9)
    u, v, rad = u * scale, v * scale, rad * scale
    a = np.arctan2(-v, -u) / np.pi
    n = _WHEEL.shape[0]
    fk = (a + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int) % n
    k1 = (k0 + 1) % n
    f = (fk - np.floor(fk))[..., None]
    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    small = rad[..., None] <= 1
    col = np.where(small, 1 - rad[..., None] * (1 - col), col * 0.75)
    col = np.where(bad[..., None], 0.0, col)
    return (col * 255).astype(np.uint8)


def disparity_to_gray(disp: np.ndarray, max_disp: float | None = None) -> np.ndarray:
    """Encode disparity MAGNITUDE as (H, W) uint8 (near = bright, like the
    Middlebury stereo viewers).  Works on the internal (<= 0, left-camera
    clamp) and the on-disk (negated, >= 0) conventions alike via abs();
    accepts (H, W) or (H, W, 1).  Non-finite values render black."""
    d = np.abs(np.asarray(disp, np.float64))
    if d.ndim == 3:
        d = d[..., 0]
    bad = ~np.isfinite(d)
    d = np.where(bad, 0.0, d)
    if max_disp is None:
        max_disp = d.max()
    g = np.minimum(d / max(max_disp, 1e-9), 1.0)
    g = np.where(bad, 0.0, g)
    return (g * 255.0 + 0.5).astype(np.uint8)


def save_image(path, img: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image.  PIL handles PNG etc.;
    .pgm/.ppm always work (binary PNM, no dependencies)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {img.dtype}")
    path = Path(path)
    if path.suffix in (".pgm", ".ppm", ".pnm"):
        magic = b"P5" if img.ndim == 2 or img.shape[2] == 1 else b"P6"
        h, w = img.shape[:2]
        with open(path, "wb") as f:
            f.write(magic + b"\n%d %d\n255\n" % (w, h))
            f.write(img.tobytes())
        return
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL is in the baked env
        raise RuntimeError(
            f"cannot encode {path}: PIL unavailable; use a .pgm/.ppm path"
        ) from e
    Image.fromarray(img if img.ndim == 2 else img).save(path)
