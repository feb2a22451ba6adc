"""Variational (TV) refinement, DIS step 5 (VarRefClass,
refine_variational.cpp:36-336, over FDF1.0.1's opticalflow_aux.c and
solver.c):

  - bilinear backward warp and validity mask (opticalflow_aux.c:16-60);
  - derivative filters {1,-8,0,8,-1}/12 and {-0.5,0,0.5}, replicate borders;
  - TV diffusivity edge weights (opticalflow_aux.c:119-165);
  - data term, colour and gradient constancy (opticalflow_aux.c:306-548);
  - weighted-Laplacian right-hand side (opticalflow_aux.c:171-199);
  - red-black SOR, coupled for flow (solver.c:19-72), scalar for stereo
    (solver.c:428-466), with stereo's sign clamp after each inner iteration.

A level runs tv_innerit * (level + 1) inner iterations.  Fields are
(B, h, w), images (B, h, w, C).  Divisions of a constant by a tensor are one
true division.
"""

from __future__ import annotations

import torch

from .params import Params

DATANORM = 0.1 * 0.1
EPS_COLOR = 0.001 * 0.001
EPS_GRAD = 0.001 * 0.001
EPS_SMOOTH = 0.001 * 0.001
DERIV5 = (1.0 / 12.0, -8.0 / 12.0, 0.0, 8.0 / 12.0, -1.0 / 12.0)
DERIV3 = (-0.5, 0.0, 0.5)


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(c), dtype=t.dtype, device=t.device) / t


def _shift(x: torch.Tensor, dim: int, from_before: bool) -> torch.Tensor:
    n = x.shape[dim]
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    if from_before:
        return torch.cat([zero, x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), zero], dim)


def _up(x):
    return _shift(x, -2, True)


def _down(x):
    return _shift(x, -2, False)


def _left(x):
    return _shift(x, -1, True)


def _right(x):
    return _shift(x, -1, False)


def _conv(img: torch.Tensor, coeffs, dim: int) -> torch.Tensor:
    """dst[x] = sum_k c[k] src[x + k - r] along `dim`, replicate borders."""
    r = len(coeffs) // 2
    n = img.shape[dim]
    taps = torch.arange(-r, n + r, device=img.device).clamp_(0, n - 1)
    p = img.index_select(dim, taps)
    out = torch.zeros_like(img)
    for k, c in enumerate(coeffs):
        if c != 0.0:
            out = out + c * p.narrow(dim, k, n)
    return out


def image_warp(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """src (B, h, w, C) sampled at (x + wx, y + wy), clamped taps, and the
    in-bounds mask."""
    h, w, c = src.shape[-3:]
    f = dict(dtype=src.dtype, device=src.device)
    xx = torch.arange(w, **f)[None, :] + wx
    yy = torch.arange(h, **f)[:, None] + wy
    x, y = torch.floor(xx), torch.floor(yy)
    mask = ((xx >= 0.0) & (xx <= w - 1.0) & (yy >= 0.0) & (yy <= h - 1.0)).to(src.dtype)
    xi, yi = x.long(), y.long()
    x1, x2 = xi.clamp(0, w - 1), (xi + 1).clamp(0, w - 1)
    y1, y2 = yi.clamp(0, h - 1), (yi + 1).clamp(0, h - 1)
    dx, dy = (xx - x)[..., None], (yy - y)[..., None]
    flat = src.reshape(-1, c)
    pair0 = (torch.arange(src.shape[0], device=src.device) * (h * w)).reshape(-1, 1, 1)
    y1 = y1 * w + pair0
    y2 = y2 * w + pair0
    dst = (flat[y1 + x1] * (1 - dx) * (1 - dy) + flat[y1 + x2] * dx * (1 - dy)
           + flat[y2 + x1] * (1 - dx) * dy + flat[y2 + x2] * dx * dy)
    return dst, mask


def derivatives(im1: torch.Tensor, im2w: torch.Tensor):
    """(ix, iy, iz, ixx, ixy, iyy, ixz, iyz) on the mean image
    (opticalflow_aux.c:63-116)."""
    mean = 0.5 * (im1 + im2w)
    iz = im2w - im1
    ix = _conv(mean, DERIV5, -2)
    iy = _conv(mean, DERIV5, -3)
    return (ix, iy, iz, _conv(ix, DERIV5, -2), _conv(ix, DERIV5, -3), _conv(iy, DERIV5, -3),
            _conv(iz, DERIV5, -2), _conv(iz, DERIV5, -3))


def smoothness(uu, vv, quarter_alpha: float):
    """(horiz, vert) edge weights; the last column / row couple nothing."""
    ux, uy = _conv(uu, DERIV3, -1), _conv(uu, DERIV3, -2)
    vx, vy = _conv(vv, DERIV3, -1), _conv(vv, DERIV3, -2)
    s = _over(quarter_alpha, torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + EPS_SMOOTH))
    horiz = s + _right(s)
    horiz[..., -1] = 0.0
    vert = s + _down(s)
    vert[..., -1, :] = 0.0
    return horiz, vert


def sub_laplacian(b, src, wh, wv):
    th = wh * (_right(src) - src)
    tv = wv * (_down(src) - src)
    return b + th - _left(th) + tv - _up(tv)


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def data_term(du, dv, mask, derivs, half_delta_over3: float, half_gamma_over3: float,
              nop: int):
    """(a11, a12, a22, b1, b2) per pixel (compute_data, and compute_data_DE
    for nop 1, where only a11 and b1 count)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = derivs
    c = ix.shape[-1]
    du3 = du[..., None]
    dv3 = dv[..., None] if nop == 2 else None
    m = mask[..., None]
    z = torch.zeros_like(du)
    a11, a12, a22, b1, b2 = z, z, z, z, z
    if half_delta_over3:
        t = iz + ix * du3 + (iy * dv3 if nop == 2 else 0.0)
        n = ix * ix + iy * iy + DATANORM
        if c == 1:
            denom = torch.sqrt(3.0 * t * t / n + EPS_COLOR)
        else:
            denom = torch.sqrt(_channel_sum(t * t / n)[..., None] + EPS_COLOR)
        coef = (m * half_delta_over3 / denom) / n
        a11 = a11 + _channel_sum(coef * ix * ix)
        b1 = b1 - _channel_sum(coef * iz * ix)
        if nop == 2:
            a12 = a12 + _channel_sum(coef * ix * iy)
            a22 = a22 + _channel_sum(coef * iy * iy)
            b2 = b2 - _channel_sum(coef * iz * iy)
    n1 = ixx * ixx + ixy * ixy + DATANORM
    n2 = iyy * iyy + ixy * ixy + DATANORM
    t1 = ixz + ixx * du3 + (ixy * dv3 if nop == 2 else 0.0)
    t2 = iyz + ixy * du3 + (iyy * dv3 if nop == 2 else 0.0)
    if c == 1:
        denom = torch.sqrt(3.0 * t1 * t1 / n1 + 3.0 * t2 * t2 / n2 + EPS_GRAD)
    else:
        denom = torch.sqrt(_channel_sum(t1 * t1 / n1 + t2 * t2 / n2)[..., None] + EPS_GRAD)
    t = m * half_gamma_over3 / denom
    c1, c2 = t / n1, t / n2
    a11 = a11 + _channel_sum(c1 * ixx * ixx + c2 * ixy * ixy)
    b1 = b1 - _channel_sum(c1 * ixx * ixz + c2 * ixy * iyz)
    if nop == 2:
        a12 = a12 + _channel_sum(c1 * ixx * ixy + c2 * ixy * iyy)
        a22 = a22 + _channel_sum(c2 * iyy * iyy + c1 * ixy * ixy)
        b2 = b2 - _channel_sum(c2 * iyy * iyz + c1 * ixy * ixz)
    if c == 1:  # x3, so the smoothing weights match the RGB path (opticalflow_aux.c:420-427)
        a11, a12, a22, b1, b2 = 3 * a11, 3 * a12, 3 * a22, 3 * b1, 3 * b2
    return a11, a12, a22, b1, b2


def _red(h: int, w: int, device) -> torch.Tensor:
    return (torch.arange(w, device=device)[None, :] + torch.arange(h, device=device)[:, None]) % 2 == 0


def _neighbours(x, wh, wv):
    return _up(wv * x) + _left(wh * x) + wv * _down(x) + wh * _right(x)


def sor_coupled(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations: int, omega: float):
    """Red-black SOR on the coupled 2x2 system; within a colour du first,
    then dv with the new du (solver.c:19-72)."""
    red = _red(*du.shape[-2:], du.device)
    sum_w = _up(wv) + _left(wh) + wv + wh
    inv11, inv22 = _over(omega, a11 + sum_w), _over(omega, a22 + sum_w)

    def half(du, dv, colour):
        du = torch.where(colour, (1.0 - omega) * du + inv11 * (b1 + _neighbours(du, wh, wv) - a12 * dv), du)
        dv = torch.where(colour, (1.0 - omega) * dv + inv22 * (b2 + _neighbours(dv, wh, wv) - a12 * du), dv)
        return du, dv

    for _ in range(iterations):
        du, dv = half(du, dv, red)
        du, dv = half(du, dv, ~red)
    return du, dv


def sor_scalar(du, a11, b1, wh, wv, iterations: int, omega: float):
    """Red-black SOR on the scalar system (solver.c:428-466)."""
    red = _red(*du.shape[-2:], du.device)
    inv = _over(omega, a11 + _up(wv) + _left(wh) + wv + wh)
    for _ in range(iterations):
        for colour in (red, ~red):
            du = torch.where(colour, (1.0 - omega) * du + inv * (b1 + _neighbours(du, wh, wv)), du)
    return du


def refine_level(flow, im1, im2, level: int, p: Params, camlr: int):
    """One level's refinement of (B, h, w, nop) flow on the unpadded level
    images (RefLevelOF / RefLevelDE, refine_variational.cpp:152-336)."""
    n_inner = p.tv_innerit * (level + 1)
    qa = 0.25 * p.tv_alpha
    hd3 = p.tv_delta * 0.5 / 3.0
    hg3 = p.tv_gamma * 0.5 / 3.0
    wx = flow[..., 0].contiguous()
    if p.nop == 2:
        wy = flow[..., 1].contiguous()
        im2w, mask = image_warp(im2, wx, wy)
        derivs = derivatives(im1, im2w)
        du, dv = torch.zeros_like(wx), torch.zeros_like(wx)
        uu, vv = wx, wy
        for _ in range(n_inner):
            wh, wv = smoothness(uu, vv, qa)
            a11, a12, a22, b1, b2 = data_term(du, dv, mask, derivs, hd3, hg3, 2)
            b1 = sub_laplacian(b1, wx, wh, wv)
            b2 = sub_laplacian(b2, wy, wh, wv)
            du, dv = sor_coupled(du, dv, a11, a12, a22, b1, b2, wh, wv, p.tv_solverit, p.tv_sor)
            uu, vv = wx + du, wy + dv
        return torch.stack([uu, vv], dim=-1)
    zero = torch.zeros_like(wx)
    im2w, mask = image_warp(im2, wx, zero)
    derivs = derivatives(im1, im2w)
    du, uu = zero, wx
    for _ in range(n_inner):
        wh, wv = smoothness(uu, zero, qa)
        a11, _, _, b1, _ = data_term(du, zero, mask, derivs, hd3, hg3, 1)
        b1 = sub_laplacian(b1, wx, wh, wv)
        du = sor_scalar(du, a11, b1, wh, wv, p.tv_solverit, p.tv_sor)
        uu = (wx + du).clamp(max=0.0) if camlr == 0 else (wx + du).clamp(min=0.0)
    return uu[..., None]
