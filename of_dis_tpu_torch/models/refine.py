"""Variational (TV) refinement — DIS step 5, PyTorch port of
of_dis_tpu/models/refine.py (VarRefClass, refine_variational.cpp, over the
FDF1.0.1 C kernels opticalflow_aux.c and solver.c):

  - bilinear backward warp + validity mask        (opticalflow_aux.c:16-60),
    as the direct 4-tap gather
  - 5-tap derivative filter {1,-8,0,8,-1}/12 and 3-tap flow derivative
    {-0.5,0,0.5}, replicate borders               (refine_variational.cpp:45-48)
  - TV diffusivity + neighbour-sum edge weights   (opticalflow_aux.c:119-165)
  - data term (colour + gradient constancy, datanorm=0.01, eps=1e-6, x3
    single-channel compensation)                  (opticalflow_aux.c:306-548)
  - weighted-Laplacian RHS update                 (opticalflow_aux.c:171-199)
  - red-black coupled SOR (solver.c:19-72 is the numeric spec)

For flow (nop = 2) the whole inner loop of a level runs in one CUDA kernel
on the card (csrc/refine_inner.cu via ops/kernels.py::refine_inner); the
step functions compose its plain version, `refine_inner_reference`.  For
stereo (nop = 1, RefLevelDE) the steps run as PyTorch ops and the scalar SOR
as a CUDA kernel (csrc/sor_rb.cu via ops/kernels.py::sor_scalar), whose
plain version is `sor_scalar_rb`; after each inner iteration the disparity
is clamped to the camera's sign.

Inner-iteration count scales with pyramid level: n_inner = tv_innerit *
(level+1) (refine_variational.cpp:36).

Fields are (..., h, w) and images (..., h, w, C): leading dims are a batch
of image pairs, and every step counts its axes from the end.
"""

from __future__ import annotations

import math

import torch

from ..config import DISConfig
from ..ops import kernels

DATANORM = 0.1 * 0.1          # opticalflow_aux.c:10
EPS_COLOR = 0.001 * 0.001     # opticalflow_aux.c:11
EPS_GRAD = 0.001 * 0.001
EPS_SMOOTH = 0.001 * 0.001


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t rounded as one division, as the kernels divide (PyTorch takes a
    Python scalar over a tensor as reciprocal(t) * c, which rounds twice)."""
    return torch.full((), float(c), dtype=t.dtype, device=t.device) / t


# ---------------------------------------------------------------------------
# Shifts with zero fill (borders carry zero weights by construction)
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, dim: int, from_before: bool) -> torch.Tensor:
    n = x.shape[dim]
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    if from_before:
        return torch.cat([zero, x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), zero], dim)


def _up(x):     # x[j-1, i]
    return _shift(x, -2, True)


def _down(x):   # x[j+1, i]
    return _shift(x, -2, False)


def _left(x):   # x[j, i-1]
    return _shift(x, -1, True)


def _right(x):  # x[j, i+1]
    return _shift(x, -1, False)


# ---------------------------------------------------------------------------
# Convolutions (replicate borders, matching the FDF fast paths)
# ---------------------------------------------------------------------------

def _edge_taps(n: int, r: int, device) -> torch.Tensor:
    return torch.arange(-r, n + r, device=device).clamp_(0, n - 1)


def _conv(img: torch.Tensor, coeffs, dim: int) -> torch.Tensor:
    """1-D convolution along axis `dim` (counted from the end), dst[x] =
    sum_k c[k] src[x+k-r], replicate borders."""
    r = len(coeffs) // 2
    n = img.shape[dim]
    p = img.index_select(dim, _edge_taps(n, r, img.device))
    out = torch.zeros_like(img)
    for k, c in enumerate(coeffs):
        if c != 0.0:
            out = out + c * p.narrow(dim, k, n)
    return out


# The x and y axes of a field (..., h, w) and of an image (..., h, w, C).
FIELD_XY = (-1, -2)
IMAGE_XY = (-2, -3)


# {1, -8, 0, 8, -1}/12 (refine_variational.cpp:45-46).
DERIV5 = (1.0 / 12.0, -8.0 / 12.0, 0.0, 8.0 / 12.0, -1.0 / 12.0)
# {-0.5, 0, 0.5} (refine_variational.cpp:47-48).
DERIV3 = (-0.5, 0.0, 0.5)


# ---------------------------------------------------------------------------
# Warp + derivatives
# ---------------------------------------------------------------------------

def image_warp(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Bilinear backward warp with clamp-to-edge taps and in-bounds mask
    (image_warp, opticalflow_aux.c:16-60).  src (..., h, w, C); wx, wy
    (..., h, w); each pair's taps read its own image."""
    h, w, c = src.shape[-3:]
    dev = src.device
    jj = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    ii = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    xx = ii + wx
    yy = jj + wy
    x = torch.floor(xx)
    y = torch.floor(yy)
    mask = ((xx >= 0.0) & (xx <= w - 1.0) & (yy >= 0.0) & (yy <= h - 1.0)).float()
    xi = x.long()
    yi = y.long()
    x1 = xi.clamp(0, w - 1)
    x2 = (xi + 1).clamp(0, w - 1)
    y1 = yi.clamp(0, h - 1)
    y2 = (yi + 1).clamp(0, h - 1)
    dx = (xx - x)[..., None]
    dy = (yy - y)[..., None]
    flat = src.reshape(-1, c)
    pair0 = (torch.arange(math.prod(src.shape[:-3]), device=dev) * (h * w)).reshape(
        src.shape[:-3] + (1, 1))  # first pixel of each pair's image
    y1 = y1 * w + pair0
    y2 = y2 * w + pair0
    dst = (
        flat[y1 + x1] * (1 - dx) * (1 - dy)
        + flat[y1 + x2] * dx * (1 - dy)
        + flat[y2 + x1] * (1 - dx) * dy
        + flat[y2 + x2] * dx * dy
    )
    return dst, mask


def get_derivatives(im1: torch.Tensor, im2w: torch.Tensor):
    """First/second spatio-temporal derivatives on the mean image
    (get_derivatives, opticalflow_aux.c:63-116)."""
    mean = 0.5 * (im1 + im2w)
    iz = im2w - im1
    x, y = IMAGE_XY
    ix = _conv(mean, DERIV5, x)
    iy = _conv(mean, DERIV5, y)
    ixx = _conv(ix, DERIV5, x)
    ixy = _conv(ix, DERIV5, y)
    iyy = _conv(iy, DERIV5, y)
    ixz = _conv(iz, DERIV5, x)
    iyz = _conv(iz, DERIV5, y)
    return ix, iy, iz, ixx, ixy, iyy, ixz, iyz


# ---------------------------------------------------------------------------
# Smoothness + RHS
# ---------------------------------------------------------------------------

def compute_smoothness(uu, vv, quarter_alpha: float):
    """TV diffusivity edge weights (compute_smoothness, opticalflow_aux.c:119-165).

    Returns (horiz, vert): horiz[j,i] couples (j,i)<->(j,i+1) (last col 0),
    vert[j,i] couples (j,i)<->(j+1,i) (last row 0).  qa / sqrt(...) is one
    true division, as in the TPU and CUDA kernels."""
    x, y = FIELD_XY
    ux = _conv(uu, DERIV3, x)
    uy = _conv(uu, DERIV3, y)
    vx = _conv(vv, DERIV3, x)
    vy = _conv(vv, DERIV3, y)
    s = _over(quarter_alpha, torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + EPS_SMOOTH))
    horiz = s + _right(s)
    horiz[..., -1] = 0.0
    vert = s + _down(s)
    vert[..., -1, :] = 0.0
    return horiz, vert


def sub_laplacian(b, src, wh, wv):
    """b += div(w * grad(src)) (sub_laplacian, opticalflow_aux.c:171-199)."""
    th = wh * (_right(src) - src)   # zero at last col since wh there is 0
    tv = wv * (_down(src) - src)
    return b + th - _left(th) + tv - _up(tv)


# ---------------------------------------------------------------------------
# Data term
# ---------------------------------------------------------------------------

def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over its last (channel) axis in channel order, as the
    refine-inner kernel adds."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def compute_data(du, dv, mask, derivs, half_delta_over3: float,
                 half_gamma_over3: float, nop: int):
    """Per-pixel system (a11, a12, a22, b1, b2) — compute_data
    (opticalflow_aux.c:306-438) and compute_data_DE (:442-548, nop == 1,
    where dv contributions vanish and only a11/b1 are kept).

    derivs are (..., h, w, C); du/dv/mask (..., h, w)."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = derivs
    c = ix.shape[-1]
    du3 = du[..., None]
    dv3 = dv[..., None] if nop == 2 else None
    m = mask[..., None]
    z = torch.zeros_like(du)
    a11, a12, a22, b1, b2 = z, z, z, z, z

    # --- colour constancy ---
    if half_delta_over3:
        t = iz + ix * du3 + (iy * dv3 if nop == 2 else 0.0)
        n = ix * ix + iy * iy + DATANORM
        if c == 1:
            denom = torch.sqrt(3.0 * t * t / n + EPS_COLOR)
        else:
            denom = torch.sqrt(_channel_sum(t * t / n)[..., None] + EPS_COLOR)
        coef = (m * half_delta_over3 / denom) / n  # (h, w, C)
        a11 = a11 + _channel_sum(coef * ix * ix)
        b1 = b1 - _channel_sum(coef * iz * ix)
        if nop == 2:
            a12 = a12 + _channel_sum(coef * ix * iy)
            a22 = a22 + _channel_sum(coef * iy * iy)
            b2 = b2 - _channel_sum(coef * iz * iy)

    # --- gradient constancy ---
    n1 = ixx * ixx + ixy * ixy + DATANORM
    n2 = iyy * iyy + ixy * ixy + DATANORM
    t1 = ixz + ixx * du3 + (ixy * dv3 if nop == 2 else 0.0)
    t2 = iyz + ixy * du3 + (iyy * dv3 if nop == 2 else 0.0)
    if c == 1:
        denom = torch.sqrt(3.0 * t1 * t1 / n1 + 3.0 * t2 * t2 / n2 + EPS_GRAD)
    else:
        denom = torch.sqrt(
            _channel_sum(t1 * t1 / n1 + t2 * t2 / n2)[..., None] + EPS_GRAD
        )
    t = m * half_gamma_over3 / denom
    c1 = t / n1
    c2 = t / n2
    a11 = a11 + _channel_sum(c1 * ixx * ixx + c2 * ixy * ixy)
    b1 = b1 - _channel_sum(c1 * ixx * ixz + c2 * ixy * iyz)
    if nop == 2:
        a12 = a12 + _channel_sum(c1 * ixx * ixy + c2 * ixy * iyy)
        a22 = a22 + _channel_sum(c2 * iyy * iyy + c1 * ixy * ixy)
        b2 = b2 - _channel_sum(c2 * iyy * iyz + c1 * ixy * ixz)

    if c == 1:
        # x3 so smoothing weights match the RGB path (opticalflow_aux.c:420-427).
        a11, a12, a22, b1, b2 = 3 * a11, 3 * a12, 3 * a22, 3 * b1, 3 * b2
    return a11, a12, a22, b1, b2


# ---------------------------------------------------------------------------
# Red-black SOR
# ---------------------------------------------------------------------------

def _checkerboard(h: int, w: int, device) -> torch.Tensor:
    """(h, w) red mask, (x + y) % 2 == 0; broadcasts over a batch."""
    jj = torch.arange(h, device=device)[:, None]
    ii = torch.arange(w, device=device)[None, :]
    return (ii + jj) % 2 == 0


def sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations: int, omega: float):
    """Coupled red-black SOR on the 5-point system (numeric spec:
    sor_coupled_slow_but_readable, solver.c:19-72).  Within a colour, du is
    updated first and dv uses the new du, exactly like the reference.  The
    plain version of the sor_coupled kernel (csrc/sor_rb.cu), rounded as the
    TPU kernel rounds (of_dis_tpu/ops/pallas_kernels.py:69-82): the weights
    summed first, then omega / (a11 + sum) and omega / (a22 + sum), each one
    true division, so the two agree bit for bit."""
    h, w = du.shape[-2:]
    red = _checkerboard(h, w, du.device)
    sum_dpsis = _up(wv) + _left(wh) + wv + wh
    inv11 = _over(omega, a11 + sum_dpsis)
    inv22 = _over(omega, a22 + sum_dpsis)

    def nb(x):
        return _up(wv * x) + _left(wh * x) + wv * _down(x) + wh * _right(x)

    def half_step(du, dv, color_mask):
        B1 = b1 + nb(du)
        du_new = (1.0 - omega) * du + inv11 * (B1 - a12 * dv)
        du = torch.where(color_mask, du_new, du)
        B2 = b2 + nb(dv)
        dv_new = (1.0 - omega) * dv + inv22 * (B2 - a12 * du)
        dv = torch.where(color_mask, dv_new, dv)
        return du, dv

    for _ in range(iterations):
        du, dv = half_step(du, dv, red)
        du, dv = half_step(du, dv, ~red)
    return du, dv


def sor_scalar_rb(du, a11, b1, wh, wv, iterations: int, omega: float):
    """Scalar red-black SOR (spec: sor_coupled_slow_but_readable_DE,
    solver.c:428-466).  The plain version of the sor_scalar kernel
    (csrc/sor_rb.cu), rounded as the TPU kernel rounds
    (of_dis_tpu/ops/pallas_kernels.py:1357-1365): omega / A11 first, then
    (1 - omega) du + that times B1.  omega / A11 is one true division, as
    the kernel divides, so the two agree bit for bit."""
    h, w = du.shape[-2:]
    red = _checkerboard(h, w, du.device)
    inv = _over(omega, a11 + _up(wv) + _left(wh) + wv + wh)

    def nb(x):
        return _up(wv * x) + _left(wh * x) + wv * _down(x) + wh * _right(x)

    def half_step(du, color_mask):
        return torch.where(color_mask, (1.0 - omega) * du + inv * (b1 + nb(du)), du)

    for _ in range(iterations):
        du = half_step(du, red)
        du = half_step(du, ~red)
    return du


# ---------------------------------------------------------------------------
# Inner loop (plain version of csrc/refine_inner.cu) + level driver
# ---------------------------------------------------------------------------

def refine_inner_reference(wx, wy, mask, derivs, n_inner: int, solver_it: int,
                           omega: float, qa: float, hd3: float, hg3: float):
    """Plain version of the refine-inner kernel: the step sequence of
    of_dis_tpu/models/refine.py:388-410 (nop = 2); fields (..., h, w),
    derivs (..., h, w, C)."""
    du = torch.zeros_like(wx)
    dv = torch.zeros_like(wx)
    uu, vv = wx, wy
    for _ in range(n_inner):
        wh, wv = compute_smoothness(uu, vv, qa)
        a11, a12, a22, b1, b2 = compute_data(du, dv, mask, derivs, hd3, hg3, 2)
        b1 = sub_laplacian(b1, wx, wh, wv)
        b2 = sub_laplacian(b2, wy, wh, wv)
        du, dv = sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv, solver_it, omega)
        uu = wx + du
        vv = wy + dv
    return uu, vv


def refine_level(
    flow: torch.Tensor,   # (..., h, w, nop)
    im1: torch.Tensor,    # (..., h, w, C) unpadded level images
    im2: torch.Tensor,
    level: int,
    cfg: DISConfig,
    camlr: int = 0,
) -> torch.Tensor:
    """One scale of variational refinement (RefLevelOF / RefLevelDE,
    refine_variational.cpp:152-336) of a batch of pairs.  camlr picks the
    stereo sign clamp."""
    n_inner = cfg.tv_innerit * (level + 1)   # refine_variational.cpp:36
    qa = 0.25 * cfg.tv_alpha
    hd3 = cfg.tv_delta * 0.5 / 3.0
    hg3 = cfg.tv_gamma * 0.5 / 3.0

    wx = flow[..., 0].contiguous()
    if cfg.nop == 2:
        wy = flow[..., 1].contiguous()
        im2w, mask = image_warp(im2, wx, wy)
        derivs = get_derivatives(im1, im2w)
        uu, vv = kernels.refine_inner(
            wx, wy, mask, derivs, n_inner, cfg.tv_solverit, cfg.tv_sor, qa, hd3, hg3
        )
        return torch.stack([uu, vv], dim=-1)

    # Stereo: a single field; the vertical flow is 0 throughout.
    zero = torch.zeros_like(wx)
    im2w, mask = image_warp(im2, wx, zero)
    derivs = get_derivatives(im1, im2w)
    du = zero
    uu = wx
    for _ in range(n_inner):
        wh, wv = compute_smoothness(uu, zero, qa)
        a11, _, _, b1, _ = compute_data(du, zero, mask, derivs, hd3, hg3, 1)
        b1 = sub_laplacian(b1, wx, wh, wv)
        du = kernels.sor_scalar(du, a11, b1, wh, wv, cfg.tv_solverit, cfg.tv_sor)
        # Disparity sign clamp (refine_variational.cpp:299-314).
        uu = (wx + du).clamp(max=0.0) if camlr == 0 else (wx + du).clamp(min=0.0)
    return uu[..., None]
