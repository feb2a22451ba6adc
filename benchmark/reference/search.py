"""The patch grid and the inverse-compositional Gauss-Newton patch search
(DIS steps 2-3: PatGridClass, patchgrid.cpp:31-211; PatClass,
patch.cpp:57-402).

All N patches of a level are one axis, and a batch of B pairs makes it
B*N.  The reference's per-patch loop that stops early becomes a fixed
`max_iter + 1`-trip loop whose updates a per-patch convergence flag masks.
A patch never moves more than psz/2 from its start (the outlier reset), so
its bilinear taps lie in a (2 psz + 2)^2 window around the start; taps
outside that window read 0.  Every sum over a patch is taken in one fixed
order (channels per pixel, a butterfly over groups of 32 pixels, then the
groups), and a division by a constant is one true division.

Where a patch's start is already out of bounds, its weight is |loss of the
template| instead of the upstream code's uninitialised memory
(patch.cpp:135-141).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .params import Params


class Geometry(NamedTuple):
    w: int
    h: int
    nopw: int
    noph: int
    n_patches: int
    pt_ref: np.ndarray      # (N, 2) float32 patch centres (x, y), i = x * noph + y
    coarse_idx: np.ndarray  # (N,) flat index into the (h // 2, w // 2) coarser flow


def geometry(w: int, h: int, p: Params) -> Geometry:
    """Patch centres on a grid of spacing `steps`, centred in the level
    (patchgrid.cpp:42-75), and the coarser-flow lookup of each
    (patchgrid.cpp:195-211), clamped where a level side is odd."""
    steps = p.steps
    nopw, noph = int(math.ceil(w / steps)), int(math.ceil(h / steps))
    offw = int(math.floor((w - (nopw - 1) * steps) / 2))
    offh = int(math.floor((h - (noph - 1) * steps) / 2))
    px = np.repeat(np.arange(nopw) * steps + offw, noph)
    py = np.tile(np.arange(noph) * steps + offh, nopw)
    pt_ref = np.stack([px, py], axis=1).astype(np.float32)
    cw, ch = max(w // 2, 1), max(h // 2, 1)
    cx = np.minimum((pt_ref[:, 0] // 2).astype(np.int64), cw - 1)
    cy = np.minimum((pt_ref[:, 1] // 2).astype(np.int64), ch - 1)
    return Geometry(w, h, nopw, noph, nopw * noph, pt_ref, cy * cw + cx)


class Result(NamedTuple):
    p: torch.Tensor        # (B, N, nop) displacement
    absw: torch.Tensor     # (B, N, psz * psz) densification weights


def patch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each patch (..., psz, psz, C) -> (...), in the fixed order."""
    lead, psz, c = x.shape[:-3], x.shape[-3], x.shape[-1]
    v = x[..., 0]
    for k in range(1, c):
        v = v + x[..., k]
    npix = psz * psz
    nt = -(-npix // 32) * 32
    v = F.pad(v.reshape(*lead, npix), (0, nt - npix)).reshape(*lead, nt // 32, 32)
    for half in (16, 8, 4, 2, 1):
        v = v[..., :half] + v[..., half:2 * half]
    s = v[..., 0, 0]
    for q in range(1, nt // 32):
        s = s + v[..., q, 0]
    return s


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (B, Hp, Wp, C) flattened over its pixels, at flat indices idx
    (P, a, b) -> (P, a, b, C)."""
    c = img.shape[-1]
    return img.reshape(-1, c)[idx.reshape(-1)].reshape(idx.shape + (c,))


def _pair_base(img: torch.Tensor, n: int) -> torch.Tensor:
    hp, wp = img.shape[-3:-1]
    return torch.arange(img.shape[0], device=img.device).repeat_interleave(n) * (hp * wp)


def _param_to_pt(pt_ref, p, nop: int):
    if nop == 2:
        return pt_ref + p
    return torch.stack([pt_ref[:, 0] + p[:, 0], pt_ref[:, 1]], dim=1)


def _out_of_bounds(pt, w: int, h: int, psz: int):
    lb = -float(psz) / 2.0
    return ((pt[:, 0] < lb) | (pt[:, 1] < lb) | (pt[:, 0] > float(w + psz // 2 - 2))
            | (pt[:, 1] > float(h + psz // 2 - 2)))


def templates(im_a, dx_a, dy_a, pt_ref, p: Params, pad: int):
    """Templates, their gradients and the Hessian of every patch
    (InitializePatch, patch.cpp:57-88): (B, N, psz, psz, C) x 3 and (B, N, 3)
    for flow, (B, N, 1) for stereo."""
    psz = p.patch_size
    lb = -(psz // 2)
    n = pt_ref.shape[0]
    jj = torch.arange(psz, device=im_a.device)
    cy = torch.floor(pt_ref[:, 1] + 0.5).long() + (pad + lb)
    cx = torch.floor(pt_ref[:, 0] + 0.5).long() + (pad + lb)
    idx = (cy[:, None] + jj)[:, :, None] * im_a.shape[-2] + (cx[:, None] + jj)[:, None, :]
    idx = idx.repeat(im_a.shape[0], 1, 1) + _pair_base(im_a, n)[:, None, None]
    tmp, dx, dy = (_gather(a, idx).reshape(a.shape[0], n, psz, psz, a.shape[-1])
                   for a in (im_a, dx_a, dy_a))
    if p.patch_norm:
        tmp = tmp - _div(patch_sum(tmp), p.novals)[..., None, None, None]
    h00 = patch_sum(dx * dx)
    if p.nop == 2:
        h01 = patch_sum(dx * dy)
        h11 = patch_sum(dy * dy)
        det = h00 * h11 - h01 * h01
        bump = torch.where(det == 0.0, 1e-10, 0.0).to(det.dtype)
        hes = torch.stack([h00 + bump, h01, h11 + bump], dim=-1)
    else:
        bump = torch.where(h00 == 0.0, 1e-10, 0.0).to(h00.dtype)
        hes = (h00 + bump)[..., None]
    return tmp, dx, dy, hes


def search(im_a, dx_a, dy_a, im_b, pt_ref, p_init, p: Params, w: int, h: int, pad: int,
           camlr: int) -> Result:
    """One level's search of B pairs (PatClass::OptimizeStart, OptimizeIter,
    OptimizeComputeErrImg, patch.cpp:119-284); trip 0 is OptimizeStart
    (delta_p 0, no clamp or reset).  camlr picks the stereo sign clamp."""
    T, tdx, tdy, hes = templates(im_a, dx_a, dy_a, pt_ref, p, pad)
    psz, nop, dt = p.patch_size, p.nop, im_b.dtype
    novals = float(p.novals)
    n_pt = pt_ref.shape[0]
    pair0 = _pair_base(im_b, n_pt)
    n = pair0.shape[0]
    hp, wp = im_b.shape[-3:-1]
    dev = im_b.device
    lb = -(psz // 2)
    sy, sx = min(2 * psz + 2, hp), min(2 * psz + 2, wp)
    T = T.reshape(n, psz, psz, -1)
    tdx = tdx.reshape(T.shape)
    tdy = tdy.reshape(T.shape)
    hes = hes.reshape(n, -1)
    pt_ref = pt_ref.repeat(im_b.shape[0], 1)
    if nop == 2:
        h00, h01, h11 = hes[:, 0], hes[:, 1], hes[:, 2]
        det = h00 * h11 - h01 * h01
    else:
        h00 = hes[:, 0]

    p_in = p_init.reshape(n, nop)
    pt_st = _param_to_pt(pt_ref, p_in, nop)
    oob0 = _out_of_bounds(pt_st, w, h, psz)
    by = (torch.floor(pt_st[:, 1]).long() + lb - psz // 2 + pad).clamp(0, hp - sy)
    bx = (torch.floor(pt_st[:, 0]).long() + lb - psz // 2 + pad).clamp(0, wp - sx)
    jj = torch.arange(psz, device=dev)

    def taps(o, base, size):
        t0 = o[:, None] + jj
        t1 = t0 + 1
        m0 = ((t0 >= 0) & (t0 < size)).to(dt)
        m1 = ((t1 >= 0) & (t1 < size)).to(dt)
        return base[:, None] + t0.clamp(0, size - 1), m0, base[:, None] + t1.clamp(0, size - 1), m1

    def extract(pt):
        """Bilinear patch at pt (getPatchStaticBil, patch.cpp:334-402): rows
        blended first, then columns."""
        fy, fx = torch.floor(pt[:, 1]), torch.floor(pt[:, 0])
        ry = (pt[:, 1] - fy)[:, None, None, None]
        rx = (pt[:, 0] - fx)[:, None, None, None]
        y0, my0, y1, my1 = taps(fy.long() + lb + pad - by, by, sy)
        x0, mx0, x1, mx1 = taps(fx.long() + lb + pad - bx, bx, sx)

        def tap(yy, my, xx, mx):
            m = (my[:, :, None] * mx[:, None, :])[..., None]
            idx = yy[:, :, None] * wp + xx[:, None, :] + pair0[:, None, None]
            return _gather(im_b, idx) * m

        col0 = (1.0 - ry) * tap(y0, my0, x0, mx0) + ry * tap(y1, my1, x0, mx0)
        col1 = (1.0 - ry) * tap(y0, my0, x1, mx1) + ry * tap(y1, my1, x1, mx1)
        return (1.0 - rx) * col0 + rx * col1

    def bcast(v):
        return v[:, None, None, None]

    def residual(pt):
        """The L2 residual and its magnitude, the weight image
        (patch.cpp:223-262)."""
        raw = extract(pt)
        if p.patch_norm:
            raw = raw - bcast(_div(patch_sum(raw), novals))
        return raw - T, torch.abs(raw - T)

    tmpl_pd, tmpl_pw = T, torch.abs(T)
    dp_thresh_sq = p.dp_thresh * p.dp_thresh
    outlier_sq = p.outlier_thresh * p.outlier_thresh
    fd = dict(dtype=dt, device=dev)
    p_iter = p_in
    pweight = torch.zeros_like(T)
    pdiff = torch.zeros_like(T)
    mares = torch.full((n,), 1e5, **fd)
    dpsq_init = torch.full((n,), 1e-10, **fd)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    converged = torch.zeros((n,), dtype=torch.bool, device=dev)

    for trip in range(p.max_iter + 1):
        first = trip == 0
        active = ~converged
        cnt_n = torch.zeros_like(cnt) if first else cnt + 1
        if first:
            delta_p = torch.zeros_like(p_iter)
        else:
            b0 = patch_sum(tdx * pdiff)
            if nop == 2:
                b1 = patch_sum(tdy * pdiff)
                delta_p = torch.stack([(h11 * b0 - h01 * b1) / det, (h00 * b1 - h01 * b0) / det],
                                      dim=1)
            else:
                delta_p = (b0 / h00)[:, None]
        p_new = p_iter - delta_p
        if p.mode == "stereo" and not first:  # disparity sign clamp (patch.cpp:188-193)
            p_new = p_new.clamp(max=0.0) if camlr == 0 else p_new.clamp(min=0.0)
        pt_new = _param_to_pt(pt_ref, p_new, nop)
        if first:
            reset = torch.zeros_like(converged)
        else:  # outlier and bounds reset (patch.cpp:198-208)
            moved = ((pt_st - pt_new) ** 2).sum(dim=1) > outlier_sq
            reset = moved | _out_of_bounds(pt_new, w, h, psz)
            p_new = torch.where(reset[:, None], p_in, p_new)
            pt_new = _param_to_pt(pt_ref, p_new, nop)

        pd_new, pw_new = residual(pt_new)
        if first:
            m0 = oob0[:, None, None, None]
            pd_new = torch.where(m0, tmpl_pd, pd_new)
            pw_new = torch.where(m0, tmpl_pw, pw_new)
            dpsq_n = torch.full((n,), 1e-10, **fd)
            mares_old_n = torch.full((n,), 1e5, **fd)
        else:
            dpsq_n = (delta_p * delta_p).sum(dim=1)
            mares_old_n = mares
        dpsq_init_n = torch.where(cnt_n == 1, dpsq_n, dpsq_init)
        mares_n = _div(patch_sum(pw_new), novals)
        oob_start = oob0 if first else torch.zeros_like(oob0)
        mares_n = torch.where(oob_start, 1e5, mares_n)
        keep_going = (
            (cnt_n < p.max_iter)
            & (mares_n > p.res_thresh)
            & ((cnt_n < p.min_iter) | (dpsq_n / dpsq_init_n >= dp_thresh_sq))
            & ((cnt_n < p.min_iter) | (mares_n / mares_old_n <= p.dr_thresh))
        )
        conv_n = converged | reset | ~keep_going | oob_start
        a1, a4 = active[:, None], active[:, None, None, None]
        p_iter = torch.where(a1, p_new, p_iter)
        pdiff = torch.where(a4, pd_new, pdiff)
        pweight = torch.where(a4, pw_new, pweight)
        mares = torch.where(active, mares_n, mares)
        dpsq_init = torch.where(active, dpsq_init_n, dpsq_init)
        cnt = torch.where(active, cnt_n, cnt)
        converged = torch.where(active, conv_n, converged)

    # Densification weights per footprint pixel (patchgrid.cpp:253-260).
    b = im_b.shape[0]
    pw = torch.clamp(pweight, min=p.minerrval)
    s = pw[..., 0]
    for k in range(1, pw.shape[-1]):
        s = s + pw[..., k]
    return Result(p=p_iter.reshape(b, n_pt, nop), absw=(1.0 / s).reshape(b, n_pt, psz * psz))
