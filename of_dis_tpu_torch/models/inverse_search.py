"""Batched inverse-compositional Gauss-Newton patch search (DIS step 3),
PyTorch port of of_dis_tpu/models/inverse_search.py.

Patches are a batch axis: all N patches of a pyramid level live in (N, ...)
tensors, and a batch of image pairs adds a leading axis, (B, N, ...), with
the patch centres pt_ref (N, 2) shared (the grid depends only on the level's
shape).  The reference's per-patch early-exit loop (PatClass,
patch.cpp:119-284) becomes a fixed `max_iter + 1`-trip loop whose updates
are masked by a per-patch convergence flag.  A patch never moves more than
psz/2 from its start (outlier reset, patch.cpp:198-208), so every bilinear
tap it reads lies in a (2psz+2)^2 window around its start; taps are
gathered from the level image by indexing, with the window's bounds as the
mask, exactly as the JAX package's windowed extraction reads them.

`level_search_reference` (templates + `optimize_level` + densification
weights) is the plain version of the whole-level search, the spec that the
CUDA kernel csrc/level_search.cu (wrapper ops/kernels.py::level_search) is
held against; `gn_search_reference` (`optimize_level` over templates from
`build_templates`) is that of csrc/gn_search.cu (ops/kernels.py::gn_search).
Every sum over a patch (`_patch_sum`) is taken in the kernels' order, and
every division by a constant is a true division (`_div`), so a kernel and
its plain version round alike and agree bit for bit even over op4's 129 GN
trips, where a few-ULP difference can send a patch elsewhere; against the
JAX package they differ by reassociation only.

Deviation from the reference (documented, same as the JAX package): when a
patch's initial position is already out of bounds, pweight is defined as
|loss(template)| instead of the reference's uninitialised memory
(patch.cpp:135-141).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import DISConfig


class PatchTemplates(NamedTuple):
    """Per-patch template data computed once per level (patch.cpp:57-88).

    With `hes` None (the driver's form) tmp/dx/dy hold the padded level
    images instead: the level search extracts templates itself."""

    tmp: torch.Tensor    # (..., N, psz, psz, C) templates (mean-normalised if patch_norm)
    dx: torch.Tensor     # (..., N, psz, psz, C) x-gradients
    dy: torch.Tensor     # (..., N, psz, psz, C) y-gradients
    hes: Optional[torch.Tensor]  # (..., N, 3) [H00, H01, H11] flow, (..., N, 1) [H00] stereo


class SearchResult(NamedTuple):
    """Per patch, with the images' leading (batch) dims in front of N."""
    p: torch.Tensor          # (..., N, nop) final displacement parameters
    pt: torch.Tensor         # (..., N, 2) final query position (pt_ref + displacement)
    pweight: Optional[torch.Tensor]  # (..., N, psz, psz, C) |residual|, or None
                                     # when absw came back from the kernel
    converged: torch.Tensor  # (..., N) bool
    absw: Optional[torch.Tensor] = None   # (..., N, psz*psz) densification weights
    iters: Optional[torch.Tensor] = None  # (..., N) int32 GN iterations run


def _patch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each patch (..., psz, psz, C) -> (...), in the order of the
    CUDA kernels' WarpLayout::sum (csrc/gn_machine.cuh): channels per pixel,
    then a butterfly over each group of 32 pixels (zeros past psz^2), then
    the groups in order."""
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
    """x / d rounded as one division, as the kernels divide: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _loss(diff: torch.Tensor, cfg: DISConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual transform + weight image (LossComputeErrorImage,
    patch.cpp:223-262).  Returns (pdiff, pweight); pweight = |pdiff|."""
    if cfg.cost == 0:  # L2
        pd = diff
    elif cfg.cost == 1:  # L1: sign(d) * sqrt(|d|)  (v1.0.1-fixed formula)
        pd = torch.sign(diff) * torch.sqrt(torch.abs(diff))
    elif cfg.cost == 2:  # pseudo-Huber, b = normoutlier (oflow.h:63)
        bsq = cfg.normoutlier * cfg.normoutlier
        pd = torch.sign(diff) * torch.sqrt(
            2.0 * bsq * (torch.sqrt(1.0 + _div(diff * diff, bsq)) - 1.0)
        )
    else:
        raise ValueError(f"unhandled cost {cfg.cost}")
    return pd, torch.abs(pd)


def _patch_index(rows: torch.Tensor, cols: torch.Tensor, wp: int) -> torch.Tensor:
    """(N, psz) row and column indices -> (N, psz, psz) flat pixel indices."""
    return rows[:, :, None] * wp + cols[:, None, :]


def _gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (..., Hp, Wp, C) flattened over all its pixels, idx (P, a, b)
    flat pixel indices into it -> (P, a, b, C)."""
    c = img.shape[-1]
    return img.reshape(-1, c)[idx.reshape(-1)].reshape(idx.shape + (c,))


def _n_pairs(img: torch.Tensor) -> int:
    """Image pairs in a batch of images (..., Hp, Wp, C)."""
    return math.prod(img.shape[:-3])


def _pair_base(img: torch.Tensor, n: int) -> torch.Tensor:
    """(B*n,) flat index of the first pixel of each patch's image pair, for
    images (..., Hp, Wp, C) of B pairs with n patches each."""
    hp, wp = img.shape[-3:-1]
    pairs = torch.arange(_n_pairs(img), device=img.device)
    return pairs.repeat_interleave(n) * (hp * wp)


def build_templates(
    im_a: torch.Tensor,    # (..., Hp, Wp, C) padded reference images
    dx_a: torch.Tensor,
    dy_a: torch.Tensor,
    pt_ref: torch.Tensor,  # (N, 2)
    cfg: DISConfig,
    pad: int,
) -> PatchTemplates:
    """Template extraction + Hessian, once per level (InitializePatch,
    patch.cpp:57-88): integer windows at cy/cx = floor(pt + 0.5) + pad -
    psz/2.  Gradients are not mean-normalised; the Hessian uses the raw
    template gradients."""
    psz = cfg.patch_size
    lb = -(psz // 2)
    n = pt_ref.shape[0]
    jj = torch.arange(psz, device=im_a.device)
    cy = torch.floor(pt_ref[:, 1] + 0.5).long() + pad + lb
    cx = torch.floor(pt_ref[:, 0] + 0.5).long() + pad + lb
    idx = _patch_index(cy[:, None] + jj, cx[:, None] + jj, im_a.shape[-2])
    pairs = im_a.shape[:-3]
    idx = idx.repeat(_n_pairs(im_a), 1, 1) + _pair_base(im_a, n)[:, None, None]
    tmp, dx, dy = (_gather(a, idx).reshape(*pairs, n, psz, psz, a.shape[-1])
                   for a in (im_a, dx_a, dy_a))
    if cfg.patch_norm:  # patch.cpp:330-331
        tmp = tmp - _div(_patch_sum(tmp), cfg.novals)[..., None, None, None]
    h00 = _patch_sum(dx * dx)
    if cfg.nop == 2:
        h01 = _patch_sum(dx * dy)
        h11 = _patch_sum(dy * dy)
        # Singular guard: if det == 0, bump the diagonal (patch.cpp:78-82).
        det = h00 * h11 - h01 * h01
        bump = torch.where(det == 0.0, 1e-10, 0.0)
        hes = torch.stack([h00 + bump, h01, h11 + bump], dim=-1)
    else:
        bump = torch.where(h00 == 0.0, 1e-10, 0.0)
        hes = (h00 + bump)[..., None]
    return PatchTemplates(tmp=tmp, dx=dx, dy=dy, hes=hes)


def _param_to_pt(pt_ref: torch.Tensor, p: torch.Tensor, nop: int) -> torch.Tensor:
    """paramtopt (patch.cpp:214-221): flow moves (x, y); stereo moves x only."""
    if nop == 2:
        return pt_ref + p
    return torch.stack([pt_ref[:, 0] + p[:, 0], pt_ref[:, 1]], dim=1)


def _out_of_bounds(pt: torch.Tensor, w: int, h: int, psz: int) -> torch.Tensor:
    """Valid-region check with bounds tmp_lb = -psz/2, tmp_ub* = dim+psz/2-2
    (oflow.cpp:147-149, patch.cpp:135-136, 199-202)."""
    lb = -float(psz) / 2.0
    ubw = float(w + psz // 2 - 2)
    ubh = float(h + psz // 2 - 2)
    return (pt[:, 0] < lb) | (pt[:, 1] < lb) | (pt[:, 0] > ubw) | (pt[:, 1] > ubh)


def optimize_level(
    im_b: torch.Tensor,     # (..., Hp, Wp, C) padded target images
    tmpl: PatchTemplates,
    pt_ref: torch.Tensor,   # (N, 2), shared by the batch
    p_init: torch.Tensor,   # (..., N, nop)
    cfg: DISConfig,
    w: int,
    h: int,
    pad: int,
    camlr: Optional[int] = None,
) -> SearchResult:
    """Run all patches of one level to convergence (PatClass::OptimizeIter +
    OptimizeStart + OptimizeComputeErrImg, patch.cpp:119-284) as a fixed
    `max_iter + 1`-trip loop with per-patch masking.  Trip 0 is
    OptimizeStart: delta_p forced to 0, no clamp or reset.  The patches of
    every pair run as one flat axis of B*N; a patch gathers from its own
    pair's image.

    camlr overrides cfg.camlr for the stereo sign clamp."""
    if camlr is None:
        camlr = cfg.camlr
    psz = cfg.patch_size
    nop = cfg.nop
    novals = float(cfg.novals)
    pairs = im_b.shape[:-3]
    n_pt = pt_ref.shape[0]
    pair0 = _pair_base(im_b, n_pt)  # first pixel of each patch's pair
    n = pair0.shape[0]
    hp, wp = im_b.shape[-3:-1]
    dev = im_b.device
    lb = -(psz // 2)
    sy = min(2 * psz + 2, hp)
    sx = min(2 * psz + 2, wp)
    T = tmpl.tmp.reshape(n, psz, psz, -1)
    tdx = tmpl.dx.reshape(T.shape)
    tdy = tmpl.dy.reshape(T.shape)
    hes = tmpl.hes.reshape(n, -1)
    pt_ref = pt_ref.repeat(_n_pairs(im_b), 1)

    if nop == 2:
        h00, h01, h11 = hes[:, 0], hes[:, 1], hes[:, 2]
        det = h00 * h11 - h01 * h01
    else:
        h00 = hes[:, 0]

    p_in = p_init.reshape(n, nop)
    pt_st = _param_to_pt(pt_ref, p_in, nop)
    oob0 = _out_of_bounds(pt_st, w, h, psz)
    # Window bases (padded coords), clipped into the image.
    by = (torch.floor(pt_st[:, 1]).long() + lb - psz // 2 + pad).clamp(0, hp - sy)
    bx = (torch.floor(pt_st[:, 0]).long() + lb - psz // 2 + pad).clamp(0, wp - sx)
    jj = torch.arange(psz, device=dev)

    def taps(o, base, size):
        """Window-relative tap rows (or columns) o+j and o+j+1 -> absolute
        indices clamped into the window, and their in-window masks."""
        t0 = o[:, None] + jj
        t1 = t0 + 1
        m0 = ((t0 >= 0) & (t0 < size)).float()
        m1 = ((t1 >= 0) & (t1 < size)).float()
        return (base[:, None] + t0.clamp(0, size - 1), m0,
                base[:, None] + t1.clamp(0, size - 1), m1)

    def extract(pt):
        """Bilinear patch at pt (getPatchStaticBil, patch.cpp:334-402):
        blend rows first, then columns; taps outside the window read 0."""
        fy = torch.floor(pt[:, 1])
        fx = torch.floor(pt[:, 0])
        ry = (pt[:, 1] - fy)[:, None, None, None]
        rx = (pt[:, 0] - fx)[:, None, None, None]
        oy = fy.long() + lb + pad - by
        ox = fx.long() + lb + pad - bx
        y0, my0, y1, my1 = taps(oy, by, sy)
        x0, mx0, x1, mx1 = taps(ox, bx, sx)

        def tap(yy, my, xx, mx):
            m = (my[:, :, None] * mx[:, None, :])[..., None]
            return _gather(im_b, _patch_index(yy, xx, wp) + pair0[:, None, None]) * m

        col0 = (1.0 - ry) * tap(y0, my0, x0, mx0) + ry * tap(y1, my1, x0, mx0)
        col1 = (1.0 - ry) * tap(y0, my0, x1, mx1) + ry * tap(y1, my1, x1, mx1)
        return (1.0 - rx) * col0 + rx * col1  # (N, psz_j, psz_i, C)

    def bcast(v):  # (N,) -> (N, 1, 1, 1)
        return v[:, None, None, None]

    if cfg.cost == 10:
        tn = bcast(torch.sqrt(_patch_sum(T * T)))

    def residual(pt):
        raw = extract(pt)
        if cfg.patch_norm:
            raw = raw - bcast(_div(_patch_sum(raw), novals))
        if cfg.cost == 10:
            # Real NCC-style cost (README's costfct 10 — a silent no-op in
            # the reference, patch.cpp:230-262).
            rn = bcast(torch.sqrt(_patch_sum(raw * raw)))
            diff = raw * (tn / torch.clamp(rn, min=1e-10)) - T
            return diff, torch.abs(diff)
        return _loss(raw - T, cfg)

    tmpl_pd, tmpl_pw = (T, torch.abs(T)) if cfg.cost == 10 else _loss(T, cfg)
    dp_thresh_sq = cfg.dp_thresh * cfg.dp_thresh  # squared once (oflow.cpp:88)
    outlier_sq = cfg.outlier_thresh * cfg.outlier_thresh

    f32 = dict(dtype=torch.float32, device=dev)
    p_iter = p_in
    pt_iter = pt_st
    pweight = torch.zeros_like(T)
    pdiff = torch.zeros_like(T)
    mares = torch.full((n,), 1e5, **f32)
    mares_old = torch.full((n,), 1e5, **f32)
    dpsq_init = torch.full((n,), 1e-10, **f32)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    converged = torch.zeros((n,), dtype=torch.bool, device=dev)

    for trip in range(cfg.max_iter + 1):
        first = trip == 0
        active = ~converged
        cnt_n = torch.zeros_like(cnt) if first else cnt + 1

        # delta_p = H^-1 (J^T pdiff) (patch.cpp:176-184).
        if first:
            delta_p = torch.zeros_like(p_iter)
        else:
            b0 = _patch_sum(tdx * pdiff)
            if nop == 2:
                b1 = _patch_sum(tdy * pdiff)
                du = (h11 * b0 - h01 * b1) / det
                dv = (h00 * b1 - h01 * b0) / det
                delta_p = torch.stack([du, dv], dim=1)
            else:
                delta_p = (b0 / h00)[:, None]
        p_new = p_iter - delta_p
        if cfg.mode == "stereo" and not first:
            # Disparity sign clamp by camera (patch.cpp:188-193).
            p_new = p_new.clamp(max=0.0) if camlr == 0 else p_new.clamp(min=0.0)
        pt_new = _param_to_pt(pt_ref, p_new, nop)

        # Outlier / bounds reset (patch.cpp:198-208).
        if first:
            reset = torch.zeros_like(converged)
        else:
            moved = ((pt_st - pt_new) ** 2).sum(dim=1) > outlier_sq
            reset = moved | _out_of_bounds(pt_new, w, h, psz)
            p_new = torch.where(reset[:, None], p_in, p_new)
            pt_new = _param_to_pt(pt_ref, p_new, nop)

        # OptimizeComputeErrImg (patch.cpp:264-284) — runs even after a reset.
        pd_new, pw_new = residual(pt_new)
        if first:
            m0 = oob0[:, None, None, None]
            pd_new = torch.where(m0, tmpl_pd, pd_new)
            pw_new = torch.where(m0, tmpl_pw, pw_new)
            dpsq_n = torch.full((n,), 1e-10, **f32)
            mares_old_n = torch.full((n,), 1e5, **f32)
        else:
            dpsq_n = (delta_p * delta_p).sum(dim=1)
            mares_old_n = mares
        dpsq_init_n = torch.where(cnt_n == 1, dpsq_n, dpsq_init)
        mares_n = _div(_patch_sum(pw_new), novals)
        oob_start = oob0 if first else torch.zeros_like(oob0)
        mares_n = torch.where(oob_start, 1e5, mares_n)

        keep_going = (
            (cnt_n < cfg.max_iter)
            & (mares_n > cfg.res_thresh)
            & ((cnt_n < cfg.min_iter) | (dpsq_n / dpsq_init_n >= dp_thresh_sq))
            & ((cnt_n < cfg.min_iter) | (mares_n / mares_old_n <= cfg.dr_thresh))
        )
        conv_n = converged | reset | ~keep_going | oob_start

        a1 = active[:, None]
        a4 = active[:, None, None, None]
        p_iter = torch.where(a1, p_new, p_iter)
        pt_iter = torch.where(a1, pt_new, pt_iter)
        pdiff = torch.where(a4, pd_new, pdiff)
        pweight = torch.where(a4, pw_new, pweight)
        mares = torch.where(active, mares_n, mares)
        dpsq_init = torch.where(active, dpsq_init_n, dpsq_init)
        cnt = torch.where(active, cnt_n, cnt)
        converged = torch.where(active, conv_n, converged)

    return SearchResult(p=p_iter.reshape(*pairs, n_pt, nop),
                        pt=pt_iter.reshape(*pairs, n_pt, 2),
                        pweight=pweight.reshape(*pairs, n_pt, *pweight.shape[1:]),
                        converged=converged.reshape(*pairs, n_pt),
                        iters=cnt.reshape(*pairs, n_pt))


def _abs_weights(pweight: torch.Tensor, cfg: DISConfig) -> torch.Tensor:
    """absw per footprint pixel: (..., N, psz*psz) (patchgrid.cpp:253-260);
    the channels are added in order, as the level-search kernel adds them."""
    lead, psz, c = pweight.shape[:-3], pweight.shape[-3], pweight.shape[-1]
    pw = torch.clamp(pweight, min=cfg.minerrval)  # (..., N, psz, psz, C)
    s = pw[..., 0]
    for k in range(1, c):
        s = s + pw[..., k]
    return (1.0 / s).reshape(*lead, psz * psz)


def level_search_reference(ima, dxa, dya, imb, pt_ref, p_init, cfg: DISConfig,
                           w: int, h: int, pad: int,
                           camlr: Optional[int] = None) -> SearchResult:
    """Plain version of the level-search kernel: templates + the vectorised
    trip loop + densification weights."""
    tmpl = build_templates(ima, dxa, dya, pt_ref, cfg, pad)
    res = optimize_level(imb, tmpl, pt_ref, p_init, cfg, w, h, pad, camlr=camlr)
    return res._replace(pweight=None, absw=_abs_weights(res.pweight, cfg))


def gn_search_reference(imb, tmpl: PatchTemplates, pt_ref, p_init, cfg: DISConfig,
                        w: int, h: int, pad: int,
                        camlr: Optional[int] = None) -> SearchResult:
    """Plain version of the GN-search kernel: the vectorised trip loop over
    prebuilt templates; pweight (..., N, psz, psz, C) comes back, as on the JAX
    package's GN route (of_dis_tpu/models/inverse_search.py:342-353)."""
    return optimize_level(imb, tmpl, pt_ref, p_init, cfg, w, h, pad, camlr=camlr)
