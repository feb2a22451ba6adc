"""Densification: weighted patch-to-pixel flow aggregation (DIS step 4),
PyTorch port of of_dis_tpu/models/densify.py.

Forward splat (AggregateFlowDense, patchgrid.cpp:213-397): each patch adds
its uniform flow over its psz x psz footprint clipped to the image, with
per-pixel weight 1/max(minerrval, err) (gray) or 1/sum_c max(minerrval,
err_c) (RGB) (patchgrid.cpp:241-275).  The patch grid is regular, so the
splat is an overlap-add of d^2 shifted, zero-padded copies summed in a
fixed order: deterministic, with no atomics (the reference's OpenMP splat
is documented racy, CMakeLists.txt:18-19).

The forward-backward merge (`merge_backward`) comes with the fb slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import DISConfig
from .grid import LevelGeometry
from .inverse_search import SearchResult, _abs_weights


def result_absw(res: SearchResult, cfg: DISConfig) -> torch.Tensor:
    """Densification weights of a SearchResult: the level-search kernel
    returns them directly (res.absw); the plain loop derives them from the
    residual image."""
    if res.absw is not None:
        return res.absw
    return _abs_weights(res.pweight, cfg)


def _col2im_accumulate(
    vals: torch.Tensor,  # (..., N, psz*psz, K) per-patch per-footprint-pixel values
    geo: LevelGeometry,
    cfg: DISConfig,
) -> torch.Tensor:
    """Overlap-add of patch footprints onto the (..., h, w, K) images.

    Inner footprint offset j splits as dj*steps + a (d = ceil(psz/steps)),
    and every (dj, di) block lands on the same steps-phase lattice, so the
    overlap-add is d^2 shifted zero-pads of the patch grid, summed in a
    fixed order.  Out-of-image footprint pixels are dropped by the final
    crop, matching the reference's bounds check.  The leading (batch) dims
    of vals fold into one axis ahead of the channels."""
    psz = cfg.patch_size
    steps = cfg.steps
    lead, k = vals.shape[:-3], vals.shape[-1]
    noph, nopw = geo.noph, geo.nopw
    # Patch index order is i = x*noph + y (patchgrid.cpp:61-75).
    grid = vals.reshape(-1, nopw, noph, psz, psz, k).permute(0, 2, 1, 3, 4, 5)
    d = -(-psz // steps)
    pin = d * steps
    if pin != psz:
        grid = F.pad(grid, (0, 0, 0, pin - psz, 0, pin - psz))
    v = grid.reshape(-1, noph, nopw, d, steps, d, steps, k)
    v = v.permute(0, 7, 1, 4, 2, 6, 3, 5)  # (B, k, noph, a, nopw, b, dj, di)
    fj, fi = noph + d - 1, nopw + d - 1
    acc = None
    for dj in range(d):
        for di in range(d):
            t = F.pad(v[..., dj, di], (0, 0, di, d - 1 - di, 0, 0, dj, d - 1 - dj))
            acc = t if acc is None else acc + t
    full = acc.reshape(-1, k, fj * steps, fi * steps)
    # crop the (d*steps - psz) zero-pad tail back off
    full = full[..., : (noph - 1) * steps + psz, : (nopw - 1) * steps + psz]

    # full row r corresponds to image row r + offh + lb (same for cols).
    lb = -(psz // 2)
    offh = int(geo.pt_ref[:, 1].min()) if geo.n_patches else 0
    offw = int(geo.pt_ref[:, 0].min()) if geo.n_patches else 0
    oy = offh + lb
    ox = offw + lb
    h, w = geo.h, geo.w
    fh, fw = full.shape[-2], full.shape[-1]
    pad_top = max(oy, 0)
    pad_left = max(ox, 0)
    crop_top = max(-oy, 0)
    crop_left = max(-ox, 0)
    out = F.pad(
        full[..., crop_top:, crop_left:],
        (pad_left, max(w - (fw - crop_left) - pad_left, 0),
         pad_top, max(h - (fh - crop_top) - pad_top, 0)),
    )[..., :h, :w]
    return out.permute(0, 2, 3, 1).reshape(*lead, h, w, k)


def aggregate_flow_dense(
    result: SearchResult,
    geo: LevelGeometry,
    cfg: DISConfig,
    bw_result=None,
) -> torch.Tensor:
    """Densify per-patch flow (..., N, nop) into an (..., h, w, nop) field."""
    if bw_result is not None:
        raise NotImplementedError("forward-backward merge is not ported yet")
    nop = cfg.nop

    absw = result_absw(result, cfg)  # (..., N, psz²)
    # stack [w, w*u, w*v] and overlap-add in one pass
    contrib = absw[..., None] * result.p[..., None, :]  # (..., N, psz², nop)
    vals = torch.cat([absw[..., None], contrib], dim=-1)
    acc = _col2im_accumulate(vals, geo, cfg)  # (..., h, w, 1+nop)
    we = acc[..., :1]
    flow = acc[..., 1:]

    # Normalize (patchgrid.cpp:377-394); untouched pixels stay 0.
    safe = torch.where(we > 0.0, we, 1.0)
    return torch.where(we > 0.0, flow / safe, 0.0)
