"""Densification: weighted patch-to-pixel flow aggregation (DIS step 4),
PyTorch port of of_dis_tpu/models/densify.py.

Forward splat (AggregateFlowDense, patchgrid.cpp:213-397): each patch adds
its uniform flow over its psz x psz footprint clipped to the image, with
per-pixel weight 1/max(minerrval, err) (gray) or 1/sum_c max(minerrval,
err_c) (RGB) (patchgrid.cpp:241-275).  The patch grid is regular, so the
splat is an overlap-add of d^2 shifted, zero-padded copies summed in a
fixed order: deterministic, with no atomics (the reference's OpenMP splat
is documented racy, CMakeLists.txt:18-19).

Forward-backward merge (`merge_backward`, patchgrid.cpp:277-375): the
complementary grid's patches splat their NEGATED flow at their converged
query position, bilinearly over 4 cells.  Those indices are run-time
values, so the merge (and `splat_forward_scatter`, the forward splat of an
arbitrary patch subset) is a scatter-add in a fixed order (`_scatter_add`):
on CUDA `Tensor.index_put(..., accumulate=True)`, which sorts the updates
by cell (stably) and sums each cell's without atomics, where `index_add_`
and `scatter_add_` add with atomics in no fixed order; on the CPU
`index_add`, which adds in the order of the updates (as the JAX package's
scatter does: the same bits), where `index_put` accumulates in parallel in
no fixed order.  So two runs give the same bits, and so does each pair of
a batch against its own run: a pair's cell indices are offset by b*h*w.
The card's order is not the CPU's: the two differ by rounding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _scatter_add(acc: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """acc (..., npx, K) plus vals (..., M, K) added at cells idx (..., M)
    of each pair, in a fixed order (see the module docstring).  The batch's
    pairs are one flat accumulator, pair b's cells offset by b*npx."""
    lead = idx.shape[:-1]
    npx, k = acc.shape[-2:]
    base = torch.arange(math.prod(lead), device=idx.device).reshape(*lead, 1) * npx
    flat, cells, vals = acc.reshape(-1, k), (idx + base).reshape(-1), vals.reshape(-1, k)
    if flat.device.type == "cuda":
        flat = flat.index_put((cells,), vals, accumulate=True)
    else:
        flat = flat.index_add(0, cells, vals)
    return flat.reshape(acc.shape)


def _footprint(psz: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(psz*psz,) row and column offsets of a patch's pixels from its
    centre, row-major (j, i) as the weights are laid out."""
    lb = -(psz // 2)
    offs = torch.arange(lb, lb + psz, device=device)
    return offs.repeat_interleave(psz), offs.repeat(psz)


def splat_forward_scatter(
    p: torch.Tensor,        # (..., N, nop) per-patch displacement
    absw_in: torch.Tensor,  # (..., N, psz*psz) densification weights (result_absw)
    pt: torch.Tensor,       # (N, 2) or (..., N, 2) patch centres (may be far out of bounds)
    w: int,
    h: int,
    cfg: DISConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward splat as a scatter-add: returns the (..., w*h) weight and
    (..., w*h, nop) flow accumulators.  Same numerics as the overlap-add of
    aggregate_flow_dense (footprint offsets, bounds check, 1/sum_c
    max(minerrval, err) weights, patchgrid.cpp:241-275) but for an
    arbitrary patch subset, which spatial sharding needs (each device
    splats its patch shard, then the shards are summed)."""
    oy, ox = _footprint(cfg.patch_size, p.device)
    lead = p.shape[:-2]
    pt = pt.expand(*lead, *pt.shape[-2:])
    yt = pt[..., 1].long()[..., None] + oy
    xt = pt[..., 0].long()[..., None] + ox
    valid = ((xt >= 0) & (yt >= 0) & (xt < w) & (yt < h)).to(torch.float32)
    idxm = yt.clamp(0, h - 1) * w + xt.clamp(0, w - 1)
    absw = absw_in * valid
    nop = p.shape[-1]
    # [w, w*u, w*v] scattered together: one sort of the cells on the card
    vals = torch.cat([absw[..., None], absw[..., None] * p[..., None, :]], dim=-1)
    acc = _scatter_add(p.new_zeros((*lead, w * h, 1 + nop)), idxm.reshape(*lead, -1),
                       vals.reshape(*lead, -1, 1 + nop))
    return acc[..., 0], acc[..., 1:]


def aggregate_flow_dense(
    result: SearchResult,
    geo: LevelGeometry,
    cfg: DISConfig,
    bw_result: Optional[SearchResult] = None,
) -> torch.Tensor:
    """Densify per-patch flow (..., N, nop) into an (..., h, w, nop) field.

    `bw_result` (query positions in THIS grid's frame) enables the
    forward-backward merge; pass the backward grid's SearchResult."""
    nop = cfg.nop

    absw = result_absw(result, cfg)  # (..., N, psz²)
    # stack [w, w*u, w*v] and overlap-add in one pass
    contrib = absw[..., None] * result.p[..., None, :]  # (..., N, psz², nop)
    vals = torch.cat([absw[..., None], contrib], dim=-1)
    acc = _col2im_accumulate(vals, geo, cfg)  # (..., h, w, 1+nop)
    if bw_result is not None:
        merged = _merge_into(acc.reshape(*acc.shape[:-3], geo.h * geo.w, 1 + nop), bw_result,
                             geo.w, geo.h, cfg)
        acc = merged.reshape(acc.shape)
    we = acc[..., :1]
    flow = acc[..., 1:]

    # Normalize (patchgrid.cpp:377-394); untouched pixels stay 0.
    safe = torch.where(we > 0.0, we, 1.0)
    return torch.where(we > 0.0, flow / safe, 0.0)


def merge_backward(we, flow, bw: SearchResult, w: int, h: int, cfg: DISConfig,
                   origin=None, acc_shape=None):
    """Splat the negated backward flow with bilinear weights at the converged
    backward query position (patchgrid.cpp:277-375) into the accumulators
    we (..., npx) and flow (..., npx, nop); returns the new ones.  `bw` may
    be any patch subset (..., N, ...) (spatial sharding merges per-device
    shards, then sums them).  See _merge_into for origin= / acc_shape=."""
    acc = _merge_into(torch.cat([we[..., None], flow], dim=-1), bw, w, h, cfg, origin,
                      acc_shape)
    return acc[..., 0], acc[..., 1:]


def _merge_into(acc, bw: SearchResult, w: int, h: int, cfg: DISConfig, origin=None,
                acc_shape=None):
    """merge_backward on the stacked accumulator acc (..., npx, 1+nop) =
    [we, flow]: one scatter for both (one sort of the cells on the card).

    With `origin`=(oy, ox) and `acc_shape`=(acc_h, acc_w), the accumulators
    are a LOCAL TILE whose row/col 0 sits at (oy, ox) of the global (h, w)
    level: bounds checks keep GLOBAL semantics (interior only, as the
    reference), only the scatter indices shift into the tile, and a
    contribution that lands outside the tile is dropped, never clipped
    into an edge cell."""
    acc_h, acc_w = (h, w) if acc_shape is None else acc_shape
    npx = acc_w * acc_h

    fx = torch.floor(bw.pt[..., 0])
    fy = torch.floor(bw.pt[..., 1])
    posx = fx.long() + 1  # == ceil(x + 1e-5)
    posy = fy.long() + 1
    rx = bw.pt[..., 0] - fx
    ry = bw.pt[..., 1] - fy
    wbil = torch.stack([rx * ry, (1 - rx) * ry, rx * (1 - ry), (1 - rx) * (1 - ry)],
                       dim=-1)  # (..., N, 4)

    oy, ox = _footprint(cfg.patch_size, bw.pt.device)
    yt = posy[..., None] + oy  # (..., N, psz²), global coordinates
    xt = posx[..., None] + ox
    valid = ((xt >= 1) & (yt >= 1) & (xt < w - 1) & (yt < h - 1)).to(torch.float32)
    if origin is not None:
        yt = yt - origin[0]
        xt = xt - origin[1]
        valid = valid * ((yt >= 1) & (yt <= acc_h - 1) & (xt >= 1)
                         & (xt <= acc_w - 1)).to(torch.float32)
        yt = yt.clamp(1, acc_h - 1)
        xt = xt.clamp(1, acc_w - 1)

    absw = result_absw(bw, cfg) * valid  # (..., N, psz²)
    idxcc = (yt * acc_w + xt).clamp(0, npx - 1)
    # The 4 bilinear cells, cc, (x-1)c, c(y-1), (x-1)(y-1), in one scatter.
    cells = torch.stack([idxcc, idxcc - 1, idxcc - acc_w, idxcc - acc_w - 1],
                        dim=-1).clamp(0, npx - 1)  # (..., N, psz², 4)
    cw = wbil[..., None, :] * absw[..., None]  # (..., N, psz², 4)
    contrib = (-cw)[..., None] * bw.p[..., None, None, :]  # (..., N, psz², 4, nop)
    vals = torch.cat([cw[..., None], contrib], dim=-1)
    lead, k = bw.p.shape[:-2], acc.shape[-1]
    return _scatter_add(acc, cells.reshape(*lead, -1), vals.reshape(*lead, -1, k))
