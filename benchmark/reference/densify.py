"""Densification (DIS step 4): each patch adds its flow over its psz x psz
footprint with per-pixel weight 1 / sum_c max(minerrval, err_c)
(AggregateFlowDense, patchgrid.cpp:213-275), then the sums are normalised
(patchgrid.cpp:377-394).  The grid is regular, so the splat is an
overlap-add of d^2 shifted copies summed in a fixed order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import Params
from .search import Geometry, Result


def _overlap_add(vals: torch.Tensor, geo: Geometry, p: Params) -> torch.Tensor:
    """vals (B, N, psz*psz, K) onto (B, h, w, K): footprint offset j = dj *
    steps + a, each (dj, di) block one shifted zero-pad of the grid."""
    psz, steps = p.patch_size, p.steps
    k = vals.shape[-1]
    noph, nopw = geo.noph, geo.nopw
    grid = vals.reshape(-1, nopw, noph, psz, psz, k).permute(0, 2, 1, 3, 4, 5)
    d = -(-psz // steps)
    pin = d * steps
    if pin != psz:
        grid = F.pad(grid, (0, 0, 0, pin - psz, 0, pin - psz))
    v = grid.reshape(-1, noph, nopw, d, steps, d, steps, k).permute(0, 7, 1, 4, 2, 6, 3, 5)
    acc = None
    for dj in range(d):
        for di in range(d):
            t = F.pad(v[..., dj, di], (0, 0, di, d - 1 - di, 0, 0, dj, d - 1 - dj))
            acc = t if acc is None else acc + t
    full = acc.reshape(-1, k, (noph + d - 1) * steps, (nopw + d - 1) * steps)
    full = full[..., : (noph - 1) * steps + psz, : (nopw - 1) * steps + psz]
    lb = -(psz // 2)
    oy = int(geo.pt_ref[:, 1].min()) + lb
    ox = int(geo.pt_ref[:, 0].min()) + lb
    h, w = geo.h, geo.w
    fh, fw = full.shape[-2:]
    top, left = max(oy, 0), max(ox, 0)
    ct, cl = max(-oy, 0), max(-ox, 0)
    out = F.pad(full[..., ct:, cl:],
                (left, max(w - (fw - cl) - left, 0), top, max(h - (fh - ct) - top, 0)))[..., :h, :w]
    return out.permute(0, 2, 3, 1).reshape(vals.shape[0], h, w, k)


def densify(res: Result, geo: Geometry, p: Params) -> torch.Tensor:
    """(B, h, w, nop) flow of a level from its patches."""
    vals = torch.cat([res.absw[..., None], res.absw[..., None] * res.p[..., None, :]], dim=-1)
    acc = _overlap_add(vals, geo, p)
    we, flow = acc[..., :1], acc[..., 1:]
    return torch.where(we > 0.0, flow / torch.where(we > 0.0, we, 1.0), 0.0)
