"""Spatial sharding: one frame pair split across ranks with halo exchange,
PyTorch port of of_dis_tpu/parallel/spatial.py.

The reference's only "sequence-length" scaling is pyramid locality
(SURVEY.md §5): patch search reads a bounded window, SOR is a 5-point
stencil, derivative filters are 5-tap.  The JAX package cuts one pair over
a device mesh with shard_map; here each rank is one process of a
torch.distributed world and a `DeviceMesh` (parallel/multihost.py) plays
the mesh, through the collectives of parallel/collectives.py (which also
count the exchanges and the bytes staged through host memory).
Every rank calls the same functions in the same order, so every rank
issues the same collectives in the same order; a rank with no patches at a
level still takes part in each of them.  Two modes:

1-D column strips (spatial_flow, dimension "tx") — level images
replicated, exact for unbounded displacements:
  - Patch search: each rank searches its contiguous block of the level's
    patches (ceil(N / ntx) of them, fewer on the last ranks) on the full
    level images, in level_search or gn_search as ops/kernels.py::
    search_route picks for the block.
  - Densification: each rank splats its patches into a full-size
    accumulator; one all_reduce over the dimension sums them.
  - Variational refinement: the field is cut into column strips; every
    stencil op (5-/3-tap convolutions, weighted Laplacian, red-black SOR
    half-steps) exchanges 1-2 halo columns with its neighbours.  Global
    borders keep the replicate semantics by the rank index.

2-D (ty, tx) tiles (spatial_flow_tiled) — tile-local memory: each rank
builds its own raw tile pyramid from its slice of the input (2x2 box
averages never straddle tile borders), gradients, search windows and warp
sources come from halo exchange, the search runs gn_search's tile form on
the halo'd tile, densification is tile-local with a border halo-REDUCE,
and only the finest flow is gathered.  Displacements carried between
levels are clamped to +-max_disp (the image-halo budget; see the section
comment below).

Ops are the JAX sharded functions' own, in their order (the sums in `nb`,
`(omega / A11) * (...)` as one true division); the single-device
refinement (models/refine.py) is not reused, because sharded and
single-device results agree only to 1e-3 (tests/test_spatial.py).  A
strip is refined as a tile of a mesh without a ty dimension, so the JAX
file's strip stencils (`_smoothness_sharded`, `_sub_laplacian_sharded`,
`_sor_coupled_rb_sharded`, `_sor_scalar_rb_sharded`, `_warp_sharded`,
`_get_derivatives_sharded`) are its 2-D ones here; the one difference is
the stereo SOR's diagonal, summed as the 2-D form sums it.  Levels too
narrow to shard run the single-device `_level_flow` on every rank.

Execution: each entry point runs its whole pass through a sharded
executable (parallel/collectives.py::sharded): one CUDA graph per rank and
static key under NCCL, the collectives captured inside; op by op with
gloo, on the CPU and under graphs.eager().  So nothing in a pass syncs
with the host or copies from host memory: the ownership tables are device
tensors built once per key (`_own_tensors`), and the clamp counts stay on
the device until the entry point reads them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import DISConfig
from ..models import refine as rf
from ..models.densify import merge_backward, result_absw, splat_forward_scatter
from ..models.dis import _grid_tensors, _level_flow, _search, _stage_templates
from ..models.grid import level_geometry
from ..models.inverse_search import build_templates
from ..ops import graphs, kernels
from ..ops import pyramid as pyr
from ..ops.transfer import to_device
from .collectives import _all_gather, _axis_info, _axis_size, _exchange, _psum, sharded


# ---------------------------------------------------------------------------
# Halo exchange primitives (dimension "tx", column strips)
# ---------------------------------------------------------------------------

def _edges(x: torch.Tensor, k: int, axis: int, edge_mode: str):
    """The k-wide fills before and after x along `axis` at the global
    borders: "edge" (replicate), "zero", or "reflect101" (mirror without
    the edge row — OpenCV's BORDER_DEFAULT, the Sobel border)."""
    n = x.shape[axis]
    if edge_mode == "edge":
        first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
        shape = list(x.shape)
        shape[axis] = k
        return first.expand(shape), last.expand(shape)
    if edge_mode == "reflect101":
        return (x.narrow(axis, 1, k).flip(axis), x.narrow(axis, n - k - 1, k).flip(axis))
    if edge_mode == "zero":
        z = torch.zeros_like(x.narrow(axis, 0, k))
        return z, z
    raise ValueError(f"unknown edge_mode {edge_mode!r}")


def _halo(x: torch.Tensor, k: int, mesh, dim: str, axis: int, edge_mode: str):
    """x extended by k rows (axis 0) or columns (axis 1) from each
    neighbour along `dim`, filled per edge_mode at the global borders."""
    idx, n = _axis_info(mesh, dim)
    w = x.shape[axis]
    from_prev, from_next = _exchange(mesh, dim, x.narrow(axis, 0, k), x.narrow(axis, w - k, k))
    edge_p, edge_n = _edges(x, k, axis, edge_mode)
    before = edge_p if idx == 0 else from_prev
    after = edge_n if idx == n - 1 else from_next
    return torch.cat([before, x, after], dim=axis)


def halo_x(x: torch.Tensor, k: int, mesh, axis: str = "tx",
           edge_mode: str = "edge") -> torch.Tensor:
    """Extend a local strip (h, wl, ...) with k columns from each neighbour
    along mesh dimension `axis`.

    Global borders are filled with edge-replication (edge_mode="edge",
    matching the replicate conv borders) or zeros (edge_mode="zero",
    matching the shift ops whose out-of-image weights are zero)."""
    if edge_mode not in ("edge", "zero"):
        raise ValueError(f"halo_x: edge_mode {edge_mode!r} (reflect101: _halo_x_mode)")
    return _halo(x, k, mesh, axis, 1, edge_mode)


def _conv_h_sharded(img, coeffs, mesh, axis):
    """Horizontal conv on a strip: halo-extend, then valid conv."""
    r = len(coeffs) // 2
    xh = halo_x(img, r, mesh, axis, "edge")
    w = img.shape[1]
    out = torch.zeros_like(img)
    for k, c in enumerate(coeffs):
        if c != 0.0:
            out = out + c * xh[:, k : k + w]
    return out


def _shift_left_sharded(x, mesh, axis):
    """x[j, i-1] with zero at the global left edge (local strip view).  Only
    the predecessor's last column is exchanged."""
    idx, _ = _axis_info(mesh, axis)
    from_prev, _ = _exchange(mesh, axis, None, x[:, -1:])
    first = torch.zeros_like(x[:, :1]) if idx == 0 else from_prev
    return torch.cat([first, x[:, :-1]], dim=1)


def _shift_right_sharded(x, mesh, axis):
    """x[j, i+1] with zero at the global right edge."""
    idx, n = _axis_info(mesh, axis)
    _, from_next = _exchange(mesh, axis, x[:, :1], None)
    last = torch.zeros_like(x[:, :1]) if idx == n - 1 else from_next
    return torch.cat([x[:, 1:], last], dim=1)


# ---------------------------------------------------------------------------
# Sharded variational refinement
# ---------------------------------------------------------------------------

def _refine_level_sharded(flow_strip, im1_strip, im2_full, level, cfg, mesh, axis,
                          camlr=None):
    """refine_level on a column strip; im2 replicated for the warp.  A strip
    is a tile of a mesh without a ty dimension (ay None: the vertical
    stencils see the whole height, as rf's shifts and convolutions do), so
    the 2-D tile refinement runs it.  camlr overrides cfg.camlr for the
    backward (fb-merge) stereo grid."""
    idx, _ = _axis_info(mesh, axis)
    h, wl = flow_strip.shape[:2]
    return _refine_level_2d(flow_strip, im1_strip, im2_full, 0, idx * wl, 0, 0, level, cfg,
                            mesh, None, axis, im2_full.shape[1], h, camlr)


# ---------------------------------------------------------------------------
# Sharded level pipeline: patch shard -> psum densify -> strip refine
# ---------------------------------------------------------------------------

def _normalize(we, fo):
    """Flow from weight and weighted-flow accumulators (patchgrid.cpp:377-394);
    untouched pixels stay 0."""
    safe = torch.where(we > 0, we, 1.0)
    return torch.where((we > 0)[..., None], fo / safe[..., None], 0.0)


def _densify_psum(res, res_other, pt_shard, w, h, cfg, mesh, axis):
    """Shard splat (+ optional fb merge of the other direction's shard) into
    a full-size accumulator, psum over the mesh, normalize.  res None: this
    rank has no patches at the level and adds zeros."""
    nop = cfg.nop
    if res is None:
        acc = torch.zeros((w * h, 1 + nop), dtype=torch.float32, device=pt_shard.device)
    else:
        we, fo = splat_forward_scatter(res.p, result_absw(res, cfg), pt_shard, w, h, cfg)
        if res_other is not None:
            we, fo = merge_backward(we, fo, res_other, w, h, cfg)
        acc = torch.cat([we[:, None], fo], dim=1)
    acc = _psum(acc, mesh, axis)  # [we, fo] in one all_reduce
    return _normalize(acc[:, 0], acc[:, 1:]).reshape(h, w, nop)


def _refine_strip(flow, im_src, im_tgt, sl, cfg, mesh, axis, rank, camlr):
    """Slice this rank's column strip, refine it against the (replicated)
    target image, and gather the full field back."""
    wl = flow.shape[1] // _axis_size(mesh, axis)
    strip = flow[:, rank * wl : (rank + 1) * wl]
    src_strip = im_src[:, rank * wl : (rank + 1) * wl]
    strip = _refine_level_sharded(strip, src_strip, im_tgt, sl, cfg, mesh, axis, camlr)
    return _all_gather(strip, mesh, axis, 1)


def _level_manual(im_a, dx_a, dy_a, im_b, dx_b, dy_b, flow_prev, flow_bw_prev,
                  sl, w, h, cfg, mesh, axis):
    """One pyramid level on every rank of `axis`: patch shard -> psum
    densify (incl. fb merge) -> strip refinement -> all_gather.  Mirrors
    models/dis.py::_level_flow per rank, callable with any mesh that has
    `axis` (e.g. the 2-D (data, tx) mesh).  Returns (flow, flow_bw or None)."""
    rank, ntx = _axis_info(mesh, axis)
    pad = cfg.patch_size
    nop = cfg.nop
    geo, pt_full, coarse_idx = _grid_tensors(w, h, cfg, im_a.device)
    n = geo.n_patches
    # This rank's contiguous block of ceil(n / ntx) patches (the last ranks'
    # are shorter, possibly empty).
    k = -(-n // ntx)
    lo, hi = min(rank * k, n), min((rank + 1) * k, n)
    pt_shard = pt_full[lo:hi]

    def init_shard(prev):
        if prev is None:
            return torch.zeros((hi - lo, nop), dtype=torch.float32, device=im_a.device)
        return 2.0 * prev.reshape(-1, nop)[coarse_idx[lo:hi]]

    res = res_bw = None
    if hi > lo:
        tmpl, tmpl_bw = _stage_templates(im_a, dx_a, dy_a, im_b, dx_b, dy_b, pt_shard, cfg, pad)
        res = _search(tmpl, im_b, pt_shard, init_shard(flow_prev), cfg, w, h, pad)
        if cfg.use_fb_merge:
            # Backward grid: swapped images, flipped camera (oflow.cpp:154-157).
            res_bw = _search(tmpl_bw, im_a, pt_shard, init_shard(flow_bw_prev), cfg, w, h, pad,
                             camlr=1 - cfg.camlr)

    # Per-rank densification into a full-size accumulator + psum
    # (deterministic; replaces the reference's racy OpenMP scatter).
    flow = _densify_psum(res, res_bw, pt_shard, w, h, cfg, mesh, axis)
    flow_bw = None
    if cfg.use_fb_merge and sl > cfg.sc_l:
        flow_bw = _densify_psum(res_bw, res, pt_shard, w, h, cfg, mesh, axis)

    if cfg.use_tv_refine:
        raw1 = im_a[pad:-pad, pad:-pad]
        raw2 = im_b[pad:-pad, pad:-pad]
        flow = _refine_strip(flow, raw1, raw2, sl, cfg, mesh, axis, rank, cfg.camlr)
        if flow_bw is not None:
            flow_bw = _refine_strip(flow_bw, raw2, raw1, sl, cfg, mesh, axis, rank,
                                    1 - cfg.camlr)
    return flow, flow_bw


def _replicated_level(ims, flow, flow_bw, sl, lw, lh, cfg):
    """A level on the full images, the same on every rank (the
    single-device `_level_flow` on a batch of one).  ims: the level's six
    padded images (im1, dx1, dy1, im2, dx2, dy2), (Hp, Wp, C) each."""
    pad = cfg.patch_size
    raw1 = ims[0][pad:-pad, pad:-pad]
    raw2 = ims[3][pad:-pad, pad:-pad]
    one = lambda t: None if t is None else t[None]  # noqa: E731
    flow, flow_bw = _level_flow(*(one(t) for t in ims), one(flow), one(flow_bw), sl, lw, lh,
                                cfg, raw1[None], raw2[None])
    return flow[0], None if flow_bw is None else flow_bw[0]


def _pair_manual(img1p, img2p, cfg, mesh, axis):
    """Coarse-to-fine flow for one padded (H, W, C) pair on every rank of
    `axis`.

    Level images are replicated over `axis` (they are small); levels whose
    width divides the axis run sharded, others run replicated."""
    h, w = img1p.shape[:2]
    ntx = _axis_size(mesh, axis)
    n_lv = cfg.sc_f + 1
    pyr1 = pyr.build_pyramid(img1p, n_lv, cfg.patch_size, first_level=cfg.sc_l)
    pyr2 = pyr.build_pyramid(img2p, n_lv, cfg.patch_size, first_level=cfg.sc_l)
    flow = None
    flow_bw = None
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lw, lh = w >> sl, h >> sl
        ims = [p[sl] for p in pyr1 + pyr2]
        if lw % ntx == 0 and lw >= 2 * ntx:
            flow, flow_bw = _level_manual(*ims, flow, flow_bw, sl, lw, lh, cfg, mesh, axis)
        else:
            flow, flow_bw = _replicated_level(ims, flow, flow_bw, sl, lw, lh, cfg)
    return flow


def _mesh_device(mesh) -> torch.device:
    """Where a rank computes: the mesh's device type (the current CUDA
    device for "cuda")."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _padded_pair(img1, img2, cfg: DISConfig, device):
    """Both images as float32 (H, W, C) tensors on `device`; raises unless
    padded to divisibility by 2^sc_f."""
    a, b = to_device(img1, device), to_device(img2, device)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    h, w = a.shape[:2]
    if w % (1 << cfg.sc_f) or h % (1 << cfg.sc_f):
        raise ValueError("inputs must be padded to divisibility by 2^sc_f")
    return a, b


@sharded
def _strip_pass(mesh, img1p, img2p, cfg: DISConfig, axis: str):
    """spatial_flow's pass on one rank, as an executable."""
    return _pair_manual(img1p, img2p, cfg, mesh, axis)


def spatial_fn(cfg: DISConfig, mesh, axis: str = "tx"):
    """The bare sharded pipeline behind spatial_flow: a callable taking two
    padded (H, W, C) float32 images on this rank's device, run by every
    rank of the mesh; returns the (H >> sc_l, W >> sc_l, nop) flow on each.
    It runs through its executable (`_strip_pass`)."""
    def fn(img1p, img2p):
        return _strip_pass(mesh, img1p, img2p, cfg, axis)
    return fn


def spatial_flow(img1, img2, cfg: DISConfig, mesh, axis: str = "tx") -> torch.Tensor:
    """Coarse-to-fine flow for ONE pair, sharded spatially over `axis`;
    every rank of the mesh calls it with the same pair (numpy arrays or
    tensors, (H, W[, C]) padded to divisibility by 2^sc_f) and gets the
    whole flow at scale sc_l, (H >> sc_l, W >> sc_l, nop).

    Levels whose width divides the axis run patch-sharded with psum
    densification and column-strip refinement; coarse levels fall back to
    replicated execution (their cost is negligible)."""
    cfg.validate()
    a, b = _padded_pair(img1, img2, cfg, _mesh_device(mesh))
    return spatial_fn(cfg, mesh, axis)(a, b)


# ---------------------------------------------------------------------------
# 2-D (ty, tx) tiling: tiled level images + halo exchange in both axes
# ---------------------------------------------------------------------------
#
# SURVEY.md §5's "sequence-parallel" design: the frame is cut into an
# nty x ntx grid of tiles; each rank holds only a halo'd TILE of every
# pyramid level (images, search windows, flow, refinement fields), patches
# are owned by the tile containing their grid center, densification is a
# tile-local splat with a border halo-REDUCE instead of a full-image psum,
# and refinement exchanges 1-2 px halos per stencil op.
#
# Contract (the one deviation from the replicated paths): the warm-start
# displacement a patch may carry into a level is clamped to +-max_disp px
# (default 8), because the image halo each rank holds is
# H = psz + ceil(max_disp) + 2 wide.  Flow fields whose inter-level growth
# stays under max_disp are EXACTLY the single-device result up to float
# reassociation; faster content degrades gracefully (the clamp re-finds
# large motion over successive levels).  Use spatial_flow / batched_flow
# when unbounded per-level motion must be preserved.


def halo_y(x: torch.Tensor, k: int, mesh, axis: str = "ty",
           edge_mode: str = "edge") -> torch.Tensor:
    """Row version of halo_x: extend a (hl, w, ...) tile with k rows from
    each neighbour along `axis`.  edge_mode at the GLOBAL borders: "edge"
    (replicate), "zero", or "reflect101" (mirror without the edge row —
    OpenCV BORDER_DEFAULT, the Sobel border)."""
    return _halo(x, k, mesh, axis, 0, edge_mode)


def _halo_x_mode(x, k, mesh, axis, edge_mode):
    """halo_x with the extra reflect101 edge mode (column version)."""
    return _halo(x, k, mesh, axis, 1, edge_mode)


def _halo2d(x, k, mesh, ay, ax, edge_mode="edge"):
    """Extend a (th, tw, ...) tile by k in both axes (2-pass: the y-pass
    carries the x-halos, so corners arrive from diagonal neighbours)."""
    return halo_y(_halo_x_mode(x, k, mesh, ax, edge_mode), k, mesh, ay, edge_mode)


def _sobel_tile(tile, mesh, ay, ax):
    """3x3 Sobel /8 on a tile: 1-px halo exchange, reflect-101 at global
    borders — identical values to pyr.sobel on the full level."""
    p = _halo2d(tile, 1, mesh, ay, ax, "reflect101")
    diff_x = p[:, 2:] - p[:, :-2]
    smooth_x = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
    dx = (diff_x[:-2] + 2.0 * diff_x[1:-1] + diff_x[2:]) * 0.125
    dy = (smooth_x[2:] - smooth_x[:-2]) * 0.125
    return dx, dy


def _conv_v_sharded(img, coeffs, mesh, axis):
    r = len(coeffs) // 2
    xh = halo_y(img, r, mesh, axis, "edge")
    h = img.shape[0]
    out = torch.zeros_like(img)
    for k, c in enumerate(coeffs):
        if c != 0.0:
            out = out + c * xh[k : k + h]
    return out


def _shift_up_sharded(x, mesh, axis):
    """x[j-1, i] with zero at the global top edge."""
    idx, _ = _axis_info(mesh, axis)
    from_prev, _ = _exchange(mesh, axis, None, x[-1:])
    first = torch.zeros_like(x[:1]) if idx == 0 else from_prev
    return torch.cat([first, x[:-1]], dim=0)


def _shift_down_sharded(x, mesh, axis):
    idx, n = _axis_info(mesh, axis)
    _, from_next = _exchange(mesh, axis, x[:1], None)
    last = torch.zeros_like(x[:1]) if idx == n - 1 else from_next
    return torch.cat([x[1:], last], dim=0)


def _smoothness_2d(uu, vv, qa, mesh, ay, ax):
    ux = _conv_h_sharded(uu, rf.DERIV3, mesh, ax)
    uy = _conv_v_sharded(uu, rf.DERIV3, mesh, ay)
    vx = _conv_h_sharded(vv, rf.DERIV3, mesh, ax)
    vy = _conv_v_sharded(vv, rf.DERIV3, mesh, ay)
    s = rf._over(qa, torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + rf.EPS_SMOOTH))
    iy, ny = _axis_info(mesh, ay)
    ix, nx = _axis_info(mesh, ax)
    horiz = s + _shift_right_sharded(s, mesh, ax)
    if ix == nx - 1:
        horiz[:, -1] = 0.0
    vert = s + _shift_down_sharded(s, mesh, ay)
    if iy == ny - 1:
        vert[-1, :] = 0.0
    return horiz, vert


def _sub_laplacian_2d(b, src, wh, wv, mesh, ay, ax):
    th_ = wh * (_shift_right_sharded(src, mesh, ax) - src)
    tv = wv * (_shift_down_sharded(src, mesh, ay) - src)
    return (b + th_ - _shift_left_sharded(th_, mesh, ax) + tv
            - _shift_up_sharded(tv, mesh, ay))


def _sor_rb_2d(du, dv, a11, a12, a22, b1, b2, wh, wv, iters, omega, mesh, ay, ax, nop):
    """Red-black SOR on a 2-D tile; global checkerboard colour, halo
    exchange in both axes per half-step.  dv/a12/a22/b2 ignored for nop=1."""
    h, wl = du.shape
    iy, _ = _axis_info(mesh, ay)
    ix, _ = _axis_info(mesh, ax)
    # The global checkerboard's red cells, (x + y) % 2 == 0 (equal tile sizes).
    jj = torch.arange(h, device=du.device)[:, None] + iy * h
    ii = torch.arange(wl, device=du.device)[None, :] + ix * wl
    red = (ii + jj) % 2 == 0

    sum_dpsis = _shift_up_sharded(wv, mesh, ay) + _shift_left_sharded(wh, mesh, ax) + wv + wh
    inv11 = rf._over(omega, a11 + sum_dpsis)

    def nb(x):
        return (_shift_up_sharded(wv * x, mesh, ay) + _shift_left_sharded(wh * x, mesh, ax)
                + wv * _shift_down_sharded(x, mesh, ay)
                + wh * _shift_right_sharded(x, mesh, ax))

    if nop == 2:
        inv22 = rf._over(omega, a22 + sum_dpsis)

        def half(du, dv, mask):
            B1 = b1 + nb(du)
            du = torch.where(mask, (1 - omega) * du + inv11 * (B1 - a12 * dv), du)
            B2 = b2 + nb(dv)
            dv = torch.where(mask, (1 - omega) * dv + inv22 * (B2 - a12 * du), dv)
            return du, dv

        for _ in range(iters):
            du, dv = half(du, dv, red)
            du, dv = half(du, dv, ~red)
        return du, dv

    def half1(du, mask):
        B1 = b1 + nb(du)
        return torch.where(mask, (1 - omega) * du + inv11 * B1, du)

    for _ in range(iters):
        du = half1(du, red)
        du = half1(du, ~red)
    return du, dv


def _warp_2d(src_tile, wx, wy, y0, x0, ty0, tx0, w, h):
    """Warp a (th, tw) flow tile against a halo'd raw image tile whose row 0
    sits at (ty0, tx0) of the global raw level.  Taps are clamped globally
    (reference semantics) then into the tile (exact when |flow| <= the halo
    width — the max_disp contract)."""
    th, tw = wx.shape
    lth, ltw = src_tile.shape[:2]
    dev = wx.device
    jj = torch.arange(th, dtype=torch.float32, device=dev)[:, None] + y0
    ii = torch.arange(tw, dtype=torch.float32, device=dev)[None, :] + x0
    xx = ii + wx
    yy = jj + wy
    x = torch.floor(xx)
    y = torch.floor(yy)
    dx = (xx - x)[..., None]
    dy = (yy - y)[..., None]
    mask = ((xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)).float()
    x, y = x.long(), y.long()
    cx = lambda v: (v.clamp(0, w - 1) - tx0).clamp(0, ltw - 1)  # noqa: E731
    cy = lambda v: (v.clamp(0, h - 1) - ty0).clamp(0, lth - 1)  # noqa: E731
    x1, x2, y1, y2 = cx(x), cx(x + 1), cy(y), cy(y + 1)
    flat = src_tile.reshape(-1, src_tile.shape[2])
    g = lambda yi, xi: flat[yi * ltw + xi]  # noqa: E731
    dst = (g(y1, x1) * (1 - dx) * (1 - dy) + g(y1, x2) * dx * (1 - dy)
           + g(y2, x1) * (1 - dx) * dy + g(y2, x2) * dx * dy)
    return dst, mask


def _get_derivatives_2d(im1, im2w, mesh, ay, ax):
    mean = 0.5 * (im1 + im2w)
    iz = im2w - im1
    ix = _conv_h_sharded(mean, rf.DERIV5, mesh, ax)
    iy = _conv_v_sharded(mean, rf.DERIV5, mesh, ay)
    ixx = _conv_h_sharded(ix, rf.DERIV5, mesh, ax)
    ixy = _conv_v_sharded(ix, rf.DERIV5, mesh, ay)
    iyy = _conv_v_sharded(iy, rf.DERIV5, mesh, ay)
    ixz = _conv_h_sharded(iz, rf.DERIV5, mesh, ax)
    iyz = _conv_v_sharded(iz, rf.DERIV5, mesh, ay)
    return ix, iy, iz, ixx, ixy, iyy, ixz, iyz


def _refine_level_2d(flow_tile, im1_tile, im2_tile, y0, x0, ty0, tx0,
                     level, cfg, mesh, ay, ax, w, h, camlr=None):
    """refine_level on a 2-D tile: the TV inner loop of one level
    (refine_variational.cpp:152-336) with halo-exchanged stencils.  im1
    tile is interior-only (halo via exchange), im2 tile is halo'd for the
    warp; ay None refines a column strip.  camlr overrides cfg.camlr for
    the backward (fb-merge) stereo grid."""
    if camlr is None:
        camlr = cfg.camlr
    nop = cfg.nop
    wx = flow_tile[..., 0]
    wy = flow_tile[..., 1] if nop == 2 else torch.zeros_like(wx)
    im2w, mask = _warp_2d(im2_tile, wx, wy, y0, x0, ty0, tx0, w, h)
    derivs = _get_derivatives_2d(im1_tile, im2w, mesh, ay, ax)
    qa = 0.25 * cfg.tv_alpha
    hd3 = cfg.tv_delta * 0.5 / 3.0
    hg3 = cfg.tv_gamma * 0.5 / 3.0
    du = torch.zeros_like(wx)
    dv = torch.zeros_like(wx)
    uu, vv = wx, wy
    for _ in range(cfg.tv_innerit * (level + 1)):
        wh, wv_ = _smoothness_2d(uu, vv, qa, mesh, ay, ax)
        a11, a12, a22, b1, b2 = rf.compute_data(du, dv, mask, derivs, hd3, hg3, nop)
        b1 = _sub_laplacian_2d(b1, wx, wh, wv_, mesh, ay, ax)
        if nop == 2:
            b2 = _sub_laplacian_2d(b2, wy, wh, wv_, mesh, ay, ax)
        du, dv = _sor_rb_2d(du, dv, a11, a12, a22, b1, b2, wh, wv_, cfg.tv_solverit,
                            cfg.tv_sor, mesh, ay, ax, nop)
        if nop == 2:
            uu = wx + du
            vv = wy + dv
        elif camlr == 0:  # disparity sign clamp (refine_variational.cpp:299-314)
            uu = torch.clamp(wx + du, max=0.0)
        else:
            uu = torch.clamp(wx + du, min=0.0)
    if nop == 2:
        return torch.stack([uu, vv], dim=-1)
    return uu[..., None]


def _halo_reduce_2d(acc, k, mesh, ay, ax):
    """Fold a tile-local splat's k-wide border accumulations into the
    neighbours (2-pass: x then y propagates corners).  acc (th+2k, tw+2k, K);
    edge-tile outer borders (out-of-image footprints) are dropped — exactly
    the reference's global bounds check."""
    iy, ny = _axis_info(mesh, ay)
    ix, nx = _axis_info(mesh, ax)
    acc = acc.clone()
    from_left, from_right = _exchange(mesh, ax, acc[:, :k], acc[:, -k:])
    acc[:, k : 2 * k] += torch.zeros_like(acc[:, :k]) if ix == 0 else from_left
    acc[:, -2 * k : -k] += torch.zeros_like(acc[:, :k]) if ix == nx - 1 else from_right
    from_top, from_bot = _exchange(mesh, ay, acc[:k], acc[-k:])
    acc[k : 2 * k] += torch.zeros_like(acc[:k]) if iy == 0 else from_top
    acc[-2 * k : -k] += torch.zeros_like(acc[:k]) if iy == ny - 1 else from_bot
    return acc[k:-k, k:-k]


def _halo_width(cfg: DISConfig, max_disp: float) -> int:
    """H: the image halo of a tile, psz + ceil(max_disp) + 2."""
    return cfg.patch_size + int(np.ceil(max_disp)) + 2


def _level_2d(tile1, tile2, flow_prev, flow_bw_prev, prev_is_full, own,
              sl, lw, lh, cfg, mesh, ay, ax, max_disp):
    """One pyramid level on TILE-LOCAL data: tile1/tile2 are this rank's
    (th, tw, C) raw level tiles.  Gradients, padded search tiles and the
    warp-source tile are built by HALO EXCHANGE — nothing full-size is ever
    materialized per rank.  own: the level's patches this tile owns, a
    long tensor on the device (tile_ownership's valid entries; possibly
    none).  flow_prev is the
    rank's coarser flow TILE (th/2, tw/2, nop), or the full coarser field
    when the previous level ran replicated (prev_is_full).  Returns
    (flow_tile (th, tw, nop), flow_bw_tile or None, n_clamped), n_clamped
    a (1,) int64 tensor on the device, summed over the tiles."""
    pad = cfg.patch_size
    psz = cfg.patch_size
    nop = cfg.nop
    dev = tile1.device
    iy, _ = _axis_info(mesh, ay)
    ix, _ = _axis_info(mesh, ax)
    th, tw, _ = tile1.shape
    y0 = iy * th
    x0 = ix * tw
    hp_g, wp_g = lh + 2 * pad, lw + 2 * pad
    H = _halo_width(cfg, max_disp)

    # Tile-local gradients (1-px halo exchange; reflect-101 global borders).
    dx1_t, dy1_t = _sobel_tile(tile1, mesh, ay, ax)

    # Halo'd padded tiles: an H-wide exchange with replicate (images) / zero
    # (gradients) global borders reproduces exactly the corresponding region
    # of the full padded level arrays.  Frame origin in global padded
    # coordinates is (y0 + pad - H, x0 + pad - H) — possibly negative; such
    # virtual rows are replicas/zeros and are never selected (window bases
    # are clipped to the global padded extent).
    im1p_t = _halo2d(tile1, H, mesh, ay, ax, "edge")
    im2p_t = _halo2d(tile2, H, mesh, ay, ax, "edge")
    dx1p_t = _halo2d(dx1_t, H, mesh, ay, ax, "zero")
    dy1p_t = _halo2d(dy1_t, H, mesh, ay, ax, "zero")
    sy0 = y0 + pad - H
    sx0 = x0 + pad - H

    geo, pt_full, coarse_idx = _grid_tensors(lw, lh, cfg, dev)
    pt_own = pt_full[own]

    def warm_start(prev):
        """(p_init, clamp-hit count) from the coarser flow (full or tiled);
        the count an int64 tensor on the device."""
        if prev is None:
            return (torch.zeros((own.shape[0], nop), dtype=torch.float32, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))
        cidx = coarse_idx[own]
        cw = max(lw // 2, 1)
        if prev_is_full:
            p_raw = 2.0 * prev.reshape(-1, nop)[cidx]
        else:
            # Tiled coarser flow: a patch center inside this tile always
            # maps into this rank's coarser tile (tiles halve exactly).
            th2, tw2 = prev.shape[:2]
            ly = (cidx // cw - y0 // 2).clamp(0, th2 - 1)
            lx = (cidx % cw - x0 // 2).clamp(0, tw2 - 1)
            p_raw = 2.0 * prev.reshape(-1, nop)[ly * tw2 + lx]
        # The max_disp contract; count hits (silent degradation guard).
        hit = torch.any(torch.abs(p_raw) > max_disp, dim=1)
        return p_raw.clamp(-max_disp, max_disp), hit.sum()

    tile = (sy0, sx0, hp_g, wp_g)
    p_init, ncl_fw = warm_start(flow_prev)
    res = res_bw = None
    if own.numel():
        tmpl = build_templates(im1p_t, dx1p_t, dy1p_t, pt_own, cfg, pad, tile_origin=(sy0, sx0))
        res = kernels.gn_search(im2p_t, tmpl, pt_own, p_init, cfg, lw, lh, pad, tile=tile)

    ncl_bw = None
    if cfg.use_fb_merge:
        # Backward grid on the same tile ownership: swapped images, flipped
        # camera (oflow.cpp:154-157).
        dx2_t, dy2_t = _sobel_tile(tile2, mesh, ay, ax)
        dx2p_t = _halo2d(dx2_t, H, mesh, ay, ax, "zero")
        dy2p_t = _halo2d(dy2_t, H, mesh, ay, ax, "zero")
        p_init_bw, ncl_bw = warm_start(flow_bw_prev)
        if own.numel():
            tmpl_bw = build_templates(im2p_t, dx2p_t, dy2p_t, pt_own, cfg, pad,
                                      tile_origin=(sy0, sx0))
            res_bw = kernels.gn_search(im1p_t, tmpl_bw, pt_own, p_init_bw, cfg, lw, lh, pad,
                                       camlr=1 - cfg.camlr, tile=tile)
    counts = (ncl_fw if ncl_bw is None else ncl_fw + ncl_bw).reshape(1)
    n_clamped = _psum(_psum(counts, mesh, ax), mesh, ay)

    # --- tile-local densify + halo reduce (no full-image psum) ---
    # fb-merge splats at the CONVERGED backward positions (up to max_disp +
    # psz/2 + 1 from the static centres), so the accumulator halo must be
    # H-wide then; pure-forward splats reach only psz.
    ks = H if cfg.use_fb_merge else psz
    acc_shape = (th + 2 * ks, tw + 2 * ks)

    def densify_tile(r_fw, r_bw):
        if r_fw is None:  # no patches here: this tile adds nothing
            acc = torch.zeros((*acc_shape, 1 + nop), dtype=torch.float32, device=dev)
        else:
            pt_loc = torch.stack([pt_own[:, 0] - float(x0 - ks), pt_own[:, 1] - float(y0 - ks)],
                                 dim=1)
            we, fo = splat_forward_scatter(r_fw.p, result_absw(r_fw, cfg), pt_loc,
                                           acc_shape[1], acc_shape[0], cfg)
            if r_bw is not None:
                we, fo = merge_backward(we, fo, r_bw, lw, lh, cfg, origin=(y0 - ks, x0 - ks),
                                        acc_shape=acc_shape)
            acc = torch.cat([we[:, None], fo], dim=1).reshape(*acc_shape, 1 + nop)
        acc = _halo_reduce_2d(acc, ks, mesh, ay, ax)
        return _normalize(acc[..., 0], acc[..., 1:])

    flow = densify_tile(res, res_bw)
    flow_bw = None
    if cfg.use_fb_merge and sl > cfg.sc_l:
        flow_bw = densify_tile(res_bw, res)

    if cfg.use_tv_refine:
        # Warp-source tile: im2p_t IS the H-wide replicate-halo'd raw tile —
        # taps beyond it clamp into the halo (the max_disp contract);
        # global-border taps see the replicate values, i.e. exactly the
        # reference's clamp-to-edge.
        flow = _refine_level_2d(flow, tile1, im2p_t, y0, x0, y0 - H, x0 - H, sl, cfg, mesh,
                                ay, ax, lw, lh, camlr=cfg.camlr)
        if flow_bw is not None:
            flow_bw = _refine_level_2d(flow_bw, tile2, im1p_t, y0, x0, y0 - H, x0 - H, sl, cfg,
                                       mesh, ay, ax, lw, lh, camlr=1 - cfg.camlr)
    return flow, flow_bw, n_clamped


def _gather_2d(t, mesh, ay, ax):
    """Every rank's tile of a (ty, tx) mesh, assembled in full on each."""
    return _all_gather(_all_gather(t, mesh, ax, 1), mesh, ay, 0)


def _pair_2d(tile1, tile2, h, w, own, cfg, mesh, ay, ax, max_disp):
    """Coarse-to-fine flow for one padded (h, w) pair on a (ty, tx) tile
    mesh.  tile1, tile2: this rank's (h / nty, w / ntx, C) slices of the
    padded pair when any level is tiled, else the whole pair.  own: this
    rank's owned patches per tiled level (`_own_tensors`).

    Levels in `own` (a CONTIGUOUS run from sc_l upward; tile_ownership
    enforces it) run tile-local: each rank builds its raw tile chain
    bottom-up from its input slice (one 2^sc_l box average + local 2x2
    averages — non-overlapping boxes never straddle tile borders, so the
    pyramid needs no halo at all).  Levels above the run are replicated:
    their full images derive from ONE gather of the coarsest tiled level's
    tiles (small).  Only the final finest flow is gathered full-size.

    Returns (flow, clamp_counts): clamp_counts["lv<sl>"] a (1,) int64
    tensor on the device."""
    pad = cfg.patch_size
    tiled_lvls = sorted(int(k[2:]) for k in own)
    sl_t = tiled_lvls[-1] if tiled_lvls else cfg.sc_l - 1

    # --- per-rank raw tile chain for the tiled levels ---
    tiles = {}
    if tiled_lvls:
        for key, img in (("t1", tile1), ("t2", tile2)):
            t = pyr.box_average(img, 1 << cfg.sc_l) if cfg.sc_l > 0 else img
            tiles[(key, cfg.sc_l)] = t
            for sl in range(cfg.sc_l + 1, sl_t + 1):
                t = pyr.downsample_half(t)
                tiles[(key, sl)] = t

    # --- full images for the replicated levels (above sl_t) ---
    levels = {}
    if sl_t < cfg.sc_f:
        n_lv = cfg.sc_f + 1
        if tiled_lvls:
            cur = [pyr.downsample_half(_gather_2d(tiles[(k, sl_t)], mesh, ay, ax))
                   for k in ("t1", "t2")]
            for sl in range(sl_t + 1, n_lv):
                if sl > sl_t + 1:
                    cur = [pyr.downsample_half(c) for c in cur]
                ims = []
                for c in cur:
                    dx_, dy_ = pyr.sobel(c)
                    ims += [pyr.pad_replicate(c, pad), pyr.pad_zero(dx_, pad),
                            pyr.pad_zero(dy_, pad)]
                levels[sl] = ims
        else:
            pyr1 = pyr.build_pyramid(tile1, n_lv, pad, first_level=cfg.sc_l)
            pyr2 = pyr.build_pyramid(tile2, n_lv, pad, first_level=cfg.sc_l)
            levels = {sl: [p[sl] for p in pyr1 + pyr2] for sl in range(cfg.sc_l, n_lv)}

    flow = None
    flow_bw = None
    prev_is_full = True
    clamp_counts = {}
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lw, lh = w >> sl, h >> sl
        if f"lv{sl}" in own:
            flow, flow_bw, nclamp = _level_2d(
                tiles[("t1", sl)], tiles[("t2", sl)], flow, flow_bw, prev_is_full,
                own[f"lv{sl}"], sl, lw, lh, cfg, mesh, ay, ax, max_disp,
            )
            clamp_counts[f"lv{sl}"] = nclamp
            prev_is_full = False
        else:
            flow, flow_bw = _replicated_level(levels[sl], flow, flow_bw, sl, lw, lh, cfg)
            prev_is_full = True
    if not prev_is_full:  # finest level ran tiled: gather once at the end
        flow = _gather_2d(flow, mesh, ay, ax)
    return flow, clamp_counts


def tile_ownership(h, w, cfg, ny, nx, max_disp):
    """Static patch-ownership tables per tileable level of an (h, w) pair on
    an (ny, nx) tile grid — shared by spatial_flow_tiled and the 3-axis
    (data, ty, tx) composition (multihost.flow_2d_tiled).  NumPy, so the
    tables equal the JAX package's.

    Tile-local levels must form a CONTIGUOUS run from sc_l upward (the
    per-rank raw tile chain and the tiled flow_prev handoff both assume
    it): stop at the first non-tileable level.  Returns own["lv<sl>"] =
    (idx (ny, nx, K) int32, valid (ny, nx, K) bool): tile (ty, tx) owns
    the patches idx[ty, tx][valid[ty, tx]]."""
    H = _halo_width(cfg, max_disp)
    own = {}
    for sl in range(cfg.sc_l, cfg.sc_f + 1):
        lw, lh = w >> sl, h >> sl
        th, tw = lh // ny, lw // nx
        tileable = (
            lh % ny == 0 and lw % nx == 0
            # one-hop halo exchange: neighbours must hold the whole halo
            # (H > psz always, so this also covers the patch-fits bound)
            and th >= H and tw >= H
        )
        if not tileable:
            break
        geo = level_geometry(lw, lh, cfg)
        if geo.n_patches == 0:
            break
        ty = np.clip(geo.pt_ref[:, 1].astype(np.int64) // th, 0, ny - 1)
        tx = np.clip(geo.pt_ref[:, 0].astype(np.int64) // tw, 0, nx - 1)
        owner = ty * nx + tx
        counts = np.bincount(owner, minlength=ny * nx)
        kmax = max(int(counts.max()), 1)
        idx = np.zeros((ny, nx, kmax), np.int32)
        valid = np.zeros((ny, nx, kmax), bool)
        for t in range(ny * nx):
            mine = np.nonzero(owner == t)[0]
            idx[t // nx, t % nx, : mine.size] = mine
            valid[t // nx, t % nx, : mine.size] = True
        own[f"lv{sl}"] = (idx, valid)
    return own


@lru_cache(maxsize=64)
def _own_cached(h, w, cfg, ny, nx, max_disp, iy, ix, device):
    return {k: torch.as_tensor(idx[iy, ix][valid[iy, ix]], dtype=torch.long, device=device)
            for k, (idx, valid) in tile_ownership(h, w, cfg, ny, nx, max_disp).items()}


def _own_tensors(h: int, w: int, cfg: DISConfig, mesh, ay: str, ax: str, max_disp: float,
                 device) -> Dict[str, torch.Tensor]:
    """This rank's owned patches per tiled level of an (h, w) pair
    (tile_ownership's valid entries of its tile), as long tensors on
    `device`, copied there once per key.  A graph being captured reads them
    from outside its pool, so its executable holds them (graphs.hold)."""
    iy, ny = _axis_info(mesh, ay)
    ix, nx = _axis_info(mesh, ax)
    own = _own_cached(h, w, cfg, ny, nx, float(max_disp), iy, ix, device)
    graphs.hold(*own.values())
    return own


def _input_tiles(img1p, img2p, own, mesh, ay, ax):
    """This rank's slices of a padded pair when any level is tiled (the JAX
    package shards the inputs over (ty, tx) then), else the whole pair."""
    if not own:
        return img1p, img2p
    iy, ny = _axis_info(mesh, ay)
    ix, nx = _axis_info(mesh, ax)
    th, tw = img1p.shape[0] // ny, img1p.shape[1] // nx
    return tuple(im[iy * th : (iy + 1) * th, ix * tw : (ix + 1) * tw] for im in (img1p, img2p))


@sharded
def _tiled_pass(mesh, img1p, img2p, cfg: DISConfig, ay: str, ax: str, max_disp: float):
    """spatial_flow_tiled's pass on one rank, as an executable: (flow,
    clamp_counts), the counts (1,) int64 tensors on the device."""
    h, w = img1p.shape[:2]
    own = _own_tensors(h, w, cfg, mesh, ay, ax, max_disp, img1p.device)
    t1, t2 = _input_tiles(img1p, img2p, own, mesh, ay, ax)
    return _pair_2d(t1, t2, h, w, own, cfg, mesh, ay, ax, max_disp)


def spatial_tiled_fn(cfg: DISConfig, mesh, h: int, w: int,
                     axes: Tuple[str, str] = ("ty", "tx"), max_disp: float = 8.0):
    """The bare 2-D tiled pipeline behind spatial_flow_tiled plus its static
    ownership tables: returns (fn, own) with fn(img1p, img2p) -> (flow,
    clamp_counts), run by every rank of the mesh on the whole padded (h, w,
    C) pair on its device, through its executable (`_tiled_pass`, which
    reads this rank's entries of own as device tensors, copied once per
    key); clamp_counts["lv<sl>"] is a (1,) int64 tensor on the device."""
    ay, ax = axes
    own = tile_ownership(h, w, cfg, _axis_size(mesh, ay), _axis_size(mesh, ax), max_disp)

    def fn(img1p, img2p):
        return _tiled_pass(mesh, img1p, img2p, cfg, ay, ax, float(max_disp))
    return fn, own


def spatial_flow_tiled(img1, img2, cfg: DISConfig, mesh,
                       axes: Tuple[str, str] = ("ty", "tx"), max_disp: float = 8.0,
                       return_diagnostics: bool = False):
    """Flow/disparity for ONE pair spatially tiled over a 2-D (ty, tx) mesh
    with tiled level images (section contract: warm-start displacement
    clamped to +-max_disp in the tiled levels).  Every rank calls it with
    the same padded pair and gets the whole flow at scale sc_l.

    With return_diagnostics=True, returns (flow, clamp_counts) where
    clamp_counts maps "lv<sl>" -> number of patches whose warm start was
    clamped at that level.  A nonzero count means the result deviates from
    the single-device pipeline for fast content (the max_disp contract) —
    callers should raise max_disp or fall back to spatial_flow."""
    cfg.validate()
    a, b = _padded_pair(img1, img2, cfg, _mesh_device(mesh))
    flow, clamp_counts = _tiled_pass(mesh, a, b, cfg, *axes, float(max_disp))
    if return_diagnostics:
        return flow, {k: int(v) for k, v in clamp_counts.items()}
    return flow
