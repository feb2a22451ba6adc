"""Coarse-to-fine DIS driver (dense inverse search optical flow and
stereo), PyTorch port of of_dis_tpu/models/dis.py (OFC::OFClass,
oflow.cpp:32-363, and the driver glue of run_dense.cpp:296-414):

    flow = dis_flow(img1, img2, cfg)          # (H, W, 2), on the card
    disp = dis_stereo(img1, img2, cfg)        # (H, W), left camera <= 0
    flow = dis_flow(img1, img2, cfg, device="cpu")

The scale loop is a Python loop, run once per static key: on the card
`dis_entry_jit` / `dis_entry_init_jit` capture a whole call in a CUDA graph
at their first call for a key and replay the graph after (ops/graphs.py);
on the CPU and under graphs.eager() it runs op by op.  A call is the
frames' conversion to float32 and divisibility padding
(ops/kernels.py::frame_pad), the padded pipeline (`_dis_padded`; alone it
is `dis_padded_jit` / `dis_padded_init_jit`, the JAX package's
executables, of_dis_tpu/models/dis.py:179-186), and the final upscale and
crop (ops/kernels.py::flow_upscale), so the frames enter the graph in
their own dtype (uint8 from a camera) and no full-resolution op runs
outside it.  Per scale sl = sc_f .. sc_l
(oflow.cpp:184-337): templates -> init from coarser flow (2x NN lookup) ->
level search -> deterministic densification (+ the forward-backward merge)
-> variational refinement.  With fb-merge (cfg.use_fb_merge) a backward
search runs on the swapped images with the flipped camera, its flow is
merged into the forward one, and above the finest scale it is densified,
refined and carried to the next level too (oflow.cpp:154-157, 269-294).
The search runs in one of two CUDA kernels, as ops/kernels.py::search_route
decides for the level's shape: csrc/level_search.cu extracts the templates
itself, csrc/gn_search.cu takes them from `build_templates`.  Refinement
runs csrc/refine_inner.cu (flow) or csrc/sor_rb.cu's scalar SOR (stereo).
Final: upscale by 2^sc_l (INTER_LINEAR, flow values scaled) and crop the
divisibility padding (run_dense.cpp:406-414), inside the entry's
executable (the JAX package does both outside its jit).

Every stage runs on a batch of pairs (B, Hp, Wp, C), each kernel launch
taking all B; `dis_raw` runs one pair as a batch of one, and
parallel/batch.py::batched_flow runs B.  Entry points run on CUDA unless
the caller passes device="cpu"; without a GPU they raise.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from ..config import DISConfig
from ..ops import graphs, kernels
from ..ops import pyramid as pyr
from ..ops.transfer import to_device
from .densify import aggregate_flow_dense
from .grid import level_geometry
from .inverse_search import PatchTemplates, build_templates
from .refine import refine_level


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another; raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "of_dis_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@lru_cache(maxsize=64)
def _grid_tensors_cached(w: int, h: int, cfg: DISConfig, device: torch.device):
    geo = level_geometry(w, h, cfg)
    pt_ref = torch.as_tensor(geo.pt_ref, device=device)
    coarse_idx = torch.as_tensor(geo.coarse_idx, device=device).long()
    return geo, pt_ref, coarse_idx


def _grid_tensors(w: int, h: int, cfg: DISConfig, device: torch.device):
    """Level geometry plus its patch centres and coarse-init indices on
    `device`, copied there once per level shape.  A graph being captured
    reads the two tensors from outside its pool, so its executable holds
    them (graphs.hold): the lru_cache may drop them while the graph lives."""
    geo, pt_ref, coarse_idx = _grid_tensors_cached(w, h, cfg, device)
    graphs.hold(pt_ref, coarse_idx)
    return geo, pt_ref, coarse_idx


def _stage_templates(im_a, dx_a, dy_a, im_b, dx_b, dy_b, pt_ref, cfg: DISConfig, pad: int):
    """Stage 'pconst': template extraction + Hessians (patchgrid.cpp:109-114)
    of the forward grid, and of the backward grid with fb-merge (else None).
    kernels.search_route decides once per level shape, for both directions:
    on levels it sends to the whole-level search the templates are made
    inside that kernel, and this stage forwards the level images (hes
    None); elsewhere they are built here for gn_search.  Counts the level
    in kernels.routes (a replay adds what its capture counted)."""
    hp, wp, c = im_a.shape[-3:]
    psz = cfg.patch_size
    route = kernels.search_route(hp, wp, c, pt_ref.shape[0], psz,
                                 min(2 * psz + 2, hp), min(2 * psz + 2, wp))
    kernels.routes[route] += 1

    def templates(im, dx, dy):
        if route == "level":
            return PatchTemplates(tmp=im, dx=dx, dy=dy, hes=None)
        return build_templates(im, dx, dy, pt_ref, cfg, pad)

    tmpl_bw = templates(im_b, dx_b, dy_b) if cfg.use_fb_merge else None
    return templates(im_a, dx_a, dy_a), tmpl_bw


def _stage_init(flow_prev: Optional[torch.Tensor], coarse_idx, b: int, n: int,
                cfg: DISConfig, device) -> torch.Tensor:
    """Stage 'pinit': InitializeFromCoarserOF (patchgrid.cpp:195-211),
    a 2x NN upsample of the coarser flow (zeros at the coarsest scale), for
    b pairs: (b, n, nop).  flow_prev is (b, h, w, nop), or (h, w, nop)
    shared by the batch (a warm start)."""
    if flow_prev is None:
        return torch.zeros((b, n, cfg.nop), dtype=torch.float32, device=device)
    h, w = flow_prev.shape[-3:-1]
    init = 2.0 * flow_prev.reshape(-1, h * w, cfg.nop)[:, coarse_idx]
    return init.expand(b, n, cfg.nop).contiguous()


def _search(tmpl: PatchTemplates, im_b, pt_ref, p_init, cfg: DISConfig, w: int, h: int,
            pad: int, camlr: Optional[int] = None):
    """One direction's level search, in the kernel the templates stage
    chose, inside the host span dis.search.level or dis.search.gn (seen by
    a profiler in eager runs and captures; a replay runs no host code);
    camlr overrides cfg.camlr (the stereo sign clamp)."""
    if tmpl.hes is None:
        with torch.profiler.record_function("dis.search.level"):
            return kernels.level_search(tmpl.tmp, tmpl.dx, tmpl.dy, im_b, pt_ref, p_init,
                                        cfg, w, h, pad, camlr=camlr)
    with torch.profiler.record_function("dis.search.gn"):
        return kernels.gn_search(im_b, tmpl, pt_ref, p_init, cfg, w, h, pad, camlr=camlr)


def _stage_optimize(im_a, im_b, tmpl_fw, tmpl_bw, pt_ref, p_init, p_init_bw,
                    cfg: DISConfig, w: int, h: int, pad: int):
    """Stage 'poptim': the level search, forward (+ backward for fb-merge,
    the images swapped and the camera flipped, oflow.cpp:154-157)."""
    res_fw = _search(tmpl_fw, im_b, pt_ref, p_init, cfg, w, h, pad)
    res_bw = None
    if cfg.use_fb_merge:
        res_bw = _search(tmpl_bw, im_a, pt_ref, p_init_bw, cfg, w, h, pad,
                         camlr=1 - cfg.camlr)
    return res_fw, res_bw


def _stage_densify(res_fw, res_bw, sl: int, geo, cfg: DISConfig):
    """Stage 'cflow': weighted aggregation (+ fb merge); the backward flow is
    only needed above the finest scale (oflow.cpp:269-270)."""
    flow_fw = aggregate_flow_dense(res_fw, geo, cfg, bw_result=res_bw)
    flow_bw = None
    if cfg.use_fb_merge and sl > cfg.sc_l:
        flow_bw = aggregate_flow_dense(res_bw, geo, cfg, bw_result=res_fw)
    return flow_fw, flow_bw


def _stage_refine(flow_fw, flow_bw, im_a_raw, im_b_raw, sl: int, cfg: DISConfig):
    """Stage 'tvopt': variational refinement of the forward flow (and of
    the backward flow when it is carried, on the swapped images with the
    flipped camera, oflow.cpp:291-294)."""
    if not cfg.use_tv_refine:
        return flow_fw, flow_bw
    flow_fw = refine_level(flow_fw, im_a_raw, im_b_raw, sl, cfg, camlr=cfg.camlr)
    if flow_bw is not None:
        flow_bw = refine_level(flow_bw, im_b_raw, im_a_raw, sl, cfg, camlr=1 - cfg.camlr)
    return flow_fw, flow_bw


def _level_flow(im_a, dx_a, dy_a, im_b, dx_b, dy_b, flow_prev, flow_bw_prev, sl: int,
                w: int, h: int, cfg: DISConfig, im_a_raw, im_b_raw):
    """One pyramid level of a batch: (flow_fw, flow_bw or None), each
    (B, h, w, nop).  Composed of the _stage_* functions above, which
    utils/instrument.py times one by one for the -v 2 table."""
    pad = cfg.patch_size
    geo, pt_ref, coarse_idx = _grid_tensors(w, h, cfg, im_a.device)
    b, n = im_a.shape[0], geo.n_patches
    tmpl_fw, tmpl_bw = _stage_templates(im_a, dx_a, dy_a, im_b, dx_b, dy_b, pt_ref, cfg, pad)
    p_init = _stage_init(flow_prev, coarse_idx, b, n, cfg, im_a.device)
    p_init_bw = (_stage_init(flow_bw_prev, coarse_idx, b, n, cfg, im_a.device)
                 if cfg.use_fb_merge else None)
    res_fw, res_bw = _stage_optimize(im_a, im_b, tmpl_fw, tmpl_bw, pt_ref, p_init, p_init_bw,
                                     cfg, w, h, pad)
    flow_fw, flow_bw = _stage_densify(res_fw, res_bw, sl, geo, cfg)
    return _stage_refine(flow_fw, flow_bw, im_a_raw, im_b_raw, sl, cfg)


def _pyramids(img1, img2, cfg: DISConfig, gradmag_input: bool):
    """Both pyramids of a batch (B, H, W, C), levels sc_l .. sc_f: (im1s,
    dx1s, dy1s, im2s, dx2s, dy2s).  img2's gradients are kept only for
    fb-merge, whose backward search alone reads them."""
    n_lv, pad = cfg.sc_f + 1, cfg.patch_size
    im1s, dx1s, dy1s = pyr.build_pyramid(img1, n_lv, pad, gradmag_input, first_level=cfg.sc_l)
    im2s, dx2s, dy2s = pyr.build_pyramid(img2, n_lv, pad, gradmag_input, first_level=cfg.sc_l)
    if not cfg.use_fb_merge:
        dx2s = dy2s = [None] * n_lv
    return im1s, dx1s, dy1s, im2s, dx2s, dy2s


def _dis_padded(img1, img2, cfg: DISConfig, init_flow=None, gradmag_input: bool = False):
    """Run DIS on a batch of pairs (B, H, W, C), already padded to
    divisibility by 2^sc_f.  init_flow, at scale sc_f+1, is (B, h, w, nop)
    or (h, w, nop) shared by the batch; it seeds the forward flow only.

    Returns flow at scale sc_l: (B, H/2^sc_l, W/2^sc_l, nop)."""
    h, w = img1.shape[1:3]
    if w % (1 << cfg.sc_f) or h % (1 << cfg.sc_f):
        raise ValueError(f"image dims {h}x{w} not divisible by 2^{cfg.sc_f}")
    pad = cfg.patch_size
    im1s, dx1s, dy1s, im2s, dx2s, dy2s = _pyramids(img1, img2, cfg, gradmag_input)

    flow = init_flow  # sized for scale sc_f+1 when provided (oflow.cpp:217-220)
    flow_bw = None
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lw, lh = w >> sl, h >> sl
        raw1 = im1s[sl][:, pad:-pad, pad:-pad]
        raw2 = im2s[sl][:, pad:-pad, pad:-pad]
        flow, flow_bw = _level_flow(im1s[sl], dx1s[sl], dy1s[sl], im2s[sl], dx2s[sl], dy2s[sl],
                                    flow, flow_bw, sl, lw, lh, cfg, raw1, raw2)
    return flow


@graphs.executable
def dis_padded_jit(img1, img2, cfg: DISConfig, gradmag_input: bool = False):
    """_dis_padded without a warm start, one executable per (cfg,
    gradmag_input, shapes): (B, Hp, Wp, C) pairs padded to divisibility by
    2^sc_f -> (B, Hp/2^sc_l, Wp/2^sc_l, nop)."""
    return _dis_padded(img1, img2, cfg, None, gradmag_input)


@graphs.executable
def dis_padded_init_jit(img1, img2, init_flow, cfg: DISConfig, gradmag_input: bool = False):
    """_dis_padded with init_flow at scale sc_f+1, (B, h, w, nop) or (h, w,
    nop) shared by the batch: one executable per key, its shape included."""
    return _dis_padded(img1, img2, cfg, init_flow, gradmag_input)


def _upscale_crop(flow, cfg: DISConfig, hp: int, wp: int, h0: int, w0: int):
    """Flow (B, h_l, w_l, nop) at scale sc_l of (Hp, Wp) padded pairs ->
    (B, h0, w0, nop): upscaled by 2^sc_l (run_dense.cpp:406-411: values
    times 2^sc_l, INTER_LINEAR) and the divisibility padding cropped
    (run_dense.cpp:414)."""
    if cfg.sc_l != 0:
        flow = pyr.resize_bilinear(flow * float(1 << cfg.sc_l), hp, wp)
    t, _, l, _ = pyr.divisibility_padding(h0, w0, 1 << cfg.sc_f)
    return flow[:, t : t + h0, l : l + w0]


def _prepare(img1, img2, cfg: DISConfig, device, lead: int, own_dtype: bool = False):
    """Validated (..., H, W, C) tensors of a pair (lead 0) or a batch (lead
    1) on the resolved device, and that device: float32, or in the frames'
    own dtype with own_dtype (for the entry's executable, whose frame_pad
    converts them)."""
    cfg.validate()
    dev = resolve_device(device)
    img1 = to_device(img1, dev, own_dtype=own_dtype)
    img2 = to_device(img2, dev, own_dtype=own_dtype)
    if img1.ndim == lead + 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    if img1.ndim != lead + 3:
        raise ValueError(f"expected {'(B, ' if lead else '('}H, W[, C]) images, "
                         f"got shape {tuple(img1.shape)}")
    if img1.shape[-1] != cfg.channels:
        raise ValueError(f"expected {cfg.channels} channels, got {img1.shape[-1]}")
    if img1.shape != img2.shape:
        raise ValueError(f"image shapes differ: {tuple(img1.shape)} vs {tuple(img2.shape)}")
    return img1, img2, dev


def _dis_entry(img1, img2, cfg: DISConfig, init_flow=None, gradmag_input: bool = False):
    """A batch (B, H, W, C) of arbitrary size, in the frames' own dtype:
    conversion to float32 and divisibility padding (kernels.frame_pad),
    pyramid and coarse-to-fine (_dis_padded), final upscale + crop
    (kernels.flow_upscale) (run_dense.cpp:296-414).  Returns (B, H, W, nop)."""
    h0, w0 = img1.shape[1:3]
    p1, p2 = kernels.frame_pad(img1, img2, 1 << cfg.sc_f)
    flow = _dis_padded(p1, p2, cfg, init_flow, gradmag_input)
    return kernels.flow_upscale(flow, cfg, p1.shape[1], p1.shape[2], h0, w0)


@graphs.executable
def dis_entry_jit(img1, img2, cfg: DISConfig, gradmag_input: bool = False):
    """_dis_entry without a warm start, one executable per (cfg,
    gradmag_input, shapes and dtype of the frames): dis_raw's and
    batched_flow's whole call, (B, H, W, C) -> (B, H, W, nop)."""
    return _dis_entry(img1, img2, cfg, None, gradmag_input)


@graphs.executable
def dis_entry_init_jit(img1, img2, init_flow, cfg: DISConfig, gradmag_input: bool = False):
    """_dis_entry with init_flow at scale sc_f+1, (B, h, w, nop) or (h, w,
    nop) shared by the batch: one executable per key, its shape included."""
    return _dis_entry(img1, img2, cfg, init_flow, gradmag_input)


def dis_raw(img1, img2, cfg: DISConfig, init_flow=None, gradmag_input: bool = False,
            device=None) -> torch.Tensor:
    """Full driver on arbitrary-size (H, W[, C]) inputs (numpy arrays or
    tensors): divisibility padding, pyramid, coarse-to-fine, final upscale +
    crop (run_dense.cpp:296-414), as a batch of one pair through
    dis_entry_jit / dis_entry_init_jit.  Returns an (H, W, nop) float32
    tensor on `device` (CUDA unless given)."""
    img1, img2, dev = _prepare(img1, img2, cfg, device, 0, own_dtype=True)
    if init_flow is None:
        return dis_entry_jit(img1[None], img2[None], cfg, gradmag_input)[0]
    init = to_device(init_flow, dev)
    return dis_entry_init_jit(img1[None], img2[None], init, cfg, gradmag_input)[0]


def dis_flow(img1, img2, cfg: Optional[DISConfig] = None, **kw) -> torch.Tensor:
    """Optical flow: (H, W, 2) float32 (u, v) tensor.  Keyword arguments go
    to dis_raw (init_flow, gradmag_input, device)."""
    if cfg is None:
        from ..config import operating_point

        cfg = operating_point(2, img1.shape[1], channels=1 if img1.ndim == 2 else img1.shape[2])
    if cfg.mode != "flow":
        raise ValueError("cfg.mode must be 'flow'")
    return dis_raw(img1, img2, cfg, **kw)


def dis_stereo(img1, img2, cfg: Optional[DISConfig] = None, **kw) -> torch.Tensor:
    """Stereo disparity: (H, W) float32 tensor in the internal sign
    convention (left camera <= 0); io.write_pfm negates on write like the
    reference.  Keyword arguments go to dis_raw."""
    if cfg is None:
        from ..config import operating_point

        cfg = operating_point(2, img1.shape[1], mode="stereo",
                              channels=1 if img1.ndim == 2 else img1.shape[2])
    if cfg.mode != "stereo":
        raise ValueError("cfg.mode must be 'stereo'")
    return dis_raw(img1, img2, cfg, **kw)[..., 0]
