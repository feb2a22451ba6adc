"""The DIS driver (OFClass, oflow.cpp:32-363, and run_dense.cpp:296-414)
over a batch of pairs:

    flow = run(params, img1, img2)                 # (B, H, W, nop), float32
    flow = run(params, img1, img2, torch.bfloat16)  # the same computed in bfloat16

Divisibility padding, both pyramids, then per scale sc_f .. sc_l: the
patch grid, its start from the coarser flow (2x nearest lookup, zeros at
the coarsest scale), the search, densification, the TV refinement;
finally the upscale by 2^sc_l with the flow scaled, and the crop of the
padding.  Blocks of `block` pairs run one after another, so that memory
stays small.  The L2 cost without the forward-backward merge, as the
configurations run them (params.from_dict refuses others).
"""

from __future__ import annotations

import torch

from . import pyramid as pyr
from .densify import densify
from .params import Params
from .refine import refine_level
from .search import geometry, search


def _init(flow_prev, coarse_idx, b: int, n: int, p: Params, like: torch.Tensor):
    if flow_prev is None:
        return torch.zeros((b, n, p.nop), dtype=like.dtype, device=like.device)
    h, w = flow_prev.shape[-3:-1]
    return (2.0 * flow_prev.reshape(-1, h * w, p.nop)[:, coarse_idx]).contiguous()


def _padded(img1: torch.Tensor, img2: torch.Tensor, p: Params) -> torch.Tensor:
    """(B, Hp, Wp, C) pairs divisible by 2^sc_f -> flow at scale sc_l."""
    hp, wp = img1.shape[1:3]
    pad = p.patch_size
    im1s, dx1s, dy1s = pyr.build_pyramid(img1, p.sc_f + 1, pad, p.sc_l)
    im2s, _, _ = pyr.build_pyramid(img2, p.sc_f + 1, pad, p.sc_l)
    flow = None
    for sl in range(p.sc_f, p.sc_l - 1, -1):
        w, h = wp >> sl, hp >> sl
        geo = geometry(w, h, p)
        pt_ref = torch.as_tensor(geo.pt_ref, device=img1.device).to(img1.dtype)
        coarse_idx = torch.as_tensor(geo.coarse_idx, device=img1.device).long()
        b, n = img1.shape[0], geo.n_patches
        res = search(im1s[sl], dx1s[sl], dy1s[sl], im2s[sl], pt_ref,
                     _init(flow, coarse_idx, b, n, p, img1), p, w, h, pad, p.camlr)
        flow = densify(res, geo, p)
        if p.use_tv_refine:
            flow = refine_level(flow, im1s[sl][:, pad:-pad, pad:-pad],
                                im2s[sl][:, pad:-pad, pad:-pad], sl, p, p.camlr)
    return flow


def run(p: Params, img1: torch.Tensor, img2: torch.Tensor, dtype=torch.float32,
        block: int = 8) -> torch.Tensor:
    """Flow (B, H, W, nop) as float32, for pairs (B, H, W[, C]) of any
    numeric dtype, computed in `dtype` on the images' device."""
    if img1.ndim == 3:
        img1, img2 = img1[..., None], img2[..., None]
    h0, w0 = img1.shape[1:3]
    scf = 1 << p.sc_f
    t, _, l, _ = pyr.divisibility_padding(h0, w0, scf)
    out = []
    for s in range(0, img1.shape[0], block):
        a = pyr.pad_to_divisible(img1[s:s + block].to(dtype), scf)
        b = pyr.pad_to_divisible(img2[s:s + block].to(dtype), scf)
        flow = _padded(a, b, p)
        if p.sc_l != 0:
            flow = pyr.resize_bilinear(flow * float(1 << p.sc_l), a.shape[1], a.shape[2])
        out.append(flow[:, t:t + h0, l:l + w0].float())
    return torch.cat(out)
