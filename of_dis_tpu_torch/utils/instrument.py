"""Instrumented driver: the per-scale stage timing table of verbosity 2,
PyTorch port of of_dis_tpu/utils/instrument.py.

Reproduces the reference's verbosity-2 output (oflow.cpp:296-304: "TIME
(Sc: %i, #p:%6i, pconst, pinit, poptim, cflow, tvopt, total)") by running
the stage functions the production driver is composed of
(models/dis.py::_stage_templates, _stage_init, _stage_optimize,
_stage_densify, _stage_refine) one by one on one pair, a batch of one as
dis_raw runs it.  On the card each stage is an executable, keyed like the
JAX package's `_cached_jit` (of_dis_tpu/utils/instrument.py:40-54): the
pyramids, and per level the templates, the search, the densification and
the refinement each run as a CUDA graph captured at their first call for a
key and replayed after (ops/graphs.py); the coarse init runs op by op, as
there.  Each stage ends with torch.cuda.synchronize(), outside the graphs,
so a stage's time includes its kernels; the numerics are dis_raw's, bit for
bit, because the stage bodies, the divisibility padding and the final
2^sc_l upscale + crop (run_dense.cpp:296-414) are the same calls.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..config import DISConfig
from ..models.dis import (
    _grid_tensors,
    _prepare,
    _pyramids,
    _stage_densify,
    _stage_init,
    _stage_optimize,
    _stage_refine,
    _stage_templates,
    _upscale_crop,
)
from ..models.grid import level_geometry
from ..ops import graphs
from ..ops import pyramid as pyr
from ..ops.transfer import to_device

_pyramids_jit = graphs.executable(_pyramids)
_templates_jit = graphs.executable(_stage_templates)
_optimize_jit = graphs.executable(_stage_optimize)
_refine_jit = graphs.executable(_stage_refine)


@graphs.executable
def _densify_jit(res_fw, res_bw, sl: int, w: int, h: int, cfg: DISConfig):
    """_stage_densify of the (w, h) level, whose geometry is static."""
    return _stage_densify(res_fw, res_bw, sl, level_geometry(w, h, cfg), cfg)


def dis_flow_timed(
    img1,
    img2,
    cfg: DISConfig,
    verbosity: Optional[int] = None,
    gradmag_input: bool = False,
    init_flow=None,
    device=None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """Run the full driver on one pair (H, W[, C]) with per-scale stage
    timings, on CUDA unless given device="cpu".

    Returns (out, stats): `out` is dis_raw's (H, W, nop) result, and `stats`
    a list of per-scale dicts with keys sc, n_patches, pconst, pinit,
    poptim, cflow, tvopt, total (ms).  Prints the table at verbosity > 1 and
    the total at verbosity > 0 (default: cfg.verbosity)."""
    v = cfg.verbosity if verbosity is None else verbosity
    img1, img2, dev = _prepare(img1, img2, cfg, device, 0)
    init = None if init_flow is None else to_device(init_flow, dev)

    def clock(t0=None):
        """The host clock after the device's queued work has finished; with
        t0, the ms since t0."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        return t if t0 is None else (t - t0) * 1000.0

    h0, w0 = img1.shape[:2]
    scf = 1 << cfg.sc_f
    p1 = pyr.pad_to_divisible(img1[None], scf)
    p2 = pyr.pad_to_divisible(img2[None], scf)
    h, w = p1.shape[1:3]
    pad = cfg.patch_size

    t0 = clock()
    im1s, dx1s, dy1s, im2s, dx2s, dy2s = _pyramids_jit(p1, p2, cfg, gradmag_input)
    t_pyr = clock(t0)
    if v > 1:
        print(f"TIME (Pyramide+Gradients) (ms): {t_pyr:3g}")

    stats: List[Dict] = []
    # A warm start seeds the coarsest level's forward init, as in dis_raw
    # (oflow.cpp:217-220).
    flow, flow_bw = init, None
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lw, lh = w >> sl, h >> sl
        geo, pt_ref, coarse_idx = _grid_tensors(lw, lh, cfg, dev)
        n = geo.n_patches

        t0 = clock()
        tmpl_fw, tmpl_bw = _templates_jit(im1s[sl], dx1s[sl], dy1s[sl], im2s[sl], dx2s[sl],
                                          dy2s[sl], pt_ref, cfg, pad)
        t_const = clock(t0)

        t0 = clock()
        p0 = _stage_init(flow, coarse_idx, 1, n, cfg, dev)
        p0b = _stage_init(flow_bw, coarse_idx, 1, n, cfg, dev) if cfg.use_fb_merge else None
        t_init = clock(t0)

        t0 = clock()
        res_fw, res_bw = _optimize_jit(im1s[sl], im2s[sl], tmpl_fw, tmpl_bw, pt_ref, p0, p0b,
                                       cfg, lw, lh, pad)
        t_opt = clock(t0)

        t0 = clock()
        flow, flow_bw = _densify_jit(res_fw, res_bw, sl, lw, lh, cfg)
        t_dens = clock(t0)

        t_tv = 0.0
        if cfg.use_tv_refine:
            t0 = clock()
            flow, flow_bw = _refine_jit(flow, flow_bw, im1s[sl][:, pad:-pad, pad:-pad],
                                        im2s[sl][:, pad:-pad, pad:-pad], sl, cfg)
            t_tv = clock(t0)

        total = t_const + t_init + t_opt + t_dens + t_tv
        stats.append(dict(sc=sl, n_patches=n, pconst=t_const, pinit=t_init, poptim=t_opt,
                          cflow=t_dens, tvopt=t_tv, total=total))
        if v > 1:
            print(
                f"TIME (Sc: {sl}, #p:{n:6d}, pconst, pinit, poptim, "
                f"cflow, tvopt, total): {t_const:8.2f} {t_init:8.2f} {t_opt:8.2f} "
                f"{t_dens:8.2f} {t_tv:8.2f} -> {total:8.2f} ms."
            )
    if v > 0:
        print(f"TIME (O.Flow Run-Time   ) (ms): {sum(s['total'] for s in stats):3g}")

    # Final upscale + divisibility crop (run_dense.cpp:406-414), as dis_raw.
    return _upscale_crop(flow, cfg, h, w, h0, w0)[0], stats
