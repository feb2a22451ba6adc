"""Wrappers of the hand-written CUDA kernels, and their plain versions.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; any other device, dtype, shape or layout
raises.  There is no fallback from the kernel to the plain version on the
card.  `launches` counts kernel launches (never plain-version calls), so a
run can show that it went through the kernels; `routes` counts the pyramid
levels that each route of `search_route` searched (models/dis.py::
_stage_templates counts them, on the card and on the CPU alike).

Every wrapper takes a batch of image pairs, a leading axis B on its images
and fields, and launches once for all of them; given one pair's tensors
(no leading axis) it launches a batch of one and returns one pair's.

The plain versions live beside the step functions they compose
(models/inverse_search.py::level_search_reference, ::gn_search_reference;
models/refine.py::refine_inner_reference, ::sor_scalar_rb,
::sor_coupled_rb; ops/pyramid.py::pad_to_divisible; models/dis.py::
_upscale_crop).  Those modules call the wrappers here, so this module
imports none of models/ at load time; each wrapper takes what it needs from
there when it is called.

  level_search   csrc/level_search.cu   replaces of_dis_tpu/ops/pallas_kernels.py::_level_kernel
  gn_search      csrc/gn_search.cu      replaces of_dis_tpu/ops/pallas_kernels.py::_gn_kernel
                                        and ::_gn_kernel_tiled
  refine_inner   csrc/refine_inner.cu   replaces of_dis_tpu/ops/pallas_kernels.py::_refine_inner_kernel
  sor_scalar     csrc/sor_rb.cu         replaces of_dis_tpu/ops/pallas_kernels.py::_sor_scalar_kernel
  sor_coupled    csrc/sor_rb.cu         replaces of_dis_tpu/ops/pallas_kernels.py::_sor_coupled_kernel
  frame_pad      csrc/frame_io.cu       the entry's divisibility padding (no TPU kernel: XLA ops)
  flow_upscale   csrc/frame_io.cu       the entry's final upscale and crop (no TPU kernel: XLA ops)

level_search and gn_search share the GN state machine (csrc/gn_machine.cuh),
one warp per patch; `search_route` picks one of them per level.
refine_inner and the two SOR solvers (sor_scalar, sor_coupled) each launch
one kernel body with the barrier the level needs: `refine_variant` and
`sor_variant` pick a single CTA, a thread-block cluster or a cooperative
grid from the level's shape and the number of pairs.

Every wrapper can be captured in a CUDA graph (ops/graphs.py): it
allocates its outputs and scratch with PyTorch's allocator, launches on
the current stream, reads nothing back from the card and copies nothing
from the host, and its branches (the variant, the pair axis) depend on
shapes only.  The launchers' one-time queries (csrc/launch.cuh's
PerDevice: SM count, occupancy, attributes) run in the executables'
warm-up, before a capture.  Under replay a wrapper is not called:
graphs.py adds the launches and routes its capture recorded to `launches`
and `routes`.  Keep these properties when a wrapper changes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import DISConfig
from . import build
from . import pyramid as pyr

launches: Dict[str, int] = {"level_search": 0, "gn_search": 0, "refine_inner": 0,
                            "sor_scalar": 0, "sor_coupled": 0, "frame_pad": 0,
                            "flow_upscale": 0}
routes: Dict[str, int] = {"level": 0, "gn": 0}


def reset_launches() -> None:
    """Zero `launches` and `routes`."""
    for counter in (launches, routes):
        for k in counter:
            counter[k] = 0


def _check(name: str, t: torch.Tensor, shape: Sequence[int], device: torch.device,
           dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _one_pair(single: bool, ts):
    """ts with a pair axis of one added (single) or as they are."""
    return tuple(t[None] for t in ts) if single else tuple(ts)


def _drop_pair(res):
    """A SearchResult of a batch of one as one pair's."""
    return type(res)(*(None if t is None else t[0] for t in res))


# ---------------------------------------------------------------------------
# Which search kernel a level runs
# ---------------------------------------------------------------------------

# The JAX package's whole-level kernel budget (of_dis_tpu/ops/pallas_kernels.py
# :809, :1220, :1242-1246).
_TPU_STACK_FACTOR = 4.5
_TPU_LEVEL_BUDGET = 80 * 2**20
_TPU_LEVEL_MAX_PATCHES = 512
_TPU_LEVEL_MAX_PIXELS = 12288


def _tpu_level_words(hp, wp, c, np_, psz, sy, sx) -> int:
    return (2 * hp * wp * c + hp * sy * np_ + (wp + 32 + -(-sx // 32) * 32) * sy * np_ * c
            + 2 * sx * c * sy * np_ + 10 * c * psz * psz * np_ + 64)


def search_route(hp: int, wp: int, c: int, n: int, psz: int, sy: int, sx: int) -> str:
    """"level" (level_search: templates extracted in the kernel) or "gn"
    (templates built beforehand, then gn_search) for a padded (hp, wp, c)
    level with n patches and (sy, sx) search windows.

    This reproduces the JAX package's split (of_dis_tpu/ops/pallas_kernels.py
    ::gn_route with _level_shape_ok and _level_words), so that each TPU
    kernel's counterpart runs where that kernel runs: its "level" is
    "level"; its "untiled" and "tiled<ps>" (one TPU kernel in two layouts)
    are "gn"; its "xla" (a window no larger than psz) stays on "level".
    The split is the TPU's VMEM budget, not a finding on the H100; a later
    change may redraw it with H100 numbers."""
    if not (sy > psz and sx > psz):
        return "level"
    np_ = -(-n // 128) * 128
    if np_ > _TPU_LEVEL_MAX_PATCHES or hp * wp > _TPU_LEVEL_MAX_PIXELS:
        return "gn"
    words = _tpu_level_words(hp, wp, c, np_, psz, sy, sx)
    return "level" if words * _TPU_STACK_FACTOR * 4 <= _TPU_LEVEL_BUDGET else "gn"


def _search_consts(cfg: DISConfig, camlr: int) -> tuple:
    """The GN machine's scalar arguments after (sy, sx), as the C launchers take them."""
    return (cfg.max_iter, cfg.min_iter, cfg.cost, int(cfg.patch_norm),
            -1 if cfg.mode != "stereo" else int(camlr),
            cfg.normoutlier, cfg.dp_thresh * cfg.dp_thresh, cfg.dr_thresh,
            cfg.res_thresh, cfg.outlier_thresh * cfg.outlier_thresh, cfg.minerrval)


# ---------------------------------------------------------------------------
# Kernel A: whole-level Gauss-Newton patch search
# ---------------------------------------------------------------------------

def _level_search_lib():
    lib = build.load("level_search")
    fn = lib.level_search_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 17
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def level_search(ima, dxa, dya, imb, pt_ref, p_init, cfg: DISConfig,
                 w: int, h: int, pad: int, camlr: Optional[int] = None):
    """Search one pyramid level of B pairs: (B, Hp, Wp, C) padded level
    images ima, dxa, dya (reference) and imb (target), pt_ref (N, 2) shared
    by the pairs, p_init (B, N, nop); or one pair's (Hp, Wp, C) images and
    (N, nop) p_init.  Returns a SearchResult with absw (B, N, psz²) and
    iters set (one pair's: (N, ...))."""
    from ..models.inverse_search import SearchResult, level_search_reference

    if ima.device.type == "cpu":
        return level_search_reference(ima, dxa, dya, imb, pt_ref, p_init, cfg, w, h, pad, camlr)
    if ima.device.type != "cuda":
        raise ValueError(f"level_search: unsupported device {ima.device}")
    if camlr is None:
        camlr = cfg.camlr
    single = ima.ndim == 3
    ima, dxa, dya, imb, p_init = _one_pair(single, (ima, dxa, dya, imb, p_init))
    b, hp, wp, c = ima.shape
    n = pt_ref.shape[0]
    psz, nop = cfg.patch_size, cfg.nop
    if psz not in (8, 12) or c not in (1, 3) or n < 1:
        raise ValueError(f"level_search: unsupported psz={psz}, C={c}, N={n}")
    dev = ima.device
    for name, t in (("ima", ima), ("dxa", dxa), ("dya", dya), ("imb", imb)):
        _check(name, t, (b, hp, wp, c), dev)
    _check("pt_ref", pt_ref, (n, 2), dev)
    _check("p_init", p_init, (b, n, nop), dev)
    sy = min(2 * psz + 2, hp)
    sx = min(2 * psz + 2, wp)
    f32 = dict(dtype=torch.float32, device=dev)
    p = torch.empty((b, n, nop), **f32)
    pt = torch.empty((b, n, 2), **f32)
    absw = torch.empty((b, n, psz * psz), **f32)
    conv = torch.empty((b, n), dtype=torch.int32, device=dev)
    iters = torch.empty((b, n), dtype=torch.int32, device=dev)
    fn = _level_search_lib()
    with torch.cuda.device(dev):
        rc = fn(
            _ptr(ima), _ptr(dxa), _ptr(dya), _ptr(imb), _ptr(pt_ref), _ptr(p_init),
            _ptr(p), _ptr(pt), _ptr(absw), _ptr(conv), _ptr(iters),
            n, b, hp, wp, c, psz, nop, pad, w, h, sy, sx, *_search_consts(cfg, camlr),
            _stream(dev),
        )
    _raise_on(rc, "level_search")
    launches["level_search"] += 1
    res = SearchResult(p=p, pt=pt, pweight=None, converged=conv.bool(), absw=absw,
                       iters=iters)
    return _drop_pair(res) if single else res


# ---------------------------------------------------------------------------
# Kernel C: Gauss-Newton patch search over templates built beforehand
# ---------------------------------------------------------------------------

def _gn_search_lib():
    lib = build.load("gn_search")
    fn = lib.gn_search_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 21
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def gn_search(imb, tmpl, pt_ref, p_init, cfg: DISConfig, w: int, h: int, pad: int,
              camlr: Optional[int] = None, tile: Optional[Tuple[int, int, int, int]] = None):
    """Search one pyramid level of B pairs from prebuilt PatchTemplates
    `tmpl` (tmp, dx, dy (B, N, psz, psz, C); hes (B, N, 3) for flow, (B, N,
    1) for stereo) in the padded (B, Hp, Wp, C) target images imb; pt_ref
    (N, 2) shared by the pairs, p_init (B, N, nop); or one pair's, without
    the leading B.  Returns a SearchResult with pweight (B, N, psz, psz, C)
    and iters set (one pair's: (N, ...)).

    tile=(oy, ox, hp_g, wp_g): imb is a halo'd tile whose row / column 0
    sits at (oy, ox) of the (hp_g, wp_g) global padded level (spatial
    tiling, parallel/spatial.py); windows are sized and clipped in the
    global frame, then read from the tile (models/inverse_search.py::
    optimize_level)."""
    from ..models.inverse_search import PatchTemplates, SearchResult, gn_search_reference

    if imb.device.type == "cpu":
        return gn_search_reference(imb, tmpl, pt_ref, p_init, cfg, w, h, pad, camlr, tile)
    if imb.device.type != "cuda":
        raise ValueError(f"gn_search: unsupported device {imb.device}")
    if camlr is None:
        camlr = cfg.camlr
    single = imb.ndim == 3
    imb, p_init, *fields = _one_pair(single, (imb, p_init) + tuple(tmpl))
    tmpl = PatchTemplates(*fields)
    b, hp, wp, c = imb.shape
    n = pt_ref.shape[0]
    psz, nop = cfg.patch_size, cfg.nop
    if psz not in (8, 12) or c not in (1, 3) or n < 1:
        raise ValueError(f"gn_search: unsupported psz={psz}, C={c}, N={n}")
    dev = imb.device
    _check("imb", imb, (b, hp, wp, c), dev)
    for name, t in (("tmp", tmpl.tmp), ("dx", tmpl.dx), ("dy", tmpl.dy)):
        _check(name, t, (b, n, psz, psz, c), dev)
    _check("hes", tmpl.hes, (b, n, 3 if nop == 2 else 1), dev)
    _check("pt_ref", pt_ref, (n, 2), dev)
    _check("p_init", p_init, (b, n, nop), dev)
    oy, ox, hp_g, wp_g = (0, 0, hp, wp) if tile is None else (int(t) for t in tile)
    sy = min(2 * psz + 2, hp_g)
    sx = min(2 * psz + 2, wp_g)
    if sy > hp or sx > wp:
        raise ValueError(f"gn_search: a {hp}x{wp} tile cannot hold {sy}x{sx} windows")
    f32 = dict(dtype=torch.float32, device=dev)
    p = torch.empty((b, n, nop), **f32)
    pt = torch.empty((b, n, 2), **f32)
    pweight = torch.empty((b, n, psz, psz, c), **f32)
    conv = torch.empty((b, n), dtype=torch.int32, device=dev)
    iters = torch.empty((b, n), dtype=torch.int32, device=dev)
    fn = _gn_search_lib()
    with torch.cuda.device(dev):
        rc = fn(
            _ptr(tmpl.tmp), _ptr(tmpl.dx), _ptr(tmpl.dy), _ptr(tmpl.hes), _ptr(imb),
            _ptr(pt_ref), _ptr(p_init),
            _ptr(p), _ptr(pt), _ptr(pweight), _ptr(conv), _ptr(iters),
            n, b, hp, wp, c, psz, nop, pad, w, h, sy, sx, oy, ox, hp_g, wp_g,
            *_search_consts(cfg, camlr), _stream(dev),
        )
    _raise_on(rc, "gn_search")
    launches["gn_search"] += 1
    res = SearchResult(p=p, pt=pt, pweight=pweight, converged=conv.bool(), iters=iters)
    return _drop_pair(res) if single else res


def gn_search_occupancy(psz: int, c: int, nop: int) -> Tuple[int, int]:
    """(blocks per SM, warps per block) of gn_search's kernel for (psz, C,
    nop) on the current CUDA device; each warp searches one patch."""
    fn = build.load("gn_search").gn_search_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    blocks, warps = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(fn(psz, c, nop, ctypes.byref(blocks), ctypes.byref(warps)), "gn_search_occupancy")
    return blocks.value, warps.value


# ---------------------------------------------------------------------------
# Kernel B: TV refinement inner loop
# ---------------------------------------------------------------------------

_REFINE_SCRATCH_FIELDS = 10
REFINE_VARIANTS = ("block", "cluster", "grid")  # codes 0, 1, 2 of refine_inner_launch
# Where refine_variant moves to the next variant, in pixels per level (h * w):
# one pixel per thread of one 1024-thread CTA, and of a 16-CTA cluster.
# On an H100 the block variant won at op2's 14x32 and lost to the cluster at
# 28x64, and the cluster won at 56x128 and lost to the grid at 112x256
# (PERF.md).
_REFINE_BLOCK_MAX_PX = 1024
_REFINE_CLUSTER_MAX_PX = 16 * 1024
_REFINE_CTA_PX = 256  # pixels per CTA of the cluster variant (one per thread)
_REFINE_MAX_CTAS = 16  # the largest cluster on an H100 (non-portable above 8)
# The block variant keeps its scratch fields in shared memory: the largest
# level whose fields fit in the 232,448 bytes an H100 block may use.
_REFINE_BLOCK_CAPACITY_PX = 232448 // (4 * _REFINE_SCRATCH_FIELDS)
# From _WIDE_BATCH pairs a launch on, clusters of more than
# _WIDE_CLUSTER_CTAS CTAs (the portable size) lose to the grid: on an H100
# at 56x128 (16 CTAs) the cluster took 109.6 µs at B = 16 and 165.9 at
# B = 32 against the grid's 95.9 and 124.7, and won at B = 8 (62.6 vs
# 74.0); at 28x64 (7 CTAs) it beat the block (61.8 vs 65.0 at B = 16, 64.1
# vs 67.6 at B = 32) and the grid (72.1, 88.7) (PERF.md).
_WIDE_BATCH = 16
_WIDE_CLUSTER_CTAS = 8


def refine_variants(h: int, w: int) -> Tuple[str, ...]:
    """The launch variants that can take an (h, w) level."""
    if h * w <= _REFINE_BLOCK_CAPACITY_PX:
        return REFINE_VARIANTS
    return tuple(v for v in REFINE_VARIANTS if v != "block")


def refine_cluster_ctas(h: int, w: int) -> int:
    """CTAs of the cluster variant for an (h, w) level: 256 pixels each,
    one per thread, 2 to 16 of them (larger levels stride)."""
    return min(_REFINE_MAX_CTAS, max(2, -(-(h * w) // _REFINE_CTA_PX)))


def refine_variant(h: int, w: int, c: int, b: int = 1) -> Tuple[str, int]:
    """How refine_inner launches for an (h, w, C) level of b pairs:
    ("block", 1) one CTA per pair, ("cluster", n) one cluster of n CTAs per
    pair, or ("grid", 0) a cooperative grid.  Each is the barrier the level
    needs between phases and no wider; the thresholds come from timing every
    variant on an H100 at op2's and op4's level shapes (PERF.md).  C does
    not move them."""
    px = h * w
    if px <= _REFINE_BLOCK_MAX_PX:
        return ("block", 1)
    n = refine_cluster_ctas(h, w)
    if px <= _REFINE_CLUSTER_MAX_PX and (b < _WIDE_BATCH or n <= _WIDE_CLUSTER_CTAS):
        return ("cluster", n)
    return ("grid", 0)


def _refine_inner_lib():
    lib = build.load("refine_inner")
    fn = lib.refine_inner_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def refine_inner(wx, wy, mask, derivs, n_inner: int, solver_it: int,
                 omega: float, qa: float, hd3: float, hg3: float,
                 variant: Optional[str] = None):
    """The whole TV inner loop of one level of B pairs.  wx, wy, mask (B, h,
    w); derivs the 8-tuple (ix, iy, iz, ixx, ixy, iyy, ixz, iyz) of (B, h,
    w, C); or one pair's, without the leading B.  Returns (uu, vv), each (B,
    h, w) (one pair's: (h, w)).  On the card the kernel launches as
    refine_variant picks, or as `variant` (one of REFINE_VARIANTS) names;
    every variant that can take the level (refine_variants) gives the same
    bits."""
    if variant is not None and variant not in REFINE_VARIANTS:
        raise ValueError(f"refine_inner: unknown variant {variant!r}")
    if wx.device.type == "cpu":
        from ..models.refine import refine_inner_reference

        return refine_inner_reference(wx, wy, mask, derivs, n_inner, solver_it,
                                      omega, qa, hd3, hg3)
    if wx.device.type != "cuda":
        raise ValueError(f"refine_inner: unsupported device {wx.device}")
    single = wx.ndim == 2
    wx, wy, mask, *derivs = _one_pair(single, (wx, wy, mask) + tuple(derivs))
    b, h, w = wx.shape
    c = derivs[0].shape[-1]
    if c not in (1, 3) or len(derivs) != 8 or n_inner < 1 or solver_it < 1:
        raise ValueError(f"refine_inner: unsupported C={c}, n_inner={n_inner}, "
                         f"solver_it={solver_it}")
    dev = wx.device
    for name, t in (("wx", wx), ("wy", wy), ("mask", mask)):
        _check(name, t, (b, h, w), dev)
    for k, t in enumerate(derivs):
        _check(f"derivs[{k}]", t, (b, h, w, c), dev)
    if variant is None:
        variant, n_ctas = refine_variant(h, w, c, b)
    elif variant not in refine_variants(h, w):
        raise ValueError(f"refine_inner: variant {variant!r} cannot take a {h}x{w} level")
    else:
        n_ctas = refine_cluster_ctas(h, w) if variant == "cluster" else 0
    uu = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    vv = torch.empty_like(uu)
    scratch = torch.empty((_REFINE_SCRATCH_FIELDS, b, h, w), dtype=torch.float32, device=dev)
    fn = _refine_inner_lib()
    with torch.cuda.device(dev):
        rc = fn(
            _ptr(wx), _ptr(wy), _ptr(mask), *[_ptr(t) for t in derivs],
            _ptr(uu), _ptr(vv), _ptr(scratch),
            b, h, w, c, int(n_inner), int(solver_it),
            float(omega), float(qa), float(hd3), float(hg3),
            REFINE_VARIANTS.index(variant), n_ctas, _stream(dev),
        )
    _raise_on(rc, f"refine_inner ({variant})")
    launches["refine_inner"] += 1
    return (uu[0], vv[0]) if single else (uu, vv)


# ---------------------------------------------------------------------------
# Kernels D and E: red-black SOR, scalar (stereo) and coupled (flow)
# ---------------------------------------------------------------------------

def _sor_lib(name: str, argtypes):
    fn = getattr(build.load("sor_rb"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_fields(name: str, fields, iterations: int) -> torch.device:
    dev = fields[0].device
    shape = fields[0].shape
    if len(shape) != 3 or iterations < 1:
        raise ValueError(f"{name}: unsupported shape {tuple(shape)}, iterations={iterations}")
    for k, t in enumerate(fields):
        _check(f"{name} field {k}", t, shape, dev)
    return dev


SOR_VARIANTS = ("block", "cluster", "grid")  # codes 0, 1, 2 of both sor_*_launch
# csrc/sor_rb.cu keeps each thread's vertical pixel pairs ((y, x), (y + 1, x))
# in registers, at most _SOR_PAIRS[nop] of them per thread (a scalar pixel
# keeps 6 values, a coupled one 9): the block variant's one CTA of up to 512
# threads holds 3,584 scalar pairs (56 x 128) or 1,536 coupled ones, a
# cluster of up to 16 CTAs of 256 threads 28,672 or 12,288; the grid variant
# takes any level.
_SOR_PAIRS = {1: 7, 2: 3}
_SOR_BLOCK_THREADS = 512
_SOR_CTA_THREADS = 256
_SOR_MAX_CTAS = 16
# Where sor_variant moves to the next variant, in pairs per level: (last
# pairs of the block, last of the cluster).  On an H100 the scalar block won
# up to 40x96 (1,920 pairs) and lost to the cluster from 48x112 (2,688),
# stereo op2's 56x128 included; the scalar cluster tied the grid at 80x160
# (6,400) and lost to it from 96x192 (9,216).  The coupled block beat the
# cluster at every level it can take (up to 48x64, 1,536 pairs); the
# coupled cluster won up to 64x128 (4,096, one pair a thread) and lost to
# the grid from 72x128 (4,608) (PERF.md).
_SOR_MAX_PAIRS = {1: (2048, 6144), 2: (1536, 4096)}
# From this many pairs a launch on, the solvers' clusters queue on the card:
# on an H100 at 56x128 the scalar cluster took 11.6 µs at B = 2 and 18.3 at
# B = 8 (grid 14.0, 14.1; block 15.0, 15.1), the coupled one 12.6 and 20.4
# (grid 14.3, 14.8); from _WIDE_BATCH on the scalar block beat the grid
# (B = 16: 15.1 vs 16.3; B = 32: 15.2 vs 20.7) (PERF.md).
_SOR_CLUSTER_BATCH = 8


def _sor_pairs(h: int, w: int) -> int:
    return -(-h // 2) * w


def sor_variants(h: int, w: int, nop: int = 1) -> Tuple[str, ...]:
    """The launch variants of the nop solver (1 sor_scalar, 2 sor_coupled)
    that can take an (h, w) level."""
    pairs, per_thread = _sor_pairs(h, w), _SOR_PAIRS[nop]
    out = ("block",) if pairs <= per_thread * _SOR_BLOCK_THREADS else ()
    if pairs <= per_thread * _SOR_CTA_THREADS * _SOR_MAX_CTAS:
        out += ("cluster",)
    return out + ("grid",)


def sor_cluster_ctas(h: int, w: int, nop: int = 1) -> int:
    """CTAs of the nop solver's cluster variant for an (h, w) level: 256
    pixel pairs each, one per thread, 2 to 16 of them (larger levels hold
    more pairs per thread).  Raises if the cluster cannot take the level."""
    if "cluster" not in sor_variants(h, w, nop):
        raise ValueError(f"sor: a {h}x{w} level is too large for the nop={nop} cluster")
    return min(_SOR_MAX_CTAS, max(2, -(-_sor_pairs(h, w) // _SOR_CTA_THREADS)))


def sor_variant(h: int, w: int, nop: int = 1, b: int = 1) -> Tuple[str, int]:
    """How the nop solver (1 sor_scalar, 2 sor_coupled) launches for an (h,
    w) level of b pairs: ("block", 1) one CTA per pair, ("cluster", n) one
    cluster of n CTAs per pair, or ("grid", 0) a cooperative grid: the
    barrier the level needs between half-steps and no wider; the thresholds
    come from timing every variant on an H100 (PERF.md)."""
    pairs = _sor_pairs(h, w)
    block_max, cluster_max = _SOR_MAX_PAIRS[nop]
    if pairs <= block_max:
        return ("block", 1)
    if pairs > cluster_max:
        return ("grid", 0)
    if b < _SOR_CLUSTER_BATCH:
        return ("cluster", sor_cluster_ctas(h, w, nop))
    # b pairs' clusters queue up on the card: the block where it can take
    # the level and the batch is wide, else the grid
    if b >= _WIDE_BATCH and "block" in sor_variants(h, w, nop):
        return ("block", 1)
    return ("grid", 0)


def _sor_launch(name: str, nop: int, fields, iterations: int, omega: float,
                variant: Optional[str]):
    """Launch csrc/sor_rb.cu's nop solver on the card: fields are its
    inputs, (du[, dv], system..., wh, wv), each (B, h, w) or one pair's (h,
    w); returns its nop outputs, of the inputs' shape."""
    single = fields[0].ndim == 2
    fields = _one_pair(single, fields)
    dev = _check_fields(name, fields, iterations)
    b, h, w = fields[0].shape
    if variant is None:
        variant, n_ctas = sor_variant(h, w, nop, b)
    elif variant not in sor_variants(h, w, nop):
        raise ValueError(f"{name}: variant {variant!r} cannot take a {h}x{w} level")
    else:
        n_ctas = sor_cluster_ctas(h, w, nop) if variant == "cluster" else 0
    outs = [torch.empty_like(fields[0]) for _ in range(nop)]
    # du (and dv) while the sweeps run, each (h + 2) rows of the kernel's even
    # row stride (<= w + 3) with a zero border; the block variant keeps them
    # in shared memory.
    field = None if variant == "block" else torch.empty(
        (b * nop * (h + 2) * (w + 3),), dtype=torch.float32, device=dev)
    fn = _sor_lib(f"{name}_launch", [ctypes.c_void_p] * (len(fields) + nop + 1)
                  + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(*[_ptr(t) for t in fields], *[_ptr(t) for t in outs],
                None if field is None else _ptr(field),
                b, h, w, int(iterations), float(omega), SOR_VARIANTS.index(variant), n_ctas,
                _stream(dev))
    _raise_on(rc, f"{name} ({variant})")
    launches[name] += 1
    return [o[0] for o in outs] if single else outs


def sor_scalar(du, a11, b1, wh, wv, iterations: int, omega: float,
               variant: Optional[str] = None):
    """`iterations` red-black sweeps of the scalar (stereo) SOR; all fields
    (B, h, w), or one pair's (h, w).  Returns the new du, of their shape.
    On the card the kernel launches as
    sor_variant picks, or as `variant` (one of SOR_VARIANTS) names; every
    variant that can take the level (sor_variants) gives the same bits."""
    if variant is not None and variant not in SOR_VARIANTS:
        raise ValueError(f"sor_scalar: unknown variant {variant!r}")
    if du.device.type == "cpu":
        from ..models.refine import sor_scalar_rb

        return sor_scalar_rb(du, a11, b1, wh, wv, iterations, omega)
    if du.device.type != "cuda":
        raise ValueError(f"sor_scalar: unsupported device {du.device}")
    return _sor_launch("sor_scalar", 1, (du, a11, b1, wh, wv), iterations, omega, variant)[0]


def sor_coupled(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations: int, omega: float,
                variant: Optional[str] = None):
    """`iterations` red-black sweeps of the coupled (flow) SOR; all fields
    (B, h, w), or one pair's (h, w).  Returns the new (du, dv), of their
    shape.  On the card the kernel launches as
    sor_variant(h, w, nop=2) picks, or as `variant` (one of SOR_VARIANTS)
    names; every variant that can take the level (sor_variants(h, w, 2))
    gives the same bits."""
    if variant is not None and variant not in SOR_VARIANTS:
        raise ValueError(f"sor_coupled: unknown variant {variant!r}")
    if du.device.type == "cpu":
        from ..models.refine import sor_coupled_rb

        return sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations, omega)
    if du.device.type != "cuda":
        raise ValueError(f"sor_coupled: unsupported device {du.device}")
    return tuple(_sor_launch("sor_coupled", 2, (du, dv, a11, a12, a22, b1, b2, wh, wv),
                             iterations, omega, variant))


# ---------------------------------------------------------------------------
# The entry's full-resolution passes: frame padding, flow upscale and crop
# ---------------------------------------------------------------------------

_FRAME_DTYPES = (torch.uint8, torch.float32)  # codes 0, 1 of frame_pad_launch


def _frame_io_lib(name: str, argtypes):
    fn = getattr(build.load("frame_io"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def frame_pad(img1, img2, divisor: int):
    """Both frames of B pairs, (B, H, W, C) in their own dtype, as float32
    (B, Hp, Wp, C) each, edge-replicated to divisibility by `divisor`
    (pyr.divisibility_padding); or one pair's (H, W, C) frames.  On the card
    one launch writes both (views of one (2, B, Hp, Wp, C) tensor).  uint8
    and float32 frames go to the kernel as they are; frames of another dtype
    (or of two dtypes) are converted to float32 first, and any layout is
    made contiguous (the entry takes what a caller hands it)."""
    if img1.device.type == "cpu":
        return tuple(pyr.pad_to_divisible(x.to(torch.float32), divisor) for x in (img1, img2))
    if img1.device.type != "cuda":
        raise ValueError(f"frame_pad: unsupported device {img1.device}")
    single = img1.ndim == 3
    img1, img2 = _one_pair(single, (img1, img2))
    same = img1.dtype == img2.dtype and img1.dtype in _FRAME_DTYPES
    dtype = img1.dtype if same else torch.float32
    img1, img2 = (x.to(dtype).contiguous() for x in (img1, img2))
    b, h, w, c = img1.shape
    if c not in (1, 3):
        raise ValueError(f"frame_pad: unsupported C={c}")
    dev = img1.device
    _check("img2", img2, (b, h, w, c), dev, dtype)
    t, bottom, left, right = pyr.divisibility_padding(h, w, divisor)
    hp, wp = h + t + bottom, w + left + right
    out = torch.empty((2, b, hp, wp, c), dtype=torch.float32, device=dev)
    fn = _frame_io_lib("frame_pad_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(_ptr(img1), _ptr(img2), _ptr(out), _FRAME_DTYPES.index(dtype),
                b, h, w, c, hp, wp, t, left, _stream(dev))
    _raise_on(rc, "frame_pad")
    launches["frame_pad"] += 1
    return (out[0, 0], out[1, 0]) if single else (out[0], out[1])


def flow_upscale(flow, cfg: DISConfig, hp: int, wp: int, h0: int, w0: int):
    """The flow (B, Hp >> sc_l, Wp >> sc_l, nop) at scale sc_l of (Hp, Wp)
    padded pairs as (B, h0, w0, nop): times 2^sc_l, resized to (Hp, Wp)
    (INTER_LINEAR, half-pixel centres; none at sc_l 0) and the
    divisibility padding cropped, only the cropped pixels computed; or one
    pair's, without the leading B.  A flow of any layout is made contiguous
    (without refinement the densified flow is a strided view).  The plain
    version is models/dis.py::_upscale_crop, whose float32 operations the
    kernel repeats in order."""
    single = flow.ndim == 3
    (flow,) = _one_pair(single, (flow,))
    if flow.device.type == "cpu":
        from ..models.dis import _upscale_crop

        out = _upscale_crop(flow, cfg, hp, wp, h0, w0)
        return out[0] if single else out
    if flow.device.type != "cuda":
        raise ValueError(f"flow_upscale: unsupported device {flow.device}")
    flow = flow.contiguous()
    sc, nop = cfg.sc_l, cfg.nop
    b, hl, wl = flow.shape[:3]
    if (hl << sc, wl << sc) != (hp, wp):
        raise ValueError(f"flow_upscale: a {hl}x{wl} flow at scale {sc} is not of {hp}x{wp}")
    dev = flow.device
    _check("flow", flow, (b, hl, wl, nop), dev)
    t, _, left, _ = pyr.divisibility_padding(h0, w0, 1 << cfg.sc_f)
    if t + h0 > hp or left + w0 > wp:
        raise ValueError(f"flow_upscale: {h0}x{w0} does not fit {hp}x{wp}")
    out = torch.empty((b, h0, w0, nop), dtype=torch.float32, device=dev)
    fn = _frame_io_lib("flow_upscale_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(_ptr(flow), _ptr(out), b, hl, wl, nop, sc, h0, w0, t, left, _stream(dev))
    _raise_on(rc, "flow_upscale")
    launches["flow_upscale"] += 1
    return out[0] if single else out
