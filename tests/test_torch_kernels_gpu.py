"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes, including the variants later slices need (12-px patches,
stereo, the backward search's camlr 1, gn_search's tile form for spatial
tiling), and the forward-backward merge on the card (the small fbcon
goldens, the merge's fixed order).  Marked `gpu` and skipped without a CUDA
device.  This file imports
no JAX and no conftest fixture, so on a machine with a GPU and no JAX it runs
as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from golden_util import GOLD, epe, load_manifest
from of_dis_tpu_torch import DISConfig, dis_flow, dis_raw, dis_stereo, io, operating_point
from of_dis_tpu_torch.cli import _cfg_from_params
from of_dis_tpu_torch.models.densify import aggregate_flow_dense
from of_dis_tpu_torch.models.grid import level_geometry
from of_dis_tpu_torch.models.inverse_search import (
    SearchResult,
    build_templates,
    gn_search_reference,
    level_search_reference,
)
from of_dis_tpu_torch.models.refine import (
    refine_inner_reference,
    sor_coupled_rb,
    sor_scalar_rb,
)
from of_dis_tpu_torch.ops import kernels
from of_dis_tpu_torch.ops import pyramid as pyr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _smooth_pair(h=96, w=128, c=1, seed=0):
    """A smooth random pair, img2 = img1 moved by (-3, +2)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h + 16, w + 16, c)
    for _ in range(4):  # repeated 3x3 box blur
        base = sum(np.roll(np.roll(base, dy, 0), dx, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9
    base = (base * 255).astype(np.float32)
    return base[8:8 + h, 8:8 + w], base[6:6 + h, 11:11 + w]


def _level_args(cfg, c, device, sl=1):
    img1, img2 = _smooth_pair(c=c)
    pad = cfg.patch_size
    im1s, dx1s, dy1s = pyr.build_pyramid(torch.as_tensor(img1, device=device), sl + 1, pad)
    im2s, _, _ = pyr.build_pyramid(torch.as_tensor(img2, device=device), sl + 1, pad)
    lw, lh = img1.shape[1] >> sl, img1.shape[0] >> sl
    geo = level_geometry(lw, lh, cfg)
    p0 = np.random.RandomState(3).randn(geo.n_patches, cfg.nop).astype(np.float32) * 1.5
    return (im1s[sl], dx1s[sl], dy1s[sl], im2s[sl],
            torch.as_tensor(geo.pt_ref, device=device), torch.as_tensor(p0, device=device),
            cfg, lw, lh, pad)


@pytest.mark.parametrize("mode,c,psz,cost,camlr", [
    ("flow", 1, 8, 0, 0), ("flow", 3, 8, 0, 0), ("flow", 1, 8, 1, 0), ("flow", 1, 8, 2, 0),
    ("flow", 1, 8, 10, 0), ("flow", 1, 12, 0, 0), ("stereo", 1, 8, 0, 0),
    ("stereo", 1, 8, 0, 1),  # the sign clamp >= 0 (fb stereo's backward search)
])
def test_level_search_kernel_matches_plain(cuda, mode, c, psz, cost, camlr):
    cfg = DISConfig(mode=mode, channels=c, sc_f=1, sc_l=0, max_iter=8, min_iter=8,
                    patch_size=psz, overlap=0.4 if psz == 8 else 0.75, cost=cost,
                    camlr=camlr).validate()
    args = _level_args(cfg, c, cuda)
    _assert_search_equal(kernels.level_search(*args), level_search_reference(*args))


def _assert_search_equal(res, ref):
    """A search kernel and its plain version sum and divide in one order:
    equal bits (the weights are pweight for gn_search, absw for
    level_search)."""
    for name in ("p", "pt", "pweight", "absw", "converged", "iters"):
        a, b = getattr(res, name), getattr(ref, name)
        if a is None and b is None:
            continue
        assert torch.equal(a, b), (name, float((a.float() - b.float()).abs().max()))


@pytest.mark.parametrize("n", [1, 2, 5, 7, 33])
@pytest.mark.parametrize("psz", [8, 12])
def test_level_search_kernel_patch_counts(cuda, n, psz):
    """N = 1 and N not a multiple of the kernel's warps (patches) per block."""
    cfg = DISConfig(sc_f=1, sc_l=0, max_iter=8, min_iter=2, patch_size=psz,
                    overlap=0.4 if psz == 8 else 0.75).validate()
    args = list(_level_args(cfg, 1, cuda))
    assert args[4].shape[0] >= n
    args[4], args[5] = args[4][-n:].contiguous(), args[5][-n:].contiguous()
    _assert_search_equal(kernels.level_search(*args), level_search_reference(*args))


@pytest.mark.parametrize("mode,c,psz,cost,camlr", [
    ("flow", 1, 12, 0, 0), ("flow", 3, 12, 0, 0), ("flow", 1, 12, 10, 0), ("flow", 1, 8, 0, 0),
    ("flow", 3, 8, 0, 0), ("flow", 1, 12, 1, 0), ("flow", 1, 12, 2, 0), ("flow", 3, 8, 10, 0),
    ("stereo", 1, 12, 0, 0), ("stereo", 3, 12, 0, 1), ("stereo", 1, 8, 0, 0),
    ("stereo", 3, 8, 1, 0), ("stereo", 1, 12, 2, 1),
])
def test_gn_search_kernel_matches_plain(cuda, mode, c, psz, cost, camlr):
    cfg = DISConfig(mode=mode, channels=c, sc_f=1, sc_l=0, max_iter=8, min_iter=8,
                    patch_size=psz, overlap=0.4 if psz == 8 else 0.75, cost=cost,
                    camlr=camlr).validate()
    ima, dxa, dya, imb, pt_ref, p0, _, lw, lh, pad = _level_args(cfg, c, cuda)
    tmpl = build_templates(ima, dxa, dya, pt_ref, cfg, pad)
    res = kernels.gn_search(imb, tmpl, pt_ref, p0, cfg, lw, lh, pad)
    ref = gn_search_reference(imb, tmpl, pt_ref, p0, cfg, lw, lh, pad)
    _assert_search_equal(res, ref)


@pytest.mark.parametrize("n", [1, 2, 5, 7, 33])
@pytest.mark.parametrize("c,psz", [(1, 12), (3, 8)])
def test_gn_search_kernel_patch_counts(cuda, n, c, psz):
    """N = 1 and N not a multiple of the kernel's warps (patches) per block."""
    cfg = DISConfig(channels=c, sc_f=1, sc_l=0, max_iter=8, min_iter=2, patch_size=psz,
                    overlap=0.4 if psz == 8 else 0.75).validate()
    ima, dxa, dya, imb, pt_ref, p0, _, lw, lh, pad = _level_args(cfg, c, cuda)
    assert pt_ref.shape[0] >= n
    pt_ref, p0 = pt_ref[-n:].contiguous(), p0[-n:].contiguous()
    tmpl = build_templates(ima, dxa, dya, pt_ref, cfg, pad)
    res = kernels.gn_search(imb, tmpl, pt_ref, p0, cfg, lw, lh, pad)
    ref = gn_search_reference(imb, tmpl, pt_ref, p0, cfg, lw, lh, pad)
    _assert_search_equal(res, ref)


def _sor_system(h, w, device, seed):
    rng = np.random.RandomState(seed)
    f = lambda scale, off=0.0: torch.as_tensor(  # noqa: E731
        (rng.randn(h, w) * scale + off).astype(np.float32), device=device)
    wh = (f(0.5, 1.0)).abs()
    wv = (f(0.5, 1.0)).abs()
    wh[:, -1] = 0.0
    wv[-1, :] = 0.0
    return dict(du=f(0.3), dv=f(0.3), a11=f(0.5, 2.0).abs(), a12=f(0.2),
                a22=f(0.5, 2.0).abs(), b1=f(1.0), b2=f(1.0), wh=wh, wv=wv)


def _sor_threshold_shapes(nop):
    """(h, w) just below and just above each pair count (ceil(h / 2) * w)
    where sor_variant(h, w, nop) changes its choice, with w = 64; h odd
    above, so the last row of pairs has no bottom pixel."""
    shapes = []
    for pairs in kernels._SOR_MAX_PAIRS[nop]:
        shapes += [(2 * (pairs // 64), 64), (2 * (pairs // 64) + 1, 64)]
    return shapes


@pytest.mark.parametrize("h,w", [(13, 17), (14, 32), (56, 128), (448, 1024)]
                         + _sor_threshold_shapes(2))
def test_sor_kernels_match_plain(cuda, h, w):
    """sor_scalar as sor_variant picks; sor_coupled in every variant that can
    take the level, each bit-equal to the plain version, which divides and
    sums in the kernel's order."""
    s = _sor_system(h, w, cuda, seed=h + w)
    names = ("du", "a11", "b1", "wh", "wv")
    out = kernels.sor_scalar(*[s[k] for k in names], 3, 1.6)
    torch.testing.assert_close(out, sor_scalar_rb(*[s[k] for k in names], 3, 1.6),
                               rtol=1e-5, atol=1e-5)
    args = [s[k] for k in ("du", "dv", "a11", "a12", "a22", "b1", "b2", "wh", "wv")] + [3, 1.6]
    rdu, rdv = sor_coupled_rb(*args)
    for v in kernels.sor_variants(h, w, 2) + (None,):
        du, dv = kernels.sor_coupled(*args, variant=v)
        torch.testing.assert_close(du, rdu, rtol=0, atol=0, msg=f"du, variant {v}")
        torch.testing.assert_close(dv, rdv, rtol=0, atol=0, msg=f"dv, variant {v}")
    for v in set(kernels.SOR_VARIANTS) - set(kernels.sor_variants(h, w, 2)):
        with pytest.raises(ValueError):
            kernels.sor_coupled(*args, variant=v)


@pytest.mark.parametrize("h,w", _sor_threshold_shapes(1) + [(14, 32), (28, 64), (56, 128),
                                                           (448, 1024)])
def test_sor_scalar_variants_bit_equal(cuda, h, w):
    """Every variant gives the same bits, and so does the plain version,
    which divides and sums in the kernel's order."""
    s = _sor_system(h, w, cuda, seed=h * w)
    args = [s[k] for k in ("du", "a11", "b1", "wh", "wv")] + [3, 1.6]
    outs = {v: kernels.sor_scalar(*args, variant=v) for v in kernels.sor_variants(h, w)}
    picked = kernels.sor_scalar(*args)
    for v, out in outs.items():
        assert torch.equal(out, picked), v
    ref = sor_scalar_rb(*args)
    torch.testing.assert_close(picked, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(picked, ref), float((picked - ref).abs().max())
    for v in set(kernels.SOR_VARIANTS) - set(outs):
        with pytest.raises(ValueError):
            kernels.sor_scalar(*args, variant=v)


def _refine_args(h, w, c, n_inner, device):
    rng = np.random.RandomState(h + w + c)

    def field(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale, device=device)

    wx, wy = field(h, w), field(h, w)
    mask = torch.as_tensor((rng.rand(h, w) > 0.05).astype(np.float32), device=device)
    derivs = tuple(field(h, w, c, scale=s) for s in (5, 5, 10, 2, 2, 2, 3, 3))
    return (wx, wy, mask, derivs, n_inner, 3, 1.6, 2.5, 5 / 6, 5 / 3)


@pytest.mark.parametrize("h,w,c,n_inner", [(13, 17, 1, 3), (56, 128, 1, 4), (56, 128, 3, 4),
                                           (448, 1024, 1, 1)])
def test_refine_inner_kernel_matches_plain(cuda, h, w, c, n_inner):
    args = _refine_args(h, w, c, n_inner, cuda)
    uu, vv = kernels.refine_inner(*args)
    ru, rv = refine_inner_reference(*args)
    torch.testing.assert_close(uu, ru, rtol=0, atol=0)
    torch.testing.assert_close(vv, rv, rtol=0, atol=0)


def _threshold_shapes():
    """(h, w) just below and just above each pixel count where
    refine_variant changes its choice, with w = 64."""
    shapes = []
    for px in (kernels._REFINE_BLOCK_MAX_PX, kernels._REFINE_CLUSTER_MAX_PX):
        shapes += [(px // 64, 64), (px // 64 + 1, 64)]
    return shapes


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("side", range(4))
def test_refine_inner_variants_bit_equal(cuda, c, side):
    h, w = _threshold_shapes()[side]
    args = _refine_args(h, w, c, 2, cuda)
    outs = {v: kernels.refine_inner(*args, variant=v) for v in kernels.refine_variants(h, w)}
    assert len(outs) >= 2
    picked = kernels.refine_inner(*args)
    for v, (uu, vv) in outs.items():
        assert torch.equal(uu, picked[0]) and torch.equal(vv, picked[1]), v
    ru, rv = refine_inner_reference(*args)
    torch.testing.assert_close(picked[0], ru, rtol=0, atol=0)
    torch.testing.assert_close(picked[1], rv, rtol=0, atol=0)


def _routes(cfg, h, w):
    """search_route of every level of an (h, w) pair (h, w divisible by 2^sc_f)."""
    psz = cfg.patch_size
    out = []
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lh, lw = h >> sl, w >> sl
        hp, wp = lh + 2 * psz, lw + 2 * psz
        out.append(kernels.search_route(hp, wp, cfg.channels, level_geometry(lw, lh, cfg).n_patches,
                                        psz, min(2 * psz + 2, hp), min(2 * psz + 2, wp)))
    return out


@pytest.mark.parametrize("op", [2, 4])
def test_dis_flow_on_card_matches_cpu_and_counts_launches(cuda, op):
    img1, img2 = _smooth_pair(h=96, w=128)
    cfg = operating_point(op, 128)
    routes = _routes(cfg, 96, 128)
    dis_flow(img1, img2, cfg, device=cuda)  # captures the path's graph (ops/graphs.py)
    kernels.reset_launches()  # a replay's launches from here
    gpu = dis_flow(img1, img2, cfg, device=cuda)
    torch.cuda.synchronize()
    assert kernels.launches == {
        "level_search": routes.count("level"), "gn_search": routes.count("gn"),
        "refine_inner": cfg.n_scales, "sor_scalar": 0, "sor_coupled": 0,
        "frame_pad": 1, "flow_upscale": 1}
    cpu = dis_flow(img1, img2, cfg, device="cpu")
    epe = (gpu.cpu() - cpu).pow(2).sum(-1).sqrt().mean()
    assert float(epe) < 0.05
    assert torch.equal(gpu, dis_flow(img1, img2, cfg, device=cuda))


@pytest.mark.parametrize("c", [1, 3])
def test_dis_stereo_on_card_matches_cpu_and_counts_launches(cuda, c):
    left, _ = _smooth_pair(h=96, w=136, c=c)
    left, right = left[:, :128], left[:, 3:131]
    cfg = operating_point(2, 128, mode="stereo", channels=c)
    routes = _routes(cfg, 96, 128)
    dis_stereo(left, right, cfg, device=cuda)  # captures the path's graph (ops/graphs.py)
    kernels.reset_launches()  # a replay's launches from here
    gpu = dis_stereo(left, right, cfg, device=cuda)
    torch.cuda.synchronize()
    assert kernels.launches == {
        "level_search": routes.count("level"), "gn_search": routes.count("gn"),
        "refine_inner": 0, "sor_coupled": 0, "frame_pad": 1, "flow_upscale": 1,
        # one launch per inner iteration: n_inner = tv_innerit * (level + 1)
        "sor_scalar": sum(cfg.tv_innerit * (sl + 1) for sl in range(cfg.sc_l, cfg.sc_f + 1))}
    cpu = dis_stereo(left, right, cfg, device="cpu")
    assert float((gpu.cpu() - cpu).abs().mean()) < 0.05
    assert float(gpu.max()) <= 0.0


@pytest.mark.parametrize("name", ["of_int_fbcon", "of_rgb_fbcon", "de_int_fbcon"])
def test_fbcon_goldens_on_card(cuda, name):
    """The small forward-backward merge goldens on the card: within the
    per-case rule of tests/test_golden.py of the reference binaries'
    output, within 0.05 px of the CPU path, the same bits twice, and the
    launches of a backward search per level and a backward refinement above
    the finest level."""
    case = {c["case"]: c for c in load_manifest()["cases"]}[name]
    ch = 3 if case["binary"].endswith("RGB") else 1
    mode = "stereo" if case["out"].endswith(".pfm") else "flow"
    img1, img2 = (io.load_image(os.path.join(GOLD, case[k]), ch) for k in ("img1", "img2"))
    cfg = _cfg_from_params([float(x) for x in case["args"]], mode, ch)
    assert cfg.use_fb_merge
    dis_raw(img1, img2, cfg, device=cuda)  # captures the path's graph (ops/graphs.py)
    kernels.reset_launches()  # a replay's launches from here
    gpu = dis_raw(img1, img2, cfg, device=cuda)
    torch.cuda.synchronize()
    routes = _routes(cfg, *img1.shape[:2])
    levels = range(cfg.sc_f, cfg.sc_l - 1, -1)
    refines = list(levels) + [sl for sl in levels if sl > cfg.sc_l]
    assert kernels.launches == {
        "level_search": 2 * routes.count("level"), "gn_search": 2 * routes.count("gn"),
        "refine_inner": len(refines) if mode == "flow" else 0, "sor_coupled": 0,
        "frame_pad": 1, "flow_upscale": 1,
        "sor_scalar": 0 if mode == "flow" else sum(cfg.tv_innerit * (sl + 1) for sl in refines)}
    gpu = gpu.cpu().numpy()
    path = os.path.join(GOLD, case["out"])
    golden = (io.read_pfm(path, negate=True)[..., None] if mode == "stereo"
              else io.read_flo(path))
    assert epe(gpu, golden) < max(2.0 * case["epe_captured"], 0.02)
    assert epe(gpu, dis_raw(img1, img2, cfg, device="cpu").numpy()) < 0.05
    assert np.array_equal(gpu, dis_raw(img1, img2, cfg, device=cuda).cpu().numpy())


def test_fb_merge_same_bits_twice(cuda):
    """The merge's scatter adds in a fixed order on the card: two merges of
    3 pairs at op2's level 3 shape give the same bits, each pair those of
    its own merge, and the CPU's within 1e-5."""
    cfg = DISConfig(sc_f=0, sc_l=0, patch_size=8, overlap=0.4).validate()
    geo = level_geometry(128, 56, cfg)
    rng = np.random.RandomState(4)
    b, n = 3, geo.n_patches

    def result(moved):
        return SearchResult(
            p=torch.as_tensor(rng.randn(b, n, 2).astype(np.float32) * 2, device=cuda),
            pt=torch.as_tensor((geo.pt_ref + rng.randn(b, n, 2) * 3 * moved).astype(np.float32),
                               device=cuda),
            pweight=torch.as_tensor(rng.rand(b, n, 8, 8, 1).astype(np.float32) * 8,
                                    device=cuda),
            converged=None)

    fw, bw = result(0), result(1)
    first = aggregate_flow_dense(fw, geo, cfg, bw_result=bw)
    assert torch.equal(first, aggregate_flow_dense(fw, geo, cfg, bw_result=bw))
    for i in range(b):
        pair = [SearchResult(*(None if t is None else t[i] for t in r)) for r in (fw, bw)]
        assert torch.equal(first[i], aggregate_flow_dense(pair[0], geo, cfg,
                                                          bw_result=pair[1]))
    on_cpu = [SearchResult(*(None if t is None else t.cpu() for t in r)) for r in (fw, bw)]
    cpu = aggregate_flow_dense(on_cpu[0], geo, cfg, bw_result=on_cpu[1])
    torch.testing.assert_close(first.cpu(), cpu, rtol=0, atol=1e-5)


def test_wrappers_reject_bad_inputs(cuda):
    cfg = DISConfig(sc_f=1, sc_l=0)
    args = list(_level_args(cfg, 1, cuda))
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(TypeError):
        kernels.level_search(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        kernels.level_search(*bad)
    with pytest.raises(ValueError):
        kernels.level_search(*args[:6], dataclasses.replace(cfg, patch_size=10), *args[7:])


# ---------------------------------------------------------------------------
# The pair axis: a batched launch equals a launch per pair, bit for bit
# ---------------------------------------------------------------------------

def _search_batch(cfg, c, b, device):
    """b distinct pairs' level-1 search inputs: padded images (b, Hp, Wp, C),
    the shared centres, seeded starts (b, N, nop)."""
    pad = cfg.patch_size
    pairs = [_smooth_pair(c=c, seed=10 + i) for i in range(b)]
    stack = [torch.as_tensor(np.stack([p[k] for p in pairs]), device=device) for k in (0, 1)]
    im1s, dx1s, dy1s = pyr.build_pyramid(stack[0], 2, pad)
    im2s, _, _ = pyr.build_pyramid(stack[1], 2, pad)
    lw, lh = pairs[0][0].shape[1] >> 1, pairs[0][0].shape[0] >> 1
    geo = level_geometry(lw, lh, cfg)
    p0 = np.random.RandomState(b).randn(b, geo.n_patches, cfg.nop).astype(np.float32) * 1.5
    return (im1s[1], dx1s[1], dy1s[1], im2s[1], torch.as_tensor(geo.pt_ref, device=device),
            torch.as_tensor(p0, device=device), cfg, lw, lh, pad)


def _split(out, i):
    """Pair i of a batched kernel output (tensor, tuple or SearchResult)."""
    if isinstance(out, torch.Tensor):
        return out[i]
    return [None if t is None else t[i] for t in out]


def _assert_batched_equals_per_pair(launch, batched_args, pair_args, b):
    out = launch(*batched_args)
    for i in range(b):
        one = launch(*pair_args(i))
        got, want = _split(out, i), one
        if isinstance(want, torch.Tensor):
            got, want = [got], [want]
        for k, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w), (i, k, float((g.float() - w.float()).abs().max()))


BATCHES = [1, 2, 7, 32]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("mode,c,psz", [("flow", 1, 8), ("flow", 3, 12), ("stereo", 1, 8)])
def test_search_kernels_batched_equal_per_pair(cuda, b, mode, c, psz):
    """level_search and gn_search over b distinct pairs in one launch."""
    cfg = DISConfig(mode=mode, channels=c, sc_f=1, sc_l=0, max_iter=8, min_iter=2,
                    patch_size=psz, overlap=0.4 if psz == 8 else 0.75).validate()
    ima, dxa, dya, imb, pt_ref, p0, _, lw, lh, pad = _search_batch(cfg, c, b, cuda)
    rest = (cfg, lw, lh, pad)
    _assert_batched_equals_per_pair(
        kernels.level_search, (ima, dxa, dya, imb, pt_ref, p0) + rest,
        lambda i: (ima[i], dxa[i], dya[i], imb[i], pt_ref, p0[i]) + rest, b)
    tmpl = build_templates(ima, dxa, dya, pt_ref, cfg, pad)
    _assert_batched_equals_per_pair(
        kernels.gn_search, (imb, tmpl, pt_ref, p0) + rest,
        lambda i: (imb[i], type(tmpl)(*(t[i] for t in tmpl)), pt_ref, p0[i]) + rest, b)
    assert kernels.level_search(ima, dxa, dya, imb, pt_ref, p0, *rest).p.shape == p0.shape


def _refine_batch(h, w, c, b, device):
    args = [_refine_args(h, w, c, 2, device) for _ in range(b)]
    rng = np.random.RandomState(b)
    for i, a in enumerate(args):  # each pair its own fields
        args[i] = (a[0] + float(rng.randn()), a[1] * float(1 + rng.rand()), a[2],
                   tuple(d * float(1 + rng.rand()) for d in a[3])) + a[4:]
    stack = tuple(torch.stack([a[k] for a in args]) for k in range(3))
    derivs = tuple(torch.stack([a[3][k] for a in args]) for k in range(8))
    return stack + (derivs,) + args[0][4:], args


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("c", [1, 3])
def test_refine_inner_batched_equal_per_pair(cuda, b, c):
    """Every variant at 28x64 (all three can take it) over b distinct pairs."""
    batched, pairs = _refine_batch(28, 64, c, b, cuda)
    for v in kernels.refine_variants(28, 64):
        _assert_batched_equals_per_pair(
            lambda *a: kernels.refine_inner(*a, variant=v), batched, lambda i: pairs[i], b)


def _sor_batch(h, w, b, device):
    systems = [_sor_system(h, w, device, seed=h * w + i) for i in range(b)]
    return {k: torch.stack([s[k] for s in systems]) for k in systems[0]}


SCALAR = ("du", "a11", "b1", "wh", "wv")
COUPLED = ("du", "dv", "a11", "a12", "a22", "b1", "b2", "wh", "wv")


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("nop", [1, 2])
def test_sor_kernels_batched_equal_per_pair(cuda, b, nop):
    """Every variant of both solvers at 28x64 over b distinct pairs."""
    s = _sor_batch(28, 64, b, cuda)
    names, fn = (SCALAR, kernels.sor_scalar) if nop == 1 else (COUPLED, kernels.sor_coupled)
    for v in kernels.sor_variants(28, 64, nop):
        _assert_batched_equals_per_pair(
            lambda *a: fn(*a, 3, 1.6, variant=v), [s[k] for k in names],
            lambda i: [s[k][i] for k in names], b)


_MAX_CTAS_PER_SM = 32  # resident CTAs an SM of compute capability 9.0 holds at most


@pytest.mark.parametrize("kernel", ["refine_inner", "sor_scalar", "sor_coupled"])
def test_grid_variant_rounds_over_more_pairs_than_resident(cuda, kernel):
    """More pairs than the grid variant keeps resident: its CTAs take the
    pairs in rounds, and every pair still equals its own launch."""
    h, w = 6, 10
    # above what any launch keeps resident: every SM's most CTAs, and 3 more
    b = torch.cuda.get_device_properties(cuda).multi_processor_count * _MAX_CTAS_PER_SM + 3
    if kernel == "refine_inner":
        batched, pairs = _refine_batch(h, w, 1, b, cuda)
        _assert_batched_equals_per_pair(
            lambda *a: kernels.refine_inner(*a, variant="grid"), batched, lambda i: pairs[i], b)
        return
    nop = 1 if kernel == "sor_scalar" else 2
    s = _sor_batch(h, w, b, cuda)
    names = SCALAR if nop == 1 else COUPLED
    fn = getattr(kernels, kernel)
    _assert_batched_equals_per_pair(
        lambda *a: fn(*a, 3, 1.6, variant="grid"), [s[k] for k in names],
        lambda i: [s[k][i] for k in names], b)


# ---------------------------------------------------------------------------
# gn_search's tile form (spatial tiling, parallel/spatial.py)
# ---------------------------------------------------------------------------

def _tile_crop(img, oy, ox, th, tw, zero):
    """The (th, tw) region at (oy, ox) of padded level images (..., Hp, Wp,
    C), rows and columns outside replicated (images) or zero (gradients):
    what a tile's H-wide halo exchange holds."""
    hp, wp = img.shape[-3:-1]
    ys = torch.arange(oy, oy + th, device=img.device)
    xs = torch.arange(ox, ox + tw, device=img.device)
    out = img[..., ys.clamp(0, hp - 1), :, :][..., xs.clamp(0, wp - 1), :]
    if zero:
        inside = (((ys >= 0) & (ys < hp))[:, None] & ((xs >= 0) & (xs < wp))[None, :])
        out = out * inside[..., None].float()
    return out.contiguous()


def _tile_case(psz, c, b, tile_yx, device, p_scale=1.5):
    """Level 1 of b distinct pairs cut as spatial_flow_tiled cuts it (2x2
    tiles, halo H = psz + 8 + 2): the untiled inputs, the owned patches'
    centres and starts, the tile's crops and tile=(oy, ox, hp_g, wp_g)."""
    from of_dis_tpu_torch.parallel.spatial import tile_ownership

    cfg = DISConfig(channels=c, sc_f=1, sc_l=0, max_iter=8, min_iter=2, patch_size=psz,
                    overlap=0.4 if psz == 8 else 0.75).validate()
    ima, dxa, dya, imb, _, _, _, lw, lh, pad = _search_batch(cfg, c, b, device)
    idx, valid = tile_ownership(lh * 2, lw * 2, cfg, 2, 2, 8.0)["lv1"]
    iy, ix = tile_yx
    own = idx[iy, ix][valid[iy, ix]]
    pt = torch.as_tensor(level_geometry(lw, lh, cfg).pt_ref[own], device=device)
    p0 = np.random.RandomState(b).randn(b, own.size, cfg.nop).astype(np.float32) * p_scale
    p0 = torch.as_tensor(p0, device=device)
    H = psz + 8 + 2
    th, tw = lh // 2, lw // 2
    oy, ox = iy * th + pad - H, ix * tw + pad - H
    crops = [_tile_crop(a, oy, ox, th + 2 * H, tw + 2 * H, z)
             for a, z in ((ima, False), (dxa, True), (dya, True), (imb, False))]
    return cfg, (ima, dxa, dya, imb), pt, p0, crops, (oy, ox, lh + 2 * pad, lw + 2 * pad), lw, lh


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("psz", [8, 12])
def test_gn_search_tile_form_matches_plain_and_untiled(cuda, psz, c, b):
    """The tile form on a halo'd tile equals its plain version and the
    untiled kernel on the full images for the same patches, bit for bit
    (every window lies in the tile when |p_init| <= max_disp)."""
    for tile_yx in ((0, 0), (1, 1)):
        cfg, full, pt, p0, crops, tile, lw, lh = _tile_case(psz, c, b, tile_yx, cuda)
        pad = cfg.patch_size
        tmpl_t = build_templates(*crops[:3], pt, cfg, pad, tile_origin=tile[:2])
        tmpl_u = build_templates(*full[:3], pt, cfg, pad)
        for a, u in zip(tmpl_t, tmpl_u):
            assert torch.equal(a, u)
        res = kernels.gn_search(crops[3], tmpl_t, pt, p0, cfg, lw, lh, pad, tile=tile)
        _assert_search_equal(res, gn_search_reference(crops[3], tmpl_t, pt, p0, cfg, lw, lh,
                                                      pad, tile=tile))
        _assert_search_equal(res, kernels.gn_search(full[3], tmpl_u, pt, p0, cfg, lw, lh, pad))


@pytest.mark.parametrize("psz", [8, 12])
def test_gn_search_tile_form_window_at_the_tile_edge(cuda, psz):
    """Starts beyond max_disp push the windows of an interior tile's
    patches against the tile's edge, where the image goes on: the bases
    clip into the tile (not the image), and the kernel still equals its
    plain version bit for bit."""
    cfg, full, pt, p0, crops, tile, lw, lh = _tile_case(psz, 1, 2, (1, 1), cuda, p_scale=9.0)
    pad = cfg.patch_size
    hp_l, wp_l = crops[3].shape[-3:-1]
    sy = min(2 * psz + 2, tile[2])
    by = (torch.floor(pt[:, 1] + p0[..., 1]).long() - psz + pad).clamp(0, tile[2] - sy)
    assert bool(((by - tile[0]) < 0).any() | ((by - tile[0]) > hp_l - sy).any())
    tmpl = build_templates(*crops[:3], pt, cfg, pad, tile_origin=tile[:2])
    res = kernels.gn_search(crops[3], tmpl, pt, p0, cfg, lw, lh, pad, tile=tile)
    _assert_search_equal(res, gn_search_reference(crops[3], tmpl, pt, p0, cfg, lw, lh, pad,
                                                  tile=tile))


def test_tile_level_without_patches(cuda, tmp_path):
    """A tile that owns no patch: gn_search refuses N = 0, and the tiled
    level (the caller) skips the search, launching nothing, and still
    densifies (zeros) and returns its tile."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from of_dis_tpu_torch.parallel import spatial

    cfg, full, pt, p0, crops, tile, lw, lh = _tile_case(8, 1, 1, (0, 0), cuda)
    cfg = dataclasses.replace(cfg, use_tv_refine=False)
    tmpl = build_templates(*crops[:3], pt[:0], cfg, cfg.patch_size, tile_origin=tile[:2])
    with pytest.raises(ValueError):
        kernels.gn_search(crops[3][0], tmpl._replace(hes=tmpl.hes[0]), pt[:0], p0[0, :0], cfg,
                          lw, lh, cfg.patch_size, tile=tile)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("ty", "tx"))
        raw = full[0][0, cfg.patch_size:-cfg.patch_size, cfg.patch_size:-cfg.patch_size]
        kernels.reset_launches()
        own = torch.zeros(0, dtype=torch.long, device=cuda)  # the tile's patches: none
        flow, flow_bw, clamped = spatial._level_2d(raw, raw, None, None, True, own, 1, lw, lh,
                                                   cfg, mesh, "ty", "tx", 8.0)
        torch.cuda.synchronize()
        assert kernels.launches["gn_search"] == 0
        assert flow.shape == (lh, lw, 2) and not flow.any() and flow_bw is None
        assert clamped.tolist() == [0]  # a (1,) count on the card
    finally:
        dist.destroy_process_group()
