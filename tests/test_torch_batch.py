"""Port (of_dis_tpu_torch) batching on the CPU: `batched_flow` against a
loop of the port's own `dis_raw` (exact: each pair is computed as it is
alone), against the JAX package's `batched_flow` (mean EPE, the bound of
test_torch_dis.py::test_dis_flow_matches_jax), and the plain version of
every kernel, batched, against a loop over its pairs (exact)."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from golden_util import epe
from of_dis_tpu import DISConfig
from of_dis_tpu.parallel.batch import batched_flow as jax_batched_flow
from of_dis_tpu_torch import batched_flow, dis_raw
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import inverse_search as tsearch
from of_dis_tpu_torch.models import refine as trf
from of_dis_tpu_torch.models.grid import level_geometry
from of_dis_tpu_torch.ops import kernels
from of_dis_tpu_torch.ops import pyramid as tpyr


def _cfg(**kw):
    base = dict(mode="flow", channels=1, sc_f=1, sc_l=0, max_iter=3, min_iter=3,
                patch_size=8, overlap=0.4, use_tv_refine=True, tv_solverit=2)
    return DISConfig(**{**base, **kw}).validate()


def _frames(b, h, w, seed=0):
    """b smooth pairs; the second frame moved by (+3, +2) px, each pair its
    own content."""
    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(b, h + 8, w + 8) * 255, (0, 2, 2)).astype(np.float32)
    return base[:, 4:4 + h, 4:4 + w], base[:, 2:2 + h, 7:7 + w]


def _rgb(x):
    return np.stack([x, x * 0.8 + 10, x * 0.6 + 40], -1)


def _routes(cfg, h, w):
    """kernels.search_route of each level of an (h, w) pair."""
    psz, out = cfg.patch_size, []
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lh, lw = h >> sl, w >> sl
        hp, wp = lh + 2 * psz, lw + 2 * psz
        n = level_geometry(lw, lh, cfg).n_patches
        out.append(kernels.search_route(hp, wp, cfg.channels, n, psz,
                                        min(2 * psz + 2, hp), min(2 * psz + 2, wp)))
    return out


# (config, (pairs, h, w)), small enough for the CPU
CASES = {
    "flow gray": (_cfg(), (3, 40, 48)),
    "flow rgb": (_cfg(channels=3), (2, 40, 48)),
    "stereo gray": (_cfg(mode="stereo"), (3, 40, 48)),
    # level 0 (80x112) takes the GN route: templates, then gn_search
    "flow gray gn route": (_cfg(), (2, 80, 112)),
    # the forward-backward merge: a backward search, densify and refinement
    # per pair (stereo: the flipped sign clamp)
    "flow gray fb": (_cfg(use_fb_merge=True), (2, 40, 48)),
    "stereo gray fb": (_cfg(mode="stereo", use_fb_merge=True), (2, 40, 48)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_flow_equals_loop_of_dis_raw(case):
    cfg, (b, h, w) = CASES[case]
    a, bb = _frames(b, h, w)
    if cfg.channels == 3:
        a, bb = _rgb(a), _rgb(bb)
    if case.endswith("gn route"):
        assert _routes(cfg, h, w) == ["level", "gn"]
    out = batched_flow(a, bb, from_reference(dataclasses.asdict(cfg)), device="cpu")
    assert out.shape == (b, h, w, cfg.nop)
    for i in range(b):
        one = dis_raw(a[i], bb[i], from_reference(dataclasses.asdict(cfg)), device="cpu")
        assert torch.equal(out[i], one), (i, float((out[i] - one).abs().max()))


@pytest.fixture(scope="module")
def jax_batch():
    """tests/test_parallel.py's batch (B cut to 4) through the JAX batched_flow."""
    a, b = _frames(4, 40, 48)
    return a, b, np.asarray(jax_batched_flow(a, b, _cfg()))


def test_batched_flow_matches_jax(jax_batch):
    a, b, ref = jax_batch
    ours = batched_flow(a, b, from_reference(dataclasses.asdict(_cfg())), device="cpu").numpy()
    assert ours.shape == ref.shape
    for i in range(len(a)):
        assert epe(ours[i], ref[i]) <= 0.01, i


def _level_batch(b, cfg, c=1):
    """b pairs' padded level-1 images, shared centres and per-pair starts."""
    a, bb = _frames(b, 40, 48, seed=1)
    if c == 3:
        a, bb = _rgb(a), _rgb(bb)
    else:
        a, bb = a[..., None], bb[..., None]
    pad = cfg.patch_size
    ims1 = tpyr.build_pyramid(torch.as_tensor(a), 2, pad)
    ims2 = tpyr.build_pyramid(torch.as_tensor(bb), 2, pad)
    geo = level_geometry(24, 20, cfg)
    p0 = torch.as_tensor(np.random.RandomState(3).randn(b, geo.n_patches, cfg.nop)
                         .astype(np.float32) * 1.5)
    return (ims1[0][1], ims1[1][1], ims1[2][1], ims2[0][1],
            torch.as_tensor(geo.pt_ref), p0, cfg, 24, 20, pad)


def _fields(b, h, w, n, seed):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor((rng.rand(b, h, w) * 2 + 0.1).astype(np.float32)) for _ in range(n)]


def _each(out, i):
    """Pair i of a kernel's batched output (a tensor, tuple or SearchResult)."""
    if isinstance(out, torch.Tensor):
        return out[i]
    pair = [None if t is None else t[i] for t in out]
    return type(out)(*pair) if hasattr(out, "_fields") else tuple(pair)


def _plain_case(name):
    """(plain function, batched args, per-pair args of pair i) of a kernel."""
    b = 3
    if name in ("level_search", "gn_search"):
        cfg = from_reference(dataclasses.asdict(_cfg(max_iter=6, min_iter=2)))
        ima, dxa, dya, imb, pt_ref, p0, *rest = _level_batch(b, cfg)
        if name == "level_search":
            return (tsearch.level_search_reference, (ima, dxa, dya, imb, pt_ref, p0, *rest),
                    lambda i: (ima[i], dxa[i], dya[i], imb[i], pt_ref, p0[i], *rest))
        tmpl = tsearch.build_templates(ima, dxa, dya, pt_ref, cfg, rest[-1])
        return (tsearch.gn_search_reference, (imb, tmpl, pt_ref, p0, *rest),
                lambda i: (imb[i], _each(tmpl, i), pt_ref, p0[i], *rest))
    h, w = 13, 17
    if name == "refine_inner":
        wx, wy, mask = _fields(b, h, w, 3, seed=4)
        derivs = tuple(_fields(b, h, w, 8, seed=5))
        derivs = tuple(d[..., None] for d in derivs)
        consts = (2, 3, 1.6, 2.5, 5 / 6, 5 / 3)
        return (trf.refine_inner_reference, (wx, wy, mask, derivs, *consts),
                lambda i: (wx[i], wy[i], mask[i], tuple(d[i] for d in derivs), *consts))
    nf = 5 if name == "sor_scalar_rb" else 9
    fs = _fields(b, h, w, nf, seed=6)
    fs[-2][..., -1] = 0.0  # wh: zero last column
    fs[-1][..., -1, :] = 0.0  # wv: zero last row
    fn = getattr(trf, name)
    return fn, (*fs, 3, 1.6), lambda i: (*(f[i] for f in fs), 3, 1.6)


@pytest.mark.parametrize("name", ["level_search", "gn_search", "refine_inner", "sor_scalar_rb",
                                  "sor_coupled_rb"])
def test_plain_kernel_versions_batched_equal_loop(name):
    fn, args, one = _plain_case(name)
    out = fn(*args)
    for i in range(3):
        got, want = _each(out, i), fn(*one(i))
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        for g, r in zip(got, want):
            assert (g is None) == (r is None)
            if r is not None:
                assert torch.equal(g, r), (name, i)


def test_batched_entry_points_default_to_cuda(tmp_path):
    """batched_flow and both video drivers run on CUDA unless told
    otherwise, so on a host without a GPU they raise."""
    from of_dis_tpu_torch.parallel.video import process_video, process_video_batched

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, b = _frames(2, 40, 48)
    cfg = from_reference(dataclasses.asdict(_cfg()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batched_flow(a, b, cfg)
    for driver in (process_video, process_video_batched):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(driver([a[0], b[0]], tmp_path, cfg, loader=lambda x: x))
