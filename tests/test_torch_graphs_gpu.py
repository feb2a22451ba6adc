"""The port's compiled executables (ops/graphs.py) on the card: every path,
batch, warm start and kernel gives the same bits as a CUDA graph replay as
it does run op by op under eager(), including replays on inputs other
than the captured ones and after the caches that fed the capture were
cleared; each replay counts the launches an eager run counts.  Every
kernel is also captured alone, in each launch variant it can take, and
held against its plain version.  Marked `gpu` and skipped without a CUDA
device.  This file imports no JAX and no conftest fixture, so on a
machine with a GPU and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_gpu.py
"""

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import batched_flow, dis_raw, eager, operating_point
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.models import grid
from of_dis_tpu_torch.models.inverse_search import (
    build_templates,
    gn_search_reference,
    level_search_reference,
)
from of_dis_tpu_torch.models.refine import refine_inner_reference, sor_coupled_rb, sor_scalar_rb
from of_dis_tpu_torch.ops import graphs, kernels
from of_dis_tpu_torch.ops import pyramid as pyr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _smooth_pair(h=96, w=128, c=1, seed=0, dx=3, dy=-2):
    """A smooth random pair, the second image moved by (-dx, -dy)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h + 16, w + 16, c)
    for _ in range(4):  # repeated 3x3 box blur
        base = sum(np.roll(np.roll(base, y, 0), x, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)) / 9
    base = (base * 255).astype(np.float32)
    return base[8:8 + h, 8:8 + w], base[8 + dy:8 + dy + h, 8 + dx:8 + dx + w]


# name: (operating point, mode, channels, fb-merge)
PATHS = {
    "op2 gray": (2, "flow", 1, False),
    "op2 rgb": (2, "flow", 3, False),
    "op4 gray": (4, "flow", 1, False),
    "stereo gray": (2, "stereo", 1, False),
    "op2 gray fb": (2, "flow", 1, True),
}


def _path(name, seed=0):
    op, mode, c, fb = PATHS[name]
    img1, img2 = _smooth_pair(c=c, seed=seed, dy=0 if mode == "stereo" else -2)
    return img1, img2, operating_point(op, 128, mode=mode, channels=c, use_fb_merge=fb)


def _counted(fn):
    """fn()'s result and the launches it made, after the device finished."""
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.launches)


@pytest.mark.parametrize("name", list(PATHS))
def test_path_graph_equals_eager(cuda, name):
    """The capture's result, two replays and a replay on another pair, each
    bit-equal to its eager run, each replay with the eager launches."""
    img1, img2, cfg = _path(name)
    with eager():
        want, want_launches = _counted(lambda: dis_raw(img1, img2, cfg, device=cuda))
    assert sum(want_launches.values()) > 0
    first = dis_raw(img1, img2, cfg, device=cuda)
    (ex,) = [e for e in graphs.cache.entries(cuda) if e.key[0] is tdis.dis_entry_jit.fn
             and e.key[1].kids[0].kids[2] == cfg]
    assert ex.launches == {k: n for k, n in want_launches.items() if n}
    again, launches = _counted(lambda: dis_raw(img1, img2, cfg, device=cuda))
    twice = dis_raw(img1, img2, cfg, device=cuda)
    assert torch.equal(first, want) and torch.equal(again, want) and torch.equal(twice, want)
    assert launches == want_launches
    other1, other2, _ = _path(name, seed=1)
    with eager():
        other_want = dis_raw(other1, other2, cfg, device=cuda)
    assert torch.equal(dis_raw(other1, other2, cfg, device=cuda), other_want)
    assert not torch.equal(other_want, want)


def test_executable_records_routes(cuda):
    """The search routes a capture counted (Executable.routes) are the
    eager run's, and each replay adds them to kernels.routes, as it adds
    its launches: op4 at 128x96 searches levels 2-1 whole and level 0 on
    the GN route."""
    img1, img2, cfg = _path("op4 gray")
    kernels.reset_launches()
    with eager():
        dis_raw(img1, img2, cfg, device=cuda)
    assert kernels.routes == {"level": 2, "gn": 1}
    dis_raw(img1, img2, cfg, device=cuda)  # captures, unless an earlier test did
    (ex,) = [e for e in graphs.cache.entries(cuda) if e.key[0] is tdis.dis_entry_jit.fn
             and e.key[1].kids[0].kids[2] == cfg]
    assert ex.routes == {"level": 2, "gn": 1}
    _counted(lambda: [dis_raw(img1, img2, cfg, device=cuda) for _ in range(2)])
    assert kernels.routes == {"level": 4, "gn": 2}


@pytest.mark.parametrize("b", [1, 2, 7])
def test_batched_graph_equals_eager_and_each_pair(cuda, b):
    """batched_flow's replay of dis_entry_jit: bit-equal to its eager run
    and each pair to its own dis_raw (a replay of dis_entry_jit for one pair)."""
    img1, img2, cfg = _path("op2 gray")
    a = np.stack([np.roll(img1, 4 * i, axis=1) for i in range(b)])
    bb = np.stack([np.roll(img2, 4 * i, axis=1) for i in range(b)])
    with eager():
        want, want_launches = _counted(lambda: batched_flow(a, bb, cfg, device=cuda))
    batched_flow(a, bb, cfg, device=cuda)  # captures
    got, launches = _counted(lambda: batched_flow(a, bb, cfg, device=cuda))
    assert torch.equal(got, want) and launches == want_launches
    for i in range(b):
        assert torch.equal(got[i], dis_raw(a[i], bb[i], cfg, device=cuda))


def test_replay_on_new_inputs_and_init_flow(cuda):
    """dis_padded_init_jit, captured on one pair and warm start, replayed on
    another pair and another warm start (shared by a batch of 2 and per
    pair): the eager results, nothing baked in at capture."""
    img1, img2, cfg = _path("op2 gray")
    scf = 1 << cfg.sc_f
    p = [pyr.pad_to_divisible(torch.as_tensor(np.stack([x, np.roll(x, 5, 1)]), device=cuda), scf)
         for x in (img1, img2)]
    hp, wp = p[0].shape[1:3]
    rng = np.random.RandomState(7)
    shape = (hp >> (cfg.sc_f + 1), wp >> (cfg.sc_f + 1), 2)
    for lead in ((), (2,)):
        inits = [torch.as_tensor(rng.randn(*lead, *shape).astype(np.float32), device=cuda)
                 for _ in range(2)]
        tdis.dis_padded_init_jit(p[0], p[1], inits[0], cfg)  # captures
        for a, b, init in ((p[0], p[1], inits[1]), (p[1], p[0], inits[0])):
            got = tdis.dis_padded_init_jit(a, b, init, cfg)
            with eager():
                want = tdis.dis_padded_init_jit(a, b, init, cfg)
            assert torch.equal(got, want)


def test_replay_after_caches_cleared(cuda):
    """The lru_caches that copied the level geometry to the card are cleared
    and a few hundred MiB allocated, written and freed: the replay still
    reads its held tensors, and equals the eager run."""
    img1, img2, cfg = _path("op2 gray fb")
    dis_raw(img1, img2, cfg, device=cuda)  # captures
    tdis._grid_tensors_cached.cache_clear()
    grid._level_geometry_cached.cache_clear()
    churn = [torch.full((64, 1 << 20), float(i), device=cuda) for i in range(4)]  # 1 GiB
    del churn
    got = dis_raw(img1, img2, cfg, device=cuda)
    with eager():
        want = dis_raw(img1, img2, cfg, device=cuda)
    assert torch.equal(got, want)


# ---- each kernel captured alone, in each launch variant ----

@graphs.executable
def _level_search_alone(ima, dxa, dya, imb, pt_ref, p_init, cfg, w, h, pad):
    return kernels.level_search(ima, dxa, dya, imb, pt_ref, p_init, cfg, w, h, pad)


@graphs.executable
def _gn_search_alone(imb, tmpl, pt_ref, p_init, cfg, w, h, pad):
    return kernels.gn_search(imb, tmpl, pt_ref, p_init, cfg, w, h, pad)


@graphs.executable
def _refine_inner_alone(wx, wy, mask, derivs, n_inner, solver_it, omega, qa, hd3, hg3, *,
                        variant):
    return kernels.refine_inner(wx, wy, mask, derivs, n_inner, solver_it, omega, qa, hd3, hg3,
                                variant=variant)


@graphs.executable
def _sor_scalar_alone(du, a11, b1, wh, wv, iterations, omega, *, variant):
    return kernels.sor_scalar(du, a11, b1, wh, wv, iterations, omega, variant=variant)


@graphs.executable
def _sor_coupled_alone(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations, omega, *, variant):
    return kernels.sor_coupled(du, dv, a11, a12, a22, b1, b2, wh, wv, iterations, omega,
                               variant=variant)


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else [t for t in out if t is not None]


def _check_alone(kernel, alone, plain, args, **kw):
    """The kernel's executable alone(*args, **kw), captured, then replayed
    on the same arguments, against its plain version plain(*args): the same
    bits, one launch per replay."""
    alone(*args, **kw)  # captures
    got, launches = _counted(lambda: alone(*args, **kw))
    assert launches == {k: int(k == kernel) for k in kernels.launches}
    for g, w in zip(_flat(got), _flat(plain(*args)), strict=True):
        assert torch.equal(g, w), kernel


def _search_args(cfg, b, device):
    """A level of b pairs (pair i moved by i px) at op2's level 1 shape of a
    96x128 pair, with random starts."""
    img1, img2 = _smooth_pair()
    pad, sl = cfg.patch_size, 1
    t = [torch.as_tensor(np.stack([np.roll(x, i, 1) for i in range(b)]), device=device)
         for x in (img1, img2)]
    im1, dx1, dy1 = (v[sl] for v in pyr.build_pyramid(t[0], sl + 1, pad))
    im2 = pyr.build_pyramid(t[1], sl + 1, pad)[0][sl]
    lw, lh = 128 >> sl, 96 >> sl
    pt = torch.as_tensor(grid.level_geometry(lw, lh, cfg).pt_ref, device=device)
    p0 = torch.as_tensor(np.random.RandomState(3).randn(b, pt.shape[0], 2).astype(np.float32),
                         device=device)
    return im1, dx1, dy1, im2, pt, p0, lw, lh, pad


@pytest.mark.parametrize("kernel", ["level_search", "gn_search"])
def test_search_kernel_captured_alone(cuda, kernel):
    cfg = operating_point(2, 128)
    im1, dx1, dy1, im2, pt, p0, lw, lh, pad = _search_args(cfg, 2, cuda)
    if kernel == "level_search":
        _check_alone(kernel, _level_search_alone, level_search_reference,
                     (im1, dx1, dy1, im2, pt, p0, cfg, lw, lh, pad))
    else:
        tmpl = build_templates(im1, dx1, dy1, pt, cfg, pad)
        _check_alone(kernel, _gn_search_alone, gn_search_reference,
                     (im2, tmpl, pt, p0, cfg, lw, lh, pad))


def _fields(b, h, w, device, seed, n):
    """n seeded (b, h, w) SOR fields: du[, dv], the diagonal(s), the
    right-hand side(s), the edge weights (zero past the last column / row)."""
    rng = np.random.RandomState(seed)

    def f(scale, off=0.0):
        return torch.as_tensor((rng.randn(b, h, w) * scale + off).astype(np.float32),
                               device=device)

    wh, wv = f(0.5, 1.0).abs(), f(0.5, 1.0).abs()
    wh[..., -1] = 0.0
    wv[..., -1, :] = 0.0
    if n == 1:
        return (f(0.3), f(0.5, 2.0).abs(), f(1.0), wh, wv)
    return (f(0.3), f(0.3), f(0.5, 2.0).abs(), f(0.2), f(0.5, 2.0).abs(), f(1.0), f(1.0), wh, wv)


@pytest.mark.parametrize("variant", kernels.REFINE_VARIANTS)
@pytest.mark.parametrize("kernel", ["refine_inner", "sor_scalar", "sor_coupled"])
def test_variant_captured_alone(cuda, kernel, variant):
    """At 28x64 (op2's level 4 shape) for 2 pairs, where every variant of
    every one of the three kernels can take the level."""
    b, h, w = 2, 28, 64
    if kernel == "refine_inner":
        rng = np.random.RandomState(1)

        def field(*shape, scale=1.0):
            return torch.as_tensor(rng.randn(b, *shape).astype(np.float32) * scale, device=cuda)

        mask = torch.as_tensor((rng.rand(b, h, w) > 0.05).astype(np.float32), device=cuda)
        derivs = tuple(field(h, w, 1, scale=s) for s in (5, 5, 10, 2, 2, 2, 3, 3))
        args = (field(h, w), field(h, w), mask, derivs, 3, 3, 1.6, 2.5, 5 / 6, 5 / 3)
        _check_alone(kernel, _refine_inner_alone, refine_inner_reference, args, variant=variant)
    elif kernel == "sor_scalar":
        assert variant in kernels.sor_variants(h, w, 1)
        _check_alone(kernel, _sor_scalar_alone, sor_scalar_rb,
                     _fields(b, h, w, cuda, 2, 1) + (3, 1.6), variant=variant)
    else:
        assert variant in kernels.sor_variants(h, w, 2)
        _check_alone(kernel, _sor_coupled_alone, sor_coupled_rb,
                     _fields(b, h, w, cuda, 3, 2) + (3, 1.6), variant=variant)
