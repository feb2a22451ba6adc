"""Port (of_dis_tpu_torch) vs JAX package: which search kernel each level
runs.  ops/kernels.py::search_route must reproduce the JAX package's
gn_route (of_dis_tpu/ops/pallas_kernels.py:1259) under the mapping
"level" -> "level", "untiled" / "tiled<ps>" -> "gn", "xla" -> "level", on
every level of op1-4 flow and op2 stereo, gray and RGB, at the reference's
QA size (1024x436) and at the small goldens' size (256x160).  Pure shape
arithmetic; then the port's counter of the routes its levels took."""

import dataclasses

import numpy as np
import pytest

from of_dis_tpu.config import operating_point
from of_dis_tpu.models.grid import level_geometry
from of_dis_tpu.ops.pallas_kernels import gn_route
from of_dis_tpu_torch import dis_flow
from of_dis_tpu_torch import operating_point as torch_operating_point
from of_dis_tpu_torch.ops import kernels
from of_dis_tpu_torch.ops.kernels import (
    refine_variant,
    refine_variants,
    search_route,
    sor_variant,
    sor_variants,
)

CONFIGS = [(1, "flow"), (2, "flow"), (3, "flow"), (4, "flow"), (2, "stereo")]


def _port_route(jax_route: str) -> str:
    if jax_route.startswith("tiled") or jax_route == "untiled":
        return "gn"
    assert jax_route in ("level", "xla"), jax_route
    return "level"


@pytest.mark.parametrize("w,h", [(1024, 436), (256, 160)])
@pytest.mark.parametrize("op,mode", CONFIGS)
@pytest.mark.parametrize("c", [1, 3])
def test_search_route_matches_gn_route(w, h, op, mode, c):
    cfg = operating_point(op, w, mode=mode, channels=c)
    scf = 1 << cfg.sc_f
    hp0, wp0 = h + (-h) % scf, w + (-w) % scf
    psz = cfg.patch_size
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        lw, lh = wp0 >> sl, hp0 >> sl
        n = level_geometry(lw, lh, cfg).n_patches
        hp, wp = lh + 2 * psz, lw + 2 * psz  # build_pyramid pads psz each side
        sy, sx = min(2 * psz + 2, hp), min(2 * psz + 2, wp)
        want = _port_route(gn_route(hp, wp, c, n, psz, sy, sx))
        assert search_route(hp, wp, c, n, psz, sy, sx) == want, (sl, hp, wp, n)


def test_search_route_sends_small_windows_to_level():
    """JAX's "xla" route (a window no larger than psz) stays on "level"."""
    assert gn_route(12, 200, 1, 40, 12, 12, 26) == "xla"
    assert search_route(12, 200, 1, 40, 12, 12, 26) == "level"


@pytest.mark.parametrize("c", [1, 3])
def test_refine_variant_total_deterministic_monotone(c):
    """refine_inner's launch variant: defined for every level size, one that
    can take the level, the same on every call, never a narrower barrier for
    more pixels, and the cooperative grid at op4's finest level (448x1024).
    Pure arithmetic."""
    rank = {"block": 0, "cluster": 1, "grid": 2}
    sizes = [(h, w) for h in (1, 2, 7, 14, 28, 56, 64, 65, 112, 224, 448, 512, 513)
             for w in (1, 3, 32, 64, 128, 256, 512, 1024)]
    last = (-1, 0)
    for h, w in sorted(sizes, key=lambda s: (s[0] * s[1], s)):
        v, n = picked = refine_variant(h, w, c)
        assert picked == refine_variant(h, w, c)
        assert v in rank and v in refine_variants(h, w)
        assert (n == 1) if v == "block" else (2 <= n <= 16) if v == "cluster" else (n == 0)
        assert (rank[v], n if v == "cluster" else 0) >= last, (h, w, v, n, last)
        last = (rank[v], n if v == "cluster" else 0)
    assert refine_variant(448, 1024, c) == ("grid", 0)


@pytest.mark.parametrize("nop", [1, 2])
def test_sor_variant_total_deterministic_monotone(nop):
    """The launch variant of sor_scalar (nop 1) and sor_coupled (nop 2):
    defined for every level size, one that can take the level, the same on
    every call, never a narrower barrier for more pixel pairs, the block at
    op2's levels 5 and 4 (14x32, 28x64), a cluster at level 3 (56x128) and
    the cooperative grid at 448x1024.  Pure arithmetic."""
    rank = {"block": 0, "cluster": 1, "grid": 2}
    sizes = [(h, w) for h in (1, 2, 3, 7, 14, 28, 56, 57, 64, 65, 112, 113, 224, 448, 449)
             for w in (1, 3, 32, 64, 128, 256, 512, 1024)]
    last = (-1, 0)
    for h, w in sorted(sizes, key=lambda s: (-(-s[0] // 2) * s[1], s)):
        v, n = picked = sor_variant(h, w, nop)
        assert picked == sor_variant(h, w, nop)
        assert v in rank and v in sor_variants(h, w, nop)
        assert (n == 1) if v == "block" else (2 <= n <= 16) if v == "cluster" else (n == 0)
        assert (rank[v], n if v == "cluster" else 0) >= last, (h, w, v, n, last)
        last = (rank[v], n if v == "cluster" else 0)
        assert "grid" in sor_variants(h, w, nop)
    for h, w in ((14, 32), (28, 64)):
        assert sor_variant(h, w, nop) == ("block", 1)
    assert sor_variant(56, 128, nop)[0] == "cluster"
    assert sor_variant(448, 1024, nop) == ("grid", 0)


@pytest.mark.parametrize("b", [2, 8, 16, 32, 64])
def test_variant_pickers_take_the_batch(b):
    """With b pairs a launch, both pickers still give a variant that can
    take the level and never a narrower barrier for a larger level; from
    16 pairs on, refine_inner's clusters of more than 8 CTAs give way to the
    grid (the SOR solvers' clusters from 8 pairs: PERF.md).  Pure
    arithmetic."""
    rank = {"block": 0, "cluster": 1, "grid": 2}
    sizes = [(h, w) for h in (1, 2, 7, 14, 28, 56, 57, 64, 65, 112, 224, 448)
             for w in (1, 3, 32, 64, 128, 256, 1024)]
    for nop in (0, 1, 2):  # 0: refine_inner (by pixels), 1 / 2: the SOR solvers (by pairs)
        def pick(h, w):
            return refine_variant(h, w, 1, b) if nop == 0 else sor_variant(h, w, nop, b)

        def size(s):
            return s[0] * s[1] if nop == 0 else -(-s[0] // 2) * s[1]

        last = (-1, 0)
        for h, w in sorted(sizes, key=lambda s: (size(s), s)):
            v, n = pick(h, w)
            assert v in (refine_variants(h, w) if nop == 0 else sor_variants(h, w, nop))
            assert (rank[v], n if v == "cluster" else 0) >= last, (nop, h, w, v, n, last)
            last = (rank[v], n if v == "cluster" else 0)
    assert sor_variant(56, 128, 1, b)[0] == ("cluster" if b < 8 else "grid" if b < 16
                                             else "block")
    assert refine_variant(28, 64, 1, b) == ("cluster", 7)
    assert refine_variant(56, 128, 1, b) == (("cluster", 16) if b < 16 else ("grid", 0))
    if b >= 16:
        assert sor_variant(56, 128, 2, b) == ("grid", 0)
    assert refine_variant(14, 32, 1, b) == sor_variant(14, 32, 1, b) == ("block", 1)


def test_route_counter_counts_each_level_per_call():
    """The port's search-route counter (ops/kernels.py `routes`) on the CPU:
    each call counts every pyramid level once under the route search_route
    gives it; op4 at 128x96 searches levels 2-1 whole and level 0 on the GN
    route.  Iterations cut to 2 (the route depends on shapes only)."""
    cfg = dataclasses.replace(torch_operating_point(4, 128), max_iter=2, min_iter=2)
    img = np.random.RandomState(0).rand(96, 128).astype(np.float32) * 255
    kernels.reset_launches()
    dis_flow(img, np.roll(img, 2, axis=1), cfg, device="cpu")
    assert kernels.routes == {"level": 2, "gn": 1}
    dis_flow(img, img, cfg, device="cpu")
    assert kernels.routes == {"level": 4, "gn": 2}
    assert sum(kernels.launches.values()) == 0  # plain versions launch nothing
