"""Port (of_dis_tpu_torch) spatial sharding on the CPU, against the JAX
package and the port's single-device pipeline.

One 4-rank gloo world (tests/torch_spatial_worker.py, started once by the
module's fixture with torch.multiprocessing.spawn and a FileStore under the
test's temporary directory) runs every sharded case; the parent computes
the JAX references meanwhile, on tests/conftest.py's virtual devices, and
compares:
  - the halo primitives and the halo reduce with the JAX ones under
    shard_map: exactly (data movement and the same additions);
  - spatial_flow, spatial_flow_tiled, flow_2d and flow_2d_tiled with the
    JAX package's dis_padded_jit and the port's dis_raw: rtol = atol =
    1e-3, the bound the JAX package holds its own spatial_flow to
    (tests/test_spatial.py:56);
  - batched_flow and process_video_batched with a data mesh against the
    same calls without one: bit for bit;
  - the sharded passes through their executables (a Recorder for CUDA
    graphs): bit-equal to the eager calls, a replay counting the eager
    call's launches and exchanges, the clamp counts unchanged, a table per
    mesh (by its groups), the same keys on every rank under a small bound,
    and the tables dropped with their groups.
Outside the world: tile_ownership equals the JAX tables, and the tile form
of the plain GN search (build_templates(tile_origin=), optimize_level(
tile=)) equals the untiled search bit for bit and the JAX tile form at
tests/test_torch_inverse_search.py's tolerances.  The test marked slow
holds the port's spatial_flow / spatial_flow_tiled against the JAX ones
(whose shard_map compile takes minutes on the CPU)."""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

import torch_spatial_worker as worker
from of_dis_tpu import DISConfig
from of_dis_tpu.config import operating_point
from of_dis_tpu.models.dis import dis_padded_jit
from of_dis_tpu.models.grid import level_geometry
from of_dis_tpu.models.inverse_search import build_templates, optimize_level
from of_dis_tpu.ops import pyramid as pyr
from of_dis_tpu.parallel import spatial as jsp
from of_dis_tpu_torch import dis_raw
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import inverse_search as tsearch
from of_dis_tpu_torch.parallel.spatial import tile_ownership

TOL = dict(rtol=1e-3, atol=1e-3)
WORLD_TIMEOUT_S = 240


def _cfg(kind):
    return DISConfig(**worker.config(kind)).validate()


def _jax_flow(cfg, a, b):
    return np.asarray(dis_padded_jit(jnp.asarray(a[..., None]), jnp.asarray(b[..., None]), cfg))


def _port_flow(cfg, a, b):
    return dis_raw(a, b, from_reference(dataclasses.asdict(cfg)), device="cpu").numpy()


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _jax_halos():
    """The JAX halo primitives on the worker's inputs, under shard_map (one
    program per mesh): {key: per-rank outputs}."""
    strip, tile, acc = worker.halo_inputs()
    k = worker.HALO_K
    modes = worker.MODES

    def strips(x):
        return tuple(jsp._halo_x_mode(x, k, "tx", m) for m in modes) + (
            jsp.halo_x(x, k, "tx", "edge"),)

    spec = P(None, "tx")
    ys = jax.jit(jax.shard_map(strips, mesh=_jax_mesh((4,), ("tx",)), in_specs=spec,
                               out_specs=(spec,) * (len(modes) + 1), check_vma=False))(strip)
    wl = 4 + 2 * k
    out = {key: [np.asarray(y)[:, r * wl:(r + 1) * wl] for r in range(4)]
           for key, y in zip([f"halo_x {m}" for m in modes] + ["halo_x api"], ys)}

    def tiles(x, a):
        return (tuple(jsp.halo_y(x, k, "ty", m) for m in modes)
                + tuple(jsp._halo2d(x, k, "ty", "tx", m) for m in modes)
                + (jsp._halo_reduce_2d(a, k, "ty", "tx"),))

    spec = P("ty", "tx")
    acc_full = np.concatenate([np.concatenate(list(row), axis=1) for row in acc], axis=0)
    ys = jax.jit(jax.shard_map(tiles, mesh=_jax_mesh((2, 2), ("ty", "tx")),
                               in_specs=(spec, spec), out_specs=(spec,) * (2 * len(modes) + 1),
                               check_vma=False))(tile, acc_full)
    keys = ([f"halo_y {m}" for m in modes] + [f"halo2d {m}" for m in modes] + ["halo_reduce"])
    shapes = [(6 + 2 * k, 8)] * len(modes) + [(6 + 2 * k, 8 + 2 * k)] * len(modes) + [(6, 8)]
    for key, y, (th, tw) in zip(keys, ys, shapes):
        y = np.asarray(y)
        out[key] = [y[iy * th:(iy + 1) * th, ix * tw:(ix + 1) * tw]
                    for iy in range(2) for ix in range(2)]
    return out


def _references():
    """What the world's results are held to: JAX's dis_padded_jit and the
    port's dis_raw per case, and the JAX halo primitives."""
    refs = {"halos": _jax_halos()}
    for kind in ("flow", "stereo", "fb"):
        cfg = _cfg(kind)
        a, b = worker.pair(kind)
        refs[kind] = {"jax": _jax_flow(cfg, a, b), "port": _port_flow(cfg, a, b)}
    refs["sparse"] = {"port": _port_flow(_cfg("sparse"), *worker.pair("sparse"))}
    cfg = _cfg("flow")
    a2, b2 = worker.batch(2)
    refs["batch2"] = {"jax": np.stack([_jax_flow(cfg, a, b) for a, b in zip(a2, b2)]),
                      "port": np.stack([_port_flow(cfg, a, b) for a, b in zip(a2, b2)])}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4-rank world, compute the references meanwhile, and wait
    for the ranks: (per-rank results, references, output directory)."""
    out = tmp_path_factory.mktemp("spatial_world")
    ctx = mp.spawn(worker.run, args=(str(out / "store"), str(out)), nprocs=worker.WORLD,
                   join=False)
    try:
        refs = _references()
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the 4-rank world did not finish in {WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(worker.WORLD)]
    return ranks, refs, out


# ---------------------------------------------------------------------------
# Tables and the tile form of the search (no world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["96x128 test", "448x1024 op2", "448x1024 op4", "empty tile"])
def test_tile_ownership_matches_jax(case):
    if case == "96x128 test":
        cfg, (h, w), (ny, nx), md = _cfg("flow"), (96, 128), (2, 2), 8.0
    elif case == "empty tile":
        cfg, (h, w), (ny, nx), md = _cfg("sparse"), worker.SPARSE_HW, (1, 4), 0.0
    else:
        op = int(case[-1])
        cfg, (h, w), (ny, nx), md = operating_point(op, 1024), (448, 1024), (2, 2), 8.0
    ref = jsp.tile_ownership(h, w, cfg, ny, nx, md, "ty", "tx")[0]
    ours = tile_ownership(h, w, from_reference(dataclasses.asdict(cfg)), ny, nx, md)
    assert sorted(ours) == sorted(ref)
    for k, (idx, valid) in ours.items():
        np.testing.assert_array_equal(idx, np.asarray(ref[k][0]))
        np.testing.assert_array_equal(valid, np.asarray(ref[k][1]))
        assert idx.dtype == np.int32 and valid.dtype == bool
    if case == "448x1024 op4":  # levels 0-3 tile; level 4's 14-row tiles fall short
        assert sorted(ours) == ["lv0", "lv1", "lv2", "lv3"]
    if case == "448x1024 op2":
        assert sorted(ours) == ["lv3"]
    if case == "empty tile":
        assert (ours["lv0"][1].sum(-1) == 0).any()


def _edge_crop(img, oy, ox, th, tw, zero):
    """The (th, tw) region at (oy, ox) of a padded level image, rows and
    columns outside it replicated (images) or zero (gradients): what a
    tile's H-wide halo exchange holds."""
    ys, xs = np.arange(oy, oy + th), np.arange(ox, ox + tw)
    out = img[np.clip(ys, 0, img.shape[0] - 1)][:, np.clip(xs, 0, img.shape[1] - 1)]
    if zero:
        out = out * (((ys >= 0) & (ys < img.shape[0]))[:, None, None]
                     & ((xs >= 0) & (xs < img.shape[1]))[None, :, None])
    return np.ascontiguousarray(out)


@pytest.mark.parametrize("mode", ["flow", "stereo"])
@pytest.mark.parametrize("tile_yx", [(0, 0), (1, 1)])
def test_tile_search_plain_equals_untiled(mode, tile_yx, smooth_pair):
    """The plain tile form on tile (iy, ix) of a 2x2 tiling of the test
    level (halo H = psz + 8 + 2, as spatial_flow_tiled cuts it) equals the
    untiled search of the same owned patches bit for bit, and JAX's
    optimize_level(tile=) at test_torch_inverse_search.py's tolerances."""
    img1, img2, _ = smooth_pair
    cfg = DISConfig(mode=mode, channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                    patch_size=8, overlap=0.4, use_tv_refine=False).validate()
    tcfg = from_reference(dataclasses.asdict(cfg))
    pad, sl, nop = cfg.patch_size, 1, cfg.nop
    im1s, dx1s, dy1s = pyr.build_pyramid(jnp.asarray(img1[..., None]), 2, pad)
    im2s, _, _ = pyr.build_pyramid(jnp.asarray(img2[..., None]), 2, pad)
    ima, dxa, dya, imb = (np.array(a[sl]) for a in (im1s, dx1s, dy1s, im2s))
    lh, lw = img1.shape[0] >> sl, img1.shape[1] >> sl
    H = pad + 8 + 2
    th, tw = lh // 2, lw // 2
    iy, ix = tile_yx
    oy, ox = iy * th + pad - H, ix * tw + pad - H
    hp_g, wp_g = lh + 2 * pad, lw + 2 * pad
    idx, valid = tile_ownership(*img1.shape, tcfg, 2, 2, 8.0)[f"lv{sl}"]
    own = idx[iy, ix][valid[iy, ix]]
    geo = level_geometry(lw, lh, cfg)
    pt = geo.pt_ref[own]
    p0 = np.random.RandomState(3).randn(own.size, nop).astype(np.float32) * 1.5
    crop = [_edge_crop(a, oy, ox, th + 2 * H, tw + 2 * H, z)
            for a, z in ((ima, False), (dxa, True), (dya, True), (imb, False))]

    t = lambda a: torch.as_tensor(a)  # noqa: E731
    tile = (oy, ox, hp_g, wp_g)
    tt = tsearch.build_templates(*map(t, crop[:3]), t(pt), tcfg, pad, tile_origin=(oy, ox))
    tu = tsearch.build_templates(t(ima), t(dxa), t(dya), t(pt), tcfg, pad)
    for a, b in zip(tt, tu):
        assert torch.equal(a, b)
    ours = tsearch.gn_search_reference(t(crop[3]), tt, t(pt), t(p0), tcfg, lw, lh, pad,
                                       tile=tile)
    full = tsearch.gn_search_reference(t(imb), tu, t(pt), t(p0), tcfg, lw, lh, pad)
    for f in ("p", "pt", "pweight", "converged", "iters"):
        assert torch.equal(getattr(ours, f), getattr(full, f)), f

    jt = build_templates(*map(jnp.asarray, crop[:3]), jnp.asarray(pt), cfg, pad,
                         tile_origin=(oy, ox))
    ref = optimize_level(jnp.asarray(crop[3]), jt, jnp.asarray(pt), jnp.asarray(p0), cfg,
                         lw, lh, pad, tile=tile)
    np.testing.assert_allclose(ours.p.numpy(), np.asarray(ref.p), atol=2e-3)
    np.testing.assert_allclose(ours.pt.numpy(), np.asarray(ref.pt), atol=2e-3)
    assert (ours.converged.numpy() == np.asarray(ref.converged)).mean() >= 0.99


# ---------------------------------------------------------------------------
# The world's results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [f"{p} {m}" for p in ("halo_x", "halo_y", "halo2d")
                                 for m in worker.MODES] + ["halo_x api", "halo_reduce"])
def test_halo_primitives_match_jax(world, key):
    ranks, refs, _ = world
    for r in range(worker.WORLD):
        np.testing.assert_array_equal(ranks[r][key], refs["halos"][key][r], err_msg=f"rank {r}")


def _same_on_every_rank(ranks, key):
    for r in range(1, worker.WORLD):
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"{key} rank {r}")
    return ranks[0][key]


@pytest.mark.parametrize("path", ["strips", "tiles"])
@pytest.mark.parametrize("kind", ["flow", "stereo", "fb"])
def test_spatial_flow_matches_single_device(world, path, kind):
    """spatial_flow (tx = 4) and spatial_flow_tiled (2x2) against the JAX
    package's and the port's single-device pipelines."""
    ranks, refs, _ = world
    got = _same_on_every_rank(ranks, f"{path} {kind}")
    np.testing.assert_allclose(got, refs[kind]["jax"], **TOL)
    np.testing.assert_allclose(got, refs[kind]["port"], **TOL)
    if path == "tiles":  # motion far below max_disp: no warm start clamped
        assert not ranks[0][f"tiles {kind} clamps"].any()
    inner = got[16:-16, 16:-16]
    if kind == "stereo":
        assert abs(np.median(inner[..., 0]) + 3.0) < 0.15
    else:
        assert abs(np.median(inner[..., 0]) + 3.0) < 0.15
        assert abs(np.median(inner[..., 1]) - 2.0) < 0.15


def test_tiled_clamp_counts(world):
    """The max_disp contract's guard: no clamp at 8 px, clamps counted at 1."""
    ranks, _, _ = world
    assert not ranks[0]["tiles flow clamps"].any()
    assert _same_on_every_rank(ranks, "tiles flow clamps max_disp 1").sum() > 0
    assert not ranks[0]["flow_2d_tiled clamps"].any()


@pytest.mark.parametrize("path", ["strips", "tiles"])
def test_ranks_without_patches(world, path):
    """A level where one strip (9 patches over 4 ranks: 3, 3, 3, 0) or one
    tile (centres 16 px apart, 12-px tiles) owns no patch: that rank skips
    the search and still takes part in every collective.  Held to the
    port's dis_raw: the patches do not overlap here, so every pixel sums
    one patch and the sharded result is the single-device one.  (At this
    spacing the port's and the JAX package's single-device results differ
    by 4e-3 at one pixel of 4,608 after refinement, so the JAX package is
    the other cases' reference.)"""
    ranks, refs, _ = world
    got = _same_on_every_rank(ranks, f"{path} sparse")
    np.testing.assert_allclose(got, refs["sparse"]["port"], **TOL)
    if path == "tiles":
        assert list(ranks[0]["tiles sparse levels"]) == ["lv0"]


@pytest.mark.parametrize("key", ["flow_2d", "flow_2d_tiled"])
def test_batch_over_data_matches_single_device(world, key):
    """flow_2d over (data, tx) = (2, 2) and flow_2d_tiled over (data, ty,
    tx) = (1, 2, 2), two distinct pairs."""
    ranks, refs, _ = world
    got = _same_on_every_rank(ranks, key)
    np.testing.assert_allclose(got, refs["batch2"]["jax"], **TOL)
    np.testing.assert_allclose(got, refs["batch2"]["port"], **TOL)


def test_batched_flow_mesh_bit_equal(world):
    ranks, _, _ = world
    got = _same_on_every_rank(ranks, "batched mesh")
    np.testing.assert_array_equal(got, ranks[0]["batched"])


def test_process_video_batched_mesh_same_files(world):
    ranks, _, out = world
    yields = _same_on_every_rank(ranks, "video mesh yields")
    assert list(yields) == list(range(8))
    names = sorted(p.name for p in (out / "video").iterdir())
    assert names == sorted(p.name for p in (out / "video_mesh").iterdir())
    assert len(names) == 9  # 8 .flo and progress.json
    for n in names:
        assert (out / "video_mesh" / n).read_bytes() == (out / "video" / n).read_bytes(), n


def test_process_video_batched_mesh_resume(world):
    """Killed after its first chunk and resumed on out_dirs that are not
    shared: data rank 0 alone holds the files, decides where to resume and
    with which warm start, and the resumed run writes the uninterrupted
    run's files."""
    ranks, _, out = world
    assert list(_same_on_every_rank(ranks, "video killed yields")) == list(range(4))
    assert list(_same_on_every_rank(ranks, "video resumed yields")) == list(range(8))
    names = sorted(p.name for p in (out / "video").iterdir())
    assert names == sorted(p.name for p in (out / "video_resume0").iterdir())
    for n in names:
        assert (out / "video_resume0" / n).read_bytes() == (out / "video" / n).read_bytes(), n
    for r in range(1, worker.WORLD):
        assert not (out / f"video_resume{r}").exists()


def test_mesh_groups_hold_the_timeout(world):
    """Every group of the meshes that mesh_2d, mesh_3d and data_mesh build
    times out after init_distributed's timeout_s (120 s in the worker), not
    the backend's default."""
    ranks, _, _ = world
    for r in range(worker.WORLD):
        assert (ranks[r]["group timeouts s"] == 120.0).all(), ranks[r]["group timeouts s"]


# ---------------------------------------------------------------------------
# The JAX package's own sharded pipelines (their compile takes minutes)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("kind", ["flow", "stereo", "fb"])
def test_spatial_matches_jax_spatial(world, kind):
    """The port's spatial_flow / spatial_flow_tiled against the JAX
    package's on the same meshes (tx = 4; (ty, tx) = (2, 2))."""
    ranks, _, _ = world
    cfg = _cfg(kind)
    a, b = worker.pair(kind)
    strips = np.asarray(jsp.spatial_flow(a, b, cfg, _jax_mesh((4,), ("tx",))))
    np.testing.assert_allclose(ranks[0][f"strips {kind}"], strips, **TOL)
    tiles = np.asarray(jsp.spatial_flow_tiled(a, b, cfg, _jax_mesh((2, 2), ("ty", "tx"))))
    np.testing.assert_allclose(ranks[0][f"tiles {kind}"], tiles, **TOL)


# ---------------------------------------------------------------------------
# The sharded passes as executables (ops/graphs.py::call_sharded, with the
# Recorder standing in for CUDA graphs on the CPU)
# ---------------------------------------------------------------------------

GRAPH_CASES = ["strips flow", "tiles flow max_disp 1", "tiles sparse", "flow_2d_tiled"]


def _graph_counts(ranks, name):
    return [json.loads(str(ranks[r][f"graph {name} counts"])) for r in range(worker.WORLD)]


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_sharded_executable_equals_eager(world, name):
    """spatial_flow, spatial_flow_tiled and flow_2d_tiled through their
    executables: the capture's call and a replay give the eager call's
    bits on every rank, and the eager call ran eager, the others through
    the cache."""
    ranks, _, _ = world
    for r in range(worker.WORLD):
        want, first, got = ranks[r][f"graph {name}"]
        np.testing.assert_array_equal(first, want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
    for c in _graph_counts(ranks, name):
        assert c["eager"]["modes"] == {"graph": 0, "eager": 1}
        assert c["first"]["modes"] == c["replay"]["modes"] == {"graph": 1, "eager": 0}


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_sharded_replay_counts_as_eager(world, name):
    """A replay adds the launches and exchanges its capture recorded: one
    replay counts what the eager call counts; the first call counts its
    warm-up (an eager run) and its replay."""
    ranks, _, _ = world
    for c in _graph_counts(ranks, name):
        eager, first, replay = c["eager"], c["first"], c["replay"]
        assert eager["exchanges"]["exchanges"] > 0
        assert replay["launches"] == eager["launches"]
        assert replay["exchanges"] == eager["exchanges"]
        assert first["exchanges"] == {k: 2 * n for k, n in eager["exchanges"].items()}
        assert first["launches"] == {k: 2 * n for k, n in eager["launches"].items()}
    tables = json.loads(str(ranks[0]["graph tables"]))
    # one collective capture per case, then the replays of both calls
    assert tables["captures"] == tables["entries"] == len(GRAPH_CASES)
    assert all(tables["collective"]) and tables["replays"] == 2 * len(GRAPH_CASES)


@pytest.mark.parametrize("name", ["tiles flow max_disp 1", "tiles sparse", "flow_2d_tiled"])
def test_sharded_clamp_counts_unchanged(world, name):
    """The clamp counts stay on the device through the pass and come out
    as the same ints (spatial_flow_tiled) or int64 per pair (flow_2d_tiled)
    as the eager call's, ranks without patches included."""
    ranks, _, _ = world
    counts = _graph_counts(ranks, name)
    for c in counts:
        want, first, got = c["clamps"]
        assert first == want and got == want
        assert c["clamps"][0] == counts[0]["clamps"][0]
    if name == "tiles flow max_disp 1":
        assert sum(counts[0]["clamps"][0].values()) > 0
        want = ranks[0]["tiles flow clamps max_disp 1"]
        assert [counts[0]["clamps"][0][k] for k in sorted(counts[0]["clamps"][0])] == list(want)
    if name == "tiles sparse":
        assert list(counts[0]["clamps"][0]) == ["lv0"]


def test_sharded_meshes_of_one_layout_key_apart(world):
    """A mesh made again over new groups compares equal to the first, yet
    its executables sit in a table of their own (the groups key it): the
    second mesh's pass is captured anew and gives the same bits."""
    ranks, _, _ = world
    for r in range(worker.WORLD):
        keys = json.loads(str(ranks[r]["graph other mesh keys"]))
        assert keys == dict(same_layout=True, tables=2, entries_m14=1, entries_m14b=1)
        np.testing.assert_array_equal(ranks[r]["graph other mesh"],
                                      ranks[r]["graph tiles sparse"][0])


def test_sharded_bound_same_keys_on_every_rank(world):
    """With SMALL_BOUND executables per mesh, the same call sequence leaves
    every rank holding the same keys after each call, least recently used
    out first."""
    ranks, _, _ = world
    got = [json.loads(str(ranks[r]["graph bound keys"])) for r in range(worker.WORLD)]
    for g in got[1:]:
        assert g == got[0]
    held = got[0]["held"]
    assert [len(h) for h in held] == [1, 2, 2, 2]
    # _tiled_pass(mesh, img1p, img2p, cfg, ay, ax, max_disp)
    md = [{float(k.rsplit(", ", 1)[-1].rstrip(")")) for k in h} for h in held]
    assert md == [{0.0}, {0.0, 1.0}, {1.0, 2.0}, {2.0, 0.0}]
    assert got[0]["captures"] == 4 and got[0]["released"] == 2


def test_sharded_tables_dropped_with_their_groups(world):
    """After destroy_process_group, every table of the world's meshes is
    dropped and its executables released."""
    ranks, _, _ = world
    for r in range(worker.WORLD):
        held, left, released = ranks[r]["graph tables after destroy"]
        assert held == len(GRAPH_CASES) + 1 and left == 0 and released == held
