"""One rank of the 4-rank gloo world that tests/test_torch_spatial.py starts
on the CPU: every case of the port's spatial sharding (of_dis_tpu_torch/
parallel/spatial.py, multihost.py, and mesh= of batch.py and video.py),
run in one order by every rank, then spatial_flow, spatial_flow_tiled and
flow_2d_tiled through their sharded executables (ops/graphs.py::
call_sharded, the Recorder of tests/graph_recorder.py standing in for CUDA
graphs; kernel launches count 0 on the CPU, the card's spatial nccl phase
counts them); each rank writes its results to <out>/rank<r>.npz (and the
video cases their files under <out>/).  Imports no JAX, so the ranks start
quickly; the parent compares the results with the JAX package.

The inputs are made here from seeds (numpy), and the parent makes the same
ones by importing this module."""

from __future__ import annotations

import json
from contextlib import contextmanager
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter

WORLD = 4
# tests/test_spatial.py's configuration
BASE = dict(channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4, patch_size=8, overlap=0.4,
            use_tv_refine=True, tv_solverit=2)
# a spacing wider than the patch (overlap -1: steps 16), where ranks own no
# patches: 9 patches over 4 strips (3, 3, 3, 0) and 3 columns of centres
# over 4 tiles of a (1, 4) mesh at max_disp 0
SPARSE = dict(channels=1, sc_f=0, sc_l=0, max_iter=4, min_iter=4, patch_size=8,
              overlap=-1.0, use_tv_refine=True, tv_solverit=2)
SPARSE_HW = (48, 48)
HALO_K = 2
MODES = ("edge", "zero", "reflect101")


def config(kind: str) -> dict:
    """The DISConfig fields of a case: "flow", "stereo", "fb" (flow with
    the forward-backward merge) or "sparse"."""
    if kind == "sparse":
        return dict(mode="flow", **SPARSE)
    return dict(mode="stereo" if kind == "stereo" else "flow", use_fb_merge=kind == "fb",
                **BASE)


def pair(kind: str):
    """The (img1, img2) pair of a case: tests/conftest.py::smooth_pair for
    flow (true flow (-3, +2)); for stereo the content moves left 3 px
    (tests/test_spatial.py)."""
    h, w = 96, 128
    if kind == "stereo":
        rng = np.random.RandomState(5)
        base = gaussian_filter(rng.rand(h + 16, w + 16).astype(np.float32), 2.5)
        base = (base - base.min()) / (base.max() - base.min()) * 255
        return base[8:8 + h, 8:8 + w].copy(), base[8:8 + h, 11:11 + w].copy()
    rng = np.random.RandomState(0)
    base = gaussian_filter(rng.rand(h + 16, w + 16).astype(np.float32) * 255, 3.0) * 255
    img1, img2 = base[8:8 + h, 8:8 + w].copy(), base[6:6 + h, 11:11 + w].copy()
    if kind == "sparse":
        sh, sw = SPARSE_HW
        return img1[:sh, :sw].copy(), img2[:sh, :sw].copy()
    return img1, img2


def batch(b: int):
    """b distinct flow pairs: the flow pair rolled by 4 px per pair."""
    img1, img2 = pair("flow")
    return (np.stack([np.roll(img1, 4 * i, axis=1) for i in range(b)]),
            np.stack([np.roll(img2, 4 * i, axis=1) for i in range(b)]))


def frames(n: int):
    """n video frames, each the flow image moved by (+2, +1) px more."""
    img, _ = pair("flow")
    return [np.roll(img, (i, 2 * i), axis=(0, 1))[:48, :64].copy() for i in range(n)]


def halo_inputs():
    """Per-rank inputs of the halo primitives: a strip of a (6, 16, 2) field
    over tx = 4, a tile of a (12, 16, 2) field over (ty, tx) = (2, 2), and
    a (th + 2k, tw + 2k, 3) splat accumulator tile per rank of (2, 2)."""
    rng = np.random.RandomState(11)
    strip = rng.randn(6, 16, 2).astype(np.float32)
    tile = rng.randn(12, 16, 2).astype(np.float32)
    acc = rng.randn(2, 2, 6 + 2 * HALO_K, 8 + 2 * HALO_K, 3).astype(np.float32)
    return strip, tile, acc


# the sharded passes run through a cache of the Recorder stand-in: a few
# executables per mesh in the bound case
SMALL_BOUND = 2
BOUND_MAX_DISP = (0.0, 1.0, 2.0, 0.0)


@contextmanager
def recorded_graphs(cache):
    """Every sharded pass through `cache` (on the CPU, with gloo: the
    capture and replays of ops/graphs.py's sharded executables, with the
    Recorder standing in for CUDA graphs)."""
    from of_dis_tpu_torch.ops import graphs
    from of_dis_tpu_torch.parallel import collectives

    saved = graphs.cache, collectives.capturable
    graphs.cache, collectives.capturable = cache, lambda mesh: True
    try:
        yield
    finally:
        graphs.cache, collectives.capturable = saved


def counted(fn):
    """fn()'s result and the kernel launches, exchanges and modes it counted."""
    from of_dis_tpu_torch.ops import kernels
    from of_dis_tpu_torch.parallel import collectives

    kernels.reset_launches()
    collectives.reset_exchanges()
    out = fn()
    return out, dict(launches=dict(kernels.launches), exchanges=dict(collectives.exchanges),
                     modes=dict(collectives.modes))


def run(rank: int, store: str, out: str) -> None:
    """Every case on this rank; results to <out>/rank<rank>.npz."""
    import torch
    import torch.distributed as dist

    from of_dis_tpu_torch import DISConfig, batched_flow
    from of_dis_tpu_torch.parallel import collectives, spatial
    from of_dis_tpu_torch.parallel.batch import data_mesh
    from of_dis_tpu_torch.parallel.multihost import (
        flow_2d,
        flow_2d_tiled,
        init_distributed,
        mesh_2d,
        mesh_3d,
    )
    from of_dis_tpu_torch.parallel.video import process_video_batched

    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{store}", WORLD, rank, timeout_s=120)
    out = Path(out)
    res = {}
    cpu = "cpu"

    # ---- halo primitives ----
    strip, tile, acc = halo_inputs()
    tx4 = mesh_2d(1, 4, device_type=cpu)
    sl = torch.as_tensor(strip)[:, 4 * rank : 4 * rank + 4]
    for m in MODES:
        res[f"halo_x {m}"] = spatial._halo_x_mode(sl, HALO_K, tx4, "tx", m).numpy()
    res["halo_x api"] = spatial.halo_x(sl, HALO_K, tx4, "tx", "edge").numpy()
    m22 = mesh_3d(1, 2, 2, device_type=cpu)
    iy, ix = m22.get_local_rank("ty"), m22.get_local_rank("tx")
    tl = torch.as_tensor(tile)[6 * iy : 6 * iy + 6, 8 * ix : 8 * ix + 8]
    for m in MODES:
        res[f"halo_y {m}"] = spatial.halo_y(tl, HALO_K, m22, "ty", m).numpy()
        res[f"halo2d {m}"] = spatial._halo2d(tl, HALO_K, m22, "ty", "tx", m).numpy()
    res["halo_reduce"] = spatial._halo_reduce_2d(torch.as_tensor(acc[iy, ix]), HALO_K, m22,
                                                 "ty", "tx").numpy()

    # ---- spatial_flow over tx = 4 and spatial_flow_tiled over (2, 2) ----
    for kind in ("flow", "stereo", "fb"):
        cfg = DISConfig(**config(kind)).validate()
        a, b = pair(kind)
        res[f"strips {kind}"] = spatial.spatial_flow(a, b, cfg, tx4).numpy()
        flow, counts = spatial.spatial_flow_tiled(a, b, cfg, m22, return_diagnostics=True)
        res[f"tiles {kind}"] = flow.numpy()
        res[f"tiles {kind} clamps"] = np.array([counts[k] for k in sorted(counts)])
    cfg = DISConfig(**config("flow")).validate()
    a, b = pair("flow")
    _, counts = spatial.spatial_flow_tiled(a, b, cfg, m22, max_disp=1.0,
                                           return_diagnostics=True)
    res["tiles flow clamps max_disp 1"] = np.array([counts[k] for k in sorted(counts)])

    # ---- ranks without patches ----
    cfg = DISConfig(**config("sparse")).validate()
    a, b = pair("sparse")
    res["strips sparse"] = spatial.spatial_flow(a, b, cfg, tx4).numpy()
    m14 = mesh_3d(1, 1, 4, device_type=cpu)
    flow, counts = spatial.spatial_flow_tiled(a, b, cfg, m14, max_disp=0.0,
                                              return_diagnostics=True)
    res["tiles sparse"] = flow.numpy()
    res["tiles sparse levels"] = np.array(sorted(counts))

    # ---- a batch over data, each pair sharded ----
    cfg = DISConfig(**config("flow")).validate()
    a2, b2 = batch(2)
    dx22 = mesh_2d(2, 2, device_type=cpu)
    res["flow_2d"] = flow_2d(a2, b2, cfg, dx22).numpy()
    flow, counts = flow_2d_tiled(a2, b2, cfg, m22, return_diagnostics=True)
    res["flow_2d_tiled"] = flow.numpy()
    res["flow_2d_tiled clamps"] = np.stack([counts[k].numpy() for k in sorted(counts)])

    # ---- mesh= of batched_flow and process_video_batched ----
    dm = data_mesh(WORLD, device_type=cpu)
    a4, b4 = batch(4)
    res["batched mesh"] = batched_flow(a4, b4, cfg, device=cpu, mesh=dm).numpy()
    res["batched"] = batched_flow(a4, b4, cfg, device=cpu).numpy()
    video = frames(9)
    kw = dict(batch_size=4, loader=lambda f: f, device=cpu)
    res["video mesh yields"] = np.array(
        [i for i, _ in process_video_batched(video, out / "video_mesh", cfg, mesh=dm, **kw)])
    if rank == 0:
        list(process_video_batched(video, out / "video", cfg, **kw))
    # killed after its first chunk, then resumed, each rank with an out_dir
    # of its own (not shared): only data rank 0's holds files to resume from
    own = out / f"video_resume{rank}"
    it = process_video_batched(video, own, cfg, mesh=dm, queue_depth=0, **kw)
    res["video killed yields"] = np.array([next(it)[0] for _ in range(4)])
    it.close()
    res["video resumed yields"] = np.array(
        [i for i, _ in process_video_batched(video, own, cfg, mesh=dm, queue_depth=0, **kw)])

    # every mesh group holds init_distributed's timeout
    res["group timeouts s"] = np.array([
        m.get_group(d)._get_backend(torch.device(cpu)).options._timeout.total_seconds()
        for m in (tx4, m22, m14, dx22, dm) for d in m.mesh_dim_names])
    res["exchanges"] = np.array([collectives.exchanges["exchanges"],
                                 collectives.exchanges["staged_bytes"]])

    # ---- the sharded passes as executables (the Recorder for CUDA graphs) ----
    from graph_recorder import Recorder

    from of_dis_tpu_torch.ops import graphs

    def tiles(a, b, cfg, mesh, md):
        flow, c = spatial.spatial_flow_tiled(a, b, cfg, mesh, max_disp=md,
                                             return_diagnostics=True)
        return flow.numpy(), {k: c[k] for k in sorted(c)}

    def tiled_2d(a, b, cfg):
        flow, c = flow_2d_tiled(a, b, cfg, m22, return_diagnostics=True)
        return flow.numpy(), {k: c[k].tolist() for k in sorted(c)}

    flow_cfg, sparse_cfg = (DISConfig(**config(k)).validate() for k in ("flow", "sparse"))
    cases = {
        "strips flow": lambda: (spatial.spatial_flow(*pair("flow"), flow_cfg, tx4).numpy(), {}),
        "tiles flow max_disp 1": lambda: tiles(*pair("flow"), flow_cfg, m22, 1.0),
        "tiles sparse": lambda: tiles(*pair("sparse"), sparse_cfg, m14, 0.0),
        "flow_2d_tiled": lambda: tiled_2d(*batch(2), flow_cfg),
    }
    cache = graphs.ExecutableCache(Recorder())
    for name, fn in cases.items():
        (want, want_cc), eager_counts = counted(fn)
        with recorded_graphs(cache):
            (first, first_cc), first_counts = counted(fn)
            (got, got_cc), replay_counts = counted(fn)
        res[f"graph {name}"] = np.stack([want, first, got])
        res[f"graph {name} counts"] = np.array(json.dumps(dict(
            eager=eager_counts, first=first_counts, replay=replay_counts,
            clamps=[want_cc, first_cc, got_cc])))
    res["graph tables"] = np.array(json.dumps(dict(
        entries=len(cache.sharded_entries()), captures=len(cache.backend.captures),
        collective=[h["collective"] for h in cache.backend.captures],
        replays=cache.backend.replays)))

    # two meshes of one layout over different groups key apart
    m14b = mesh_3d(1, 1, 4, device_type=cpu)
    a, b = pair("sparse")
    with recorded_graphs(cache):
        flow_b, _ = tiles(a, b, sparse_cfg, m14b, 0.0)
    res["graph other mesh"] = flow_b
    res["graph other mesh keys"] = np.array(json.dumps(dict(
        same_layout=bool(m14b == m14), tables=len({collectives.mesh_identity(m)[0]
                                                   for m in (m14, m14b)}),
        entries_m14=len(cache.sharded_entries(collectives.mesh_identity(m14)[0])),
        entries_m14b=len(cache.sharded_entries(collectives.mesh_identity(m14b)[0])))))

    # a small bound per mesh: every rank holds the same keys after each call
    small = graphs.ExecutableCache(Recorder(), max_per_mesh=SMALL_BOUND)
    held = []
    with recorded_graphs(small):
        for md in BOUND_MAX_DISP:
            tiles(a, b, sparse_cfg, m14, md)
            held.append([graphs.describe(ex.key) for ex in small.sharded_entries()])
    res["graph bound keys"] = np.array(json.dumps(dict(
        held=held, captures=len(small.backend.captures), released=len(small.backend.released))))

    # a table whose groups are destroyed is dropped at the next sharded call
    dist.barrier()
    held = len(cache.sharded_entries())
    dist.destroy_process_group()
    cache.drop_meshes(collectives._gone)
    res["graph tables after destroy"] = np.array([held, len(cache.sharded_entries()),
                                                  len(cache.backend.released)])
    np.savez(out / f"rank{rank}.npz", **res)
