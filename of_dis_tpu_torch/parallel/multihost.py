"""Process-group set-up and the 2-D (data, tx) / 3-D (data, ty, tx) meshes,
PyTorch port of of_dis_tpu/parallel/multihost.py.

The reference is single-process shared-memory (SURVEY.md §2.2).  The
scaling story (SURVEY.md §5), on torch.distributed:

  - `init_distributed()` joins the ranks into one process group (from
    torchrun's RANK / WORLD_SIZE / MASTER_ADDR environment, or from its
    arguments); one process per rank.
  - a mesh (data, tx): independent frame pairs shard over `data` with no
    communication but the final gather of their results; single-pair
    latency shards the image over `tx` with halo exchange and psum
    densification (parallel/spatial.py).
  - `flow_2d()` composes both: each data rank processes its share of the
    pairs, each pair cut into strips over tx; `flow_2d_tiled()` the same
    over (data, ty, tx) tiles.

Meshes are `torch.distributed.device_mesh.DeviceMesh`es with named
dimensions, `data` outermost.  With NCCL each rank drives its own card,
and each rank's whole pass of flow_2d / flow_2d_tiled (its share of the
pairs and their gather over `data`, upscale and crop included) is one CUDA
graph per static key, the collectives captured inside (the JAX package's
`_cached_fn` of `jax.jit(shard_map(...))` programs,
of_dis_tpu/parallel/multihost.py:82-92; collectives.sharded).  Several
ranks can share one card with a gloo group (the halo rows then travel
through pinned host memory, parallel/collectives.py, and the passes run
eager), or with NCCL when each rank's environment names a host of its own
(NCCL_HOSTID distinct per rank, NCCL_SOCKET_IFNAME=lo, NCCL_IB_DISABLE=1:
NCCL then takes each rank for a node of its own and moves the exchanges
over its socket transport); the package never sets these itself.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..config import DISConfig
from ..models.dis import _prepare
from ..ops import pyramid as pyr
from . import collectives
from .batch import _data_slice
from ..ops import graphs
from .collectives import _all_gather, device_mesh, sharded
from .spatial import _input_tiles, _mesh_device, _own_tensors, _pair_2d, _pair_manual


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = 600) -> None:
    """Join the ranks into one process group (dist.init_process_group).

    Arguments left None come from torchrun's environment (WORLD_SIZE,
    RANK; the rendezvous from MASTER_ADDR / MASTER_PORT unless init_method
    names one, e.g. "file:///path/store" or "tcp://host:port").  Call once
    per process.  No-op for a single process, or when the group exists.
    backend: "nccl" (one card per rank; the default when CUDA is
    available) or "gloo" (the CPU, or several ranks on one card).  With
    NCCL this rank's card becomes LOCAL_RANK (or rank modulo the cards).
    A collective that does not complete within timeout_s raises, so a
    mismatched collective fails instead of hanging: the world group and
    every mesh group that mesh_2d, mesh_3d and batch.data_mesh build get
    that timeout."""
    if dist.is_initialized():
        return
    n = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 and init_method is None:
        return  # single process, nothing to initialize
    r = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count())))
    collectives.group_timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=n, rank=r, timeout=collectives.group_timeout)


def destroy_distributed() -> None:
    """Release the sharded executables (their graphs hold the groups'
    communicators), then destroy the process group and every group of
    it.  No-op without one."""
    graphs.cache.drop_meshes()
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_2d(n_data: Optional[int] = None, n_tx: int = 1, device_type: str = "cuda"):
    """(data, tx) mesh over the world's ranks (collective: every rank calls
    it).  `data` is the outer dimension, so frame pairs shard across hosts
    and the tx halo exchange stays between neighbouring ranks of a host.
    device_type: "cuda", or "cpu" for a mesh of CPU ranks."""
    if n_data is None:
        n_data = dist.get_world_size() // n_tx
    return device_mesh(device_type, (n_data, n_tx), ("data", "tx"))


def mesh_3d(n_data: Optional[int] = None, n_ty: int = 1, n_tx: int = 1,
            device_type: str = "cuda"):
    """(data, ty, tx) mesh: the full SURVEY §5 composition (collective).

    `data` outermost (frame pairs across hosts, no communication but the
    final gather); (ty, tx) innermost so each pair's 2-D tile halo
    exchange / halo-reduce stays between neighbouring ranks.

    Which axes to use (see also flow_2d):
      - throughput-bound video  -> all ranks on `data` (n_ty = n_tx = 1);
      - latency-bound single pair, wide frames -> 1-D `tx` strips
        (exact, all content speeds; flow_2d / spatial_flow);
      - latency-bound, large-in-both-dims frames -> (ty, tx) tiles
        (tile-LOCAL memory + neighbour-only exchanges, but bounded
        displacement: the max_disp warm-start contract);
      - mixtures -> this 3-dimension mesh: batch over data, tile each pair."""
    if n_data is None:
        n_data = dist.get_world_size() // (n_ty * n_tx)
    return device_mesh(device_type, (n_data, n_ty, n_tx), ("data", "ty", "tx"))


def _data_share(imgs1, imgs2, cfg: DISConfig, mesh):
    """(p1, p2, (h0, w0), (top, left)): this data rank's contiguous share of
    a batch (B, H, W[, C]) on the mesh's device, padded to divisibility by
    2^sc_f; the input size and the padding's top and left, to crop it off
    again."""
    img1, img2, _ = _prepare(imgs1, imgs2, cfg, _mesh_device(mesh), 1)
    b, h0, w0 = img1.shape[:3]
    scf = 1 << cfg.sc_f
    t, _, l, _ = pyr.divisibility_padding(h0, w0, scf)
    share = _data_slice(b, mesh, "data")
    return (pyr.pad_to_divisible(img1[share], scf), pyr.pad_to_divisible(img2[share], scf),
            (h0, w0), (t, l))


def _finish(flows, cfg: DISConfig, padded_hw, hw, tl, mesh):
    """Each pair's flow at scale sc_l (per, h_l, w_l, nop) upscaled to the
    padded size, cropped (run_dense.cpp:406-414), and gathered over data."""
    if cfg.sc_l != 0:
        flows = pyr.resize_bilinear(flows * float(1 << cfg.sc_l), *padded_hw)
    (h0, w0), (t, l) = hw, tl
    return _all_gather(flows[:, t : t + h0, l : l + w0].contiguous(), mesh, "data", 0)


def flow_2d_tiled(imgs1, imgs2, cfg: DISConfig, mesh, max_disp: float = 8.0,
                  return_diagnostics: bool = False):
    """Batch of frame pairs on a (data, ty, tx) mesh, every rank calling
    with the whole batch (B, H, W[, C]): the batch shards over `data` and
    each pair runs the 2-D tile-local pipeline over (ty, tx) (halo exchange
    + border halo-reduce densify — see spatial.spatial_flow_tiled for the
    max_disp warm-start contract).

    Returns full-resolution flow (B, H, W, nop) on every rank.  With
    return_diagnostics=True, returns (flow, clamp_counts) where
    clamp_counts["lv<sl>"] is a (B,) per-pair count of warm starts clamped
    at that level — nonzero means that pair's content moves faster than
    max_disp and the result deviates from the single-device pipeline."""
    p1, p2, hw, tl = _data_share(imgs1, imgs2, cfg, mesh)
    flow, clamp_counts = _flow_2d_tiled_pass(mesh, p1, p2, cfg, hw, tl, float(max_disp),
                                             return_diagnostics)
    if not return_diagnostics:
        return flow
    return flow, clamp_counts


@sharded
def _flow_2d_tiled_pass(mesh, p1, p2, cfg: DISConfig, hw, tl, max_disp: float,
                        diagnostics: bool):
    """flow_2d_tiled's pass on one rank, as an executable (the JAX key
    ("2d_tiled", cfg, mesh, max_disp, ...)): this data rank's padded pairs
    (per, Hp, Wp, C) -> (the whole batch's flow, the per-pair clamp counts
    gathered over data when diagnostics, else {})."""
    hp, wp = p1.shape[1:3]
    own = _own_tensors(hp, wp, cfg, mesh, "ty", "tx", max_disp, p1.device)
    flows, counts = [], []
    for i in range(p1.shape[0]):
        t1, t2 = _input_tiles(p1[i], p2[i], own, mesh, "ty", "tx")
        f, cc = _pair_2d(t1, t2, hp, wp, own, cfg, mesh, "ty", "tx", max_disp)
        flows.append(f)
        counts.append(cc)
    flow = _finish(torch.stack(flows), cfg, (hp, wp), hw, tl, mesh)
    if not diagnostics:
        return flow, {}
    return flow, {k: _all_gather(torch.cat([c[k] for c in counts]), mesh, "data", 0)
                  for k in own}


def flow_2d(imgs1, imgs2, cfg: DISConfig, mesh) -> torch.Tensor:
    """Batch of frame pairs on a (data, tx) mesh, every rank calling with
    the whole batch (B, H, W[, C]): the batch shards over `data` and each
    pair is spatially cut into strips over `tx` (halo exchange + psum
    densify).

    Returns full-resolution flow (B, H, W, nop) on every rank: like
    dis_flow / batched_flow, the final 2^sc_l upscale and divisibility-
    padding crop are applied (run_dense.cpp:406-414)."""
    p1, p2, hw, tl = _data_share(imgs1, imgs2, cfg, mesh)
    return _flow_2d_pass(mesh, p1, p2, cfg, hw, tl)


@sharded
def _flow_2d_pass(mesh, p1, p2, cfg: DISConfig, hw, tl):
    """flow_2d's pass on one rank, as an executable (the JAX key ("2d",
    cfg, mesh)): this data rank's padded pairs (per, Hp, Wp, C) -> the
    whole batch's flow, upscaled, cropped and gathered over data."""
    flows = torch.stack([_pair_manual(p1[i], p2[i], cfg, mesh, "tx")
                         for i in range(p1.shape[0])])
    return _finish(flows, cfg, p1.shape[1:3], hw, tl, mesh)
