"""Frame-pair batching, PyTorch port of
of_dis_tpu/parallel/batch.py (`_batched_padded`, `batched_flow`, :35-72).

The JAX package vmaps the single-pair driver, which gives every Pallas
kernel a leading batch dimension in its grid.  Here the driver itself runs
on a batch axis (models/dis.py): each stage is a batched PyTorch op, and
each CUDA kernel launch takes all B pairs, so one batch costs the launches
of one pair (3 level_search and 3 refine_inner at op2, whatever B is).

    flow = batched_flow(imgs1, imgs2, cfg)                # (B, H, W, nop), on the card
    flow = batched_flow(imgs1, imgs2, cfg, device="cpu")  # the plain versions

Each pair's output equals its own `dis_raw` bit for bit.  On the card a
call runs dis_raw's executable, models/dis.py::dis_entry_jit (ops/graphs.py;
the JAX package jits `_batched_padded`, of_dis_tpu/parallel/batch.py:34): a
CUDA graph per (cfg, B, shape, dtype of the frames), captured at its first
call and replayed after, with the frames' conversion and padding and the
final upscale and crop inside it.

With a mesh (`data_mesh`, a 1-D torch.distributed DeviceMesh over the
world's ranks) every rank calls batched_flow with the whole batch, runs its
contiguous share of it, and the shares are gathered over `data`, so every
rank returns the whole result, each pair bit-equal to the run without a
mesh (each rank's share runs `dis_entry_jit`; the gather stays outside):

    flow = batched_flow(imgs1, imgs2, cfg, mesh=data_mesh())
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import DISConfig
from ..models.dis import _prepare, dis_entry_jit
from .collectives import _all_gather, _axis_size, device_mesh


def data_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device_type: str = "cuda"):
    """A 1-D mesh named `axis` over the first n_devices ranks of the world
    (all of them by default); every rank calls it.  device_type "cpu" for
    CPU ranks."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return device_mesh(device_type, (n,), (axis,))


def _data_slice(b: int, mesh, axis: str) -> slice:
    """This rank's contiguous share of a batch of b pairs over `axis`; b
    must divide by the axis size."""
    n = _axis_size(mesh, axis)
    if b % n:
        raise ValueError(f"batch {b} not divisible by {axis} axis {n}")
    r, per = mesh.get_local_rank(axis), b // n
    return slice(r * per, (r + 1) * per)


def batched_flow(imgs1, imgs2, cfg: DISConfig, device=None, mesh=None,
                 axis: str = "data") -> torch.Tensor:
    """Flow (or disparity) for a batch of frame pairs (B, H, W[, C]) ->
    (B, H, W, nop), with dis_raw's divisibility padding, final upscale and
    crop.  Inputs are numpy arrays or tensors; the result is a float32
    tensor on `device` (CUDA unless given; without a GPU it raises).

    With a mesh, the batch axis is sharded over its dimension `axis` (pure
    data parallelism: each rank runs its share, then one gather); every
    rank calls with the whole batch and gets the whole result.  B must be
    divisible by the axis size."""
    img1, img2, _ = _prepare(imgs1, imgs2, cfg, device, 1, own_dtype=True)
    if mesh is not None:
        share = _data_slice(img1.shape[0], mesh, axis)
        img1, img2 = img1[share], img2[share]
    flow = dis_entry_jit(img1, img2, cfg)
    return flow if mesh is None else _all_gather(flow, mesh, axis, 0)
