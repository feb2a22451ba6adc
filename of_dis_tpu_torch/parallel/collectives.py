"""Collectives over one dimension of a torch.distributed DeviceMesh, shared
by the data-parallel drivers (batch.py, video.py) and spatial sharding
(spatial.py, multihost.py).

A named mesh dimension plays a JAX mesh axis: a rank's index along it is
`mesh.get_local_rank(dim)`, its peers the global ranks of that dimension's
group.  `lax.ppermute` becomes `dist.batch_isend_irecv` (`_exchange`),
`psum` `dist.all_reduce` (`_psum`), a tiled `all_gather` `dist.all_gather`
and a concat (`_all_gather`).  A dimension named None has size 1: a rank is
alone on it and nothing is exchanged.

Staging: with a gloo process group and CUDA tensors (several ranks sharing
one card, where NCCL refuses two ranks on one device) each send, receive,
all_reduce and all_gather is copied through pinned host memory, because
gloo moves host tensors; with NCCL, or on the CPU, nothing is staged.
`exchanges` counts, per process, the collective calls and the bytes staged
through the host.

Execution by backend (`sharded`, the counterpart of the JAX package's
`jax.jit(shard_map(...))`): under NCCL a sharded pass on CUDA tensors runs
as one CUDA graph per rank and static key (ops/graphs.py::call_sharded),
its NCCL collectives captured inside; `work.wait()` then only orders the
current stream behind the collective, and nothing waits on the host.  With
gloo on CUDA tensors (host staging: a graph cannot capture it), on the CPU
and under graphs.eager() the pass runs eager, op by op.  `modes` counts
the passes each way.  An NCCL world whose capture fails raises, naming the
key; nothing falls back to eager.

Timeouts: `device_mesh` gives each dimension's group the timeout that
multihost.init_distributed was given (`group_timeout`), so that a
mismatched collective raises instead of hanging; the groups that
init_device_mesh makes keep the backend's default of tens of minutes
otherwise.
"""

from __future__ import annotations

import functools
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..ops import graphs

# Per process: collective calls (a halo exchange, an all_reduce, an
# all_gather or a broadcast is one each) and bytes copied through pinned
# host memory.
exchanges: Dict[str, int] = {"exchanges": 0, "staged_bytes": 0}

# Per process: sharded passes by how they ran ("graph": through their
# executable; "eager": op by op).
modes: Dict[str, int] = {"graph": 0, "eager": 0}

# The process group's timeout, set by multihost.init_distributed.
group_timeout: Optional[timedelta] = None


def reset_exchanges() -> None:
    """Zero the exchange counters and the counts of modes."""
    for counter in (exchanges, modes):
        for k in counter:
            counter[k] = 0


def device_mesh(device_type: str, shape: Sequence[int], names: Sequence[str]):
    """init_device_mesh over the world's ranks (collective: every rank calls
    it), each dimension's group given `group_timeout` when one is set."""
    mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    if group_timeout is not None:
        for name in names:
            dist.distributed_c10d._set_pg_timeout(group_timeout, mesh.get_group(name))
    return mesh


def _axis_size(mesh, dim: Optional[str]) -> int:
    """The size of mesh dimension `dim` (1 for None)."""
    if dim is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(dim))


def _axis_info(mesh, dim: Optional[str]) -> Tuple[int, int]:
    """This rank's index along mesh dimension `dim`, and its size."""
    if dim is None:
        return 0, 1
    return mesh.get_local_rank(dim), _axis_size(mesh, dim)


def _stages(t: torch.Tensor, group) -> bool:
    """Whether a collective of `group` on t goes through host memory: gloo
    moves host tensors only (for send, receive and all_gather)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of `group` sends for t: t itself
    (contiguous), or a pinned host copy of it when the group stages."""
    if not _stages(t, group):
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    exchanges["staged_bytes"] += t.numel() * t.element_size()
    return host


def _buffer(like: torch.Tensor, group) -> torch.Tensor:
    """A receive buffer of like's shape, on the host when the group stages."""
    if not _stages(like, group):
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _unwire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received (or reduced) tensor back on `device`."""
    if t.device == device:
        return t
    exchanges["staged_bytes"] += t.numel() * t.element_size()
    return t.to(device, non_blocking=True)


def _exchange(mesh, dim: Optional[str], to_prev: Optional[torch.Tensor],
              to_next: Optional[torch.Tensor]):
    """One neighbour exchange along `dim` (lax.ppermute's (i, i + 1) and
    (i + 1, i) permutations): each rank sends to_prev to its predecessor
    and to_next to its successor (None: that direction is not exchanged),
    and returns (from_prev, from_next), what they sent it (None at the
    dimension's ends).  All ranks of a dimension hold tiles of one shape."""
    idx, n = _axis_info(mesh, dim)
    if n == 1:
        return None, None
    like = to_prev if to_prev is not None else to_next
    group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)
    ops, recv = [], {}
    # tag 0: a message to the successor; tag 1: to the predecessor
    if to_next is not None:
        if idx < n - 1:
            ops.append(dist.P2POp(dist.isend, _wire(to_next, group), ranks[idx + 1], group, 0))
        if idx > 0:
            recv["prev"] = _buffer(to_next, group)
            ops.append(dist.P2POp(dist.irecv, recv["prev"], ranks[idx - 1], group, 0))
    if to_prev is not None:
        if idx > 0:
            ops.append(dist.P2POp(dist.isend, _wire(to_prev, group), ranks[idx - 1], group, 1))
        if idx < n - 1:
            recv["next"] = _buffer(to_prev, group)
            ops.append(dist.P2POp(dist.irecv, recv["next"], ranks[idx + 1], group, 1))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    exchanges["exchanges"] += 1
    got = {k: _unwire(v, like.device) for k, v in recv.items()}
    return got.get("prev"), got.get("next")


def _psum(t: torch.Tensor, mesh, dim: Optional[str]) -> torch.Tensor:
    """lax.psum over `dim`: the sum of every rank's t, on every rank."""
    if _axis_size(mesh, dim) == 1:
        return t
    group = mesh.get_group(dim)
    w = _wire(t, group)
    dist.all_reduce(w, group=group)
    exchanges["exchanges"] += 1
    return _unwire(w, t.device)


def _all_gather(t: torch.Tensor, mesh, dim: Optional[str], axis: int) -> torch.Tensor:
    """lax.all_gather(tiled=True) over `dim`: every rank's t concatenated
    along `axis` in rank order, on every rank."""
    n = _axis_size(mesh, dim)
    if n == 1:
        return t
    group = mesh.get_group(dim)
    w = _wire(t, group)
    parts = [_buffer(t, group) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    exchanges["exchanges"] += 1
    return torch.cat([_unwire(p, t.device) for p in parts], dim=axis)


def _broadcast_object(obj, mesh, dim: str):
    """The (picklable) obj of the rank at index 0 of `dim`, on every rank
    of it.  Host pickling: never call it inside a sharded pass."""
    if _axis_size(mesh, dim) == 1:
        return obj
    group = mesh.get_group(dim)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_process_group_ranks(group)[0], group=group)
    exchanges["exchanges"] += 1
    return box[0]


# ---------------------------------------------------------------------------
# Sharded passes as executables
# ---------------------------------------------------------------------------

def capturable(mesh) -> bool:
    """Whether a sharded pass on `mesh` runs as a CUDA graph: on CUDA, with
    every dimension's group on NCCL (device-side collectives).  gloo stages
    through host memory, which a graph cannot capture."""
    return mesh.device_type == "cuda" and all(
        dist.get_backend(mesh.get_group(d)) == "nccl" for d in mesh.mesh_dim_names)


def mesh_identity(mesh) -> Tuple[tuple, tuple]:
    """(key, groups): what names a mesh's table of sharded executables, its
    layout and the identity of each dimension's process group, and those
    groups.  Two meshes of one layout over different groups (a mesh made
    again, or one of a new world) key apart."""
    groups = tuple(mesh.get_group(d) for d in mesh.mesh_dim_names)
    key = (mesh.device_type, tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
           tuple((d, g.group_name, id(g)) for d, g in zip(mesh.mesh_dim_names, groups)))
    return key, groups


def _gone(groups: tuple) -> bool:
    """Whether any of the groups was destroyed."""
    live = dist.distributed_c10d._world.pg_map if dist.is_initialized() else {}
    return any(g not in live for g in groups)


def sharded(fn: Callable) -> Callable:
    """fn(mesh, *args, **kwargs), a whole sharded pass that every rank of
    the mesh runs with the same static arguments and tensor shapes, as a
    compiled executable: one CUDA graph per rank and static key under NCCL
    (`capturable`), op by op otherwise (module docstring).  The wrapper's
    `fn` is the function it runs."""

    @functools.wraps(fn)
    def call(mesh, *args, **kwargs):
        if graphs.is_eager() or not capturable(mesh):
            modes["eager"] += 1
            return fn(mesh, *args, **kwargs)
        modes["graph"] += 1
        key, groups = mesh_identity(mesh)
        graphs.cache.drop_meshes(_gone)  # tables of destroyed groups
        return graphs.cache.call_sharded(fn, (mesh, *args), kwargs, key, groups, exchanges)

    call.fn = fn
    return call
