"""Copies between the host and a card, the port's counterpart of
`jax.device_put` (and of `jnp.asarray` on a host array) and of
`np.asarray` on a JAX array: an upload is queued and returns at once, and
the host waits for a result only when it reads that result.

    t = to_device(np_array, device)      # queued; returns at once
    t = stack_to_device(frames, n, dev)  # stacked straight into pinned memory
    h = to_host(t)                       # the copy back, queued
    arr = h.numpy()                      # waits for that copy only

A pageable copy (`torch.as_tensor(x, device=...)`, `.cpu()`) ends by
synchronizing the stream it runs on: an upload waits for all the work
queued ahead of it, a download for the work queued after its result too.
Here, on a CUDA device:

  - An upload copies the data into page-locked memory from PyTorch's
    caching host allocator (`torch.empty(..., pin_memory=True)`; where the
    caller builds the array, `stack_to_device` fills that buffer frame by
    frame, so each frame is copied once on the host), then queues one
    `copy_(..., non_blocking=True)` on the current stream, in order before
    the tensor's first use.
  - `to_device` stages an array in its own dtype (float32 for one torch
    cannot hold), copied by numpy on the calling thread, and converts it
    to float32 on the card after the upload: a quarter of the bytes for a
    uint8 frame, and no copy on the host's intra-op threads, which stalled
    from a few in a hundred to half of a window's pairs by 5-30 ms when
    they woke after a wait on the card (PERF.md).  A CPU tensor is staged
    in its own dtype as well.
  - A download queues a `non_blocking` copy into a pinned host tensor on
    the current stream, behind the work that produces the result, and
    records an event after it; `HostCopy.numpy()` waits on that event only.
  - The caching host allocator records an event for each copy queued on a
    pinned block and does not hand the block out again before that event,
    so a buffer that the host refills is never overwritten under a copy
    still pending.

The copies share the compute stream: copy streams of their own would let
them overlap the kernels, but on the traffic the entry points serve the
host's loading, staging and writing set the rate, and the extra streams'
event waits gained nothing end to end (PERF.md).

On the CPU nothing is copied: to_device returns the float32 tensor,
to_host's handle holds the tensor itself.  `counts` counts the uploads to
and downloads from a card and the host's waits on a download, as
ops/kernels.py's `launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

counts: Dict[str, int] = {"uploads": 0, "downloads": 0, "host_waits": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A pinned host tensor's copy on the card, queued on the current stream."""
    t = torch.empty(host.shape, dtype=host.dtype, device=device)
    t.copy_(host, non_blocking=True)
    counts["uploads"] += 1
    return t


# dtypes torch.from_numpy takes and converts to float32 as numpy does
_TORCH_DTYPES = {np.dtype(t) for t in (np.float32, np.float64, np.float16, np.uint8, np.int8,
                                       np.int16, np.int32, np.int64, np.bool_)}


def _cpu_tensor(a: np.ndarray) -> torch.Tensor:
    """a as a CPU tensor sharing its memory where it can, for torch's copy_
    into a pinned buffer: that copy runs on the intra-op threads, several
    times as fast as numpy's one-thread copy for a chunk's stack, which
    would otherwise cost more host time than the pageable copy it
    replaces.  Other dtypes, and read-only or byte-swapped arrays, are
    converted by numpy first; a view with a negative stride (an image's
    channels reversed, `img[..., ::-1]`) is made contiguous."""
    if a.dtype not in _TORCH_DTYPES or not a.flags.writeable:
        a = np.array(a, dtype=np.float32)
    elif any(s < 0 for s in a.strides):
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


def to_device(x, device, own_dtype: bool = False) -> torch.Tensor:
    """x (a numpy array, anything np.asarray takes, or a tensor) as a float32
    tensor on `device`.  Onto a card the copy is queued through pinned
    memory in x's own dtype and the call returns before it has run; the
    card converts it (the same values: every such conversion rounds to
    nearest on both).  With own_dtype the tensor keeps x's dtype (float32
    for one torch cannot hold): the entry points' frames, which their
    executable converts (models/dis.py::_prepare)."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        if device.type != "cuda" or x.device.type != "cpu":
            return x.to(device) if own_dtype else x.to(device=device, dtype=torch.float32)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
    else:
        x = np.asarray(x)
        if x.dtype not in _TORCH_DTYPES:
            x = np.asarray(x, dtype=np.float32)
        if device.type != "cuda":
            x = np.array(x, dtype=None if own_dtype else np.float32)
            return torch.from_numpy(x).to(device)
        host = torch.empty(x.shape, dtype=torch.from_numpy(np.empty(0, x.dtype)).dtype,
                           pin_memory=True)
        host.numpy()[...] = x
    t = _upload(host, device)
    return t if own_dtype else t.to(torch.float32)


def stack_to_device(arrays: Iterable, n: int, device) -> torch.Tensor:
    """The stack of the n arrays that `arrays` yields, as a float32 tensor
    on `device`.  Each array goes into the stack's buffer (pinned, for a
    card) as it comes, so a caller that loads them lazily (a generator)
    holds one at a time and each is copied once on the host; then the
    upload is queued as by to_device.  (Loading a chunk's frames into a
    list first costs more than the copies: each frame lands in memory the
    process has not touched yet.)"""
    device = torch.device(device)
    host, k = None, -1
    for k, a in enumerate(arrays):
        a = np.asarray(a)
        if host is None:
            host = torch.empty((n, *a.shape), dtype=torch.float32,
                               pin_memory=device.type == "cuda")
        if k >= n or a.shape != host.shape[1:]:
            raise ValueError(f"array {k} of {n}: shape {a.shape}, "
                             f"expected {tuple(host.shape[1:])}")
        host[k].copy_(_cpu_tensor(a))
    if k + 1 != n:
        raise ValueError(f"expected {n} arrays, got {k + 1}")
    return _upload(host, device) if device.type == "cuda" else host.to(device)


class HostCopy:
    """A tensor's copy on its way to the host (to_host); numpy() waits for
    this copy only, at its first call."""

    def __init__(self, host: torch.Tensor, done: Optional["torch.cuda.Event"] = None):
        self._host = host
        self._done = done

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
            self._done = None
            counts["host_waits"] += 1
        return self._host.numpy()


def to_host(t: torch.Tensor) -> HostCopy:
    """The copy of t to the host: queued behind the work that produces t
    (on the current stream) and returned at once from a card; the tensor
    itself on the CPU."""
    if t.device.type != "cuda":
        return HostCopy(t)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    counts["downloads"] += 1
    return HostCopy(host, torch.cuda.current_stream(t.device).record_event())
