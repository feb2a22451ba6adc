"""Video / sequence processing: temporal warm start + checkpoint/resume,
PyTorch port of of_dis_tpu/parallel/video.py.

A video run is a sequence of idempotent frame-pair work units; progress is
a small JSON sidecar (out_dir/progress.json, "last completed pair index"),
so a killed run resumes where it stopped.  The output files and the sidecar
are named as the JAX package names them (`_pair_path`), so a run started by
either package resumes in the other.  Each pair is warm-started from the
previous pair's flow, downsampled to the grid the coarsest scale starts
from (the reference's disabled init-flow input, oflow.cpp:217-220).

    for i, path in process_video(frames, "out", cfg): ...
    for i, path in process_video_batched(frames, "out", cfg, batch_size=32): ...

Both run on CUDA unless given device="cpu" (without a GPU they raise);
process_video_batched also shards each chunk over a data mesh (mesh=).
On the card process_video runs each pair through dis_raw's executable,
and process_video_batched each chunk through `_video_chunk` and its warm
start through `_warm_single`, executables as in the JAX package
(of_dis_tpu/parallel/video.py:46, 121; ops/graphs.py).  Frames go up and
results come back through pinned memory, queued in stream order
(ops/transfer.py): process_video waits for each pair's result, as the JAX
package's np.asarray(dis_raw(...)) does; process_video_batched waits only
when it flushes a chunk, for that chunk's result.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import io
from ..config import DISConfig
from ..models.dis import _dis_padded, _prepare, _upscale_crop, dis_raw, resolve_device
from ..ops import graphs
from ..ops.pyramid import pad_to_divisible, resize_bilinear
from ..ops.transfer import stack_to_device, to_device, to_host
from .batch import _data_slice
from .collectives import _all_gather, _broadcast_object


# Host seconds of process_video_batched by part, summed over its runs
# (reset_host_seconds() zeroes them): loading a chunk's frames and staging
# them into pinned memory ("load_stage"), queueing its device work and
# copies ("enqueue"), waiting at a flush for the oldest chunk's result
# ("wait"), and writing that chunk's files and progress.json ("write").
host_seconds: Dict[str, float] = dict.fromkeys(("load_stage", "enqueue", "wait", "write"), 0.0)


def reset_host_seconds() -> None:
    for k in host_seconds:
        host_seconds[k] = 0.0


def _warm_start_from(flow: torch.Tensor, cfg: DISConfig) -> torch.Tensor:
    """Downsample a full-res (H, W, nop) flow to the sc_f+1 grid that the
    coarsest-scale init expects (run_dense.cpp:372-375 semantics: scale the
    values and resample by 2^-(sc_f+1)).  Both drivers run it for the live
    chain and for resume's read-back alike, on the same device, so a resumed
    run's warm starts equal the uninterrupted run's bit for bit (float32
    .flo / .pfm round-trips are exact)."""
    padded = pad_to_divisible(flow, 1 << cfg.sc_f)
    fct = 2.0 ** (-(cfg.sc_f + 1))
    out_h = max(1, int(padded.shape[0] * fct))
    out_w = max(1, int(padded.shape[1] * fct))
    return resize_bilinear(padded * fct, out_h, out_w)


# One executable for the batched driver's live chain on the card and for
# resume's read-back alike, so a resumed run's warm starts equal the
# uninterrupted run's bit for bit.
_warm_single = graphs.executable(_warm_start_from)


@graphs.executable
def _video_chunk(p1, p2, init, cfg: DISConfig, h0: int, w0: int):
    """One chunk: (B, Hp, Wp, C) pairs pre-padded to divisibility by
    2^sc_f, one warm start `init` on the sc_f+1 grid shared by the chunk
    (None: a cold start) -> (B, h0, w0, nop), upscaled and cropped."""
    flow = _dis_padded(p1, p2, cfg, init_flow=init)
    return _upscale_crop(flow, cfg, p1.shape[1], p1.shape[2], h0, w0)


def _pair_path(out_dir: Path, cfg: DISConfig, i: int) -> Path:
    """Output file of pair i, shared by both drivers and with the JAX
    package (cross-package resume depends on the naming staying identical)."""
    if cfg.mode == "flow":
        return out_dir / f"flow_{i:06d}.flo"
    return out_dir / f"disp_{i:06d}.pfm"


def _read_pair(out_dir: Path, cfg: DISConfig, i: int) -> np.ndarray:
    """Pair i's output read back in the internal convention, (H, W, nop)
    (a stereo .pfm holds the disparity negated, so it is negated on read)."""
    if cfg.mode == "flow":
        return io.read_flo(_pair_path(out_dir, cfg, i))
    return np.asarray(io.read_pfm(_pair_path(out_dir, cfg, i), negate=True))[..., None]


def _write_pair(path: Path, cfg: DISConfig, flow: np.ndarray) -> None:
    if cfg.mode == "flow":
        io.write_flo(path, flow)
    else:
        io.write_pfm(path, flow[..., 0])


def _checkpoint(ckpt: Path, last: int) -> None:
    """Atomic progress.json: a kill mid-write must not corrupt it."""
    tmp = ckpt.with_suffix(".json.tmp")
    tmp.write_text(json.dumps({"last_completed": last}))
    os.replace(tmp, ckpt)


def _last_completed(ckpt: Path, resume: bool) -> int:
    if resume and ckpt.exists():
        return json.loads(ckpt.read_text()).get("last_completed", -1)
    return -1


def process_video(
    frames: Sequence,
    out_dir,
    cfg: DISConfig,
    loader: Optional[Callable] = None,
    warm_start: bool = True,
    resume: bool = True,
    device=None,
) -> Iterator[Tuple[int, Path]]:
    """Flow for consecutive frame pairs, one pair per call of dis_raw;
    yields (index, out_path).

    Progress is checkpointed to out_dir/progress.json after each completed
    pair; with resume=True a restarted run skips completed work and
    re-seeds its warm start from the last completed output file."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "progress.json"
    done = _last_completed(ckpt, resume)
    load = loader or (lambda p: io.load_image(p, cfg.channels))
    prev_flow: Optional[np.ndarray] = None

    for i in range(len(frames) - 1):
        out_path = _pair_path(out_dir, cfg, i)
        if i <= done and out_path.exists():
            if warm_start and i == done:
                # only the last completed pair's flow seeds the next one
                prev_flow = _read_pair(out_dir, cfg, i)
            yield i, out_path
            continue
        init = None
        if warm_start and prev_flow is not None:
            init = _warm_start_from(to_device(prev_flow, dev), cfg)
        flow = to_host(dis_raw(load(frames[i]), load(frames[i + 1]), cfg, init_flow=init,
                               device=dev)).numpy()
        _write_pair(out_path, cfg, flow)
        prev_flow = flow
        _checkpoint(ckpt, i)
        yield i, out_path


def process_video_batched(
    frames: Sequence,
    out_dir,
    cfg: DISConfig,
    batch_size: int = 32,
    loader: Optional[Callable] = None,
    warm_start: bool = True,
    resume: bool = True,
    queue_depth: int = 4,
    device=None,
    mesh=None,
) -> Iterator[Tuple[int, Path]]:
    """Batched, checkpointed video: `batch_size` consecutive pairs per
    batched call (every kernel launch takes the whole chunk), with up to
    `queue_depth` chunks queued on the card before the host waits for the
    oldest one's result and writes its files.  A chunk's frames are loaded
    one at a time straight into pinned memory and their upload queued; its
    result's copy to the host is queued right behind the chunk
    (ops/transfer.py).  So the host waits only when it flushes a chunk,
    once per chunk, for that chunk's copy alone, as the JAX package's
    np.asarray does; `host_seconds` adds up where the host's time went.

    The warm start chains across chunks: every pair of chunk j+1 starts from
    chunk j's last pair's flow, kept on the card.  This deviates from
    process_video's per-pair chain (a throughput trade, as in the JAX
    package; warm starts are a hint, not part of the output contract).

    Progress uses the same progress.json as process_video, written once per
    completed chunk.  Chunk boundaries are absolute (pairs j*B ..), and the
    last chunk is padded by repeating its last pair (whose copies are never
    written).  A killed run resumes from its last completed chunk with the
    same boundaries and a warm start re-read from the completed output file,
    so its outputs equal the uninterrupted run's bit for bit.

    With `mesh` (a 1-D "data" mesh, parallel.batch.data_mesh) every rank
    calls with the same frames: each chunk shards over the ranks (each runs
    its contiguous share of batch_size, which must divide by the mesh size)
    and is gathered, so every rank yields the same pairs and keeps the same
    warm-start chain.  Only data rank 0 writes the files and progress.json,
    and only it reads them to resume: its resume point and warm start are
    broadcast over `data`, so out_dir need not be shared between hosts (the
    yielded paths are data rank 0's).  The outputs equal those of the run
    without a mesh, bit for bit."""
    dev = resolve_device(device)
    share = slice(0, batch_size) if mesh is None else _data_slice(batch_size, mesh, "data")
    writes = mesh is None or mesh.get_local_rank("data") == 0
    out_dir = Path(out_dir)
    ckpt = out_dir / "progress.json"
    n_pairs = len(frames) - 1
    if n_pairs <= 0:
        return
    load = loader or (lambda p: io.load_image(p, cfg.channels))

    def pair_path(i):
        return _pair_path(out_dir, cfg, i)

    B = batch_size
    start_chunk = 0
    prev = None  # the warm start's source: the last resumed pair's flow
    if writes:
        out_dir.mkdir(parents=True, exist_ok=True)
        done = _last_completed(ckpt, resume)
        # Skip fully-completed chunks (chunk j covers pairs j*B .. min((j+1)*B, n)-1).
        while start_chunk * B < n_pairs and min((start_chunk + 1) * B, n_pairs) - 1 <= done:
            c0, c1 = start_chunk * B, min((start_chunk + 1) * B, n_pairs)
            if not all(pair_path(i).exists() for i in range(c0, c1)):
                break
            start_chunk += 1
        if warm_start and start_chunk > 0 and pair_path(start_chunk * B - 1).exists():
            prev = _read_pair(out_dir, cfg, start_chunk * B - 1)
    if mesh is not None:
        start_chunk, prev = _broadcast_object((start_chunk, prev), mesh, "data")
    for i in range(min(start_chunk * B, n_pairs)):
        yield i, pair_path(i)
    init = None if prev is None else _warm_single(to_device(prev, dev), cfg)

    pending = []  # [(chunk start, real pairs, the flows' copy to the host)]

    def flush_one():
        c0, n_real, copy = pending.pop(0)
        t0 = time.perf_counter()
        flows = copy.numpy()  # the host's one wait per chunk: for this chunk's copy only
        t1 = time.perf_counter()
        if writes:
            for k in range(n_real):
                _write_pair(pair_path(c0 + k), cfg, flows[k])
            _checkpoint(ckpt, c0 + n_real - 1)
        host_seconds["wait"] += t1 - t0
        host_seconds["write"] += time.perf_counter() - t1
        return [(c0 + k, pair_path(c0 + k)) for k in range(n_real)]

    for j in range(start_chunk, (n_pairs + B - 1) // B):
        c0, c1 = j * B, min((j + 1) * B, n_pairs)
        idxs = list(range(c0, c1)) + [c1 - 1] * (B - (c1 - c0))  # pad by repeat
        idxs = idxs[share]  # this rank's pairs of the chunk (all without a mesh)
        t0 = time.perf_counter()
        a = stack_to_device((load(frames[i]) for i in idxs), len(idxs), dev)
        b = stack_to_device((load(frames[i + 1]) for i in idxs), len(idxs), dev)
        t1 = time.perf_counter()
        a, b, _ = _prepare(a, b, cfg, dev, 1)
        # the chunk, its warm start shared by all its pairs (None: cold start)
        scf = 1 << cfg.sc_f
        flows = _video_chunk(pad_to_divisible(a, scf), pad_to_divisible(b, scf),
                             init if warm_start else None, cfg, a.shape[1], a.shape[2])
        if mesh is not None:
            flows = _all_gather(flows, mesh, "data", 0)
        if warm_start:
            init = _warm_single(flows[c1 - c0 - 1], cfg)  # chained on the card
        pending.append((c0, c1 - c0, to_host(flows)))
        host_seconds["load_stage"] += t1 - t0
        host_seconds["enqueue"] += time.perf_counter() - t1
        if len(pending) > queue_depth:
            yield from flush_one()
    while pending:
        yield from flush_one()
