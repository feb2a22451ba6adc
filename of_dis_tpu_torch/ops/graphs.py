"""Compiled executables: a CUDA graph captured once per static key and
replayed, the port's counterpart of `jax.jit` and its cache.

    @graphs.executable
    def dis_padded_jit(img1, img2, cfg, gradmag_input=False): ...

    flow = dis_padded_jit(p1, p2, cfg)   # on the card: the first call for
                                         # a key captures, later ones replay
    with graphs.eager():                 # jax.disable_jit(): run as written
        flow = dis_padded_jit(p1, p2, cfg)

The JAX package runs each entry point as one executable per static key
(of_dis_tpu/models/dis.py:179-186 `dis_padded_jit`, `dis_padded_init_jit`;
parallel/batch.py:34 `_batched_padded`; parallel/video.py:46, 121
`_warm_single`, `_video_chunk`; utils/instrument.py:40-54 `_cached_jit`).
Here each is a function wrapped by `executable`:

  - The static key is the function, every argument that is not a tensor
    (a DISConfig is frozen and hashable; gradmag_input, h0, w0, levels,
    None where a tensor is absent), where the tensors sit in the arguments,
    and each tensor's shape, dtype and device.  So whether init_flow is
    given, and whether it is (h, w, nop) shared by a batch or (B, h, w,
    nop), keys apart, as in JAX.
  - The first call for a key copies its tensors into static input tensors,
    runs the function once on a side stream (the warm-up builds the kernels
    with nvcc, fills the lru_caches that copy host data to the card and
    runs the launchers' one-time attribute and occupancy queries, none of
    which a capture may do), captures it with `torch.cuda.graph`, then
    replays the graph for its result: every result a caller sees comes out
    of a graph.  Later calls copy their tensors into the static inputs and
    replay.  Each call returns a copy of the graph's outputs, which no later
    replay overwrites (JAX returns fresh buffers too; the video driver keeps
    several chunks pending on the card).
  - Tensors a graph reads from outside its pool stay alive as long as the
    executable: a function that reads a cached tensor passes it to
    `hold()` (models/dis.py::_grid_tensors does, for pt_ref and coarse_idx,
    which its lru_cache may otherwise drop and free).
  - The kernel wrappers' launch counters (ops/kernels.py `launches`) stay
    true: the warm-up's launches run and are counted, a capture launches
    nothing and is not counted, and each replay adds the launches the
    capture recorded.  So a replay counts what an eager run of the same call
    counts.  The search-route counter (ops/kernels.py `routes`, the levels
    each route searched) is kept the same way, and the executable keeps
    what its capture counted (`Executable.routes`).
  - A capture that CUDA refuses raises, naming the key and the error; there
    is no eager retry.  No operation on the executables' paths syncs with
    the host or copies from host memory once the warm-up has run (the
    launchers' branches depend on shapes only).
  - The cache is bounded: MAX_EXECUTABLES per device, least recently used
    out first, and evicting an executable releases its graph and its pool.
    JAX's cache is unbounded because an XLA executable holds only code; a
    graph's pool holds every intermediate of its batch (hundreds of MiB at
    B = 32), so an unbounded cache would hold the card's memory for every
    shape ever seen.
  - Tensors on the CPU run the function as written (the plain versions of
    the kernels): there are no graphs there.  `eager()` runs every
    executable as written on the card too, for holding one mode against the
    other.

Sharded executables (`call_sharded`; parallel/collectives.py::sharded
wraps the passes of parallel/spatial.py and multihost.py, the counterpart
of the JAX package's `jax.jit(shard_map(...))` cache,
of_dis_tpu/parallel/multihost.py:82-92) capture a whole rank's pass with
its NCCL collectives inside:

  - They live in a table per mesh, keyed by the identity of the mesh's
    process groups (not by the mesh's layout, which a mesh re-made over
    new groups shares), at most MAX_SHARDED per table, evicted only by
    sharded calls on that mesh.  Warm-up and capture issue collectives, so
    every rank of the mesh must capture the same key at the same call:
    every rank makes the same sharded calls in the same order, and so
    captures, replays and evicts the same keys.  `drop_meshes` releases
    a table's executables (multihost.destroy_distributed does before the
    groups go; a table whose groups are gone is dropped at the next
    sharded call).
  - The warm-up creates the communicators (NCCL makes some at the first
    collective of a group or a pair of ranks), so the capture makes none.
  - The collectives a replay issues are counted as its kernel launches
    are: recorded at the capture (parallel/collectives.py `exchanges`)
    and added at every replay.
  - The capture runs in CUDA's thread-local capture mode (so does any
    capture in a process with a process group): the group's watchdog
    thread queries events of earlier collectives while a capture runs.

Calls take turns under a lock, and each enqueues its input copies, its
replay and its output copy on the caller's current stream.
"""

from __future__ import annotations

import contextvars
import functools
import threading
import time
import warnings
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import kernels

# Executables kept per device (an -v 2 run of op4 keeps 21 stage executables).
MAX_EXECUTABLES = 32
# Sharded executables kept per mesh (each pool holds a whole pass of a rank).
MAX_SHARDED = 8

_eager = contextvars.ContextVar("of_dis_tpu_torch_eager", default=False)
_held = contextvars.ContextVar("of_dis_tpu_torch_held", default=None)


@contextmanager
def eager():
    """Run every executable as written, op by op (jax.disable_jit())."""
    token = _eager.set(True)
    try:
        yield
    finally:
        _eager.reset(token)


def is_eager() -> bool:
    """Whether the caller runs under eager()."""
    return _eager.get()


def hold(*tensors: torch.Tensor) -> None:
    """Keep tensors that the graph being captured reads from outside its
    pool alive as long as its executable; a no-op outside a capture."""
    held = _held.get()
    if held is not None:
        held.extend(tensors)


# ---------------------------------------------------------------------------
# Arguments and results as a structure plus a list of tensors
# ---------------------------------------------------------------------------

class _Node(NamedTuple):
    kind: type          # tuple, list, a NamedTuple class or dict
    kids: tuple


class _Slot:
    """Where a tensor sits in a structure."""

    def __repr__(self) -> str:
        return "<tensor>"


_SLOT = _Slot()


def _flatten(tree, leaves: List[torch.Tensor]):
    """tree's structure, with each tensor appended to leaves and replaced by
    _SLOT; anything else is a static value and stays in the structure."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _SLOT
    if isinstance(tree, (tuple, list)):
        return _Node(type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return _Node(dict, tuple((k, _flatten(v, leaves)) for k, v in sorted(tree.items())))
    return tree


def _unflatten(spec, leaves):
    """The structure `spec` with its slots filled from the iterator leaves."""
    if spec is _SLOT:
        return next(leaves)
    if type(spec) is not _Node:
        return spec
    if spec.kind is dict:
        return {k: _unflatten(v, leaves) for k, v in spec.kids}
    kids = [_unflatten(x, leaves) for x in spec.kids]
    if hasattr(spec.kind, "_fields"):  # a NamedTuple
        return spec.kind(*kids)
    return spec.kind(kids)


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


class _Shown(str):
    """A string that reprs as itself."""

    def __repr__(self) -> str:
        return str(self)


def describe(key) -> str:
    """A key as a reader names it: the function, then each argument."""
    fn, spec, metas = key
    leaves = iter(_Shown(f"tensor{list(s)} {str(d).replace('torch.', '')} on {dv}")
                  for s, d, dv in metas)
    args, kwargs = _unflatten(spec, leaves)
    parts = [repr(a) for a in args] + [f"{k}={v!r}" for k, v in kwargs.items()]
    return f"{fn.__qualname__}({', '.join(parts)})"


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

@dataclass
class Executable:
    """One captured call: its graph (the backend's handle), the static
    tensors it reads and writes, the launches one replay makes, the
    tensors it holds from outside its pool, what its capture cost, and
    the pyramid levels each search route took in it ({"level": n, "gn":
    m}, routes that took none left out).
    A sharded one also names the counter of its collectives and the
    counts one replay adds to it."""
    key: tuple
    handle: Any
    inputs: List[torch.Tensor]
    outputs: List[torch.Tensor]
    out_spec: Any
    launches: Dict[str, int]
    held: List[torch.Tensor]
    capture_ms: float
    pool_bytes: int
    routes: Dict[str, int] = field(default_factory=dict)
    replays: int = 0
    exchanges: Dict[str, int] = field(default_factory=dict)
    exchange_counter: Optional[Dict[str, int]] = None


class _MeshTable(NamedTuple):
    """A mesh's sharded executables, oldest use first, and the process
    groups that key it (held, so that their identities stay unique)."""
    groups: tuple
    entries: "OrderedDict[tuple, Executable]"


class CudaGraphs:
    """Capture and replay on a CUDA device with torch.cuda.CUDAGraph: a
    private memory pool per graph, captured on a stream of its own."""

    def warm_up(self, run: Callable[[], Any], device: torch.device) -> None:
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            run()
        cur.wait_stream(side)

    def capture(self, run: Callable[[], Any], device: torch.device, collective: bool = False):
        """run() captured in a new graph: (graph, run's outputs).  A
        collective capture, and any capture in a process with a process
        group, lets other threads (the group's watchdog) query events
        meanwhile (thread-local capture mode)."""
        graph = torch.cuda.CUDAGraph()
        watched = collective or (dist.is_available() and dist.is_initialized())
        mode = "thread_local" if watched else "global"
        with torch.cuda.device(device), warnings.catch_warnings():
            # a function with no device work (a stage that forwards its
            # inputs) captures an empty graph, which replays as a no-op
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                                  capture_error_mode=mode):
                out = run()
        return graph, out

    def pool_bytes(self, graph, device: torch.device) -> int:
        """Bytes of the segments the caching allocator holds in the graph's
        private pool."""
        pool = tuple(graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == device.index
                   and tuple(seg.get("segment_pool_id", ())) == pool)

    def replay(self, graph) -> None:
        graph.replay()

    def release(self, graph) -> None:
        graph.reset()


class ExecutableCache:
    """Executables by key, at most max_per_device per device, and sharded
    ones at most max_per_mesh per mesh, captured and replayed by `backend`
    (CudaGraphs on the card)."""

    def __init__(self, backend, max_per_device: int = MAX_EXECUTABLES,
                 max_per_mesh: int = MAX_SHARDED):
        self.backend = backend
        self.max_per_device = max_per_device
        self.max_per_mesh = max_per_mesh
        self._by_device: Dict[torch.device, "OrderedDict[tuple, Executable]"] = {}
        self._by_mesh: Dict[tuple, _MeshTable] = {}
        self._lock = threading.Lock()

    def entries(self, device: Optional[torch.device] = None) -> List[Executable]:
        """The executables held (on `device`, or on every device), oldest use first."""
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            tables = (self._by_device.values() if device is None
                      else [self._by_device.get(device, {})])
            return [ex for t in tables for ex in t.values()]

    def sharded_entries(self, mesh_key: Optional[tuple] = None) -> List[Executable]:
        """The sharded executables held (in the table of `mesh_key`, or in
        every table), oldest use first."""
        with self._lock:
            tables = (self._by_mesh.values() if mesh_key is None
                      else [t for k, t in self._by_mesh.items() if k == mesh_key])
            return [ex for t in tables for ex in t.entries.values()]

    def clear(self) -> None:
        """Release every executable."""
        self.drop_meshes()
        with self._lock:
            for table in self._by_device.values():
                for ex in table.values():
                    self.backend.release(ex.handle)
            self._by_device.clear()

    def drop_meshes(self, which: Optional[Callable[[tuple], bool]] = None) -> None:
        """Release the sharded executables of the meshes whose groups
        `which(groups)` names (of every mesh when which is None)."""
        with self._lock:
            for k in [k for k, t in self._by_mesh.items() if which is None or which(t.groups)]:
                for ex in self._by_mesh.pop(k).entries.values():
                    self.backend.release(ex.handle)

    @staticmethod
    def _key(fn: Callable, args: tuple, kwargs: dict):
        """(leaves, spec, device, key) of a call."""
        leaves: List[torch.Tensor] = []
        spec = _flatten((tuple(args), dict(kwargs)), leaves)
        if not leaves:
            raise ValueError(f"{fn.__qualname__}: an executable needs a tensor argument")
        device = leaves[0].device
        if any(t.device != device for t in leaves):
            raise ValueError(f"{fn.__qualname__}: tensors on several devices "
                             f"{sorted({str(t.device) for t in leaves})}")
        key = (fn, spec, tuple(_meta(t) for t in leaves))
        try:
            hash(key)
        except TypeError as e:
            raise TypeError(f"{fn.__qualname__}: a static argument is not hashable ({e})") from e
        return leaves, spec, device, key

    def call(self, fn: Callable, args: tuple, kwargs: dict):
        """fn(*args, **kwargs) through its executable: captured at the first
        call for its key, replayed at every later one."""
        leaves, spec, device, key = self._key(fn, args, kwargs)
        with self._lock:
            table = self._by_device.setdefault(device, OrderedDict())
            return self._run(table, self.max_per_device, fn, key, spec, leaves, device)

    def call_sharded(self, fn: Callable, args: tuple, kwargs: dict, mesh_key: tuple,
                     groups: tuple, exchanges: Dict[str, int]):
        """fn(*args, **kwargs), a sharded pass that every rank of a mesh
        runs, through its executable in the mesh's table (mesh_key, the
        identity of its process groups `groups`): captured with its
        collectives at the first call for its key, replayed after.  The
        collectives it issues are counted in `exchanges`: at its capture,
        and added at each replay."""
        leaves, spec, device, key = self._key(fn, args, kwargs)
        with self._lock:
            table = self._by_mesh.get(mesh_key)
            if table is None:
                table = self._by_mesh[mesh_key] = _MeshTable(tuple(groups), OrderedDict())
            return self._run(table.entries, self.max_per_mesh, fn, key, spec, leaves, device,
                             exchanges)

    def _run(self, table, limit, fn, key, spec, leaves, device, exchanges=None):
        """The call through `table`'s executable for key (captured first if
        absent, the least recently used evicted at `limit`)."""
        ex = table.get(key)
        if ex is None:
            while len(table) >= limit:
                _, old = table.popitem(last=False)
                self.backend.release(old.handle)
            ex = self._compile(fn, key, spec, leaves, device, exchanges)
            table[key] = ex
        table.move_to_end(key)
        # (again after a capture: its warm-up may have written to them)
        for static, t in zip(ex.inputs, leaves):
            static.copy_(t)
        self._replay(ex)
        return _unflatten(ex.out_spec, iter([o.clone() for o in ex.outputs]))

    def _replay(self, ex: Executable) -> None:
        self.backend.replay(ex.handle)
        ex.replays += 1
        for k, n in ex.launches.items():
            kernels.launches[k] += n
        for k, n in ex.routes.items():
            kernels.routes[k] += n
        for k, n in ex.exchanges.items():
            ex.exchange_counter[k] += n

    def _compile(self, fn, key, spec, leaves, device, exchanges=None) -> Executable:
        inputs = [torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
                  for t in leaves]
        args, kwargs = _unflatten(spec, iter(inputs))

        def run():
            return fn(*args, **kwargs)

        self.backend.warm_up(run, device)
        counters = [kernels.launches, kernels.routes]
        if exchanges is not None:
            counters.append(exchanges)
        before = [dict(c) for c in counters]
        held: List[torch.Tensor] = []
        t0 = time.perf_counter()
        token = _held.set(held)
        try:
            if exchanges is None:
                handle, out = self.backend.capture(run, device)
            else:
                handle, out = self.backend.capture(run, device, collective=True)
        except RuntimeError as e:
            raise RuntimeError(f"capturing {describe(key)} failed: {e}") from e
        finally:
            _held.reset(token)
            # a capture launches and exchanges nothing: what it recorded,
            # each replay adds
            made = [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
                    for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.update(b)
        capture_ms = (time.perf_counter() - t0) * 1e3
        outputs: List[torch.Tensor] = []
        out_spec = _flatten(out, outputs)
        return Executable(key=key, handle=handle, inputs=inputs, outputs=outputs,
                          out_spec=out_spec, launches=made[0], held=held,
                          capture_ms=capture_ms,
                          pool_bytes=self.backend.pool_bytes(handle, device),
                          routes=made[1],
                          exchanges=made[2] if exchanges is not None else {},
                          exchange_counter=exchanges)


cache = ExecutableCache(CudaGraphs())


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (tuple, list)):
        items = tree
    elif isinstance(tree, dict):
        items = tree.values()
    else:
        return None
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def executable(fn: Callable) -> Callable:
    """fn as a compiled executable: on the card, one CUDA graph per static
    key (see the module docstring); on the CPU and under eager(), fn itself.
    The wrapper's `fn` is the function it runs."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        t = _first_tensor((args, kwargs))
        if _eager.get() or t is None or t.device.type != "cuda":
            return fn(*args, **kwargs)
        return cache.call(fn, args, kwargs)

    call.fn = fn
    return call
