"""Port (of_dis_tpu_torch) compiled executables on the CPU (ops/graphs.py).

The cache's bookkeeping runs through its capture interface with a
recording stand-in for CUDA graphs (`Recorder`, tests/graph_recorder.py):
one capture per key, the keys the entry points make, launch counts added
per replay, eviction at the bound, results that outlive the next replay,
and held tensors.  Then
the executables under their JAX names against the JAX functions of the
same name (mean EPE, the bound of test_torch_dis.py::
test_dis_flow_matches_jax).  On the card, tests/test_torch_graphs_gpu.py
holds the graphs against eager runs bit for bit."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from golden_util import epe
from graph_recorder import POOL, Recorder
from of_dis_tpu import DISConfig
from of_dis_tpu.models import dis as jdis
from of_dis_tpu.parallel import video as jvideo
from of_dis_tpu_torch import eager
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.ops import graphs, kernels
from of_dis_tpu_torch.parallel import collectives
from of_dis_tpu_torch.parallel import video as tvideo


def _twice_plus(x, y, scale: float):
    """A stand-in for a path: one level_search 'launch' and x * scale + y."""
    kernels.launches["level_search"] += 1
    return x * scale + y


@pytest.fixture
def launches():
    saved = dict(kernels.launches)
    kernels.reset_launches()
    yield kernels.launches
    kernels.launches.update(saved)


def test_one_capture_per_key_and_launches_per_replay(launches):
    rec = Recorder()
    cache = graphs.ExecutableCache(rec, 4)
    x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    outs = [cache.call(_twice_plus, (x + i, y, 2.0), {}) for i in range(3)]
    for i, out in enumerate(outs):
        assert torch.equal(out, (x + i) * 2.0 + y)
    assert (rec.warm_ups, len(rec.captures), rec.replays) == (1, 1, 3)
    (ex,) = cache.entries()
    assert ex.launches == {"level_search": 1} and ex.replays == 3
    assert ex.pool_bytes == POOL
    # the warm-up ran the kernel once; each of the 3 replays adds its launch
    assert launches["level_search"] == 1 + 3
    # a static argument and a shape are each part of the key
    cache.call(_twice_plus, (x, y, 3.0), {})
    cache.call(_twice_plus, (x[:1], y[:1], 2.0), {})
    assert len(rec.captures) == 3 and len(cache.entries()) == 3


def test_replay_output_outlives_the_next_replay():
    rec = Recorder()
    cache = graphs.ExecutableCache(rec, 4)
    y = torch.zeros(4)
    first = cache.call(_twice_plus, (torch.ones(4), y, 1.0), {})
    second = cache.call(_twice_plus, (torch.full((4,), 5.0), y, 1.0), {})
    assert rec.replays == 2  # the second call rewrote the graph's buffers
    assert torch.equal(first, torch.ones(4)) and torch.equal(second, torch.full((4,), 5.0))


def test_first_replay_reads_the_callers_inputs():
    """A function that writes to its input: the warm-up and the capture run
    it on the static inputs, and the first replay must still start from
    the caller's values, as every later one does."""
    def bump_twice(x):
        x.add_(1.0)
        return x * 2.0

    cache = graphs.ExecutableCache(Recorder(), 2)
    for v in (1.0, 5.0):
        assert torch.equal(cache.call(bump_twice, (torch.full((3,), v),), {}),
                           torch.full((3,), (v + 1.0) * 2.0))


def test_eviction_at_the_bound_releases_the_pool():
    rec = Recorder()
    cache = graphs.ExecutableCache(rec, 2)
    y = torch.zeros(3)
    for s in (1.0, 2.0, 3.0):
        cache.call(_twice_plus, (torch.ones(3), y, s), {})
    assert len(cache.entries()) == 2
    assert rec.released == [rec.captures[0]]  # the least recently used
    assert [ex.handle for ex in cache.entries()] == rec.captures[1:]
    cache.call(_twice_plus, (torch.ones(3), y, 2.0), {})  # still held: a replay
    assert len(rec.captures) == 3
    cache.call(_twice_plus, (torch.ones(3), y, 1.0), {})  # evicted: captured anew
    assert len(rec.captures) == 4 and rec.released[-1] is rec.captures[2]
    cache.clear()
    assert cache.entries() == [] and len(rec.released) == len(rec.captures)


def test_tensors_read_from_outside_stay_held():
    outside = torch.full((3,), 7.0)
    ref = weakref.ref(outside)

    def add_outside(x):
        graphs.hold(outside)
        return x + outside

    cache = graphs.ExecutableCache(Recorder(), 2)
    cache.call(add_outside, (torch.ones(3),), {})
    graphs.hold(torch.ones(1))  # outside a capture: held by nobody
    (ex,) = cache.entries()
    assert len(ex.held) == 1 and ex.held[0] is outside
    del outside, add_outside
    gc.collect()
    assert ref() is not None
    cache.clear()
    del ex
    gc.collect()
    assert ref() is None


def test_sharded_tables_per_mesh(launches):
    """call_sharded keeps a table per mesh key, bounded by max_per_mesh and
    evicted only by calls on that mesh; a replay adds the exchanges its
    capture counted; drop_meshes releases the tables it names."""
    rec = Recorder()
    cache = graphs.ExecutableCache(rec, max_per_device=1, max_per_mesh=2)
    counter = collectives.exchanges
    saved = dict(counter)

    def pass_(x, y, scale: float):
        counter["exchanges"] += 3
        return _twice_plus(x, y, scale)

    x, y = torch.ones(3), torch.zeros(3)
    groups_a, groups_b = ("group a",), ("group b",)
    for s in (1.0, 2.0, 3.0):
        cache.call_sharded(pass_, (x, y, s), {}, "mesh a", groups_a, counter)
    cache.call_sharded(pass_, (x, y, 1.0), {}, "mesh b", groups_b, counter)
    cache.call(_twice_plus, (x, y, 1.0), {})
    cache.call(_twice_plus, (x, y, 2.0), {})  # evicts a per-device key only
    assert [ex.key[1].kids[0].kids[2] for ex in cache.sharded_entries("mesh a")] == [2.0, 3.0]
    assert len(cache.sharded_entries("mesh b")) == 1 and len(cache.entries()) == 1
    assert all(h["collective"] for h in rec.captures[:4]) and not rec.captures[4]["collective"]
    (ex,) = cache.sharded_entries("mesh b")
    assert ex.exchanges == {"exchanges": 3} and ex.launches == {"level_search": 1}
    collectives.reset_exchanges()
    cache.call_sharded(pass_, (x, y, 1.0), {}, "mesh b", groups_b, counter)
    assert counter["exchanges"] == 3 and ex.replays == 2
    counter.update(saved)
    cache.drop_meshes(lambda groups: groups == groups_a)
    assert cache.sharded_entries("mesh a") == [] and len(cache.sharded_entries()) == 1
    assert len(rec.released) == 1 + 1 + 2  # evicted on a, on the device, dropped a
    cache.clear()
    assert cache.sharded_entries() == [] and len(rec.released) == len(rec.captures)


def _small_cfg(**kw):
    """test_torch_dis.py::test_dis_flow_matches_jax's config, with kw replaced."""
    base = dict(mode="flow", channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                patch_size=8, overlap=0.4, use_tv_refine=True)
    return DISConfig(**{**base, **kw}).validate()


def _pairs(b, h=32, w=48, seed=0):
    """b smooth pairs (b, h, w, 1), the second frame moved by (+3, +2) px."""
    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(b, h + 8, w + 8) * 255, (0, 2, 2)).astype(np.float32)
    return base[:, 4:4 + h, 4:4 + w, None], base[:, 2:2 + h, 7:7 + w, None]


def test_entry_point_keys(launches):
    """dis_padded_jit / dis_padded_init_jit through the cache: a key per
    cfg, B, shape, gradmag_input and init_flow absent, shared or per pair;
    each result bit-equal to the eager _dis_padded."""
    rec = Recorder()
    cache = graphs.ExecutableCache(rec, 16)
    cfg = from_reference(dataclasses.asdict(_small_cfg(use_tv_refine=False)))
    a, b = (torch.as_tensor(x) for x in _pairs(2, 16, 32))
    init_shared = torch.full((4, 8, 2), 0.5)
    init_pairs = torch.full((2, 4, 8, 2), 0.25)
    calls = [
        (tdis.dis_padded_jit, (a[:1], b[:1], cfg)),
        (tdis.dis_padded_jit, (a[:1], b[:1], cfg)),  # the same key
        (tdis.dis_padded_jit, (a[:1], b[:1], dataclasses.replace(cfg, max_iter=3))),
        (tdis.dis_padded_jit, (a, b, cfg)),
        (tdis.dis_padded_jit, (a[:1, :, :16], b[:1, :, :16], cfg)),
        (tdis.dis_padded_jit, (a[:1], b[:1], cfg, True)),
        (tdis.dis_padded_init_jit, (a, b, init_shared, cfg)),
        (tdis.dis_padded_init_jit, (a, b, init_pairs, cfg)),
    ]
    for fn, args in calls:
        # on the CPU the executable itself runs as written: the eager result
        assert torch.equal(cache.call(fn.fn, args, {}), fn(*args))
    assert len(rec.captures) == len(calls) - 1 == len(cache.entries())
    keys = [ex.key for ex in cache.entries()]
    assert len(set(keys)) == len(keys)
    assert graphs.describe(keys[0]).startswith(
        "dis_padded_jit(tensor[1, 16, 32, 1] float32 on cpu, tensor[1, 16, 32, 1] float32 "
        "on cpu, DISConfig(mode='flow'")


def test_eager_and_cpu_run_as_written():
    """On the CPU, and under eager(), an executable is its function."""
    seen = []

    @graphs.executable
    def f(x):
        seen.append(x)
        return x + 1

    x = torch.zeros(2)
    assert torch.equal(f(x), x + 1)
    with eager():
        assert torch.equal(f(x), x + 1)
    assert len(seen) == 2 and graphs.cache.entries() == [] and f.fn(x).shape == x.shape


def test_dis_padded_jit_matches_jax():
    cfg = _small_cfg()
    a, b = _pairs(1)
    ref = np.asarray(jdis.dis_padded_jit(a[0], b[0], cfg))
    ours = tdis.dis_padded_jit(torch.as_tensor(a), torch.as_tensor(b),
                               from_reference(dataclasses.asdict(cfg)))[0].numpy()
    assert ours.shape == ref.shape
    assert epe(ours, ref) <= 0.01


def test_dis_padded_init_jit_matches_jax():
    cfg = _small_cfg()
    a, b = _pairs(1, seed=1)
    init = np.random.RandomState(2).randn(8, 12, 2).astype(np.float32)
    ref = np.asarray(jdis.dis_padded_init_jit(a[0], b[0], init, cfg))
    ours = tdis.dis_padded_init_jit(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(init),
                                    from_reference(dataclasses.asdict(cfg)))[0].numpy()
    assert ours.shape == ref.shape
    assert epe(ours, ref) <= 0.01


def test_video_chunk_matches_jax():
    """_video_chunk on a batch of 2 pairs, pre-padded to 32x48, with one
    shared warm start, cropped to 31x47 (as if padded from it)."""
    cfg = _small_cfg()
    a, b = _pairs(2, seed=3)
    init = np.random.RandomState(4).randn(8, 12, 2).astype(np.float32) * 0.5
    ref = np.asarray(jvideo._video_chunk(a, b, init, cfg, 31, 47))
    ours = tvideo._video_chunk(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(init),
                               from_reference(dataclasses.asdict(cfg)), 31, 47).numpy()
    assert ours.shape == ref.shape == (2, 31, 47, 2)
    assert epe(ours, ref) <= 0.01
