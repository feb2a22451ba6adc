"""The port's host-device copies (ops/transfer.py) on the card: an upload
returns while work queued ahead of it still runs, an array or a CPU
tensor goes up in its own dtype and is converted on the card to numpy's
values, a download's handle
waits for that copy only and gives .cpu()'s bits, the batched video driver
waits once per flushed chunk and writes what a synchronous run writes,
and a pinned buffer is not handed out again before its copy has run.
Marked `gpu` and skipped without a CUDA device.  This file imports no JAX
and no conftest fixture, so on a machine with a GPU and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_host_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import operating_point
from of_dis_tpu_torch.ops import transfer
from of_dis_tpu_torch.parallel import video

pytestmark = pytest.mark.gpu

SLEEP_S = 1.0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def sleep(cuda):
    """queue() queues SLEEP_S of device sleep on the current stream and
    returns an event recorded after it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    cycles = int(10 ** 8 * SLEEP_S * 1e3 / start.elapsed_time(end))

    def queue():
        torch.cuda._sleep(cycles)
        return torch.cuda.current_stream(cuda).record_event()

    return queue


def test_to_device_returns_while_queued_work_runs(cuda, sleep):
    """An upload of 57 MB behind a second of queued work returns in under a
    tenth of it, the work still running; the copy holds the source's bits
    and the current stream's next op sees them."""
    x = np.random.RandomState(0).rand(32, 436, 1024).astype(np.float32)
    transfer.to_device(x, cuda)
    torch.cuda.synchronize()
    transfer.reset_counts()
    done = sleep()
    t0 = time.perf_counter()
    t = transfer.to_device(x, cuda)
    host_s = time.perf_counter() - t0
    assert not done.query(), "the upload waited for the work queued ahead of it"
    assert host_s < 0.1 * SLEEP_S, host_s
    twice = t * 2
    torch.cuda.synchronize()
    assert np.array_equal(twice.cpu().numpy(), x * 2)
    assert transfer.counts == {"uploads": 1, "downloads": 0, "host_waits": 0}
    u8 = (x[:2, :, :, None] * 255).astype(np.uint8).repeat(3, axis=3)
    bgr = u8[..., ::-1]  # negative strides, as an image's channels reversed
    assert np.array_equal(transfer.to_device(bgr, cuda).cpu().numpy(), bgr.astype(np.float32))


@pytest.mark.parametrize("source", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float64, np.bool_, np.float32])
def test_to_device_converts_on_the_card(cuda, monkeypatch, dtype, source):
    """An array or a CPU tensor goes up in its own dtype (a uint8 frame's
    bytes, not float32's) and comes out as numpy's float32 conversion of
    it, bit for bit, an array's negative strides included."""
    base = np.random.RandomState(1).rand(436, 1024, 3)
    x = {np.uint8: lambda: (base * 255).astype(np.uint8),
         np.int16: lambda: (base * 6000 - 3000).astype(np.int16),
         np.float64: lambda: base * 300 - 20,
         np.bool_: lambda: base > 0.5,
         np.float32: lambda: (base * 300 - 20).astype(np.float32)}[dtype]()[:, ::-1]
    staged, real = [], transfer._upload
    monkeypatch.setattr(transfer, "_upload", lambda h, d: staged.append(h.dtype) or real(h, d))
    got = transfer.to_device(x if source == "numpy" else torch.from_numpy(x.copy()), cuda)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), x.astype(np.float32))
    assert staged == [torch.from_numpy(np.empty(0, dtype)).dtype]


def test_to_host_waits_for_its_copy_only(cuda, sleep):
    """to_host of a result queued behind a second of work returns at once;
    its numpy() waits (one host wait, counted once) and equals .cpu()."""
    t = torch.randn(3, 436, 1024, 2, device=cuda)
    want = t.cpu().numpy()
    transfer.reset_counts()
    done = sleep()
    t0 = time.perf_counter()
    copy = transfer.to_host(t * 2)
    host_s = time.perf_counter() - t0
    assert not done.query() and host_s < 0.1 * SLEEP_S, host_s
    got = copy.numpy()
    assert done.query()
    assert np.array_equal(got, want * 2)
    assert np.array_equal(copy.numpy(), want * 2)
    assert np.array_equal(transfer.to_host(t).numpy(), t.cpu().numpy())
    assert transfer.counts == {"uploads": 0, "downloads": 2, "host_waits": 2}


def _frames(n, h=96, w=128):
    """n smooth frames, each the first moved 3 px right and 2 px down."""
    rng = np.random.RandomState(0)
    base = rng.rand(h + 64, w + 64)
    for _ in range(4):  # repeated 3x3 box blur
        base = sum(np.roll(np.roll(base, y, 0), x, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)) / 9
    base = (base * 255).astype(np.float32)
    return [base[32 - 2 * i:32 - 2 * i + h, 32 - 3 * i:32 - 3 * i + w] for i in range(n)]


def test_video_batched_waits_once_per_flush(cuda, sleep, tmp_path):
    """Four chunks of 2 pairs queued behind a second of work: the host
    loads, stages and queues all four in under a tenth of it, then waits
    once per flushed chunk; the files equal the synchronous run's
    (queue_depth=0) byte for byte."""
    frames, cfg = _frames(9), operating_point(2, 128)

    def run(out, depth, loader=lambda a: a):
        return list(video.process_video_batched(frames, tmp_path / out, cfg, batch_size=2,
                                                queue_depth=depth, loader=loader, device=cuda))

    sleep()
    run("warm", 4)  # captures the executables, fills the pinned pool as a queued run needs
    sync = run("sync", 0)
    torch.cuda.synchronize()
    transfer.reset_counts()
    video.reset_host_seconds()
    done = sleep()
    queued = run("queued", 4)
    assert done.query()
    assert video.host_seconds["load_stage"] + video.host_seconds["enqueue"] < 0.1 * SLEEP_S, \
        video.host_seconds
    assert video.host_seconds["wait"] > 0.5 * SLEEP_S, video.host_seconds
    assert transfer.counts == {"uploads": 8, "downloads": 4, "host_waits": 4}
    assert [i for i, _ in queued] == [i for i, _ in sync] == list(range(8))
    for (_, a), (_, b) in zip(queued, sync):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_pinned_buffer_not_reused_before_its_copy(cuda, sleep):
    """Eight chunks staged in a loop behind a second of queued work: each
    pinned buffer is dropped as soon as its copy is queued, and still each
    chunk arrives with its own source's values."""
    rng = np.random.RandomState(3)
    srcs = [rng.rand(2, 64, 96).astype(np.float32) for _ in range(8)]
    done = sleep()
    outs = [transfer.stack_to_device(iter(src), len(src), cuda) for src in srcs]
    assert not done.query(), "the copies ran before the test could check them"
    torch.cuda.synchronize()
    for k, (src, out) in enumerate(zip(srcs, outs)):
        assert np.array_equal(out.cpu().numpy(), src), k
