"""Port (of_dis_tpu_torch) video drivers on the CPU, after tests/test_video.py:
warm start and checkpoints against the JAX package's process_video (mean
EPE, the bound of test_torch_dis.py::test_dis_flow_matches_jax), the
batched video path's kill-and-resume (byte-identical), its padded last chunk,
stereo's warm resume, a run that the JAX package starts and the port
resumes, and both drivers with the forward-backward merge."""

import dataclasses
import json

import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from golden_util import epe
from of_dis_tpu import DISConfig
from of_dis_tpu.parallel import video as jvideo
from of_dis_tpu_torch import dis_raw, io
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.parallel.video import (
    _warm_start_from,
    process_video,
    process_video_batched,
)


def _cfg(**kw):
    """tests/test_video.py's configuration (JAX package), with kw replaced."""
    base = dict(mode="flow", channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                patch_size=8, overlap=0.4, use_tv_refine=False)
    return DISConfig(**{**base, **kw}).validate()


def _port(cfg):
    """The same configuration for the port."""
    return from_reference(dataclasses.asdict(cfg))


def _frame_seq(n=6):
    """n in-memory frames with a constant drift of (2, 1) px per frame."""
    rng = np.random.RandomState(0)
    base = gaussian_filter(rng.rand(48 + 32, 64 + 32) * 255, 2.0).astype(np.float32)
    return [base[8 + i: 8 + i + 48, 8 + 2 * i: 8 + 2 * i + 64] for i in range(n)]


def _loader(a):
    return a


def _cpu(driver, *a, **kw):
    return list(driver(*a, loader=_loader, device="cpu", **kw))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's process_video over 4 frames and its batched driver
    (batch 2) over 6, uninterrupted: each one's outputs by pair."""
    root = tmp_path_factory.mktemp("jax_video")
    frames = _frame_seq()
    single = list(jvideo.process_video(frames[:4], root / "single", _cfg(), loader=_loader))
    batched = list(jvideo.process_video_batched(frames, root / "batched", _cfg(), batch_size=2,
                                                loader=_loader))
    return ({i: io.read_flo(p) for i, p in single}, {i: io.read_flo(p) for i, p in batched})


def test_process_video_matches_jax_and_checkpoints(jax_runs, tmp_path):
    out = tmp_path / "flows"
    results = _cpu(process_video, _frame_seq()[:4], out, _port(_cfg()))
    assert [i for i, _ in results] == [0, 1, 2]
    assert json.loads((out / "progress.json").read_text()) == {"last_completed": 2}
    for i, path in results:
        assert epe(io.read_flo(path), jax_runs[0][i]) <= 0.01, i
    inner = io.read_flo(results[1][1])[12:-12, 12:-12]
    assert abs(np.median(inner[..., 0]) + 2.0) < 0.3  # u = -2 per frame
    assert abs(np.median(inner[..., 1]) + 1.0) < 0.3  # v = -1


def test_video_batched_kill_resume_matches_uninterrupted(tmp_path):
    """A run killed after chunk 0 and resumed writes every output
    byte-identical to the uninterrupted run (same chunk boundaries, warm
    start re-read from the completed output file)."""
    frames, c = _frame_seq(), _port(_cfg())
    full = _cpu(process_video_batched, frames, tmp_path / "full", c, batch_size=2)
    part = tmp_path / "part"
    it = process_video_batched(frames, part, c, batch_size=2, loader=_loader, queue_depth=0,
                               device="cpu")
    next(it)
    next(it)  # chunk 0 (pairs 0, 1) completed, then "crash"
    del it
    assert json.loads((part / "progress.json").read_text())["last_completed"] == 1
    resumed = _cpu(process_video_batched, frames, part, c, batch_size=2)
    assert [i for i, _ in resumed] == [i for i, _ in full] == list(range(5))
    for (i, p_full), (_, p_part) in zip(full, resumed):
        assert p_full.read_bytes() == p_part.read_bytes(), f"pair {i}"


def test_video_batched_last_partial_chunk(tmp_path):
    """5 pairs in batches of 4: the last chunk is padded by repetition, every
    real output is written and the padding pairs never are."""
    out = tmp_path / "flows"
    results = _cpu(process_video_batched, _frame_seq(), out, _port(_cfg()), batch_size=4)
    assert [i for i, _ in results] == list(range(5))
    assert sorted(p.name for p in out.glob("*.flo")) == [f"flow_{i:06d}.flo" for i in range(5)]
    assert json.loads((out / "progress.json").read_text())["last_completed"] == 4


def test_video_stereo_warm_resume_matches_uninterrupted(tmp_path):
    """Stereo re-seeds its warm start from the last .pfm (internal sign
    convention), so the resumed run's last output equals the uninterrupted
    one's."""
    rng = np.random.RandomState(1)
    base = gaussian_filter(rng.rand(40, 80) * 255, 2.0).astype(np.float32)
    frames = [base[:, 6:-6], base[:, 9:-3], base[:, 12:]]  # 3 px per frame
    c = _port(_cfg(mode="stereo", max_iter=3, min_iter=3))
    want = io.read_pfm(_cpu(process_video, frames, tmp_path / "full", c)[-1][1])
    part = tmp_path / "part"
    it = process_video(frames, part, c, loader=_loader, device="cpu")
    next(it)  # pair 0 completed, then "crash"
    del it
    got = io.read_pfm(_cpu(process_video, frames, part, c)[-1][1])
    np.testing.assert_array_equal(got, want)


def test_video_batched_resumes_a_jax_run(jax_runs, tmp_path):
    """The JAX package's batched driver stops after chunk 0; the port
    resumes from its progress.json and files: it writes every remaining
    pair, each within the mean-EPE bound of the uninterrupted JAX run."""
    frames, out = _frame_seq(), tmp_path / "mixed"
    it = jvideo.process_video_batched(frames, out, _cfg(), batch_size=2, loader=_loader,
                                      queue_depth=0)
    next(it)
    next(it)  # chunk 0 written by the JAX package
    del it
    written = {p.name: p.stat().st_mtime_ns for p in out.glob("*.flo")}
    assert sorted(written) == ["flow_000000.flo", "flow_000001.flo"]
    results = _cpu(process_video_batched, frames, out, _port(_cfg()), batch_size=2)
    assert [i for i, _ in results] == list(range(5))
    assert {p.name: p.stat().st_mtime_ns for p in out.glob("*.flo")
            if p.name in written} == written  # chunk 0 was not recomputed
    for i, path in results:
        assert epe(io.read_flo(path), jax_runs[1][i]) <= 0.01, i
    assert json.loads((out / "progress.json").read_text())["last_completed"] == 4


@pytest.mark.parametrize("driver", [process_video, process_video_batched])
def test_video_drivers_run_fb_merge(driver, tmp_path):
    """With fb-merge both drivers write, pair by pair, what a loop of fb
    dis_raw gives: process_video warm-starts pair 1 from pair 0's flow (the
    forward flow only), the batched driver's one chunk of 2 starts cold."""
    frames = _frame_seq(3)
    cfg = dataclasses.replace(_port(_cfg()), use_fb_merge=True)
    results = _cpu(driver, frames, tmp_path / "flows", cfg,
                   **({"batch_size": 2} if driver is process_video_batched else {}))
    init = None
    for i, path in results:
        want = dis_raw(frames[i], frames[i + 1], cfg, init_flow=init, device="cpu")
        np.testing.assert_array_equal(io.read_flo(path), want.numpy())
        if driver is process_video:
            init = _warm_start_from(want, cfg)
    assert [i for i, _ in results] == [0, 1]
