"""The port's host runtime on the CPU: its C++ codecs (of_dis_tpu_torch/
native.py, csrc/ofdis_native.cpp) against its NumPy writers and readers
and the JAX package's io, a native build that fails, ops/transfer.py's
CPU path, and process_video_batched fed from .pgm files on disk against
the JAX package's driver on the same files."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from golden_util import epe
from of_dis_tpu import DISConfig
from of_dis_tpu import io as jio
from of_dis_tpu.parallel import video as jvideo
from of_dis_tpu_torch import io, native
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.ops import build, transfer
from of_dis_tpu_torch.parallel.video import process_video_batched


def _write_pnm(path, img: np.ndarray, comment: bool = False) -> None:
    """A binary P5 (H, W) or P6 (H, W, 3) uint8 file."""
    h, w = img.shape[:2]
    magic = b"P5" if img.ndim == 2 else b"P6"
    with open(path, "wb") as f:
        f.write(magic + b"\n" + (b"# made by a test\n" if comment else b"")
                + f"{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def _numpy_bytes(monkeypatch, write, path, *a):
    """The bytes io's NumPy code writes (OF_DIS_NATIVE=0)."""
    with monkeypatch.context() as m:
        m.setenv("OF_DIS_NATIVE", "0")
        write(path, *a)
    return path.read_bytes()


def test_native_codec_matches_numpy_and_jax(tmp_path, monkeypatch):
    """.flo and .pfm bytes equal the NumPy writers' and the JAX package's;
    the readers give the values back; PNM (P5, P6 with a comment) and
    gray_from_rgb_u8 on an 11x7 field equal the NumPy versions."""
    assert native.available()
    rng = np.random.RandomState(0)
    flow = rng.randn(11, 7, 2).astype(np.float32)
    disp = -np.abs(rng.randn(11, 7)).astype(np.float32)

    assert native.write_flo(tmp_path / "n.flo", flow)
    jio.write_flo(tmp_path / "j.flo", flow)
    want = _numpy_bytes(monkeypatch, io.write_flo, tmp_path / "p.flo", flow)
    assert (tmp_path / "n.flo").read_bytes() == want == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(native.read_flo(tmp_path / "n.flo"), flow)
    np.testing.assert_array_equal(io.read_flo(tmp_path / "j.flo"), flow)

    assert native.write_pfm(tmp_path / "n.pfm", disp, negate=True)
    jio.write_pfm(tmp_path / "j.pfm", disp)
    want = _numpy_bytes(monkeypatch, io.write_pfm, tmp_path / "p.pfm", disp)
    assert (tmp_path / "n.pfm").read_bytes() == want == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(native.read_pfm(tmp_path / "n.pfm"), -disp)
    np.testing.assert_array_equal(native.read_pfm(tmp_path / "n.pfm", negate=True), disp)
    np.testing.assert_array_equal(io.read_pfm(tmp_path / "n.pfm", negate=True), disp)

    rgb = rng.randint(0, 256, (11, 7, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (11, 7)).astype(np.uint8)
    _write_pnm(tmp_path / "c.ppm", rgb, comment=True)
    _write_pnm(tmp_path / "g.pgm", gray)
    for name, img in (("c.ppm", rgb), ("g.pgm", gray.reshape(11, 7, 1))):
        got = native.read_pnm(tmp_path / name)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, io._read_pnm_numpy(tmp_path / name))
    np.testing.assert_array_equal(io.load_image(tmp_path / "c.ppm"),
                                  jio.load_image(tmp_path / "c.ppm"))
    np.testing.assert_array_equal(native.gray_from_rgb_u8(rgb),
                                  io._bgr_to_gray_u8(rgb).astype(np.float32))
    with pytest.raises(FileNotFoundError):
        io.load_image(tmp_path / "missing.pgm")


def test_native_off_and_a_failed_build(tmp_path, monkeypatch):
    """OF_DIS_NATIVE=0 keeps its JAX meaning (NumPy only); a build that
    fails raises with the compiler's output and falls back to nothing."""
    with monkeypatch.context() as m:
        m.setenv("OF_DIS_NATIVE", "0")
        assert not native.available()
        assert native.write_flo(tmp_path / "x.flo", np.zeros((2, 3, 2), np.float32)) is False
        assert native.read_pnm(tmp_path / "x.pgm") is None
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        build.build_host("bad")
    assert not list((tmp_path / "build").glob("*.so"))


def test_transfer_on_the_cpu_returns_the_same_bits():
    """On the CPU to_device, stack_to_device and to_host copy nothing to a
    card and count nothing: the float32 values, bit for bit, also of views
    with a negative stride (an image's channels reversed)."""
    rng = np.random.RandomState(1)
    f64 = rng.randn(5, 6)
    u8 = rng.randint(0, 256, (5, 6)).astype(np.uint8)
    f32 = f64.astype(np.float32)
    transfer.reset_counts()
    for x in (f64, u8, f32, torch.from_numpy(f64), f64.tolist(), u8[:, ::-1], f32[::-1]):
        t = transfer.to_device(x, "cpu")
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(x, np.float32))
        np.testing.assert_array_equal(transfer.to_host(t).numpy(), t.numpy())
    stacked = transfer.stack_to_device(iter([f64, u8, u8[::-1, ::-1], f32[:, ::-1]]), 4, "cpu")
    np.testing.assert_array_equal(stacked.numpy(), np.stack(
        [f64, u8, u8[::-1, ::-1], f32[:, ::-1]]).astype(np.float32))
    for arrays, n in (([f64], 2), ([f64, u8, f64], 2), ([f64, f64[:4]], 2)):
        with pytest.raises(ValueError):
            transfer.stack_to_device(iter(arrays), n, "cpu")
    assert transfer.counts == {"uploads": 0, "downloads": 0, "host_waits": 0}


def _cfg(**kw):
    """tests/test_video.py's configuration (JAX package), with kw replaced."""
    base = dict(mode="flow", channels=1, sc_f=1, sc_l=0, max_iter=4, min_iter=4,
                patch_size=8, overlap=0.4, use_tv_refine=False)
    return DISConfig(**{**base, **kw}).validate()


def test_video_batched_from_pgm_files_matches_jax(tmp_path, monkeypatch):
    """6 8-bit .pgm frames on disk (a drift of (2, 1) px a frame), batches
    of 2, 2 queued, the default loader (the native PNM reader) and native
    .flo writes: every file byte-equal to the port's run on the same frames
    in memory with the NumPy codec (OF_DIS_NATIVE=0), and within a mean
    EPE of 1e-4 px of the JAX package's process_video_batched on the same
    files (the packages' templates sum in another order: ~1e-5 px apart)."""
    rng = np.random.RandomState(0)
    base = gaussian_filter(rng.rand(80, 96) * 255, 2.0).astype(np.uint8)
    paths = []
    for i in range(6):
        paths.append(tmp_path / f"frame_{i}.pgm")
        _write_pnm(paths[-1], base[8 + i: 56 + i, 8 + 2 * i: 72 + 2 * i])
    jcfg = _cfg()
    cfg = from_reference(dataclasses.asdict(jcfg))
    got = list(process_video_batched(paths, tmp_path / "port", cfg, batch_size=2,
                                     queue_depth=2, device="cpu"))
    with monkeypatch.context() as m:
        m.setenv("OF_DIS_NATIVE", "0")
        frames = [io._read_pnm_numpy(p).astype(np.float32) for p in paths]
        plain = list(process_video_batched(frames, tmp_path / "plain", cfg, batch_size=2,
                                           queue_depth=2, loader=lambda a: a, device="cpu"))
    want = dict(jvideo.process_video_batched(paths, tmp_path / "jax", jcfg, batch_size=2,
                                             queue_depth=2))
    assert [i for i, _ in got] == [i for i, _ in plain] == sorted(want) == list(range(5))
    for (i, path), (_, plain_path) in zip(got, plain):
        assert path.name == plain_path.name == want[i].name
        assert path.read_bytes() == plain_path.read_bytes(), i
        assert epe(io.read_flo(path), jio.read_flo(want[i])) <= 1e-4, i
