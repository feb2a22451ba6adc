"""The entry's executable on the CPU (models/dis.py::_dis_entry, run by
dis_raw and batched_flow): frames handed on in their own dtype, converted
and padded by kernels.frame_pad, upscaled and cropped by
kernels.flow_upscale, whose plain versions run here.  uint8 and float32
frames of one image give the same bits, equal to the composition of the
plain functions; to_device's other callers still get float32."""

import dataclasses

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import batched_flow, dis_flow, dis_stereo, operating_point
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.ops import kernels, transfer
from of_dis_tpu_torch.ops import pyramid as pyr

H, W = 100, 150  # padded to 112 x 160 at sc_f 4


def _pair(c=1, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.rand(H + 16, W + 16, c)
    for _ in range(3):  # repeated 3x3 box blur
        base = sum(np.roll(np.roll(base, y, 0), x, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)) / 9
    base = (base - base.min()) / (base.max() - base.min()) * 255
    a, b = base[8:8 + H, 8:8 + W], base[6:6 + H, 11:11 + W]
    return a.astype(np.uint8), b.astype(np.uint8)


def _cfg(sc_l, mode="flow"):
    return dataclasses.replace(operating_point(2, W, mode=mode), sc_f=4, sc_l=sc_l,
                               max_iter=4, min_iter=4).validate()


def _plain(a, b, cfg):
    """The composition the entry replaces, on float32 frames: divisibility
    padding, the padded pipeline, upscale and crop."""
    scf = 1 << cfg.sc_f
    p1, p2 = (pyr.pad_to_divisible(torch.from_numpy(x.astype(np.float32))[None], scf)
              for x in (a, b))
    flow = tdis._dis_padded(p1, p2, cfg)
    return tdis._upscale_crop(flow, cfg, p1.shape[1], p1.shape[2], H, W)[0]


@pytest.mark.parametrize("sc_l", [0, 3])
def test_uint8_and_float32_frames_give_the_same_bits(sc_l):
    a, b = _pair()
    cfg = _cfg(sc_l)
    kernels.reset_launches()
    got = dis_flow(a, b, cfg, device="cpu")
    assert got.shape == (H, W, 2) and got.dtype == torch.float32
    assert torch.equal(got, dis_flow(a.astype(np.float32), b.astype(np.float32), cfg,
                                     device="cpu"))
    assert torch.equal(got, dis_flow(torch.from_numpy(a), torch.from_numpy(b), cfg,
                                     device="cpu"))
    assert torch.equal(got, _plain(a, b, cfg))
    assert float(got.abs().max()) > 0.5  # the pair moves
    batch = batched_flow(np.stack([a, b]), np.stack([b, a]), cfg, device="cpu")
    assert torch.equal(batch[0], got)
    stereo = dis_stereo(a, b, _cfg(sc_l, "stereo"), device="cpu")
    assert torch.equal(stereo, dis_stereo(a.astype(np.float32), b.astype(np.float32),
                                          _cfg(sc_l, "stereo"), device="cpu"))
    assert sum(kernels.launches.values()) == 0  # the plain versions launch nothing


@pytest.mark.parametrize("shape", [(2, H, W, 1), (1, 96, 128, 3), (H, W, 1)])
def test_plain_frame_pad_and_flow_upscale(shape):
    """The wrappers' CPU path is the plain functions: padding to divisibility
    after a conversion to float32, and _upscale_crop; a pair without the
    batch axis too."""
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8)) for _ in range(2))
    p1, p2 = kernels.frame_pad(a, b, 16)
    assert p1.dtype == torch.float32 and p1.shape[-3] % 16 == 0 and p1.shape[-2] % 16 == 0
    assert torch.equal(p1, pyr.pad_to_divisible(a.float(), 16))
    assert torch.equal(p2, pyr.pad_to_divisible(b.float(), 16))
    cfg = _cfg(3)
    hp, wp = p1.shape[-3:-1]
    flow = torch.from_numpy(rng.randn(*shape[:-3], hp >> 3, wp >> 3, 2).astype(np.float32))
    want = tdis._upscale_crop(flow if flow.ndim == 4 else flow[None], cfg, hp, wp, *shape[-3:-1])
    got = kernels.flow_upscale(flow, cfg, hp, wp, *shape[-3:-1])
    assert torch.equal(got, want if flow.ndim == 4 else want[0])


def test_to_device_keeps_float32_for_its_callers():
    """to_device gives float32 unless asked for the frame's own dtype, and
    _prepare hands frames on unconverted only for the entry."""
    u8 = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert transfer.to_device(u8, "cpu").dtype == torch.float32
    assert transfer.to_device(torch.from_numpy(u8), "cpu").dtype == torch.float32
    own = transfer.to_device(u8, "cpu", own_dtype=True)
    assert own.dtype == torch.uint8 and torch.equal(own, torch.from_numpy(u8))
    assert transfer.to_device(u8.astype(np.uint16), "cpu", own_dtype=True).dtype == torch.float32
    cfg = operating_point(2, 4)
    img1, _, _ = tdis._prepare(u8, u8, cfg, "cpu", 0)
    assert img1.dtype == torch.float32 and img1.shape == (3, 4, 1)
    img1, _, _ = tdis._prepare(u8, u8, cfg, "cpu", 0, own_dtype=True)
    assert img1.dtype == torch.uint8 and img1.shape == (3, 4, 1)
