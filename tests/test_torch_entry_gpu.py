"""The entry's two kernels on the card (csrc/frame_io.cu: frame_pad and
flow_upscale, ops/kernels.py) bit-equal to their plain versions, and the
entry's executable (models/dis.py::dis_entry_jit, the frames' padding, the
padded pipeline and the final upscale and crop in one CUDA graph) bit-equal
to the eager composition it replaced, with the full-resolution goldens'
digits unchanged and one launch of each kernel per call.  Marked `gpu` and
skipped without a CUDA device.  This file imports no JAX and no conftest
fixture, so on a machine with a GPU and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_entry_gpu.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import batched_flow, dis_flow, dis_stereo, eager, io, operating_point
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.ops import kernels
from of_dis_tpu_torch.ops import pyramid as pyr
from of_dis_tpu_torch.ops.transfer import to_device

pytestmark = pytest.mark.gpu

FULLRES = Path(__file__).resolve().parent / "goldens" / "fullres"
SIZES = [(436, 1024), (448, 1024), (375, 1242)]  # padded, already divisible, odd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(shape, dtype, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    if dtype == torch.float32:  # not whole numbers: every bit of a float frame is copied
        x = x.float() + torch.rand(shape, generator=g)
    return x.to(device)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,c", [(1, 1), (1, 3), (32, 1), (32, 3)])
def test_frame_pad_matches_plain(cuda, size, dtype, b, c):
    a, bb = (_frames((b, *size, c), dtype, s, cuda) for s in (1, 2))
    kernels.reset_launches()
    p1, p2 = kernels.frame_pad(a, bb, 32)
    torch.cuda.synchronize()
    assert kernels.launches["frame_pad"] == 1
    for got, x in ((p1, a), (p2, bb)):
        want = pyr.pad_to_divisible(x.to(torch.float32), 32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want)
    if b == 1:  # one pair's frames, without the batch axis
        q1, q2 = kernels.frame_pad(a[0], bb[0], 32)
        assert torch.equal(q1, p1[0]) and torch.equal(q2, p2[0])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sc_l", [0, 3])
@pytest.mark.parametrize("b,nop", [(1, 1), (1, 2), (32, 1), (32, 2)])
def test_flow_upscale_matches_plain(cuda, size, sc_l, b, nop):
    cfg = dataclasses.replace(operating_point(2, size[1], mode="flow" if nop == 2 else "stereo"),
                              sc_f=5, sc_l=sc_l).validate()
    h0, w0 = size
    hp, wp = -(-h0 // 32) * 32, -(-w0 // 32) * 32
    g = torch.Generator(device="cpu").manual_seed(b * 10 + nop + sc_l)
    flow = (torch.randn((b, hp >> sc_l, wp >> sc_l, nop), generator=g) * 4).to(cuda)
    kernels.reset_launches()
    got = kernels.flow_upscale(flow, cfg, hp, wp, h0, w0)
    torch.cuda.synchronize()
    assert kernels.launches["flow_upscale"] == 1
    want = tdis._upscale_crop(flow, cfg, hp, wp, h0, w0)
    assert got.shape == (b, h0, w0, nop) and got.is_contiguous()
    assert torch.equal(got, want)
    if b == 1:
        assert torch.equal(kernels.flow_upscale(flow[0], cfg, hp, wp, h0, w0), got[0])
        # a strided view, as the densified flow is without refinement
        strided = torch.cat([flow, flow], dim=-1)[..., :nop]
        assert not strided.is_contiguous()
        assert torch.equal(kernels.flow_upscale(strided, cfg, hp, wp, h0, w0), got)


def _sintel_pair(mode, seed, b=None):
    """Seeded 1024x436 uint8 pairs: a smooth texture, the second frame moved."""
    rng = np.random.RandomState(seed)
    n = 1 if b is None else b
    base = rng.rand(n, 436 + 16, 1024 + 16)
    for _ in range(3):
        base = sum(np.roll(np.roll(base, y, 1), x, 2) for y in (-1, 0, 1) for x in (-1, 0, 1)) / 9
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.uint8)
    dy = 0 if mode == "stereo" else -2
    a, bb = base[:, 8:444, 8:1032], base[:, 8 + dy:444 + dy, 11:1035]
    return (a[0], bb[0]) if b is None else (a, bb)


def _eager_composition(a, b, cfg):
    """The entry as it was composed before it became one executable: frames
    to float32 on the card, divisibility padding, the padded pipeline,
    upscale and crop, op by op."""
    with eager():
        x1, x2 = (to_device(x, "cuda")[..., None] for x in (a, b))
        scf = 1 << cfg.sc_f
        p1, p2 = pyr.pad_to_divisible(x1, scf), pyr.pad_to_divisible(x2, scf)
        flow = tdis._dis_padded(p1, p2, cfg)
        return tdis._upscale_crop(flow, cfg, p1.shape[1], p1.shape[2], *x1.shape[1:3])


@pytest.mark.parametrize("entry,op", [("dis_flow", 2), ("dis_stereo", 2), ("batched_flow", 2),
                                      ("dis_flow", 1)])  # op1: no refinement
def test_entry_equals_eager_composition(cuda, entry, op):
    mode = "stereo" if entry == "dis_stereo" else "flow"
    cfg = operating_point(op, 1024, mode=mode)
    for seed in (3, 4):
        if entry == "batched_flow":
            a, b = _sintel_pair(mode, seed, b=4)
            got = batched_flow(a, b, cfg, device=cuda)
            want = _eager_composition(a, b, cfg)
        else:
            a, b = _sintel_pair(mode, seed)
            fn = dis_stereo if mode == "stereo" else dis_flow
            got = fn(a, b, cfg, device=cuda)
            want = _eager_composition(a[None], b[None], cfg)[0]
            want = want[..., 0] if mode == "stereo" else want
        assert torch.equal(got, want)
        assert float(got.abs().max()) > 0.5


def _epe(a, b) -> float:
    """chip_smoke.py's end-point error of a result against its golden."""
    return float(np.mean(np.sqrt(np.sum((a - b) ** 2, axis=-1))))


@pytest.mark.parametrize("case,op,mode,digits", [
    ("of_int_op2", 2, "flow", "0.04405100"),
    ("of_int_op4", 4, "flow", "0.01833576"),
    ("de_int_op2", 2, "stereo", "0.02969543"),
])
def test_fullres_goldens_same_digits(cuda, case, op, mode, digits):
    """The upstream binaries' full-resolution outputs: the mean end-point
    error of the card's result reads the digits it read before the entry
    became one executable (PERF.md)."""
    files = ("de1.png", "de2.png") if mode == "stereo" else ("of1.png", "of2.png")
    img1, img2 = (io.load_image(FULLRES / f, 1) for f in files)
    cfg = operating_point(op, img1.shape[1], mode=mode)
    if mode == "stereo":
        out = dis_stereo(img1, img2, cfg, device=cuda)[..., None]
    else:
        out = dis_flow(img1, img2, cfg, device=cuda)
    golden = np.load(FULLRES / f"{case}.npz")["ref"].astype(np.float32)
    assert f"{_epe(out.cpu().numpy(), golden):.8f}" == digits


@pytest.mark.parametrize("entry", ["dis_flow", "batched_flow"])
def test_one_launch_of_each_per_call(cuda, entry):
    """Each replay of the entry's executable launches frame_pad and
    flow_upscale once, whatever the batch."""
    cfg = operating_point(2, 1024)
    if entry == "batched_flow":
        a, b = _sintel_pair("flow", 5, b=8)
        call = lambda: batched_flow(a, b, cfg, device=cuda)  # noqa: E731
    else:
        a, b = _sintel_pair("flow", 5)
        call = lambda: dis_flow(a, b, cfg, device=cuda)  # noqa: E731
    call()  # captures
    kernels.reset_launches()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    assert kernels.launches["frame_pad"] == 3 and kernels.launches["flow_upscale"] == 3
    assert kernels.launches["level_search"] == 3 * 3 and kernels.launches["refine_inner"] == 3 * 3


def test_entry_wrappers_reject_bad_inputs(cuda):
    a = torch.zeros((1, 40, 50, 2), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # C = 2
        kernels.frame_pad(a, a, 32)
    cfg = operating_point(2, 1024)
    flow = torch.zeros((1, 8, 8, 2), device=cuda)
    with pytest.raises(ValueError):  # not the flow of a 72x72 padded frame at scale 3
        kernels.flow_upscale(flow, cfg, 72, 72, 60, 60)
    with pytest.raises(TypeError):
        kernels.flow_upscale(flow.double(), cfg, 64, 64, 60, 60)
    with pytest.raises(ValueError):  # nop 1 for a flow configuration
        kernels.flow_upscale(flow[..., :1].contiguous(), cfg, 64, 64, 60, 60)
