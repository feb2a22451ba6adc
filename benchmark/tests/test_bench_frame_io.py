"""The entry's roofline reader, frame_io_roofline, on synthetic traces: a
pair's bytes counted once each, the frames' in the dtype frame_pad's
kernel name gives, the share of both kernels' device time, and nothing
where frame_pad did not run (the PyTorch ops that pad and upscale carry
neither kernel's name), its name gives no known dtype, or the card has no
peaks."""

import dataclasses

import pytest

H100 = "NVIDIA H100 80GB HBM3"


def _reader():
    import harness

    return harness.reader("frame_io_roofline")


class _Run:
    """What a reader takes from a run: op2's parameters at Sintel's size."""

    def __init__(self, mode="flow", device_name=H100):
        from of_dis_tpu_torch import operating_point
        from reference.params import from_dict

        self.params = from_dict(dataclasses.asdict(operating_point(2, 1024, mode=mode)))
        self.width, self.height = 1024, 436
        self.extra = {"device_name": device_name}


def test_pair_bytes_at_op2():
    """uint8 frames in, padded float32 frames out (448 x 1024), the flow at
    scale 3 (56 x 128) in and at full size out: about 8.2 MB an op2 pair."""
    mod = _reader()
    want = 2 * 436 * 1024 + 2 * 448 * 1024 * 4 + 56 * 128 * 2 * 4 + 436 * 1024 * 2 * 4
    assert mod.pair_bytes(_Run().params, 1024, 436, 1) == want
    stereo = mod.pair_bytes(_Run("stereo").params, 1024, 436, 1)
    assert want - stereo == 56 * 128 * 4 + 436 * 1024 * 4  # one channel of flow
    # float32 frames (from files): the frames' read four times the bytes
    assert mod.pair_bytes(_Run().params, 1024, 436, 4) - want == 3 * 2 * 436 * 1024


U8 = "<unsigned char, 1, 4>(unsigned char const*, unsigned char const*, float*, int)"
F32 = "<float, 1, 4>(float const*, float const*, float*, int)"
UP = "(float const*, float*, int, int, int, int, int, int, int, float, float)"


@pytest.mark.parametrize("kernels,mode,device_name,want", [
    # both kernels, per pair twice the bytes' least time: 50 %
    ((("frame_pad_kernel" + U8, 1.0), ("flow_upscale_kernel" + UP, 1.0)), "flow", H100, 50.0),
    ((("frame_pad_kernel" + U8, 1.0), ("flow_upscale_kernel" + UP, 1.0)), "stereo", H100, 50.0),
    ((("frame_pad_kernel" + U8, 4.0),), "flow", H100, 25.0),  # one ran
    ((("index_elementwise_kernel", 1.0),), "flow", H100, None),  # neither: the parent
    ((("frame_pad_kernel" + U8, 1.0), ("flow_upscale_kernel" + UP, 1.0)), "flow", "cpu", None),
    # float32 frames: their bytes counted at 4 each, so the same times read more
    ((("frame_pad_kernel" + F32, 1.0), ("flow_upscale_kernel" + UP, 1.0)), "flow", H100,
     "float"),
    # frame_pad did not run, or ran in two dtypes, or its name gives none: no dtype
    ((("flow_upscale_kernel" + UP, 1.0),), "flow", H100, None),
    ((("frame_pad_kernel" + U8, 1.0), ("frame_pad_kernel" + F32, 1.0)), "flow", H100, None),
    ((("frame_pad_kernel", 1.0), ("flow_upscale_kernel" + UP, 1.0)), "flow", H100, None),
])
def test_frame_io_roofline(kernels, mode, device_name, want):
    from devtrace import TraceView
    from work import peak

    mod = _reader()
    run = _Run(mode, device_name)
    least_ns = mod.pair_bytes(run.params, 1024, 436, 1) / peak(H100)["bytes_per_s"] * 1e9
    if want == "float":
        want = 50.0 * mod.pair_bytes(run.params, 1024, 436, 4) / mod.pair_bytes(
            run.params, 1024, 436, 1)
    pairs, device, t = 32, [], 0
    for name, share in kernels:
        dur = int(round(pairs * least_ns * share))
        device.append((f"void (anonymous namespace)::{name}", t, t + dur))
        t += dur
    v = TraceView(device, [], 0, t + 1000, pairs=pairs, calls=1)
    got = mod.read(v, run)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-4)  # durations rounded to whole ns
