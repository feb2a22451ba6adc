"""The entry's full-resolution passes' share of their roofline in the
traced window, in %: the least time the card's peaks allow for one pair's
bytes through the two kernels, frame_pad and flow_upscale, over their
device time per pair.  Each byte counts once: both frames read in their
dtype, both padded float32 frames written, the flow at scale sc_l read,
the cropped full-resolution flow written; a handful of operations per
value, so bytes bound them.  The frames' dtype is the T of the
frame_pad_kernel<T, C, V> instances the window ran (uint8 from the cells'
inputs, float32 from files).  None where frame_pad did not run or names no
dtype of the table (a program that pads with PyTorch ops, or one pair's
frames in two dtypes), or the card is not in the table of peaks."""

import re

from devtrace import port_kernels
from work import F32, bound_s, peak

KERNELS = ("frame_pad", "flow_upscale")
ELEMENT_BYTES = {"unsigned char": 1, "float": F32}  # frame_pad_kernel's T


def frame_bytes(view):
    """Bytes per frame element: the one T of every frame_pad kernel the
    window ran, or None."""
    match = port_kernels().get("frame_pad")
    if match is None:
        return None
    pattern = re.compile(re.escape(match) + r"<\s*([^,>]+?)\s*,")
    types = {m.group(1) for m in (pattern.search(name) for name, _, _ in view.device) if m}
    return ELEMENT_BYTES.get(types.pop()) if len(types) == 1 else None


def pair_bytes(params, width: int, height: int, element_bytes: int) -> float:
    d, c, sc = 1 << params.sc_f, params.channels, params.sc_l
    wp, hp = -(-width // d) * d, -(-height // d) * d
    frames = 2 * height * width * c * element_bytes
    padded = 2 * hp * wp * c * F32
    flow_in = (hp >> sc) * (wp >> sc) * params.nop * F32
    flow_out = height * width * params.nop * F32
    return float(frames + padded + flow_in + flow_out)


def read(view, run):
    times = [t for t in (view.kernel_seconds(k) for k in KERNELS) if t is not None]
    pk = peak(run.extra.get("device_name", ""))
    element = frame_bytes(view)
    if not times or pk is None or element is None or not view.pairs:
        return None
    nbytes = pair_bytes(run.params, run.width, run.height, element)
    return 100.0 * bound_s(nbytes, 0.0, pk) / (sum(times) / view.pairs)
