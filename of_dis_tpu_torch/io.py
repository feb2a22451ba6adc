"""Flow / depth / image file I/O.

Byte-compatible with the reference writers (run_dense.cpp:16-128):
  - Middlebury `.flo`: ASCII "PIEH" magic + int32 width,height + row-major
    float32 (u, v) pairs (SaveFlowFile, run_dense.cpp:16-57).
  - `.pfm`: "Pf\\n{w} {h}\\n{scale}\\n" header with scale -1.0 (little-endian),
    rows written bottom-up, and the disparity value NEGATED on write
    (SavePFMFile, run_dense.cpp:60-81 — internal left-camera disparity is <= 0
    per the clamp in patch.cpp:188-193, so the file holds positive values).

No OpenCV dependency.  Image loading uses PIL/imageio when available, and
reads .npy / .pgm / .ppm itself.  A copy of of_dis_tpu/io.py: where that
module uses the JAX package's C++ codec, this one uses the port's own
(native.py: .flo write and read, .pfm write, PNM input), built at first
use; the NumPy code beside it is the plain version and writes the same
bytes (tests/test_torch_config.py, tests/test_torch_host.py).
OF_DIS_NATIVE=0 runs the NumPy code only.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import native

_FLO_MAGIC = b"PIEH"
_FLO_MAGIC_FLOAT = 202021.25  # == struct.unpack('<f', b'PIEH')


def write_flo(path, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as Middlebury .flo (run_dense.cpp:16-57),
    through the C++ codec unless OF_DIS_NATIVE=0."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f".flo needs (H, W, 2), got {flow.shape}")
    if native.write_flo(path, flow):
        return
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(_FLO_MAGIC)
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(flow, dtype="<f4").tobytes())


def read_flo(path) -> np.ndarray:
    """Read Middlebury .flo into (H, W, 2) float32 (ReadFlowFile, run_dense.cpp:84-128)."""
    flow = native.read_flo(path)
    if flow is not None:
        return flow
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _FLO_MAGIC:
            raise ValueError(f"bad .flo magic {magic!r} in {path}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 2 * 4), dtype="<f4")
    return data.reshape(h, w, 2).copy()


def write_pfm(path, disparity: np.ndarray, negate: bool = True) -> None:
    """Write (H, W) float32 as grayscale .pfm (SavePFMFile, run_dense.cpp:60-81).

    negate=True replicates the reference's sign flip on write
    (run_dense.cpp:75).  Rows are stored bottom-up; scale -1.0 marks
    little-endian.
    """
    d = np.asarray(disparity, dtype=np.float32)
    if d.ndim != 2:
        raise ValueError(f".pfm needs (H, W), got {d.shape}")
    if native.write_pfm(path, d, negate):
        return
    h, w = d.shape
    out = -d if negate else d
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n{-1.0:f}\n".encode("ascii"))
        f.write(np.ascontiguousarray(out[::-1], dtype="<f4").tobytes())


def read_pfm(path, negate: bool = False) -> np.ndarray:
    """Read grayscale .pfm into (H, W) float32 (top-down row order)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"Pf":
            raise ValueError(f"only grayscale 'Pf' supported, got {header!r}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * 4), dtype=dtype)
    img = data.reshape(h, w)[::-1].astype(np.float32)
    return -img if negate else img


# ---------------------------------------------------------------------------
# Image loading (replaces cv::imread, run_dense.cpp:208-209)
# ---------------------------------------------------------------------------

def _bgr_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's fixed-point RGB->gray: (R*4899 + G*9617 + B*1868 + 8192) >> 14.

    Matches cv::imread(..., IMREAD_GRAYSCALE) on 8-bit input so the grayscale
    pipeline sees the same integers as the reference binaries.
    """
    r = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 2].astype(np.int64)
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def _read_pnm_numpy(path) -> np.ndarray:
    """Binary P5/P6 PNM reader (the plain version of native.read_pnm)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        if data[i : i + 1] == b"#":  # comment to end of line
            i = data.index(b"\n", i) + 1
            continue
        if data[i : i + 1].isspace():
            i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic not in (b"P5", b"P6") or maxval > 255:
        raise ValueError(f"unsupported PNM {magic!r} maxval={maxval} in {path}")
    c = 1 if magic == b"P5" else 3
    pix = np.frombuffer(data[i + 1 :], dtype=np.uint8, count=w * h * c)
    return pix.reshape(h, w, c).copy()


def load_image(path, channels: int = 1) -> np.ndarray:
    """Load an image as float32 (H, W, channels), channels in {1, 3}.

    Supports .npy, .pgm and .ppm plus anything PIL/imageio can decode.  Grayscale
    conversion uses OpenCV's integer formula for parity with the reference.
    RGB output keeps the decoded R,G,B order (the algorithm is symmetric in
    channels, so BGR vs RGB does not affect results).
    """
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
    elif path.suffix in (".pgm", ".ppm", ".pnm"):
        arr = native.read_pnm(path)
        if arr is None:
            arr = _read_pnm_numpy(path)
    else:
        arr = None
        try:
            from PIL import Image

            arr = np.asarray(Image.open(path))
        except ImportError:
            try:
                import imageio.v3 as iio

                arr = iio.imread(path)
            except ImportError as e:
                raise RuntimeError(
                    f"cannot decode {path}: neither PIL nor imageio available; "
                    "use .npy/.pgm/.ppm input instead"
                ) from e
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[2] == 4:
        arr = arr[..., :3]
    if channels == 1:
        if arr.shape[2] == 3:
            if arr.dtype == np.uint8:
                arr = _bgr_to_gray_u8(arr)[..., None]
            else:
                arr = (0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2])[..., None]
    elif channels == 3:
        if arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
    else:
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    return np.ascontiguousarray(arr, dtype=np.float32)
