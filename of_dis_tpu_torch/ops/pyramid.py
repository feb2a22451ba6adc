"""Image pyramid, gradients, resize and padding ops (PyTorch port of
of_dis_tpu/ops/pyramid.py), with exact OpenCV semantics for the operations
that shape the numerics (ConstructImgPyramide, run_dense.cpp:130-178):

  - 0.5x downscale = cv::resize(..., 0.5, 0.5, INTER_LINEAR), which at an
    exact half-scale is a 2x2 box average (run_dense.cpp:150).
  - Gradients = 3x3 cv::Sobel, scale 1/8, BORDER_DEFAULT (= reflect-101)
    (run_dense.cpp:156-157).
  - Per-level padding by `pad` pixels: replicate for images, zero for
    gradients (run_dense.cpp:163-177).
  - Input divisibility padding: replicate, floor(pad/2) before / ceil after
    (run_dense.cpp:298-311).
  - Final flow upscale = cv::resize INTER_LINEAR with half-pixel centers
    (run_dense.cpp:406-411), written out as its formula.

All functions take channels-last float32 tensors (..., H, W, C): any
leading dims are a batch of image pairs, and each image is computed as it
would be alone.  They work on the tensor's own device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def box_average(img: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k box average; k divides H and W.  The batch is
    folded into the rows, so the reduction sees one image's layout and
    sums each box in the order it sums it for one image alone."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    if h % k or w % k:
        raise ValueError(f"dims {h}x{w} not divisible by {k}")
    s = img.reshape(-1, k, w // k, k, c).sum(dim=(1, 3))
    return s.reshape(*lead, h // k, w // k, c) * (1.0 / (k * k))


def downsample_half(img: torch.Tensor) -> torch.Tensor:
    """Exact cv::resize(0.5, INTER_LINEAR): 2x2 box average. Needs even H, W."""
    return box_average(img, 2)


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Row/column indices of an edge-replicated padding."""
    return torch.arange(-before, n + after, device=device).clamp_(0, n - 1)


def _reflect101_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba), OpenCV's BORDER_DEFAULT."""
    h, w = img.shape[-3:-1]

    def idx(n):
        i = torch.arange(-r, n + r, device=img.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return img[..., idx(h), :, :][..., idx(w), :]


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy with scale 1/8 and reflect-101 borders.

    Matches cv::Sobel(src, CV_32F, 1, 0, 3, 1/8.0, 0, BORDER_DEFAULT)
    (run_dense.cpp:156-157).  Separable: smooth [1,2,1] x diff [-1,0,1].
    """
    p = _reflect101_pad(img, 1)
    diff_x = p[..., 2:, :] - p[..., :-2, :]
    smooth_x = p[..., :-2, :] + 2.0 * p[..., 1:-1, :] + p[..., 2:, :]
    dx = (diff_x[..., :-2, :, :] + 2.0 * diff_x[..., 1:-1, :, :] + diff_x[..., 2:, :, :]) * 0.125
    dy = (smooth_x[..., 2:, :, :] - smooth_x[..., :-2, :, :]) * 0.125
    return dx, dy


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Gradient-magnitude input image (reference SELECTCHANNEL==2,
    run_dense.cpp:138-147): sqrt(sobel_dx^2 + sobel_dy^2)."""
    dx, dy = sobel(img)
    return torch.sqrt(dx * dx + dy * dy)


def _pad_edges(img: torch.Tensor, t: int, b: int, l: int, r: int) -> torch.Tensor:
    """Edge-replicating padding of the (H, W) axes of (..., H, W, C)."""
    h, w = img.shape[-3:-1]
    rows = _edge_index(h, t, b, img.device)
    return img[..., rows, :, :][..., _edge_index(w, l, r, img.device), :]


def pad_replicate(img: torch.Tensor, pad: int) -> torch.Tensor:
    return _pad_edges(img, pad, pad, pad, pad)


def pad_zero(img: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))


def divisibility_padding(h: int, w: int, divisor: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) replicate-padding so divisor | H and W
    (run_dense.cpp:298-311): floor(pad/2) before, ceil(pad/2) after."""
    padw = (-w) % divisor
    padh = (-h) % divisor
    return (padh // 2, padh - padh // 2, padw // 2, padw - padw // 2)


def pad_to_divisible(img: torch.Tensor, divisor: int) -> torch.Tensor:
    h, w = img.shape[-3:-1]
    t, b, l, r = divisibility_padding(h, w, divisor)
    if t or b or l or r:
        img = _pad_edges(img, t, b, l, r)
    return img


def build_pyramid(
    img: torch.Tensor, n_levels: int, pad: int, gradmag_input: bool = False,
    first_level: int = 0,
) -> Tuple[List, List, List]:
    """Per-level (padded image, padded dx, padded dy), index 0 = finest.

    Level 0 is the input (or its gradient magnitude); level i is the 0.5x
    downscale of level i-1.  Images are replicate-padded by `pad`, gradients
    zero-padded (ConstructImgPyramide, run_dense.cpp:130-178).  Levels finer
    than `first_level` are not built (their slots are None): the chain of
    2x2 box averages down to `first_level` collapses into one 2^k box
    average, equal up to float reassociation.
    """
    levels = []
    cur = gradient_magnitude(img) if gradmag_input else img
    for i in range(n_levels):
        if i < first_level:
            levels.append(None)
            continue
        if i == first_level and i > 0:
            cur = box_average(cur, 1 << i)
        elif i > 0:
            cur = downsample_half(cur)
        levels.append(cur)
    imgs, dxs, dys = [], [], []
    for lv in levels:
        if lv is None:
            imgs.append(None)
            dxs.append(None)
            dys.append(None)
            continue
        dx, dy = sobel(lv)
        imgs.append(pad_replicate(lv, pad))
        dxs.append(pad_zero(dx, pad))
        dys.append(pad_zero(dy, pad))
    return imgs, dxs, dys


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::resize INTER_LINEAR with half-pixel centers (float path).

    src = (dst + 0.5) * (in/out) - 0.5, taps clamped to the image
    (run_dense.cpp:406-411 uses this for the final flow upscale).
    """
    in_h, in_w = img.shape[-3:-1]
    dev = img.device
    fy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (in_h / out_h) - 0.5
    fx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (in_w / out_w) - 0.5
    y0 = torch.floor(fy).clamp(0, in_h - 1).long()
    x0 = torch.floor(fx).clamp(0, in_w - 1).long()
    y1 = (y0 + 1).clamp(max=in_h - 1)
    x1 = (x0 + 1).clamp(max=in_w - 1)
    wy = (fy - y0.float()).clamp(0.0, 1.0)[:, None, None]
    wx = (fx - x0.float()).clamp(0.0, 1.0)[None, :, None]
    r0 = img[..., y0, :, :]
    r1 = img[..., y1, :, :]
    top = r0[..., x0, :] * (1 - wx) + r0[..., x1, :] * wx
    bot = r1[..., x0, :] * (1 - wx) + r1[..., x1, :] * wx
    return top * (1 - wy) + bot * wy
