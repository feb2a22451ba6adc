"""Image pyramid, gradients, padding and the final upscale, with OpenCV's
semantics (ConstructImgPyramide, run_dense.cpp:130-178, 298-311, 406-411):

  - 0.5x downscale: cv::resize(0.5, INTER_LINEAR), at an exact half scale a
    2x2 box average; k halvings in a row are one 2^k box average;
  - gradients: 3x3 cv::Sobel, scale 1/8, reflect-101 borders;
  - per-level padding by `pad`: replicate for images, zero for gradients;
  - divisibility padding: replicate, floor(pad/2) before, ceil after;
  - upscale: cv::resize INTER_LINEAR with half-pixel centres.

Tensors are channels-last (..., H, W, C); leading axes are pairs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_average(img: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box average, the batch folded into the rows so that each box
    is summed as it is for one image alone."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    s = img.reshape(-1, k, w // k, k, c).sum(dim=(1, 3))
    return s.reshape(*lead, h // k, w // k, c) * (1.0 / (k * k))


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.arange(-before, n + after, device=device).clamp_(0, n - 1)


def _reflect101(img: torch.Tensor, r: int) -> torch.Tensor:
    h, w = img.shape[-3:-1]

    def idx(n):
        i = torch.arange(-r, n + r, device=img.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return img[..., idx(h), :, :][..., idx(w), :]


def sobel(img: torch.Tensor):
    """dx, dy of cv::Sobel(ksize 3, scale 1/8, BORDER_DEFAULT), separable."""
    p = _reflect101(img, 1)
    diff_x = p[..., 2:, :] - p[..., :-2, :]
    smooth_x = p[..., :-2, :] + 2.0 * p[..., 1:-1, :] + p[..., 2:, :]
    dx = (diff_x[..., :-2, :, :] + 2.0 * diff_x[..., 1:-1, :, :] + diff_x[..., 2:, :, :]) * 0.125
    dy = (smooth_x[..., 2:, :, :] - smooth_x[..., :-2, :, :]) * 0.125
    return dx, dy


def pad_edges(img: torch.Tensor, t: int, b: int, l: int, r: int) -> torch.Tensor:
    h, w = img.shape[-3:-1]
    img = img[..., _edge_index(h, t, b, img.device), :, :]
    return img[..., _edge_index(w, l, r, img.device), :]


def divisibility_padding(h: int, w: int, divisor: int):
    padw = (-w) % divisor
    padh = (-h) % divisor
    return padh // 2, padh - padh // 2, padw // 2, padw - padw // 2


def pad_to_divisible(img: torch.Tensor, divisor: int) -> torch.Tensor:
    t, b, l, r = divisibility_padding(*img.shape[-3:-1], divisor)
    return pad_edges(img, t, b, l, r) if (t or b or l or r) else img


def build_pyramid(img: torch.Tensor, n_levels: int, pad: int, first_level: int):
    """Per level (padded image, padded dx, padded dy), index = scale; the
    scales finer than first_level are None."""
    imgs, dxs, dys = [], [], []
    cur = img
    for i in range(n_levels):
        if i < first_level:
            imgs.append(None), dxs.append(None), dys.append(None)
            continue
        if i == first_level and i > 0:
            cur = box_average(cur, 1 << i)
        elif i > 0:
            cur = box_average(cur, 2)
        dx, dy = sobel(cur)
        imgs.append(pad_edges(cur, pad, pad, pad, pad))
        dxs.append(F.pad(dx, (0, 0, pad, pad, pad, pad)))
        dys.append(F.pad(dy, (0, 0, pad, pad, pad, pad)))
    return imgs, dxs, dys


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::resize INTER_LINEAR: src = (dst + 0.5) * in / out - 0.5, taps
    clamped to the image; coordinates in the images' dtype."""
    in_h, in_w = img.shape[-3:-1]
    f = dict(dtype=img.dtype, device=img.device)
    fy = (torch.arange(out_h, **f) + 0.5) * (in_h / out_h) - 0.5
    fx = (torch.arange(out_w, **f) + 0.5) * (in_w / out_w) - 0.5
    y0 = torch.floor(fy).clamp(0, in_h - 1).long()
    x0 = torch.floor(fx).clamp(0, in_w - 1).long()
    y1 = (y0 + 1).clamp(max=in_h - 1)
    x1 = (x0 + 1).clamp(max=in_w - 1)
    wy = (fy - y0.to(img.dtype)).clamp(0.0, 1.0)[:, None, None]
    wx = (fx - x0.to(img.dtype)).clamp(0.0, 1.0)[None, :, None]
    r0 = img[..., y0, :, :]
    r1 = img[..., y1, :, :]
    top = r0[..., x0, :] * (1 - wx) + r0[..., x1, :] * wx
    bot = r1[..., x0, :] * (1 - wx) + r1[..., x1, :] * wx
    return top * (1 - wy) + bot * wy
