"""Seeded image pairs, made on the device: textured 8-bit frames under a
smooth warp (flow) or a smooth horizontal disparity (stereo).

    img1, img2 = make_pairs(n, 436, 1024, channels=1, mode="flow", seed=s, device=dev)

A frame is uniform noise blurred by a Gaussian of sigma 2.5 and stretched
to 0..255, on a canvas 20 px larger on each side.  Flow: the second frame
samples the canvas bilinearly at (x + u, y + v), u and v Gaussian-blurred
(sigma 24) noise scaled to a peak of 6 and 4 px.  Stereo (the left camera's
frame first): it samples at x + d, d = 4 + blurred noise (sigma 30) of peak
2, so disparities lie in 2..6 px.  Values are truncated to uint8.  Each
pair has its own frame and field.

The blur is separable: a Gaussian truncated at 4 sigma with mirrored borders
(`scipy.ndimage.gaussian_filter`'s defaults), applied as a product with a
banded matrix along each axis, in float64.  All randomness comes from one
`torch.Generator` on the device seeded by `seed`, drawn in a fixed order in
blocks of `chunk` pairs, so a seed gives the same pairs on a given device
and build.
"""

from __future__ import annotations

import torch

MARGIN = 20


def _seeded(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def blur_matrix(n: int, sigma: float, device) -> torch.Tensor:
    """(n, n) float64 matrix M with (M x)[i] = sum_t g[t] x[mirror(i + t)],
    g the normalised Gaussian truncated at radius round(4 sigma)."""
    r = int(4.0 * sigma + 0.5)
    t = torch.arange(-r, r + 1, dtype=torch.float64)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = g / g.sum()
    i = torch.arange(n)[:, None] + torch.arange(-r, r + 1)[None, :]
    while bool(((i < 0) | (i >= n)).any()):  # mirror: d c b a | a b c d | d c b a
        i = torch.where(i < 0, -i - 1, i)
        i = torch.where(i >= n, 2 * n - i - 1, i)
    m = torch.zeros((n, n), dtype=torch.float64)
    m.scatter_add_(1, i, g.expand(n, -1).contiguous())
    return m.to(device)


def _blur(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """x (k, H, W) float64 blurred along both axes."""
    return mh @ x @ mw.T


def _smooth_field(g, k: int, h: int, w: int, sigma: float, amp: float, device):
    """k fields (k, h, w) float64 of blurred normal noise, each scaled to a
    peak magnitude of amp."""
    f = torch.randn((k, h, w), generator=g, device=device, dtype=torch.float32).double()
    f = _blur(f, blur_matrix(h, sigma, device), blur_matrix(w, sigma, device))
    return f / (f.abs().amax(dim=(1, 2), keepdim=True) + 1e-9) * amp


def _bilinear(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img (k, Hc, Wc, C) sampled at rows yy and columns xx (k, h, w)."""
    k, hc, wc, c = img.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    ry, rx = (yy - y0)[..., None], (xx - x0)[..., None]
    y0, x0 = y0.long().clamp(0, hc - 2), x0.long().clamp(0, wc - 2)
    flat = img.reshape(k, hc * wc, c)

    def at(y, x):
        idx = (y * wc + x).reshape(k, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, c)

    top = at(y0, x0) * (1 - rx) + at(y0, x0 + 1) * rx
    bot = at(y0 + 1, x0) * (1 - rx) + at(y0 + 1, x0 + 1) * rx
    return top * (1 - ry) + bot * ry


def make_pairs(n: int, h: int, w: int, channels: int, mode: str, seed: int, device,
               chunk: int = 8):
    """n pairs as two uint8 tensors on `device`: (n, h, w) for one channel,
    (n, h, w, 3) for three."""
    device = torch.device(device)
    g = _seeded(seed, device)
    hc, wc = h + 2 * MARGIN, w + 2 * MARGIN
    mh, mw = blur_matrix(hc, 2.5, device), blur_matrix(wc, 2.5, device)
    yy0 = torch.arange(h, dtype=torch.float64, device=device)[:, None].expand(h, w) + MARGIN
    xx0 = torch.arange(w, dtype=torch.float64, device=device)[None, :].expand(h, w) + MARGIN
    out1, out2 = [], []
    for s in range(0, n, chunk):
        k = min(chunk, n - s)
        noise = torch.rand((k, channels, hc, wc), generator=g, device=device,
                           dtype=torch.float32).double()
        base = _blur(noise.reshape(k * channels, hc, wc), mh, mw).reshape(k, channels, hc, wc)
        lo = base.amin(dim=(1, 2, 3), keepdim=True)
        hi = base.amax(dim=(1, 2, 3), keepdim=True)
        base = ((base - lo) / (hi - lo) * 255.0).permute(0, 2, 3, 1).contiguous()
        if mode == "flow":
            u = _smooth_field(g, k, h, w, 24.0, 6.0, device)
            v = _smooth_field(g, k, h, w, 24.0, 4.0, device)
        elif mode == "stereo":
            u = 4.0 + _smooth_field(g, k, h, w, 30.0, 2.0, device)
            v = torch.zeros_like(u)
        else:
            raise ValueError(f"mode must be 'flow' or 'stereo', got {mode!r}")
        img1 = base[:, MARGIN:MARGIN + h, MARGIN:MARGIN + w]
        img2 = _bilinear(base, yy0 + v, xx0 + u)
        for dst, im in ((out1, img1), (out2, img2)):
            im = torch.floor(im).clamp_(0, 255).to(torch.uint8)
            dst.append(im[..., 0] if channels == 1 else im)
    return torch.cat(out1), torch.cat(out2)
