"""Frame-pair batching on one card, PyTorch port of
of_dis_tpu/parallel/batch.py (`_batched_padded`, `batched_flow`, :35-72).

The JAX package vmaps the single-pair driver, which gives every Pallas
kernel a leading batch dimension in its grid.  Here the driver itself runs
on a batch axis (models/dis.py): each stage is a batched PyTorch op, and
each CUDA kernel launch takes all B pairs, so one batch costs the launches
of one pair (3 level_search and 3 refine_inner at op2, whatever B is).

    flow = batched_flow(imgs1, imgs2, cfg)                # (B, H, W, nop), on the card
    flow = batched_flow(imgs1, imgs2, cfg, device="cpu")  # the plain versions

Each pair's output equals its own `dis_raw` bit for bit.  The port runs on
one card: there is no device mesh (the JAX package's `data_mesh` and
`mesh=` wait for spatial sharding).
"""

from __future__ import annotations

import torch

from ..config import DISConfig
from ..models.dis import _dis_batch, _dis_padded, _prepare


def _batched_padded(imgs1: torch.Tensor, imgs2: torch.Tensor, cfg: DISConfig) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B, h_l, w_l, nop) at scale sc_l; inputs pre-padded
    to divisibility by 2^sc_f."""
    return _dis_padded(imgs1, imgs2, cfg)


def batched_flow(imgs1, imgs2, cfg: DISConfig, device=None) -> torch.Tensor:
    """Flow (or disparity) for a batch of frame pairs (B, H, W[, C]) ->
    (B, H, W, nop), with dis_raw's divisibility padding, final upscale and
    crop.  Inputs are numpy arrays or tensors; the result is a float32
    tensor on `device` (CUDA unless given; without a GPU it raises)."""
    img1, img2, _ = _prepare(imgs1, imgs2, cfg, device, 1)
    return _dis_batch(img1, img2, cfg)
