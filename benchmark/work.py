"""The work the algorithm needs, per pair, from a configuration and the
image size alone: bytes (each input byte read once, each output byte
written once, per launch) and FP32 operations of each stage that a kernel
of the program implements, and the least time the card's peaks allow.

    w = pair_work(params, 1024, 436)     # {"level_search": (bytes, ops), ...}
    bound_s(*w["level_search"], peak)    # seconds: max(bytes / B/s, ops / FLOP/s)

Operation counts per value (from the kernels' arithmetic):
  level search  per patch value: ~10 for the template and Hessian, ~20 per
                Gauss-Newton trip, 2 for the densification weight; every
                patch is counted at max_iter + 1 trips (OptimizeStart and
                max_iter iterations; at min_iter == max_iter only an outlier
                reset stops a patch sooner);
  refine inner  per pixel and inner iteration: ~17 smoothness + 60 C + 15
                data term + 27 right-hand side and diagonal, 28 per SOR sweep;
  sor scalar    per pixel and sweep: ~16, for tv_innerit * (level + 1)
                launches of tv_solverit sweeps per level (stereo).
A level of scale sl has the padded image's size >> sl; level images carry a
border of patch_size pixels.  The names are the stages', whatever kernel
implements them: a fused or renamed kernel is held to the same work.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

F32 = 4  # bytes


def level_shapes(params, width: int, height: int):
    """(scale, level width, level height) from sc_f down to sc_l, of the
    image padded to a multiple of 2^sc_f."""
    d = 1 << params.sc_f
    wp, hp = -(-width // d) * d, -(-height // d) * d
    return [(sl, wp >> sl, hp >> sl) for sl in range(params.sc_f, params.sc_l - 1, -1)]


def _patches(w: int, h: int, steps: int) -> int:
    return int(math.ceil(w / steps)) * int(math.ceil(h / steps))


def search_work(params, w: int, h: int) -> Tuple[float, float]:
    """One level's search of one pair: the padded level images (reference
    image, its two gradients, the target) and patch centres and starts in;
    per patch the parameters, the query position and psz^2 weights, and the
    two flags out."""
    n = _patches(w, h, params.steps)
    psz2, c, nop = params.patch_size ** 2, params.channels, params.nop
    pad = params.patch_size
    image = (h + 2 * pad) * (w + 2 * pad) * c
    nbytes = F32 * (4 * image + 2 * n + n * nop + n * (nop + 2 + psz2 + 2))
    trips = n * (params.max_iter + 1)
    nops = psz2 * c * (10.0 * n + 20.0 * trips + 2.0 * n)
    return float(nbytes), nops


def refine_inner_work(params, w: int, h: int, n_inner: int) -> Tuple[float, float]:
    """One level's inner loop of the flow refinement: the flow (2), the
    mask and 8 derivative images in, the refined flow (2) out."""
    c = params.channels
    return float(F32 * h * w * (3 + 8 * c + 2)), h * w * n_inner * (59.0 + 60.0 * c
                                                                     + 28.0 * params.tv_solverit)


def sor_scalar_work(params, w: int, h: int) -> Tuple[float, float]:
    """One scalar SOR solve: 5 fields in, 1 out, tv_solverit sweeps."""
    return float(F32 * 6 * h * w), 16.0 * h * w * params.tv_solverit


def pair_work(params, width: int, height: int) -> Dict[str, Tuple[float, float]]:
    """{stage: (bytes, FP32 operations)} for one pair, summed over levels."""
    out: Dict[str, Tuple[float, float]] = {}

    def add(name, work):
        b, o = out.get(name, (0.0, 0.0))
        out[name] = (b + work[0], o + work[1])

    for sl, w, h in level_shapes(params, width, height):
        add("level_search", search_work(params, w, h))
        if not params.use_tv_refine:
            continue
        n_inner = params.tv_innerit * (sl + 1)
        if params.nop == 2:
            add("refine_inner", refine_inner_work(params, w, h, n_inner))
        else:
            for _ in range(n_inner):
                add("sor_scalar", sor_scalar_work(params, w, h))
    return out


PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak(device_name: str) -> Optional[dict]:
    """The card's published peaks ({"bytes_per_s", "fp32_flops_per_s"}), or
    None for a card the table does not hold."""
    return json.loads(PEAKS.read_text()).get(device_name)


def bound_s(nbytes: float, nops: float, pk: dict) -> float:
    return max(nbytes / pk["bytes_per_s"], nops / pk["fp32_flops_per_s"])
