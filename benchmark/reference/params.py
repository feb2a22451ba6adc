"""The DIS parameters a configuration states (the upstream OFClass
arguments and optparam fields, oflow.h:31-111, run_dense.cpp:225-294),
with the quantities derived from them (oflow.cpp:75-108)."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Params:
    mode: str            # "flow" (2 parameters per pixel) or "stereo" (1)
    channels: int        # 1 gray, 3 RGB
    sc_f: int            # coarsest scale
    sc_l: int            # finest computed scale
    max_iter: int
    min_iter: int
    dp_thresh: float     # mindprate, squared where used (oflow.cpp:88)
    dr_thresh: float     # mindrrate
    res_thresh: float    # minimgerr
    patch_size: int
    overlap: float
    use_fb_merge: bool
    cost: int            # 0 L2, 1 L1, 2 pseudo-Huber, 10 NCC
    patch_norm: bool
    use_tv_refine: bool
    tv_alpha: float
    tv_gamma: float
    tv_delta: float
    tv_innerit: int
    tv_solverit: int
    tv_sor: float
    camlr: int           # stereo: 0 left camera (disparity <= 0), 1 right
    verbosity: int
    minerrval: float
    normoutlier: float
    fratio: int

    @property
    def nop(self) -> int:
        return 2 if self.mode == "flow" else 1

    @property
    def steps(self) -> int:
        return max(1, int(math.floor(self.patch_size * (1.0 - self.overlap))))

    @property
    def outlier_thresh(self) -> float:
        return float(self.patch_size) / 2.0

    @property
    def novals(self) -> int:
        return self.channels * self.patch_size * self.patch_size


def from_dict(d: dict) -> Params:
    """Params from a configuration file's `params` object; every field is
    required and no other key is taken."""
    names = {f.name for f in dataclasses.fields(Params)}
    if set(d) != names:
        raise ValueError(f"params: missing {sorted(names - set(d))}, "
                         f"unknown {sorted(set(d) - names)}")
    p = Params(**d)
    if p.mode not in ("flow", "stereo") or p.channels not in (1, 3) or p.patch_size % 2:
        raise ValueError(f"params out of range: {p}")
    if p.cost != 0 or p.use_fb_merge:
        raise ValueError("the reference computes the L2 cost without the forward-backward "
                         f"merge; got cost {p.cost}, use_fb_merge {p.use_fb_merge}")
    return p
