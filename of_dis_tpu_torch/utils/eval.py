"""Flow/disparity quality metrics + benchmark dataset loaders, the port's
own copy of of_dis_tpu/utils/eval.py (NumPy only; the loaders yield file
paths, which of_dis_tpu_torch.io reads).

The reference has no self-metrics (SURVEY.md §5): quality was checked by
uploading .flo/.pfm to the Sintel / Middlebury servers.  The north-star
metric is average end-point error (EPE); this module provides it plus the
standard loaders so runs can be scored locally.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def epe(flow: np.ndarray, gt: np.ndarray, valid: Optional[np.ndarray] = None) -> float:
    """Average end-point error: mean ||flow - gt||_2 over (valid) pixels."""
    flow = np.asarray(flow, np.float64)
    gt = np.asarray(gt, np.float64)
    err = np.sqrt(np.sum((flow - gt) ** 2, axis=-1))
    if valid is not None:
        err = err[valid.astype(bool)]
    return float(err.mean())


def flow_error_stats(flow: np.ndarray, gt: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> Dict[str, float]:
    """EPE plus the Sintel/KITTI-style outlier fractions."""
    err = np.sqrt(np.sum((np.asarray(flow, np.float64) - gt) ** 2, axis=-1))
    if valid is not None:
        err = err[valid.astype(bool)]
    mag = np.sqrt(np.sum(np.asarray(gt, np.float64) ** 2, axis=-1))
    if valid is not None:
        mag = mag[valid.astype(bool)]
    return {
        "epe": float(err.mean()),
        "epe_median": float(np.median(err)),
        "err_gt_1px": float((err > 1.0).mean()),
        "err_gt_3px": float((err > 3.0).mean()),
        "fl_all": float(((err > 3.0) & (err > 0.05 * np.maximum(mag, 1e-9))).mean()),
    }


def disparity_error_stats(disp: np.ndarray, gt: np.ndarray,
                          valid: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Middlebury-style disparity stats (abs error, badN)."""
    err = np.abs(np.asarray(disp, np.float64) - gt)
    if valid is not None:
        err = err[valid.astype(bool)]
    return {
        "avgerr": float(err.mean()),
        "bad_0.5": float((err > 0.5).mean()),
        "bad_1.0": float((err > 1.0).mean()),
        "bad_2.0": float((err > 2.0).mean()),
    }


# ---------------------------------------------------------------------------
# Dataset loaders
# ---------------------------------------------------------------------------

def sintel_pairs(root, split: str = "training", render: str = "final"
                 ) -> Iterator[Tuple[Path, Path, Optional[Path]]]:
    """Yield (frame_t, frame_t+1, gt_flow or None) paths for MPI-Sintel."""
    root = Path(root)
    img_dir = root / split / render
    flow_dir = root / split / "flow"
    for seq in sorted(p for p in img_dir.iterdir() if p.is_dir()):
        frames = sorted(seq.glob("frame_*.png"))
        for a, b in zip(frames[:-1], frames[1:]):
            gt = flow_dir / seq.name / (a.stem + ".flo")
            yield a, b, (gt if gt.exists() else None)


def middlebury_stereo_pairs(root) -> Iterator[Tuple[Path, Path, Optional[Path]]]:
    """Yield (left, right, gt .pfm or None) for Middlebury stereo layouts."""
    root = Path(root)
    for scene in sorted(p for p in root.iterdir() if p.is_dir()):
        l = scene / "im0.png"
        r = scene / "im1.png"
        gt = scene / "disp0GT.pfm"
        if l.exists() and r.exists():
            yield l, r, (gt if gt.exists() else None)
