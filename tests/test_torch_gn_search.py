"""Port (of_dis_tpu_torch) vs JAX package: the GN search over prebuilt
templates (the plain version of csrc/gn_search.cu) against JAX
optimize_level given build_templates (its XLA loop on the CPU), at 12-px
patches (op3/op4), flow and stereo, gray and RGB, on level 1 of the small
goldens' 8-bit input pair (tests/goldens/of1.png, of2.png), which the op3
and op4 goldens run.  Tolerances are those of
tests/test_torch_inverse_search.py: sums reassociate, which moves p by a
few ULP and the densification weights by < 1 % on < 1 % of cells."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_util import GOLD
from of_dis_tpu import DISConfig, io
from of_dis_tpu.models.densify import result_absw
from of_dis_tpu.models.grid import level_geometry
from of_dis_tpu.models.inverse_search import build_templates, optimize_level
from of_dis_tpu.ops import pyramid as pyr
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import densify as tdens
from of_dis_tpu_torch.models import inverse_search as tsearch
from of_dis_tpu_torch.ops import kernels


def _level(mode, c):
    img1, img2 = (io.load_image(os.path.join(GOLD, f), c) for f in ("of1.png", "of2.png"))
    nop = 2 if mode == "flow" else 1
    cfg = DISConfig(
        mode=mode, channels=c, sc_f=1, sc_l=0, max_iter=8, min_iter=8,
        patch_size=12, overlap=0.75, use_tv_refine=False,
    ).validate()
    pad = cfg.patch_size
    im1s, dx1s, dy1s = pyr.build_pyramid(jnp.asarray(img1), 2, pad)
    im2s, _, _ = pyr.build_pyramid(jnp.asarray(img2), 2, pad)
    sl = 1
    lw, lh = img1.shape[1] >> sl, img1.shape[0] >> sl
    geo = level_geometry(lw, lh, cfg)
    p0 = np.random.RandomState(5).randn(geo.n_patches, nop).astype(np.float32) * 1.5
    arrays = [np.array(a) for a in (im1s[sl], dx1s[sl], dy1s[sl], im2s[sl])]
    return cfg, arrays, geo, p0, (lw, lh, pad)


@pytest.mark.parametrize("mode,c,camlr", [
    ("flow", 1, 0), ("flow", 3, 0), ("stereo", 1, 0), ("stereo", 3, 1),
])
def test_gn_search_plain_matches_jax(mode, c, camlr):
    cfg, (ima, dxa, dya, imb), geo, p0, (lw, lh, pad) = _level(mode, c)
    cfg = dataclasses.replace(cfg, camlr=camlr)
    ptr = jnp.asarray(geo.pt_ref)
    tmpl = build_templates(jnp.asarray(ima), jnp.asarray(dxa), jnp.asarray(dya), ptr, cfg, pad)
    ref = optimize_level(jnp.asarray(imb), tmpl, ptr, jnp.asarray(p0), cfg, lw, lh, pad)

    tcfg = from_reference(dataclasses.asdict(cfg))
    pt_ref = torch.as_tensor(geo.pt_ref)
    ttmpl = tsearch.build_templates(*[torch.as_tensor(a) for a in (ima, dxa, dya)], pt_ref,
                                    tcfg, pad)
    # the wrapper takes the plain version for CPU tensors
    ours = kernels.gn_search(torch.as_tensor(imb), ttmpl, pt_ref, torch.as_tensor(p0), tcfg,
                             lw, lh, pad)

    n, psz = geo.n_patches, cfg.patch_size
    assert ours.pweight.shape == (n, psz, psz, c)
    assert ours.absw is None and ours.iters.shape == (n,)
    np.testing.assert_allclose(ours.p.numpy(), np.asarray(ref.p), atol=2e-3)
    np.testing.assert_allclose(ours.pt.numpy(), np.asarray(ref.pt), atol=2e-3)
    np.testing.assert_allclose(tdens.result_absw(ours, tcfg).numpy(),
                               np.asarray(result_absw(ref, cfg)), rtol=1e-2, atol=1e-4)
    assert (ours.converged.numpy() == np.asarray(ref.converged)).mean() >= 0.99
    if mode == "stereo":  # the sign clamp of the camera
        p = ours.p.numpy()
        assert (p <= 0).all() if camlr == 0 else (p >= 0).all()


def test_gn_and_level_routes_agree():
    """The two plain searches are one function: prebuilt templates give the
    whole-level search's result exactly."""
    cfg, (ima, dxa, dya, imb), geo, p0, (lw, lh, pad) = _level("flow", 1)
    tcfg = from_reference(dataclasses.asdict(cfg))
    t = [torch.as_tensor(a) for a in (ima, dxa, dya, imb)]
    pt_ref, p_init = torch.as_tensor(geo.pt_ref), torch.as_tensor(p0)
    lvl = tsearch.level_search_reference(*t, pt_ref, p_init, tcfg, lw, lh, pad)
    gn = tsearch.gn_search_reference(
        t[3], tsearch.build_templates(t[0], t[1], t[2], pt_ref, tcfg, pad), pt_ref, p_init,
        tcfg, lw, lh, pad)
    assert torch.equal(lvl.p, gn.p) and torch.equal(lvl.converged, gn.converged)
    assert torch.equal(lvl.absw, tdens.result_absw(gn, tcfg))
