"""Port (of_dis_tpu_torch) vs JAX package: densification (fixed-order
overlap-add), and its bit-reproducibility."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu import DISConfig
from of_dis_tpu.models import densify as jdens
from of_dis_tpu.models.grid import level_geometry
from of_dis_tpu.models.inverse_search import SearchResult as JResult
from of_dis_tpu_torch.config import from_reference
from of_dis_tpu_torch.models import densify as tdens
from of_dis_tpu_torch.models.inverse_search import SearchResult as TResult

# (patch_size, overlap): op1 (steps 5: footprint padded to 2*5), op2, op3/op4
GRIDS = [(8, 0.3), (8, 0.4), (12, 0.75)]


def _inputs(psz, overlap, c, seed, w=52, h=36):
    cfg = DISConfig(mode="flow", channels=c, sc_f=0, sc_l=0, patch_size=psz,
                    overlap=overlap).validate()
    geo = level_geometry(w, h, cfg)
    rng = np.random.RandomState(seed)
    p = rng.randn(geo.n_patches, 2).astype(np.float32) * 3
    pweight = (rng.rand(geo.n_patches, psz, psz, c) * 8).astype(np.float32)
    return cfg, geo, p, pweight


@pytest.mark.parametrize("psz,overlap", GRIDS)
@pytest.mark.parametrize("c", [1, 3])
def test_aggregate_flow_dense_matches_jax(psz, overlap, c):
    cfg, geo, p, pweight = _inputs(psz, overlap, c, seed=psz + c)
    ref = jdens.aggregate_flow_dense(
        JResult(p=jnp.asarray(p), pt=None, pweight=jnp.asarray(pweight), converged=None),
        geo, cfg)
    tcfg = from_reference(dataclasses.asdict(cfg))
    ours = tdens.aggregate_flow_dense(
        TResult(p=torch.as_tensor(p), pt=None, pweight=torch.as_tensor(pweight),
                converged=None), geo, tcfg)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # absw given directly (the level-search kernel's output) takes the same path
    absw = tdens._abs_weights(torch.as_tensor(pweight), tcfg)
    again = tdens.aggregate_flow_dense(
        TResult(p=torch.as_tensor(p), pt=None, pweight=None, converged=None, absw=absw),
        geo, tcfg)
    assert torch.equal(again, ours)


def test_aggregate_flow_dense_deterministic():
    cfg, geo, p, pweight = _inputs(8, 0.4, 1, seed=9, w=64, h=40)
    tcfg = from_reference(dataclasses.asdict(cfg))
    res = TResult(p=torch.as_tensor(p), pt=None, pweight=torch.as_tensor(pweight),
                  converged=None)
    a = tdens.aggregate_flow_dense(res, geo, tcfg)
    b = tdens.aggregate_flow_dense(res, geo, tcfg)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Forward-backward merge and the scatter splat (patchgrid.cpp:277-375)
# ---------------------------------------------------------------------------

def _fb_inputs(seed, w=48, h=32, nop=2, c=1):
    """A level's config and geometry, and a backward SearchResult's arrays:
    converged positions around the grid (some near or past the border),
    displacements, per-pixel residuals; plus forward accumulators."""
    cfg = DISConfig(mode="flow" if nop == 2 else "stereo", channels=c, sc_f=0, sc_l=0,
                    patch_size=8, overlap=0.4).validate()
    geo = level_geometry(w, h, cfg)
    rng = np.random.RandomState(seed)
    n = geo.n_patches
    p = (rng.randn(n, nop) * 2).astype(np.float32)
    pt = (geo.pt_ref + rng.randn(n, 2) * 3).astype(np.float32)
    pweight = (rng.rand(n, 8, 8, c) * 8).astype(np.float32)
    we = rng.rand(w * h).astype(np.float32)
    flow = rng.randn(w * h, nop).astype(np.float32)
    return cfg, geo, p, pt, pweight, we, flow


def _results(p, pt, pweight):
    return (JResult(p=jnp.asarray(p), pt=jnp.asarray(pt), pweight=jnp.asarray(pweight),
                    converged=None),
            TResult(p=torch.as_tensor(p), pt=torch.as_tensor(pt),
                    pweight=torch.as_tensor(pweight), converged=None))


@pytest.mark.parametrize("tile", [None, ((4, 6), (20, 30))])
@pytest.mark.parametrize("nop", [1, 2])
def test_merge_backward_matches_jax(nop, tile):
    """Plain and tile form (origin=, acc_shape=) against the JAX function on
    the same SearchResult: bit-equal, since both add each cell's updates in
    their order (the bound asked of them is 1e-5 absolute)."""
    cfg, geo, p, pt, pweight, we, flow = _fb_inputs(seed=11 + nop, nop=nop)
    kw = {}
    if tile is not None:
        (oy, ox), (th, tw) = tile
        kw = dict(origin=tile[0], acc_shape=tile[1])
        we, flow = we[: th * tw], flow[: th * tw]
    jres, tres = _results(p, pt, pweight)
    jwe, jflow = jdens.merge_backward(jnp.asarray(we), jnp.asarray(flow), jres, geo.w, geo.h,
                                      cfg, **kw)
    twe, tflow = tdens.merge_backward(torch.as_tensor(we), torch.as_tensor(flow), tres, geo.w,
                                      geo.h, from_reference(dataclasses.asdict(cfg)), **kw)
    np.testing.assert_array_equal(twe.numpy(), np.asarray(jwe))
    np.testing.assert_array_equal(tflow.numpy(), np.asarray(jflow))


@pytest.mark.parametrize("c", [1, 3])
def test_splat_forward_scatter_matches_jax(c):
    """The scatter form of the forward splat on a patch subset with
    out-of-bounds centres, against the JAX function: bit-equal, as the
    merge."""
    cfg, geo, p, pt, pweight, _, _ = _fb_inputs(seed=21 + c, c=c)
    pt[::7] += 1000.0  # far out of bounds: dropped
    absw = np.array(jdens._abs_weights(jnp.asarray(pweight), cfg))
    jwe, jflow = jdens.splat_forward_scatter(jnp.asarray(p), jnp.asarray(absw),
                                             jnp.asarray(pt), geo.w, geo.h, cfg)
    twe, tflow = tdens.splat_forward_scatter(torch.as_tensor(p), torch.as_tensor(absw),
                                             torch.as_tensor(pt), geo.w, geo.h,
                                             from_reference(dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(twe.numpy(), np.asarray(jwe))
    np.testing.assert_array_equal(tflow.numpy(), np.asarray(jflow))


def test_fb_merge_identical_flows_cancel():
    """tests/test_densify.py's case on the port: if the backward flow is the
    negated forward flow everywhere with equal weights, the merged field
    equals the forward-only field inside the 1-px frame the backward splat
    leaves out."""
    cfg = from_reference(dataclasses.asdict(
        DISConfig(mode="flow", channels=1, patch_size=8, overlap=0.4, sc_f=0, sc_l=0)))
    geo = level_geometry(48, 32, cfg)
    n = geo.n_patches
    p = torch.tensor([[1.5, -0.75]]).repeat(n, 1)
    pw = torch.ones((n, 8, 8, 1))
    pt_ref = torch.as_tensor(geo.pt_ref)
    fw = TResult(p=p, pt=pt_ref + p, pweight=pw, converged=torch.ones(n, dtype=torch.bool))
    bw = TResult(p=-p, pt=pt_ref - p, pweight=pw, converged=torch.ones(n, dtype=torch.bool))
    merged = tdens.aggregate_flow_dense(fw, geo, cfg, bw_result=bw).numpy()
    only_fw = tdens.aggregate_flow_dense(fw, geo, cfg).numpy()
    np.testing.assert_allclose(merged[8:-8, 8:-8], only_fw[8:-8, 8:-8], atol=1e-5)
    np.testing.assert_allclose(merged[8:-8, 8:-8, 0], 1.5, atol=1e-5)


def test_fb_merge_deterministic_and_per_pair():
    """Two merges give the same bits, and a batch of two pairs merges each
    pair as it merges alone (cells offset by pair, never mixed)."""
    cfg = from_reference(dataclasses.asdict(_fb_inputs(0)[0]))
    geo = _fb_inputs(0)[1]
    pairs = []
    for seed in (31, 32):
        _, _, p, pt, pweight, _, _ = _fb_inputs(seed)
        _, _, p2, _, pw2, _, _ = _fb_inputs(seed + 10)
        fw = TResult(p=torch.as_tensor(p2), pt=None, pweight=torch.as_tensor(pw2),
                     converged=None)
        pairs.append((fw, _results(p, pt, pweight)[1]))
    alone = [tdens.aggregate_flow_dense(fw, geo, cfg, bw_result=bw) for fw, bw in pairs]
    fw, bw = pairs[0]
    assert torch.equal(alone[0], tdens.aggregate_flow_dense(fw, geo, cfg, bw_result=bw))

    def stack(k):
        return TResult(*(None if t[0] is None else torch.stack(t)
                         for t in zip(*(pr[k] for pr in pairs))))

    both = tdens.aggregate_flow_dense(stack(0), geo, cfg, bw_result=stack(1))
    assert torch.equal(both[0], alone[0]) and torch.equal(both[1], alone[1])
