"""work.py's bytes and FP32 operations per pair, pinned to the values of
the program's earlier chip-run formulas (chip_smoke.py's
level_search_work, refine_inner_work, sor_work) for the same level shapes
and trips: op2 at 1024x436 has levels 32x14, 64x28 and 128x56 with 32, 112
and 448 patches, 13 trips each; refinement runs 6, 5 and 4 inner
iterations of 3 SOR sweeps."""

import dataclasses

import pytest

import work
from reference.params import from_dict


def _params(mode):
    from of_dis_tpu_torch import operating_point

    return from_dict(dataclasses.asdict(operating_point(2, 1024, mode=mode)))


def test_level_shapes():
    assert work.level_shapes(_params("flow"), 1024, 436) == [(5, 32, 14), (4, 64, 28), (3, 128, 56)]


def test_op2_flow_work():
    w = work.pair_work(_params("flow"), 1024, 436)
    assert set(w) == {"level_search", "refine_inner"}
    # level search: 4 (4 image + 2N + 2N + 70N) bytes, 64 (10N + 260N + 2N) ops, per level
    assert w["level_search"] == (420480.0, 10305536.0)
    # refine inner: 52 h w bytes, 203 h w n_inner ops
    assert w["refine_inner"] == (489216.0, 8184960.0)


def test_op2_stereo_work():
    w = work.pair_work(_params("stereo"), 1024, 436)
    assert set(w) == {"level_search", "sor_scalar"}
    # nop 1: 4 (4 image + 2N + N + 69N) bytes, the same operations as flow
    assert w["level_search"] == (pytest.approx(4 * (4 * (1440 + 3520 + 10368) + 72 * (32 + 112 + 448))),
                                 10305536.0)
    # 15 solves: 24 h w bytes, 48 h w ops each
    assert w["sor_scalar"] == (967680.0, 1935360.0)


def test_bounds_on_the_h100():
    pk = work.peak("NVIDIA H100 80GB HBM3")
    w = work.pair_work(_params("flow"), 1024, 436)
    assert work.bound_s(*w["level_search"], pk) * 1e3 == pytest.approx(0.000154, rel=0.01)
    assert work.bound_s(*w["refine_inner"], pk) * 1e3 == pytest.approx(0.000146, rel=0.01)
    s = work.pair_work(_params("stereo"), 1024, 436)
    assert work.bound_s(*s["sor_scalar"], pk) * 1e3 == pytest.approx(0.000289, rel=0.01)
    assert work.peak("a card the table does not hold") is None
