#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (of_dis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout's sources, holds each
kernel against its plain PyTorch version on the card at the shapes the main
paths give it, and drives nine paths at 1024x436 on tests/goldens/fullres
through the entry points (dis_flow: operating point 2 gray, op1 gray, op2
RGB, op3 gray, op4 gray, op2 gray with the forward-backward merge;
dis_stereo: op2 gray and RGB, op2 gray with the merge), each with the
launch counters reset just before its run and read just after.  Both
search kernels (level_search, gn_search) must equal their plain versions
exactly on every call (the fb stereo path's backward searches run
level_search at camlr 1, the sign clamp >= 0); refine_inner and sor_scalar
run every call through each launch variant (block, cluster, grid), and
sor_coupled (on no path) seeded fields at op2's level shapes and up to
448x1024; the variants must give the same bits as one another and as their
plain versions, and each prints its variants' times, the one
refine_variant / sor_variant picks and a fit of each variant's cost per
phase.  The merge's scatter runs twice on the card on op2 gray fb's finest
level (the same bits required) and once on the CPU.  A batched phase then
drives op2 gray (B = 32), stereo gray (B = 8), op4 gray (B = 4) and op2
gray fb (B = 4) on distinct pairs through batched_flow: each pair must
equal its own run, each kernel call of a batch its plain version on the
same batched tensors, and every kernel in every variant at B = 1, 2, 7, 32
its per-pair launches; it prints op2 gray pairs/s at B = 1, 8, 32.
It checks the outputs against the reference binaries' goldens, the port's CPU path and
a second run (bit-identical), times pairs, profiles the device, runs the
CLI (flow and stereo; the fb paths at -v 2, whose per-scale table must
print, and with --viz), and prints one JSON line per phase.  The line
before the last lists every kernel with its times and bound; the last line
is {"ok": true, "device": {...}}.  Any failure raises and the script exits
non-zero without that line; so does a host without CUDA.

Times: CUDA events around one launch, queued behind a device-side sleep so
the host's enqueue is not timed (median over repetitions).  Bounds: the
larger of bytes over 3.35 TB/s and FP32 operations over 67 TFLOP/s (H100
SXM data sheet), counted from this run's inputs and GN trips.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULLRES = ROOT / "tests" / "goldens" / "fullres"
OUT_DIR = ROOT / "build" / "chip_smoke"
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12      # H100 SXM FP32, outside the tensor cores
EPE_GOLDEN = 0.08            # tests/test_golden_fullres.py:24
EPE_CPU = 0.05               # tests/test_golden_fullres.py:87
CPU_LIMIT_S = 60.0           # op4's card-vs-CPU check runs only if its CPU pair takes less
KERNELS = ("level_search", "gn_search", "refine_inner", "sor_scalar", "sor_coupled")

OF = ("of1.png", "of2.png")
DE = ("de1.png", "de2.png")
# Each path: input pair, channels, mode, operating point, full-res golden
# (None: card against CPU only), and the launches one pair must make.
PATHS = {
    "op2 gray": (OF, 1, "flow", 2, "of_int_op2", dict(level_search=3, refine_inner=3)),
    "op1 gray": (OF, 1, "flow", 1, "of_int_op1", dict(level_search=3)),
    "op2 rgb": (OF, 3, "flow", 2, "of_rgb_op2", dict(level_search=2, gn_search=1,
                                                    refine_inner=3)),
    "op3 gray": (OF, 1, "flow", 3, "of_int_op3", dict(level_search=2, gn_search=3,
                                                     refine_inner=5)),
    "op4 gray": (OF, 1, "flow", 4, "of_int_op4", dict(level_search=2, gn_search=4,
                                                     refine_inner=6)),
    "stereo gray": (DE, 1, "stereo", 2, "de_int_op2", dict(level_search=3, sor_scalar=15)),
    "stereo rgb": (DE, 3, "stereo", 2, None, dict(level_search=2, gn_search=1,
                                                  sor_scalar=15)),
    # The forward-backward merge (FB): a backward search per level, and above
    # the finest level a backward refinement (stereo: n_inner = level + 1 SOR
    # launches at levels 5 and 4, with the flipped sign clamp).
    "op2 gray fb": (OF, 1, "flow", 2, "of_int_fbcon", dict(level_search=6, refine_inner=5)),
    "stereo gray fb": (DE, 1, "stereo", 2, None, dict(level_search=6, sor_scalar=26)),
}
FB = ("op2 gray fb", "stereo gray fb")
# Card-vs-CPU checks (op2 gray as before; op4 only within CPU_LIMIT_S) and
# pairs timed per path.
CPU_CHECKED = ("op2 gray", "op3 gray", "op4 gray", "stereo gray", "stereo rgb", *FB)
PAIRS_TIMED = {"op2 gray": 10, "op3 gray": 10, "op4 gray": 5, "stereo gray": 10,
               "stereo rgb": 10, "op2 gray fb": 10, "stereo gray fb": 10}
PROFILED = {"op2 gray": 5, "op3 gray": 3, "op4 gray": 3, "stereo gray": 5, "stereo rgb": 3,
            "op2 gray fb": 5, "stereo gray fb": 5}


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T_START, 1), **kw}),
          flush=True)


def epe(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.sqrt(np.sum((a - b) ** 2, axis=-1))))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def expected_launches(name: str) -> dict:
    return {k: PATHS[name][5].get(k, 0) for k in KERNELS}


def path_inputs(name: str):
    """(img1, img2, cfg) of a path, from the full-res goldens' inputs."""
    from of_dis_tpu_torch import io, operating_point

    files, ch, mode, op, _, _ = PATHS[name]
    imgs = [io.load_image(FULLRES / f, ch) for f in files]
    return imgs[0], imgs[1], operating_point(op, imgs[0].shape[1], mode=mode, channels=ch,
                                             use_fb_merge=name in FB)


def cli_params(cfg) -> list:
    """A configuration as the CLI's 20 explicit parameters (run_dense.cpp:269-294)."""
    return [str(x) for x in (
        cfg.sc_f, cfg.sc_l, cfg.max_iter, cfg.min_iter, cfg.dp_thresh, cfg.dr_thresh,
        cfg.res_thresh, cfg.patch_size, cfg.overlap, int(cfg.use_fb_merge),
        int(cfg.patch_norm), cfg.cost, int(cfg.use_tv_refine), cfg.tv_alpha, cfg.tv_gamma,
        cfg.tv_delta, cfg.tv_innerit, cfg.tv_solverit, cfg.tv_sor, cfg.verbosity)]


def call_levels(cfg, calls_per_level, search: bool = False) -> list:
    """The pyramid level of each call a pair makes of a kernel that runs
    calls_per_level(sl) times per direction and level, in call order.  With
    fb-merge the backward calls follow the forward ones of their level,
    labelled "<sl> bw": at every level for a search, above the finest for a
    refinement (models/dis.py::_stage_optimize, _stage_refine)."""
    out = []
    for sl in range(cfg.sc_f, cfg.sc_l - 1, -1):
        n = calls_per_level(sl)
        out += [str(sl)] * n
        if cfg.use_fb_merge and (search or sl > cfg.sc_l):
            out += [f"{sl} bw"] * n
    return out


def run_path(name: str, img1, img2, cfg, device) -> np.ndarray:
    """One pair through the path's entry point: (H, W, nop) on the host."""
    from of_dis_tpu_torch import dis_flow, dis_stereo

    if cfg.mode == "stereo":
        return dis_stereo(img1, img2, cfg, device=device)[..., None].cpu().numpy()
    return dis_flow(img1, img2, cfg, device=device).cpu().numpy()


def cpu_run_to(name: str, out: str) -> None:
    """Run a path on the CPU and save it (the op4 check runs this in a child
    process, so that it can be stopped at CPU_LIMIT_S)."""
    img1, img2, cfg = path_inputs(name)
    t0 = time.perf_counter()
    flow = run_path(name, img1, img2, cfg, "cpu")
    np.save(out, flow)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


def gpu_ms(torch, fn, reps: int) -> float:
    """Median device time of fn() in ms: each call is queued behind a
    device sleep longer than its host-side enqueue, between two events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(host_s * 4e9, 1e5), 4e9))
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound_ms(nbytes: float, nops: float):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = nops / PEAK_FP32_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def level_search_work(args, cfg, iters) -> tuple:
    """Bytes moved (inputs once, outputs once) and FP32 operations of one
    level search, counting the GN trips these inputs ran (iters + 1 per
    patch): per patch value ~10 operations for the template and Hessian,
    ~20 per trip (bilinear blend, mean, loss, the two solve and one
    residual reductions), 2 for absw."""
    ima, _, _, _, pt_ref, p_init = args[:6]
    n = pt_ref.shape[0]
    psz2 = cfg.patch_size ** 2
    c = ima.shape[2]
    nbytes = 4 * (4 * ima.numel() + pt_ref.numel() + p_init.numel()
                  + n * (cfg.nop + 2 + psz2 + 2))
    trips = float((iters.double() + 1).sum())
    nops = psz2 * c * (10.0 * n + 20.0 * trips + 2.0 * n)
    return nbytes, nops


def gn_search_work(args, cfg, iters) -> tuple:
    """Bytes (templates, gradients, Hessian, the target image, centres and
    starts in; p, pt, pweight, flags out) and FP32 operations of one GN
    search: ~20 per patch value and trip, as in level_search_work, over the
    trips these inputs ran."""
    imb, tmpl, pt_ref, p_init = args[:4]
    n = pt_ref.shape[0]
    npv = tmpl.tmp[0].numel()  # psz^2 * C
    nbytes = 4 * (3 * tmpl.tmp.numel() + tmpl.hes.numel() + imb.numel() + pt_ref.numel()
                  + p_init.numel() + n * (cfg.nop + 2 + npv + 2))
    nops = 20.0 * npv * float((iters.double() + 1).sum())
    return nbytes, nops


def refine_inner_work(wx, derivs, n_inner, solver_it) -> tuple:
    """Bytes (wx, wy, mask, 8 derivatives in; uu, vv out) and FP32
    operations of one refine-inner launch: per pixel and inner iteration
    ~17 (smoothness) + 60 C + 15 (data term) + 27 (RHS, diagonal) + 28 per
    SOR sweep."""
    h, w = wx.shape
    c = derivs[0].shape[-1]
    nbytes = 4 * h * w * (3 + 8 * c + 2)
    nops = h * w * n_inner * (59.0 + 60.0 * c + 28.0 * solver_it)
    return nbytes, nops


def sor_work(nop: int, h: int, w: int, iterations: int) -> tuple:
    """Bytes (5 fields in and 1 out for the scalar solver; 9 in and 2 out
    for the coupled one) and FP32 operations per pixel and sweep: scalar
    ~16 (diagonal 4, divide 1, neighbour sum 7, update 4), coupled ~31."""
    fields = 6 if nop == 1 else 11
    return 4.0 * fields * h * w, (16.0 if nop == 1 else 31.0) * h * w * iterations


def record_calls(kernels, fn) -> dict:
    """fn() with every kernel wrapper's calls recorded: {kernel: [(args, kwargs)]}."""
    calls = {k: [] for k in KERNELS}
    orig = {k: getattr(kernels, k) for k in KERNELS}

    def recorder(k):
        def rec(*a, **kw):
            calls[k].append((a, kw))
            return orig[k](*a, **kw)
        return rec

    try:
        for k in KERNELS:
            setattr(kernels, k, recorder(k))
        fn()
    finally:
        for k, f in orig.items():
            setattr(kernels, k, f)
    return calls


def one_pair_args(kernel: str, a: tuple) -> tuple:
    """A kernel call's arguments on a batch of one pair as that pair's own
    (the wrappers take either)."""
    if kernel == "level_search":  # ima, dxa, dya, imb, pt_ref, p_init, ...
        return (*(t[0] for t in a[:4]), a[4], a[5][0], *a[6:])
    if kernel == "gn_search":  # imb, tmpl, pt_ref, p_init, ...
        return (a[0][0], type(a[1])(*(t[0] for t in a[1])), a[2], a[3][0], *a[4:])
    if kernel == "refine_inner":  # wx, wy, mask, derivs, ...
        return (*(t[0] for t in a[:3]), tuple(t[0] for t in a[3]), *a[4:])
    n = 5 if kernel == "sor_scalar" else 9  # the SOR fields, then iterations, omega
    return (*(t[0] for t in a[:n]), *a[n:])


# ---- the batched phase ----
# Each batched path: B distinct pairs, pair i the path's pair rolled
# horizontally by ROLL_PX * i px, so a wrong pair offset cannot hide.
BATCHED = {"op2 gray": 32, "stereo gray": 8, "op4 gray": 4, "op2 gray fb": 4}
ROLL_PX = 4
CHECK_B = (1, 2, 7, 32)      # batched launches held against per-pair launches
VARIANT_B = (1, 2, 8, 16, 32)  # launch variants timed at these batch sizes
THROUGHPUT_B = (1, 8, 32)    # pairs/s of the batched op2 gray path
QUEUED = 16                  # batches queued per timed repetition
THROUGHPUT_REPS = 5


def rolled_batch(img1, img2, b: int):
    """(b, H, W, C) stacks of a pair rolled horizontally by ROLL_PX * i px."""
    return tuple(np.stack([np.roll(im, ROLL_PX * i, axis=1) for i in range(b)])
                 for im in (img1, img2))


def outputs(out, i=None) -> list:
    """A kernel wrapper's outputs as a list (a tensor, a tuple or a
    SearchResult), of pair i of a batched call if i is given."""
    ts = [out] if hasattr(out, "shape") else list(out)
    return ts if i is None else [None if t is None else t[i] for t in ts]


def batched_vs_pairs(torch, launch, make, variants) -> dict:
    """For each launch variant and each b of CHECK_B: one batched launch of
    make(b)'s batch against a launch per pair, every output bit-equal.
    Returns {"variant b": pairs that differ}."""
    differ = {}
    for v in variants:
        for b in CHECK_B:
            batch, pairs = make(b)
            out = launch(batch, v)
            bad = 0
            for i, one in enumerate(pairs):
                got, want = outputs(out, i), outputs(launch(one, v))
                bad += not all((g is None and w is None) or torch.equal(g, w)
                               for g, w in zip(got, want))
            differ[f"{v} {b}"] = bad
    torch.cuda.synchronize()
    return differ


def tiled(torch, t, b: int):
    """b pairs from a batch t of fewer: pair i is t's pair i % len(t)."""
    return t[torch.tensor([i % t.shape[0] for i in range(b)], device=t.device)]


def batched_phase(torch, dev, inputs, rows, smi, golden, sor_system) -> dict:
    """The batched paths (BATCHED), each pair equal to its own run; every
    kernel at each b of CHECK_B, batched against per-pair launches; the
    launch variants' times at VARIANT_B; each kernel's ms per pair at B = 32
    (into rows); op2 gray pairs/s at THROUGHPUT_B.  Returns {b: pairs/s}."""
    h0, w0 = inputs["op2 gray"][0].shape[:2]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from of_dis_tpu_torch import batched_flow
    from of_dis_tpu_torch.ops import kernels
    from of_dis_tpu_torch.models.inverse_search import (
        PatchTemplates,
        gn_search_reference,
        level_search_reference,
    )
    from of_dis_tpu_torch.models.refine import refine_inner_reference, sor_scalar_rb

    bcalls = {}
    for name, nb in BATCHED.items():
        img1, img2, cfg = inputs[name]
        a, bb = rolled_batch(img1, img2, nb)
        kernels.reset_launches()
        out = batched_flow(a, bb, cfg, device=dev)
        torch.cuda.synchronize()
        made = dict(kernels.launches)
        out = out.cpu().numpy()
        bcalls[name] = record_calls(kernels, lambda: batched_flow(a, bb, cfg, device=dev))
        equal = [bool(np.array_equal(out[i], run_path(name, a[i], bb[i], cfg, dev)))
                 for i in range(nb)]
        line = dict(config=f"{name} {w0}x{h0}", pairs=nb, roll_px_per_pair=ROLL_PX,
                    launches_per_batch=made, pairs_equal_to_own_run=sum(equal),
                    epe_pair0_vs_golden=epe(out[0], golden(PATHS[name][4])))
        emit("batched path", **line)
        require(made == expected_launches(name),
                f"{name} batch of {nb} launched {made}, expected {expected_launches(name)}")
        require(all(equal), f"{name}: batched pairs differ from their own runs: {equal}")
        require(line["epe_pair0_vs_golden"] < EPE_GOLDEN, f"{name} batched: {line}")

    # Every kernel call of the batched paths (one per level), on the path's
    # own B distinct pairs, against its plain version on the same batched
    # tensors on the card: every output bit-equal.
    plain = {"level_search": level_search_reference, "gn_search": gn_search_reference,
             "refine_inner": refine_inner_reference, "sor_scalar": sor_scalar_rb}
    for name, nb in BATCHED.items():
        for k, kcalls in bcalls[name].items():
            seen = set()
            for i, (a, kw) in enumerate(kcalls):
                hw = tuple(a[0].shape[1:3])
                if hw in seen:  # stereo's SOR: several calls per level
                    continue
                seen.add(hw)
                got, want = outputs(getattr(kernels, k)(*a, **kw)), outputs(plain[k](*a, **kw))
                torch.cuda.synchronize()
                differ = [j for j, (g, r) in enumerate(zip(got, want))
                          if not ((g is None and r is None) or torch.equal(g, r))]
                line = dict(kernel=k, path=name, pairs=nb, call=i, hw=list(hw),
                            outputs_that_differ=differ,
                            max_abs_err=max((float((g.double() - r.double()).abs().max())
                                             for g, r in zip(got, want) if g is not None),
                                            default=0.0))
                emit("batched kernel vs plain", **line)
                require(not differ, f"{k} on the {name} batch differs from its plain version: "
                                    f"{line}")

    # Every kernel, every variant, at each b of CHECK_B: one batched launch
    # against a launch per pair, at the batched paths' own calls.  Pairs past
    # a path's batch repeat its pairs with a distinct start (p_init, or the
    # SOR right-hand side) so that no two pairs of a batch are the same.
    def shift(b, nb, step):
        return torch.tensor([step * (i // nb) for i in range(b)], device=dev)

    def search_make(a, with_tmpl):
        """level_search's (ima, dxa, dya, imb, pt_ref, p_init, ...) or
        gn_search's (imb, tmpl, pt_ref, p_init, ...)."""
        n_img = 1 if with_tmpl else 4
        pt, p0 = a[n_img + with_tmpl], a[n_img + with_tmpl + 1]
        rest = a[n_img + with_tmpl + 2:]

        def make(b):
            nb = p0.shape[0]
            imgs = [tiled(torch, x, b) for x in a[:n_img]]
            tm = PatchTemplates(*(tiled(torch, f, b) for f in a[1])) if with_tmpl else None
            pb = (tiled(torch, p0, b) + shift(b, nb, 0.25)[:, None, None]).contiguous()

            def pair(i):
                head = [x[i] for x in imgs]
                if with_tmpl:
                    head.append(PatchTemplates(*(f[i] for f in tm)))
                return (*head, pt, pb[i], *rest)

            head = imgs + ([tm] if with_tmpl else [])
            return (*head, pt, pb, *rest), [pair(i) for i in range(b)]
        return make

    def refine_make(a):
        def make(b):
            nb = a[0].shape[0]
            f = [tiled(torch, x, b) for x in a[:3]]
            f[0] = (f[0] + shift(b, nb, 0.01)[:, None, None]).contiguous()  # wx
            d = tuple(tiled(torch, x, b) for x in a[3])
            return ((*f, d, *a[4:]),
                    [(*(x[i] for x in f), tuple(x[i] for x in d), *a[4:]) for i in range(b)])
        return make

    def sor_make(a):
        def make(b):
            nb = a[0].shape[0]
            f = [tiled(torch, x, b) for x in a[:5]]
            f[2] = (f[2] + shift(b, nb, 0.01)[:, None, None]).contiguous()  # b1
            return (*f, *a[5:]), [(*(x[i] for x in f), *a[5:]) for i in range(b)]
        return make

    def coupled_make(h, w):
        def make(b):
            systems = [sor_system(h, w, h * w + i) for i in range(b)]
            f = [torch.stack([sy[k] for sy in systems]) for k in range(9)]
            return (*f, 3, 1.6), [(*(x[i] for x in f), 3, 1.6) for i in range(b)]
        return make

    launch = {
        "level_search": lambda a, v: kernels.level_search(*a),
        "gn_search": lambda a, v: kernels.gn_search(*a),
        "refine_inner": lambda a, v: kernels.refine_inner(*a, variant=v),
        "sor_scalar": lambda a, v: kernels.sor_scalar(*a, variant=v),
        "sor_coupled": lambda a, v: kernels.sor_coupled(*a, variant=v),
    }
    stereo_cfg = inputs["stereo gray"][2]
    stereo_levels = [sl for sl in range(stereo_cfg.sc_f, stereo_cfg.sc_l - 1, -1)
                     for _ in range(stereo_cfg.tv_innerit * (sl + 1))]
    # (kernel, case, make, variants, timed into the kernels row's ms per pair at B = 32)
    bcases = []
    for name in ("op2 gray", "stereo gray", "op4 gray"):
        for i, (a, _) in enumerate(bcalls[name]["level_search"]):
            bcases.append(("level_search", f"{name} call {i}", search_make(a, False), (None,),
                           name == "op2 gray"))
    for i, (a, _) in enumerate(bcalls["op4 gray"]["gn_search"]):
        bcases.append(("gn_search", f"op4 gray call {i}", search_make(a, True), (None,), True))
    for name in ("op2 gray", "op4 gray"):
        for i, (a, _) in enumerate(bcalls[name]["refine_inner"]):
            h, w = a[0].shape[1:]
            bcases.append(("refine_inner", f"{name} {h}x{w}", refine_make(a),
                           kernels.refine_variants(h, w), name == "op2 gray"))
    seen = set()
    for sl, (a, _) in zip(stereo_levels, bcalls["stereo gray"]["sor_scalar"]):
        h, w = a[0].shape[1:]
        first = sl not in seen  # each level's first call is checked in every variant
        seen.add(sl)
        bcases.append(("sor_scalar", f"stereo gray level {sl}", sor_make(a),
                       kernels.sor_variants(h, w) if first else (), True))
    for h, w in ((14, 32), (28, 64), (56, 128)):
        bcases.append(("sor_coupled", f"op2 shape {h}x{w}", coupled_make(h, w),
                       kernels.sor_variants(h, w, 2), True))

    b32 = {k: 0.0 for k in KERNELS}  # ms per pair at B = 32, the rows' own calls
    variant_times = {}
    for k, case, make, variants, timed in bcases:
        differ = batched_vs_pairs(torch, launch[k], make, variants) if variants else {}
        line = dict(kernel=k, case=case, pairs_that_differ=differ)
        if timed:
            batch32 = make(32)[0]
            ms = gpu_ms(torch, lambda: launch[k](batch32, None), 10)
            b32[k] += ms / 32
            line["ms_at_b32"] = ms
        if variants and variants != (None,) and "call" not in case:
            shape = case.split()[-1]
            key = f"{k} {shape}"
            if key not in variant_times:
                variant_times[key] = True
                per_b = {}
                for b in VARIANT_B:
                    batch = make(b)[0]
                    hw = batch[0].shape[1:]
                    per_b[str(b)] = dict(
                        picked=list(kernels.refine_variant(*hw, 1, b) if k == "refine_inner"
                                    else kernels.sor_variant(*hw, 1 if k == "sor_scalar" else 2,
                                                             b)),
                        ms={v: gpu_ms(torch, lambda v=v: launch[k](batch, v), 10)
                            for v in variants})
                line["variant_ms_at_b"] = per_b
        emit("batched kernel", **line)
        require(not any(differ.values()),
                f"{k} {case}: batched launches differ from per-pair launches: {differ}")
    for k in KERNELS:
        rows[k]["ms_per_pair_b32"] = b32[k]

    # Throughput: op2 gray at B = 1, 8, 32 distinct pairs, pre-padded on the
    # card (as bench.py feeds the JAX package's _batched_padded): QUEUED
    # batches queued, then the last one's copy to the host; THROUGHPUT_REPS
    # repetitions.  Then one profiled batch: device busy per pair and idle.
    from of_dis_tpu_torch.ops import pyramid as pyr
    from of_dis_tpu_torch.parallel.batch import _batched_padded

    img1, img2, cfg = inputs["op2 gray"]
    scf = 1 << cfg.sc_f
    throughput = {}
    for b in THROUGHPUT_B:
        a, bb = (pyr.pad_to_divisible(torch.as_tensor(x, device=dev), scf)
                 for x in rolled_batch(img1, img2, b))
        _batched_padded(a, bb, cfg).cpu()
        rates = []
        for _ in range(THROUGHPUT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(QUEUED):
                last = _batched_padded(a, bb, cfg)
            last.cpu()
            rates.append(QUEUED * b / (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _batched_padded(a, bb, cfg).cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
        throughput[str(b)] = float(np.median(rates))
        emit("throughput", config=f"op2 gray {w0}x{h0} batched, pre-padded on the card",
             batch=b, queued_batches=QUEUED, reps=THROUGHPUT_REPS,
             pairs_per_s_median=float(np.median(rates)), pairs_per_s_min=float(min(rates)),
             pairs_per_s_max=float(max(rates)), pairs_per_s_all=rates,
             profiled_batch_wall_ms=wall_ms,
             device_busy_ms_per_pair=busy / b if busy else "not measured",
             device_idle_share=(1.0 - busy / wall_ms) if busy else "not measured",
             nvidia_smi=smi)
    return throughput


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    from of_dis_tpu_torch import io
    from of_dis_tpu_torch.models.inverse_search import (
        gn_search_reference,
        level_search_reference,
    )
    from of_dis_tpu_torch.models.refine import (
        refine_inner_reference,
        sor_coupled_rb,
        sor_scalar_rb,
    )
    from of_dis_tpu_torch.ops import build, kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- env ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # ---- build ----
    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if any(w in ln for w in ("entry function", "registers", "spill"))]
             for k, v in build.build_log.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3), libraries=sorted(libs), ptxas=ptxas)
    occ = {}
    for psz in (8, 12):
        for c in (1, 3):
            for nop in (1, 2):
                blocks, warps = kernels.gn_search_occupancy(psz, c, nop)
                occ[f"psz{psz} C{c} nop{nop}"] = dict(blocks_per_sm=blocks,
                                                     warps_per_sm=blocks * warps)
    emit("gn_search occupancy", note="one warp per patch; resident blocks and warps per SM",
         per_instance=occ)

    # The least time gpu_ms reads for one launch: a one-element PyTorch add.
    one = torch.zeros(1, device=dev)
    emit("launch floor", note="gpu_ms of one launch of a one-element add",
         ms=gpu_ms(torch, lambda: one.add_(1.0), 50))

    # ---- inputs: each path's pair, and every kernel call one pair makes ----
    inputs = {name: path_inputs(name) for name in PATHS}
    h0, w0 = inputs["op2 gray"][0].shape[:2]

    def capture(name):
        """Run a path once on the card, recording every kernel call's
        arguments as one pair's (the driver calls each kernel on a batch of
        one)."""
        calls = record_calls(kernels, lambda: run_path(name, *inputs[name], dev))
        torch.cuda.synchronize()
        return {k: [(one_pair_args(k, a), kw) for a, kw in v] for k, v in calls.items()}

    calls = {}
    for name in PATHS:
        calls[name] = capture(name)
        made = {k: len(v) for k, v in calls[name].items()}
        require(made == expected_launches(name),
                f"{name} pair made kernel calls {made}, expected {expected_launches(name)}")

    def level_of(name, i, kernel):
        """Pyramid level of a path's i-th call of a search kernel (the
        coarser levels take level_search, the finer gn_search)."""
        lv = call_levels(inputs[name][2], lambda sl: 1, search=True)
        n_level = PATHS[name][5].get("level_search", 0)
        return lv[i] if kernel == "level_search" else lv[n_level + i]

    def search_check(name, res, ref, cfg):
        """Kernel vs plain search: every output equal (p, pt, the weights
        (pweight of gn_search, absw of level_search), converged, iters)."""
        weights = "pweight" if res.pweight is not None else "absw"
        errs = {k: float((getattr(res, k) - getattr(ref, k)).abs().max())
                for k in ("p", "pt", weights)}
        differ = {k: int((getattr(res, k) != getattr(ref, k)).sum())
                  for k in ("converged", "iters")}
        line = dict(case=name, n=int(res.p.shape[0]), max_iter=cfg.max_iter,
                    **{f"max_abs_err_{k}": e for k, e in errs.items()},
                    converged_differ=differ["converged"], iters_differ=differ["iters"],
                    mean_trips=float(res.iters.double().mean() + 1))
        line["ok"] = all(e == 0.0 for e in errs.values()) and not any(differ.values())
        return line

    rows = {}  # kernel -> dict of the kernels line

    # ---- kernel level_search: kernel vs plain version on the card ----
    ls_err = 0.0
    ls_ms = ls_plain = ls_bound = 0.0
    ls_bound_by = None  # of the finest level, the largest term of the sums
    ls_level_ms = {}
    # (case, args, kwargs): every call of every path, and the other costs at
    # op2 gray's finest level.  ms, plain_ms and bound_ms of the kernels line
    # sum op2 gray's three calls.
    cases = [(name, f"{name} level {level_of(name, i, 'level_search')}", a, k)
             for name in PATHS for i, (a, k) in enumerate(calls[name]["level_search"])]
    a3, k3 = calls["op2 gray"]["level_search"][2]
    for cost in (1, 2, 10):
        cfg_c = dataclasses.replace(a3[6], cost=cost)
        cases.append((None, f"op2 gray level 3 cost {cost}", a3[:6] + (cfg_c,) + a3[7:], k3))
    camlr1_checked = 0  # stereo searches with the sign clamp >= 0 (fb's backward grid)
    for path, name, a, k in cases:
        res = kernels.level_search(*a, **k)
        ref = level_search_reference(*a, **k)
        torch.cuda.synchronize()
        line = search_check(name, res, ref, a[6])
        line["level_hw"] = list(a[0].shape[:2])
        if a[6].mode == "stereo":
            line["camlr"] = a[6].camlr if k.get("camlr") is None else k["camlr"]
            camlr1_checked += line["camlr"] == 1 and line["ok"]
        if path is not None:
            ms = gpu_ms(torch, lambda: kernels.level_search(*a, **k), 50)
            b, by = bound_ms(*level_search_work(a, a[6], res.iters))
            line.update(ms=ms, bound_ms=b, bound_by=by)
            if path == "op2 gray":  # the plain version is timed where the row sums
                pms = gpu_ms(torch, lambda: level_search_reference(*a, **k), 5)
                ls_level_ms[name.split(" level ")[1]] = ms
                ls_ms += ms
                ls_plain += pms
                ls_bound += b
                ls_bound_by = by
                line["plain_ms"] = pms
        emit("kernel level_search", **line)
        require(line["ok"], f"level_search disagrees with its plain version: {line}")
        ls_err = max(ls_err, line["max_abs_err_p"], line["max_abs_err_pt"])
    require(camlr1_checked == 3, f"{camlr1_checked} level_search calls checked at camlr 1, "
                                 "expected stereo gray fb's 3 backward levels")
    # What a GN trip costs: op2 gray's levels at max_iter = min_iter = 4, 8
    # and 12 (every patch runs max_iter + 1 trips), fit to a fixed cost per
    # launch plus a cost per trip.
    for i, (a, k) in enumerate(calls["op2 gray"]["level_search"]):
        t = {}
        for it in (4, 8, 12):
            cfg_i = dataclasses.replace(a[6], max_iter=it, min_iter=it)
            args_i = a[:6] + (cfg_i,) + a[7:]
            t[it] = gpu_ms(torch, lambda: kernels.level_search(*args_i, **k), 30) * 1e3
        per_trip, fixed = np.polyfit([it + 1.0 for it in t], list(t.values()), 1)
        level = level_of("op2 gray", i, "level_search")
        emit("level_search phase costs", case=f"op2 gray level {level}", n=int(a[4].shape[0]),
             us_per_trip=float(per_trip), us_fixed=float(fixed),
             us_at_max_iter={str(it): u for it, u in t.items()})

    rows["level_search"] = dict(
        source="level_search.cu", replaces="of_dis_tpu/ops/pallas_kernels.py:1124",
        per="op2 gray", max_abs_err=ls_err, ms=ls_ms, plain_ms=ls_plain, bound_ms=ls_bound,
        bound_by=ls_bound_by, level_ms=ls_level_ms, camlr1_calls_checked=camlr1_checked)

    # ---- kernel gn_search: every call of every path, exact; times at op3 and op4 ----
    gn_err = 0.0
    gn_ms = gn_plain = gn_bound = 0.0
    gn_bound_by = None
    gn_level_ms = {}
    for name in PATHS:
        for i, (a, k) in enumerate(calls[name]["gn_search"]):
            case = f"{name} level {level_of(name, i, 'gn_search')}"
            res = kernels.gn_search(*a, **k)
            ref = gn_search_reference(*a, **k)
            torch.cuda.synchronize()
            line = search_check(case, res, ref, a[4])
            line["level_hw"] = list(a[0].shape[:2])
            if name in ("op3 gray", "op4 gray"):
                ms = gpu_ms(torch, lambda: kernels.gn_search(*a, **k), 20)
                pms = gpu_ms(torch, lambda: gn_search_reference(*a, **k), 2)
                b, by = bound_ms(*gn_search_work(a, a[4], res.iters))
                if name == "op4 gray":
                    gn_ms += ms
                    gn_plain += pms
                    gn_bound += b
                    gn_bound_by = by
                    gn_level_ms[case.split(" level ")[1]] = ms
                line.update(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
            emit("kernel gn_search", **line)
            require(line["ok"], f"gn_search disagrees with its plain version: {line}")
            gn_err = max(gn_err, line["max_abs_err_p"], line["max_abs_err_pt"])
    rows["gn_search"] = dict(
        source="gn_search.cu",
        replaces="of_dis_tpu/ops/pallas_kernels.py:538 and :560",
        per="op4 gray", max_abs_err=gn_err, ms=gn_ms, plain_ms=gn_plain, bound_ms=gn_bound,
        bound_by=gn_bound_by, level_ms=gn_level_ms)

    # ---- kernel refine_inner: kernel vs plain version on the card ----
    ri_err = 0.0
    ri_ms = ri_plain = ri_bound = 0.0
    ri_bound_by = None
    rng = np.random.RandomState(0)
    hb, wb = 448, 1024
    big = [torch.as_tensor(rng.randn(hb, wb).astype(np.float32) * s, device=dev) for s in (1.0, 1.0)]
    big.append(torch.as_tensor((rng.rand(hb, wb) > 0.05).astype(np.float32), device=dev))
    big_derivs = tuple(
        torch.as_tensor(rng.randn(hb, wb, 1).astype(np.float32) * s, device=dev)
        for s in (5.0, 5.0, 10.0, 2.0, 2.0, 2.0, 3.0, 3.0)
    )
    a_big = tuple(big) + (big_derivs,) + calls["op2 gray"]["refine_inner"][2][0][4:]
    a_big = a_big[:4] + (1,) + a_big[5:]  # n_inner of op4's finest level (level 0)
    rcases = [(f"{name} level {call_levels(inputs[name][2], lambda sl: 1)[i]}", a)
              for name in PATHS for i, (a, _) in enumerate(calls[name]["refine_inner"])]
    rcases.append(("random 448x1024", a_big))
    ri_level_ms = {}
    for name, a in rcases:
        h, w = a[0].shape
        picked = kernels.refine_variant(h, w, a[3][0].shape[-1])
        ru, rv = refine_inner_reference(*a)
        variants = kernels.refine_variants(h, w)
        outs = {v: kernels.refine_inner(*a, variant=v) for v in variants}
        torch.cuda.synchronize()
        uu, vv = outs[picked[0]]
        bit_equal = all(torch.equal(o[0], uu) and torch.equal(o[1], vv) for o in outs.values())
        err = max(float((uu - ru).abs().max()), float((vv - rv).abs().max()))
        ok = bool(bit_equal and torch.equal(uu, ru) and torch.equal(vv, rv))
        barriers = int(a[4]) * (2 + 2 * int(a[5])) - 1
        variant_ms = {v: gpu_ms(torch, lambda v=v: kernels.refine_inner(*a, variant=v), 10)
                      for v in variants}
        line = dict(case=name, hw=[h, w], n_inner=int(a[4]), picked=list(picked),
                    variants_bit_equal=bit_equal, max_abs_err=err, ok=ok,
                    variant_ms=variant_ms, barriers=barriers,
                    variant_us_per_barrier={v: t * 1e3 / barriers for v, t in variant_ms.items()})
        ms = gpu_ms(torch, lambda: kernels.refine_inner(*a), 30)
        pms = gpu_ms(torch, lambda: refine_inner_reference(*a), 5)
        b, by = bound_ms(*refine_inner_work(a[0], a[3], a[4], a[5]))
        line.update(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
        if name.startswith("op2 gray level"):
            ri_ms += ms
            ri_plain += pms
            ri_bound += b
            ri_bound_by = by
            ri_level_ms[name.split(" level ")[1]] = ms
        emit("kernel refine_inner", **line)
        require(ok, f"refine_inner variants disagree or leave their plain version: {line}")
        ri_err = max(ri_err, err)
    # What a phase costs in each variant at op2's level shapes: times at
    # (n_inner, solver_it) = (1, 1), (5, 1), (5, 5) fit fixed + n_inner *
    # (smoothness and coefficients + 2 solver_it SOR half-steps), each phase
    # with the barrier after it.
    for name, a in rcases[:3]:
        fit = {}
        for v in kernels.refine_variants(*a[0].shape):
            t = {(ni, si): gpu_ms(torch, lambda v=v, ni=ni, si=si: kernels.refine_inner(
                *a[:4], ni, si, *a[6:], variant=v), 10) * 1e3
                 for ni, si in ((1, 1), (5, 1), (5, 5))}
            half = (t[5, 5] - t[5, 1]) / 40
            iteration = (t[5, 1] - t[1, 1]) / 4 - 2 * half
            fit[v] = dict(us_per_sor_half_step=half, us_per_smoothness_and_coefficients=iteration,
                          us_fixed=t[1, 1] - iteration - 2 * half)
        emit("refine_inner phase costs", case=name, hw=list(a[0].shape), per_variant=fit)

    rows["refine_inner"] = dict(
        source="refine_inner.cu", replaces="of_dis_tpu/ops/pallas_kernels.py:144",
        per="op2 gray", max_abs_err=ri_err, ms=ri_ms, plain_ms=ri_plain, bound_ms=ri_bound,
        bound_by=ri_bound_by, level_ms=ri_level_ms)

    # ---- kernels sor_scalar and sor_coupled: kernel vs plain version ----
    def sor_system(h, w, seed):
        r = np.random.RandomState(seed)

        def f(scale, off=0.0):
            return torch.as_tensor((r.randn(h, w) * scale + off).astype(np.float32), device=dev)

        wh, wv = f(0.5, 1.0).abs(), f(0.5, 1.0).abs()
        wh[:, -1] = 0.0
        wv[-1, :] = 0.0
        return (f(0.3), f(0.3), f(0.5, 2.0).abs(), f(0.2), f(0.5, 2.0).abs(), f(1.0), f(1.0),
                wh, wv)

    sor_kernels = {1: ("sor_scalar", sor_scalar_rb), 2: ("sor_coupled", sor_coupled_rb)}

    def sor_case(nop, case, a, timed):
        """Every launch variant of the nop solver (1 sor_scalar, 2
        sor_coupled) that can take the call's shape: bit-equal to one another
        and to the plain version (which divides and sums in the kernel's
        order); each variant's time."""
        name, plain = sor_kernels[nop]

        def run(fn, **kw):
            out = fn(*a, **kw)
            return out if nop == 2 else (out,)

        h, w = a[0].shape
        picked = kernels.sor_variant(h, w, nop)
        variants = kernels.sor_variants(h, w, nop)
        outs = {v: run(getattr(kernels, name), variant=v) for v in variants}
        ref = run(plain)
        torch.cuda.synchronize()
        out = outs[picked[0]]
        bit_equal = all(all(map(torch.equal, o, out)) for o in outs.values())
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        ok = bool(bit_equal and all(map(torch.equal, out, ref)))
        line = dict(case=case, hw=[h, w], iterations=int(a[-2]), picked=list(picked),
                    variants_bit_equal=bit_equal, max_abs_err=err, ok=ok,
                    variant_ms={v: gpu_ms(torch, lambda v=v: run(getattr(kernels, name),
                                                                variant=v), 20)
                                for v in variants})
        if timed:
            ms = gpu_ms(torch, lambda: run(getattr(kernels, name)), 50)
            pms = gpu_ms(torch, lambda: run(plain), 5)
            b, by = bound_ms(*sor_work(nop, h, w, int(a[-2])))
            line.update(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
        emit(f"kernel {name}", **line)
        require(ok, f"{name} variants disagree or leave their plain version: {line}")
        return line

    def sor_phase_costs(nop, cases):
        """What a half-step costs in each variant: iterations 1, 3 and 9 (2,
        6, 18 half-steps, each with the barrier before it) fit to a fixed
        cost per launch plus a cost per half-step."""
        name = sor_kernels[nop][0]
        for case, a in cases.items():
            h, w = a[0].shape
            fit = {}
            for v in kernels.sor_variants(h, w, nop):
                t = {it: gpu_ms(torch, lambda v=v, it=it: getattr(kernels, name)(
                    *a[:-2], it, a[-1], variant=v), 10) * 1e3 for it in (1, 3, 9)}
                per_half, fixed = np.polyfit([2.0 * it for it in t], list(t.values()), 1)
                fit[v] = dict(us_per_half_step=float(per_half), us_fixed=float(fixed),
                              us_at_iterations={str(it): u for it, u in t.items()})
            emit(f"{name} phase costs", case=case, hw=[h, w],
                 picked=list(kernels.sor_variant(h, w, nop)), per_variant=fit)

    # Between and above op2's level shapes, where sor_variant's thresholds lie.
    threshold_shapes = ((40, 96), (48, 112), (80, 160), (96, 192), (112, 256), (224, 512),
                        (448, 1024))

    # sor_scalar: every call of the stereo paths (15 per pair: levels 5, 4, 3
    # with n_inner 6, 5, 4; with fb 11 more, the backward flow's at levels 5
    # and 4) and 448x1024, through every variant; ms,
    # plain_ms and bound_ms of the kernels line sum stereo gray's calls.
    ss = dict(source="sor_rb.cu", replaces="of_dis_tpu/ops/pallas_kernels.py:1350",
              per="stereo gray", max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
              bound_by=None, level_ms={}, variant_ms={})
    fit_cases = {}  # one call per level shape of stereo gray, for the phase costs
    for name in ("stereo gray", "stereo rgb", "stereo gray fb"):
        cfg = inputs[name][2]
        levels = call_levels(cfg, lambda sl: cfg.tv_innerit * (sl + 1))
        for sl, (a, _) in zip(levels, calls[name]["sor_scalar"]):
            line = sor_case(1, f"{name} level {sl}", a, name == "stereo gray")
            ss["max_abs_err"] = max(ss["max_abs_err"], line["max_abs_err"])
            if name == "stereo gray":
                fit_cases.setdefault(f"{name} level {sl}", a)
                for key in ("ms", "plain_ms", "bound_ms"):
                    ss[key] += line[key]
                ss["bound_by"] = line["bound_by"]
                ss["level_ms"][sl] = ss["level_ms"].get(sl, 0.0) + line["ms"]
                for v, t in line["variant_ms"].items():
                    ss["variant_ms"][v] = ss["variant_ms"].get(v, 0.0) + t
    for h, w in threshold_shapes:
        s = sor_system(h, w, h * w)
        fit_cases[f"random {h}x{w}"] = (s[0], s[2], s[5], s[7], s[8], 3, 1.6)
    line = sor_case(1, "random 448x1024", fit_cases["random 448x1024"], True)
    ss["max_abs_err"] = max(ss["max_abs_err"], line["max_abs_err"])
    rows["sor_scalar"] = ss
    sor_phase_costs(1, fit_cases)

    # sor_coupled: on no path (flow levels run it inside refine_inner); on
    # seeded fields at op2's level shapes (levels 5, 4, 3 at 1024x436), at
    # op4's level 0 (448x1024) and between them, through every variant; ms,
    # plain_ms and bound_ms of the kernels line sum op2's three shapes, and
    # variant_ms gives each variant's ms at each of them.
    sc = dict(source="sor_rb.cu", replaces="of_dis_tpu/ops/pallas_kernels.py:58",
              per=None, max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
              level_ms={}, variant_ms={})
    coupled_cases = {f"op2 level {sl} shape": (h, w)
                     for sl, (h, w) in ((5, (14, 32)), (4, (28, 64)), (3, (56, 128)))}
    # and where sor_variant(h, w, 2)'s own thresholds lie (1,536 and 4,096 pairs)
    coupled_cases.update({f"random {h}x{w}": (h, w) for h, w in
                          ((32, 64), (40, 64), (48, 64), (64, 128), (72, 128)) + threshold_shapes})
    fit_cases = {}
    for case, (h, w) in coupled_cases.items():
        a = fit_cases[case] = sor_system(h, w, h + w) + (3, 1.6)
        line = sor_case(2, case, a, case.startswith("op2") or h == 448)
        sc["max_abs_err"] = max(sc["max_abs_err"], line["max_abs_err"])
        if case.startswith("op2"):
            sl = case.split()[2]
            for key in ("ms", "plain_ms", "bound_ms"):
                sc[key] += line[key]
            sc["bound_by"] = line["bound_by"]
            sc["level_ms"][sl] = line["ms"]
            for v, t in line["variant_ms"].items():
                sc["variant_ms"].setdefault(v, {})[sl] = t
    rows["sor_coupled"] = sc
    sor_phase_costs(2, fit_cases)

    # ---- main path: each path through the kernels, counted ----
    def golden(case):
        return np.load(FULLRES / f"{case}.npz")["ref"].astype(np.float32)

    def cpu_flow(name):
        """The path on the CPU, and its seconds; op4 in a child process that
        is stopped at CPU_LIMIT_S (then None)."""
        if name != "op4 gray":
            t0 = time.perf_counter()
            flow = run_path(name, *inputs[name], "cpu")
            return flow, time.perf_counter() - t0
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        out = OUT_DIR / "op4_cpu.npy"
        code = f"import chip_smoke; chip_smoke.cpu_run_to({name!r}, {str(out)!r})"
        try:
            proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                                  text=True, timeout=CPU_LIMIT_S + 30)
        except subprocess.TimeoutExpired:
            return None, f">= {CPU_LIMIT_S + 30} (stopped)"
        require(proc.returncode == 0, f"op4 CPU run failed: {proc.stderr[-2000:]}")
        secs = json.loads(proc.stdout.strip().splitlines()[-1])["seconds"]
        return (np.load(out) if secs < CPU_LIMIT_S else None), secs

    flows = {}
    counts = {}
    latency = {}
    for name in PATHS:
        img1, img2, cfg = inputs[name]
        kernels.reset_launches()
        flow = run_path(name, img1, img2, cfg, dev)
        torch.cuda.synchronize()
        counts[name] = dict(kernels.launches)
        require(counts[name] == expected_launches(name),
                f"{name} pair launched {counts[name]}, expected {expected_launches(name)}")
        flows[name] = flow
        again = run_path(name, img1, img2, cfg, dev)
        line = dict(config=f"{name} {w0}x{h0}", launches=counts[name],
                    finite_and_shaped=bool(np.isfinite(flow).all()
                                           and flow.shape == (h0, w0, cfg.nop)),
                    bit_identical=bool(np.array_equal(flow, again)))
        case = PATHS[name][4]
        if case is not None:
            line["epe_vs_golden"] = epe(flow, golden(case))
        if name in CPU_CHECKED:
            flow_cpu, secs = cpu_flow(name)
            line["cpu_seconds"] = secs
            if flow_cpu is not None:
                line["epe_card_vs_cpu"] = epe(flow, flow_cpu)
            else:
                line["epe_card_vs_cpu"] = f"not compared: the CPU pair takes >= {CPU_LIMIT_S} s"
        if name in PAIRS_TIMED:
            for _ in range(3):
                run_path(name, img1, img2, cfg, dev)
            torch.cuda.synchronize()
            pair_ms = []
            for _ in range(PAIRS_TIMED[name]):
                t0 = time.perf_counter()
                run_path(name, img1, img2, cfg, dev)
                torch.cuda.synchronize()
                pair_ms.append((time.perf_counter() - t0) * 1e3)
            latency[name] = float(np.median(pair_ms))
            line.update(pair_ms_median=latency[name], pair_ms_min=float(np.min(pair_ms)),
                        pairs_timed=len(pair_ms))
        emit("main path", **line)
        require(line["finite_and_shaped"], f"{name}: non-finite or misshapen output")
        require(line["bit_identical"], f"{name}: two runs differ")
        if "epe_vs_golden" in line:
            require(line["epe_vs_golden"] < EPE_GOLDEN,
                    f"{name}: mean EPE {line['epe_vs_golden']}")
        if isinstance(line.get("epe_card_vs_cpu"), float):
            require(line["epe_card_vs_cpu"] < EPE_CPU,
                    f"{name}: card vs CPU mean EPE {line['epe_card_vs_cpu']}")

    # ---- fb-merge: the scatter's order, at op2 gray fb's finest level ----
    # That level's two searches (forward, backward) from the recorded calls;
    # the merge twice on the card (the same bits required), once on the CPU
    # (reported), and the densify stage's device time with and without it.
    from of_dis_tpu_torch.models.densify import aggregate_flow_dense
    from of_dis_tpu_torch.models.grid import level_geometry

    (a_fw, k_fw), (a_bw, k_bw) = calls["op2 gray fb"]["level_search"][-2:]
    res_fw, res_bw = kernels.level_search(*a_fw, **k_fw), kernels.level_search(*a_bw, **k_bw)
    cfg_fb = a_fw[6]
    geo = level_geometry(a_fw[7], a_fw[8], cfg_fb)

    def merge(fw, bw):
        return aggregate_flow_dense(fw, geo, cfg_fb, bw_result=bw)

    def on_cpu(res):
        return type(res)(*(None if t is None else t.cpu() for t in res))

    m1, m2 = merge(res_fw, res_bw), merge(res_fw, res_bw)
    m_cpu = merge(on_cpu(res_fw), on_cpu(res_bw))
    torch.cuda.synchronize()
    line = dict(config=f"op2 gray fb {w0}x{h0} level {cfg_fb.sc_l}", hw=[geo.h, geo.w],
                patches=geo.n_patches, cells=geo.n_patches * cfg_fb.patch_size ** 2 * 4,
                bit_identical=bool(torch.equal(m1, m2)),
                equal_to_cpu=bool(torch.equal(m1.cpu(), m_cpu)),
                max_abs_err_vs_cpu=float((m1.cpu() - m_cpu).abs().max()),
                densify_ms=gpu_ms(torch, lambda: aggregate_flow_dense(res_fw, geo, cfg_fb), 20),
                densify_with_merge_ms=gpu_ms(torch, lambda: merge(res_fw, res_bw), 20))
    emit("fb merge", **line)
    require(line["bit_identical"], f"two merges on the card differ: {line}")

    # ---- batched: B distinct pairs per call, each equal to its own run ----
    throughput = batched_phase(torch, dev, inputs, rows, smi, golden, sor_system)

    # ---- where the time goes: device activity over a traced window ----
    # Busy time and wall time come from the same traced window, so the idle
    # share includes the profiler's own host overhead.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, n_prof in PROFILED.items():
        img1, img2, cfg = inputs[name]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_prof):
                run_path(name, img1, img2, cfg, dev)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / n_prof
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in dev_events:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
        busy_ms = sum(t for t, _ in by_name.values()) / n_prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        emit("profile", config=name, pairs=n_prof, traced_wall_ms_per_pair=traced_ms,
             device_ops_per_pair=len(dev_events) / n_prof if dev_events else "not measured",
             device_busy_ms_per_pair=busy_ms if dev_events else "not measured",
             device_idle_share_traced=(1.0 - busy_ms / traced_ms) if dev_events
             else "not measured",
             top=[dict(name=k[:80], ms_per_pair=t / n_prof, per_pair=c / n_prof)
                  for k, (t, c) in top])

    # ---- cli: flow .flo and stereo .pfm equal the library's output ----
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, files, out_name in (("op2 gray", OF, "of_int_op2.flo"),
                                  ("stereo gray", DE, "de_int_op2.pfm")):
        out = OUT_DIR / out_name
        proc = subprocess.run(
            [sys.executable, "-m", "of_dis_tpu_torch.cli", str(FULLRES / files[0]),
             str(FULLRES / files[1]), str(out), "--op", "2", "-v", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        require(proc.returncode == 0, f"cli failed: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        if out_name.endswith(".flo"):
            cli_equal = bool(np.array_equal(io.read_flo(out), flows[name]))
        else:
            lib = OUT_DIR / "library.pfm"
            io.write_pfm(lib, flows[name][..., 0])
            cli_equal = out.read_bytes() == lib.read_bytes()
        emit("cli", output=out_name, returncode=proc.returncode,
             stdout=proc.stdout.strip().splitlines()[-1:], equal_to_library=cli_equal)
        require(cli_equal, f"cli {out_name} differs from the library's output")

    # The fb paths through the CLI's 20 explicit parameters: op2 gray fb at
    # -v 2 (utils/instrument.py's per-scale table), stereo gray fb at -v 0
    # with --viz; each file must equal the library's output bit for bit.
    for name, files, out_name, extra in (
            ("op2 gray fb", OF, "of_int_fbcon.flo", ["-v", "2"]),
            ("stereo gray fb", DE, "de_int_fbcon.pfm", ["-v", "0", "--viz",
                                                        str(OUT_DIR / "de_int_fbcon.pgm")])):
        cfg = inputs[name][2]
        out = OUT_DIR / out_name
        proc = subprocess.run(
            [sys.executable, "-m", "of_dis_tpu_torch.cli", str(FULLRES / files[0]),
             str(FULLRES / files[1]), str(out), "--params", *cli_params(cfg), *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        require(proc.returncode == 0, f"cli failed: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        if out_name.endswith(".flo"):
            cli_equal = bool(np.array_equal(io.read_flo(out), flows[name]))
        else:
            lib = OUT_DIR / "library.pfm"
            io.write_pfm(lib, flows[name][..., 0])
            cli_equal = out.read_bytes() == lib.read_bytes()
        lines = proc.stdout.strip().splitlines()
        line = dict(output=out_name, args=extra, returncode=proc.returncode,
                    equal_to_library=cli_equal)
        if "2" in extra:
            table = [ln for ln in lines if ln.startswith("TIME (Sc:")]
            line.update(stdout=lines, scale_rows=len(table),
                        table_ok=len(table) == cfg.n_scales
                        and any(ln.startswith("TIME (Pyramide+Gradients)") for ln in lines)
                        and any(ln.startswith("TIME (O.Flow Run-Time   )") for ln in lines))
        else:
            img = io._read_pnm_numpy(OUT_DIR / "de_int_fbcon.pgm")
            line.update(viz_shape=list(img.shape), viz_std=float(img.std()),
                        table_ok=tuple(img.shape[:2]) == (h0, w0) and float(img.std()) > 0)
        emit("cli", **line)
        require(cli_equal, f"cli {out_name} differs from the library's output")
        require(line["table_ok"], f"cli {out_name}: {line}")

    # ---- kernels ----
    kernel_rows = [
        dict(name=k, route="cuda", source=f"of_dis_tpu_torch/csrc/{rows[k]['source']}",
             replaces=rows[k]["replaces"],
             launches=counts[rows[k]["per"]][k] if rows[k]["per"] else 0,
             max_abs_err=rows[k]["max_abs_err"], ms=rows[k]["ms"],
             plain_ms=rows[k]["plain_ms"], bound_ms=rows[k]["bound_ms"],
             bound_by=rows[k]["bound_by"], library_ms=None,
             **{key: rows[k][key] for key in ("level_ms", "variant_ms", "ms_per_pair_b32")
                if key in rows[k]})
        for k in KERNELS
    ]
    emit("kernels", note="launches, ms, plain_ms and bound_ms are per pair of the path "
         "named in `per` (the sum over its launches; level_ms splits ms by pyramid level, "
         "variant_ms gives it for each launch variant); ms_per_pair_b32 is the time of the "
         "same calls of the batched path at B = 32 distinct pairs, over 32; "
         "sor_coupled is on no path: its times sum one launch at each op2 level shape, "
         "and its variant_ms gives each variant's ms at each of those levels",
         per={k: rows[k]["per"] for k in KERNELS}, launches_per_path=counts,
         pair_ms_median=latency, batched_pairs_per_s=throughput,
         checks={k: "ok" for k in KERNELS},
         total_seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
