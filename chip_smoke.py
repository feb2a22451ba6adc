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
phase.  The entry's frame_pad and flow_upscale (one launch of each per call
of dis_raw or batched_flow) equal their plain versions on every recorded
call, and are timed on op2 gray's frames as uint8 at B = 1 and 32 and on
the flows of op2, stereo gray and op4 gray, beside PyTorch's own ops for
the same result.  The merge's scatter runs twice on the card on op2 gray fb's finest
level (the same bits required) and once on the CPU.  A batched phase then
drives op2 gray (B = 32), stereo gray (B = 8), op4 gray (B = 4) and op2
gray fb (B = 4) on distinct pairs through batched_flow: each pair must
equal its own run, each kernel call of a batch its plain version on the
same batched tensors, and every kernel in every variant at B = 1, 2, 7, 32
its per-pair launches; it prints op2 gray pairs/s at B = 1, 8, 32.
Before the main paths run, the graphs phase holds the port's compiled
executables (ops/graphs.py: a CUDA graph captured once per static key and
replayed) against eager runs (graphs.eager()): on each of the nine paths
the capture's result, two replays, a replay on another pair and a replay
after the lru_caches that fed the capture were cleared and memory was
churned, all bit-equal to the eager runs, with the eager launches per
replay; batched_flow at B = 1, 8, 32 (each pair equal to its own run);
process_video_batched over 16 frames with warm start and two chunks
queued (equal to the eager run and to a run resumed in the middle);
dis_flow_timed's stage executables; and every kernel captured alone in
each launch variant, against its plain version.  It prints each
executable's capture ms and pool MiB.  The paths then run through their
graphs by default; kernel-call recordings run under eager().  Pair
latency, the profile and throughput are taken in both modes.
The video files phase writes op2 gray's first frame, rolled 4 px a frame,
as 193 8-bit .pgm files and runs process_video_batched over them (chunks
of 32, 4 queued, the native PNM reader and .flo writer): a run without
warm start must write what io.write_flo writes of batched_flow on the same
frames, byte for byte, the warm-started runs must agree, each chunk must
cost the host one wait (ops/transfer.py's counts); it prints pairs/s, the
host's seconds per chunk by part, the copies' GB/s and the device's busy
and idle share, and times the runs again, in turns, with the copies moved
onto an upload and a download stream of their own (from the files and
from the same frames in memory).  Every result a path returns is copied
to the host through pinned memory (transfer.to_host).
It checks the outputs against the reference binaries' goldens, the port's CPU path and
a second run (bit-identical), times pairs, profiles the device, runs the
CLI (flow and stereo; the fb paths at -v 2, whose per-scale table must
print, and with --viz), and prints one JSON line per phase.  Last, the
spatial phase starts one 4-rank gloo world on cuda:0 (spawned processes, a
file store under build/chip_smoke/spatial; the card's compute mode must not
be Exclusive_Process) and drives spatial sharding there (SPATIAL): op2 gray
and stereo gray in column strips (tx = 4), op4 gray and op2 gray fb in 2x2
tiles (gn_search's tile form), flow_2d over (data, tx) = (2, 2) on 4 pairs
and batched_flow over data = 4 on 8 pairs; each path against its golden,
the single-device run on the card (mean EPE under 1e-3 where no warm start
was clamped, the max difference printed beside it; batched_flow bit for
bit), with
every kernel call of each rank equal to its plain version and op4's
level-0 tile calls equal to the untiled kernel; it prints launches per
rank, pair ms, exchanges and host-staged bytes per pair and peak memory per
rank.  The ranks share one card, so those times say nothing about sharding
across cards.  Then the spatial nccl phase runs the same paths in a 4-rank
NCCL world (on cuda:0, each rank named a host of its own by NCCL_HOSTID,
NCCL_SOCKET_IFNAME=lo and NCCL_IB_DISABLE=1, so that NCCL takes them for
four nodes and moves the exchanges over its socket transport; one rank per
card on a host with four): each path under eager() (every kernel call
against its plain version; on the rolled pair with host syncs raising),
then through its sharded executable (one CUDA graph per rank and static
key, the NCCL collectives captured inside): the first call, a replay and
a replay on the rolled pair, each bit-equal to the eager run, counting its
launches and exchanges, nothing staged through the host; it prints the
mode that ran, capture ms and pool MiB, host-dispatched ops per pair in
both modes and the max difference from the gloo world's flow.  The line
before the last lists every kernel with its times and bound; the last line
is {"ok": true, "device": {...}}.  Any failure raises and the script exits
non-zero without that line; so does a host without CUDA.

Times: CUDA events around one launch, queued behind a device-side sleep so
the host's enqueue is not timed (median over repetitions).  Bounds: the
larger of bytes over 3.35 TB/s and FP32 operations over 67 TFLOP/s (H100
SXM data sheet), counted from this run's inputs and GN trips.
"""

from __future__ import annotations

import contextlib
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
EPE_SHARDED = 1e-3           # sharded vs single-device, tests/test_torch_spatial.py's bound
CPU_LIMIT_S = 60.0           # op4's card-vs-CPU check runs only if its CPU pair takes less
KERNELS = ("level_search", "gn_search", "refine_inner", "sor_scalar", "sor_coupled",
           "frame_pad", "flow_upscale")
# The entry's two kernels: one launch of each per call of dis_raw's or
# batched_flow's executable (models/dis.py::dis_entry_jit), whatever B is.
ENTRY = dict(frame_pad=1, flow_upscale=1)

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


def expected_launches(name: str, entry: bool = True) -> dict:
    """The launches of one call of a path: its own kernels, and with entry
    the entry's (process_video_batched pads and upscales with the plain
    functions, so its chunks launch neither)."""
    want = {**PATHS[name][5], **(ENTRY if entry else {})}
    return {k: want.get(k, 0) for k in KERNELS}


def plain_versions() -> dict:
    """Each kernel's plain PyTorch version, taking the wrapper's arguments
    (the wrappers run these on the CPU)."""
    import torch

    from of_dis_tpu_torch.models.dis import _upscale_crop
    from of_dis_tpu_torch.models.inverse_search import (
        gn_search_reference,
        level_search_reference,
    )
    from of_dis_tpu_torch.models.refine import refine_inner_reference, sor_coupled_rb, sor_scalar_rb
    from of_dis_tpu_torch.ops import pyramid as pyr

    def frame_pad(img1, img2, divisor):
        return tuple(pyr.pad_to_divisible(x.to(torch.float32), divisor) for x in (img1, img2))

    def flow_upscale(flow, cfg, hp, wp, h0, w0):
        single = flow.ndim == 3
        out = _upscale_crop(flow[None] if single else flow, cfg, hp, wp, h0, w0)
        return out[0] if single else out

    return {"level_search": level_search_reference, "gn_search": gn_search_reference,
            "refine_inner": refine_inner_reference, "sor_scalar": sor_scalar_rb,
            "sor_coupled": sor_coupled_rb, "frame_pad": frame_pad, "flow_upscale": flow_upscale}


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
    """One pair through the path's entry point: (H, W, nop) on the host,
    copied there as a user's result is (ops/transfer.py: through pinned
    memory, waiting for this result only)."""
    from of_dis_tpu_torch import dis_flow, dis_stereo
    from of_dis_tpu_torch.ops.transfer import to_host

    if cfg.mode == "stereo":
        return to_host(dis_stereo(img1, img2, cfg, device=device)[..., None]).numpy()
    return to_host(dis_flow(img1, img2, cfg, device=device)).numpy()


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


def dispatched(name: str) -> bool:
    """Whether a CUDA API call (cuda* or cu*) enqueues work on the device (a
    kernel launch, a graph launch, a copy or a fill)."""
    return name.startswith("cu") and any(w in name for w in ("Launch", "Memcpy", "Memset"))


def profile_summary(prof, traced_ms: float, n: int, DeviceType) -> dict:
    """Per pair (or batch) of a torch.profiler window over n of them: device
    ops (a graph replay's nodes each counted), the host's calls that
    enqueued them (a graph launch counted once), device busy ms, the idle
    share of the window's wall time, the largest device items."""
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    host_calls = [e for e in events if e.device_type == DeviceType.CPU and dispatched(e.name)]
    by_name = {}
    for e in dev_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = {}
    for e in host_calls:
        host[e.name] = host.get(e.name, 0) + 1
    return dict(
        traced_wall_ms_per_pair=traced_ms,
        copy_ms_per_pair={k: t / n for k, (t, _) in sorted(by_name.items())
                          if k.startswith("Memcpy")},
        device_ops_per_pair=len(dev_events) / n if dev_events else "not measured",
        host_dispatched_ops_per_pair=len(host_calls) / n if host_calls else "not measured",
        host_dispatch_calls_per_pair={k: c / n for k, c in sorted(host.items())},
        device_busy_ms_per_pair=busy_ms if dev_events else "not measured",
        device_idle_share_traced=(1.0 - busy_ms / traced_ms) if dev_events else "not measured",
        top=[dict(name=k[:80], ms_per_pair=t / n, per_pair=c / n) for k, (t, c) in top])


def record_calls(kernels, fn) -> dict:
    """fn() with every kernel wrapper's calls recorded: {kernel: [(args, kwargs)]}.
    A graph replay calls no wrapper, so fn runs under graphs.eager()."""
    from of_dis_tpu_torch.ops import graphs

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
        with graphs.eager():
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
    if kernel == "frame_pad":  # img1, img2, divisor
        return (a[0][0], a[1][0], *a[2:])
    if kernel == "flow_upscale":  # flow, cfg, hp, wp, h0, w0
        return (a[0][0], *a[1:])
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
    from of_dis_tpu_torch.models.inverse_search import PatchTemplates

    bcalls = {}
    for name, nb in BATCHED.items():
        img1, img2, cfg = inputs[name]
        a, bb = rolled_batch(img1, img2, nb)
        batched_flow(a, bb, cfg, device=dev)  # captures dis_entry_jit's graph, if new
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
    plain = plain_versions()
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

    def pad_make(a):
        """frame_pad's (img1, img2, divisor): the batch's pairs are distinct
        (rolled) up to its own B, repeated past it."""
        def make(b):
            x1, x2 = (tiled(torch, x, b) for x in a[:2])
            return (x1, x2, *a[2:]), [(x1[i], x2[i], *a[2:]) for i in range(b)]
        return make

    def upscale_make(a):
        def make(b):
            nb = a[0].shape[0]
            f = (tiled(torch, a[0], b) + shift(b, nb, 0.25)[:, None, None, None]).contiguous()
            return (f, *a[1:]), [(f[i], *a[1:]) for i in range(b)]
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
        "frame_pad": lambda a, v: kernels.frame_pad(*a),
        "flow_upscale": lambda a, v: kernels.flow_upscale(*a),
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
    # the entry's: op2's frames; the flows of op2 (nop 2, sc_l 3), stereo (nop 1), op4 (sc_l 0)
    bcases.append(("frame_pad", "op2 gray", pad_make(bcalls["op2 gray"]["frame_pad"][0][0]),
                   (None,), True))
    for name in ("op2 gray", "stereo gray", "op4 gray"):
        bcases.append(("flow_upscale", name, upscale_make(bcalls[name]["flow_upscale"][0][0]),
                       (None,), name == "op2 gray"))

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
    # card, through models/dis.py::dis_padded_jit (as bench.py feeds the JAX
    # package's _batched_padded): QUEUED
    # batches queued, then the last one's copy to the host; THROUGHPUT_REPS
    # repetitions.  Then one profiled batch: device busy per pair and idle.
    from of_dis_tpu_torch.ops import pyramid as pyr
    from of_dis_tpu_torch.models.dis import dis_padded_jit

    from of_dis_tpu_torch.ops import graphs

    img1, img2, cfg = inputs["op2 gray"]
    scf = 1 << cfg.sc_f
    throughput = {"graph": {}, "eager": {}}
    for mode, b in ((m, b) for m in throughput for b in THROUGHPUT_B):
        a, bb = (pyr.pad_to_divisible(torch.as_tensor(x, device=dev), scf)
                 for x in rolled_batch(img1, img2, b))
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            dis_padded_jit(a, bb, cfg).cpu()
            rates = []
            for _ in range(THROUGHPUT_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(QUEUED):
                    last = dis_padded_jit(a, bb, cfg)
                last.cpu()
                rates.append(QUEUED * b / (time.perf_counter() - t0))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dis_padded_jit(a, bb, cfg).cpu()
                wall_ms = (time.perf_counter() - t0) * 1e3
        summary = profile_summary(prof, wall_ms / b, b, DeviceType)
        throughput[mode][str(b)] = float(np.median(rates))
        emit("throughput", config=f"op2 gray {w0}x{h0} batched, pre-padded on the card",
             mode=mode, batch=b, queued_batches=QUEUED, reps=THROUGHPUT_REPS,
             pairs_per_s_median=float(np.median(rates)), pairs_per_s_min=float(min(rates)),
             pairs_per_s_max=float(max(rates)), pairs_per_s_all=rates,
             profiled_batch_wall_ms=wall_ms,
             device_busy_ms_per_pair=summary["device_busy_ms_per_pair"],
             device_idle_share=summary["device_idle_share_traced"],
             host_dispatched_ops_per_batch=(summary["host_dispatched_ops_per_pair"] * b
                                            if isinstance(summary["host_dispatched_ops_per_pair"],
                                                          float) else "not measured"),
             nvidia_smi=smi)
    return throughput


# ---- the graphs phase: compiled executables against eager runs ----
GRAPH_B = (1, 8, 32)     # batched_flow's dis_entry_jit graphs, op2 gray
VIDEO_FRAMES = 16        # process_video_batched: op2 gray's first frame moved 4 px a frame
VIDEO_B = 4
VIDEO_QUEUE = 2
VIDEO_CUT = 8            # pairs a first run yields before it is stopped, then resumed
CHURN_MIB = 512


def clear_and_churn(torch, dev) -> None:
    """Clear the lru_caches whose tensors graphs read (level geometry on
    the card), then allocate, write and free CHURN_MIB of device memory."""
    from of_dis_tpu_torch.models import dis as tdis
    from of_dis_tpu_torch.models import grid

    tdis._grid_tensors_cached.cache_clear()
    grid._level_geometry_cached.cache_clear()
    churn = [torch.full((64, 1 << 18), float(i), device=dev) for i in range(CHURN_MIB // 64)]
    torch.cuda.synchronize()
    del churn


def _alone(kernel: str, *args, **kw):
    """One kernel wrapper's call, for an executable that captures it alone."""
    from of_dis_tpu_torch.ops import kernels

    return getattr(kernels, kernel)(*args, **kw)


def graphs_phase(torch, dev, inputs, calls, golden, sor_system, smi) -> dict:
    """Every path, the batched and video drivers, dis_flow_timed and each
    kernel through their executables (CUDA graphs), each against its eager
    run (graphs.eager()) bit for bit; prints every executable's capture ms
    and pool MiB.  Returns {path: pool MiB of its executable} for the
    kernels line."""
    import contextlib
    import shutil

    from of_dis_tpu_torch import batched_flow, eager
    from of_dis_tpu_torch.ops import graphs, kernels
    from of_dis_tpu_torch.parallel.video import process_video, process_video_batched
    from of_dis_tpu_torch.utils.instrument import dis_flow_timed

    def first_call(fn):
        """fn() as the first call of its keys: (result, the executables it
        captured, its wall ms, warm-up and capture included)."""
        before = {id(e) for e in graphs.cache.entries(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return out, [e for e in graphs.cache.entries(dev) if id(e) not in before], ms

    def described(e):
        return dict(key=graphs.describe(e.key)[:160], capture_ms=e.capture_ms,
                    pool_mib=e.pool_bytes / 2**20, launches_per_replay=e.launches,
                    held_tensors=len(e.held))

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.launches)

    h0, w0 = inputs["op2 gray"][0].shape[:2]
    pools = {}
    for name in PATHS:
        img1, img2, cfg = inputs[name]

        def run(a=img1, b=img2):
            return run_path(name, a, b, cfg, dev)

        with eager():
            want, eager_launches = counted(run)
        first, made, first_ms = first_call(run)
        again, replay_launches = counted(run)
        twice = run()
        a, b = rolled_batch(img1, img2, 2)
        with eager():
            other_want = run(a[1], b[1])
        other = run(a[1], b[1])
        clear_and_churn(torch, dev)
        after_clear = run()
        pools[name] = sum(e.pool_bytes for e in made) / 2**20
        line = dict(config=f"{name} {w0}x{h0}", executables=[described(e) for e in made],
                    first_call_ms=first_ms, eager_launches=eager_launches,
                    replay_launches=replay_launches,
                    capture_equal_to_eager=bool(np.array_equal(first, want)),
                    replays_equal_to_eager=bool(np.array_equal(again, want)
                                                and np.array_equal(twice, want)),
                    other_pair_equal_to_eager=bool(np.array_equal(other, other_want)),
                    other_pair_differs=not np.array_equal(other_want, want),
                    after_cache_clear_equal=bool(np.array_equal(after_clear, want)),
                    nvidia_smi=smi)
        case = PATHS[name][4]
        if case is not None:
            line["epe_vs_golden"] = epe(first, golden(case))
        emit("graph path", **line)
        require(len(made) == 1 and made[0].pool_bytes > 0,
                f"{name}: captured {len(made)} executables, expected 1 with a pool: {line}")
        require(eager_launches == expected_launches(name) == replay_launches
                and made[0].launches == {k: n for k, n in eager_launches.items() if n},
                f"{name}: launches eager {eager_launches}, per replay {replay_launches}")
        require(all(line[k] for k in ("capture_equal_to_eager", "replays_equal_to_eager",
                                      "other_pair_equal_to_eager", "other_pair_differs",
                                      "after_cache_clear_equal")),
                f"{name}: a graph result differs from its eager run: {line}")
        if "epe_vs_golden" in line:
            require(line["epe_vs_golden"] < EPE_GOLDEN, f"{name} graph: {line}")

    # batched_flow through dis_entry_jit's graph at each b of GRAPH_B
    img1, img2, cfg = inputs["op2 gray"]
    for b in GRAPH_B:
        a, bb = rolled_batch(img1, img2, b)

        def run_batch():
            return batched_flow(a, bb, cfg, device=dev).cpu().numpy()

        with eager():
            want = run_batch()
        got, made, first_ms = first_call(run_batch)
        again = run_batch()
        own = [run_path("op2 gray", a[i], bb[i], cfg, dev) for i in range(b)]
        pools[f"op2 gray B = {b}"] = sum(e.pool_bytes for e in made) / 2**20
        line = dict(config=f"op2 gray {w0}x{h0} batched_flow", pairs=b,
                    executables=[described(e) for e in made], first_call_ms=first_ms,
                    equal_to_eager=bool(np.array_equal(got, want) and np.array_equal(again, want)),
                    pairs_equal_to_own_run=sum(bool(np.array_equal(got[i], own[i]))
                                               for i in range(b)))
        emit("graph batched", **line)
        require(line["equal_to_eager"] and line["pairs_equal_to_own_run"] == b,
                f"batched graph B = {b}: {line}")

    # process_video_batched: warm start chained on the card, VIDEO_QUEUE chunks
    # pending; graph against eager, and a run stopped after VIDEO_CUT pairs
    # and resumed (its warm start re-read from the last file written)
    frames = [np.roll(img1, 4 * i, axis=1) for i in range(VIDEO_FRAMES)]
    root = OUT_DIR / "video"
    shutil.rmtree(root, ignore_errors=True)

    def video(d, mode_eager=False, stop=None):
        done = []
        with eager() if mode_eager else contextlib.nullcontext():
            gen = process_video_batched(frames, root / d, cfg, batch_size=VIDEO_B,
                                        loader=lambda x: x, queue_depth=VIDEO_QUEUE, device=dev)
            for item in gen:
                done.append(item)
                if len(done) == stop:
                    gen.close()
                    break
        return done

    _, made, first_ms = first_call(lambda: video("graph"))
    video("eager", mode_eager=True)
    video("resumed", stop=VIDEO_CUT)
    cut_at = json.loads((root / "resumed" / "progress.json").read_text())["last_completed"]
    video("resumed")
    n_pairs = VIDEO_FRAMES - 1
    files = [f"flow_{i:06d}.flo" for i in range(n_pairs)]
    same = {d: sum((root / d / f).read_bytes() == (root / "graph" / f).read_bytes() for f in files)
            for d in ("eager", "resumed")}
    line = dict(config=f"op2 gray {w0}x{h0} process_video_batched", frames=VIDEO_FRAMES,
                batch_size=VIDEO_B, queue_depth=VIDEO_QUEUE, warm_start=True,
                executables=[described(e) for e in made], first_run_ms=first_ms,
                cut_after_pair=cut_at, files_equal_to_graph_run=same)
    emit("graph video", **line)
    require(same == {"eager": n_pairs, "resumed": n_pairs} and cut_at == VIDEO_CUT - 1,
            f"video graph: {line}")
    # process_video: a pair at a time through dis_raw, warm-started (dis_padded_init_jit)
    for d, mode_eager in (("single graph", False), ("single eager", True)):
        with eager() if mode_eager else contextlib.nullcontext():
            list(process_video(frames[:VIDEO_B + 1], root / d, cfg, loader=lambda x: x,
                               device=dev))
    files = [f"flow_{i:06d}.flo" for i in range(VIDEO_B)]
    line = dict(config=f"op2 gray {w0}x{h0} process_video", frames=VIDEO_B + 1,
                warm_start=True,
                files_equal_to_eager=sum((root / "single graph" / f).read_bytes()
                                         == (root / "single eager" / f).read_bytes()
                                         for f in files))
    emit("graph video", **line)
    require(line["files_equal_to_eager"] == VIDEO_B, f"process_video graph: {line}")

    # dis_flow_timed (-v 2): one executable per stage, its result dis_raw's
    img1, img2, cfg = inputs["op2 gray fb"]
    out, made, first_ms = first_call(
        lambda: dis_flow_timed(img1, img2, cfg, verbosity=0, device=dev)[0].cpu().numpy())
    again, stats = dis_flow_timed(img1, img2, cfg, verbosity=0, device=dev)
    want = run_path("op2 gray fb", img1, img2, cfg, dev)
    line = dict(config=f"op2 gray fb {w0}x{h0} dis_flow_timed", stage_executables=len(made),
                capture_ms=sum(e.capture_ms for e in made),
                pool_mib=sum(e.pool_bytes for e in made) / 2**20,
                equal_to_dis_raw=bool(np.array_equal(out, want)
                                      and np.array_equal(again.cpu().numpy(), want)),
                replay_total_ms=sum(st["total"] for st in stats))
    emit("graph dis_flow_timed", **line)
    require(line["equal_to_dis_raw"] and len(made) > 0, f"dis_flow_timed graph: {line}")

    # every kernel captured alone, in each launch variant, against its plain
    # version; in a cache of its own, so that the paths' executables stay held
    kernel_cache = graphs.ExecutableCache(graphs.CudaGraphs(), len(KERNELS) * 16)

    def alone(*a, **kw):
        return kernel_cache.call(_alone, a, kw)

    plain = plain_versions()
    cases = [("level_search", a, k) for a, k in calls["op2 gray"]["level_search"]]
    cases += [("level_search", a, k) for a, k in calls["stereo gray fb"]["level_search"]
              if k.get("camlr") == 1][:1]
    cases += [("gn_search", a, k) for a, k in calls["op4 gray"]["gn_search"]]
    for a, _ in calls["op2 gray"]["refine_inner"]:
        cases += [("refine_inner", a, dict(variant=v)) for v in kernels.refine_variants(*a[0].shape)]
    seen = set()
    for a, _ in calls["stereo gray"]["sor_scalar"]:
        if a[0].shape not in seen:
            seen.add(a[0].shape)
            cases += [("sor_scalar", a, dict(variant=v)) for v in kernels.sor_variants(*a[0].shape)]
    for h, w in ((14, 32), (28, 64), (56, 128)):
        a = sor_system(h, w, h * w) + (3, 1.6)
        cases += [("sor_coupled", a, dict(variant=v)) for v in kernels.sor_variants(h, w, 2)]
    cases += [("frame_pad", a, k) for a, k in calls["op2 gray"]["frame_pad"]]
    cases += [("flow_upscale", a, k) for name in ("op2 gray", "stereo gray", "op4 gray")
              for a, k in calls[name]["flow_upscale"]]
    checked = {k: [] for k in KERNELS}
    for k, a, kw in cases:
        alone(k, *a, **kw)  # captures
        got, launches = counted(lambda: alone(k, *a, **kw))
        want = plain[k](*a, **{x: y for x, y in kw.items() if x != "variant"})
        ok = launches == {x: int(x == k) for x in KERNELS} and all(
            (g is None and r is None) or torch.equal(g, r)
            for g, r in zip(outputs(got), outputs(want), strict=True))
        checked[k].append(dict(hw=list(a[0].shape[:2]), variant=kw.get("variant"), ok=ok))
    kernel_cache.clear()
    for k, rows in checked.items():
        emit("graph kernel alone", kernel=k, cases=len(rows),
             variants=sorted({str(r["variant"]) for r in rows}),
             bit_equal_to_plain=sum(r["ok"] for r in rows), rows=rows)
        require(rows and all(r["ok"] for r in rows),
                f"{k}: a captured launch differs from its plain version: {rows}")
    emit("graph executables", note="every executable held after the graphs phase",
         count=len(graphs.cache.entries(dev)), max_per_device=graphs.MAX_EXECUTABLES,
         executables=[described(e) for e in graphs.cache.entries(dev)])
    return pools


# ---- the video files phase: process_video_batched fed from .pgm files ----
FILE_B = 32              # pairs per chunk, as the JAX package's benchmark batch
FILE_CHUNKS = 6          # 1 + 32 x 6 = 193 frames
FILE_QUEUE = 4
FILE_RUNS = 3            # timed runs, after one warm run
COPY_REPS = 5            # timed copies of a chunk in each direction


def busy_union_ms(dev_events) -> float:
    """ms in which at least one device op runs (copies on their own streams
    overlap the kernels, so the sum of op times would count time twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    total, end = 0.0, None
    for s0, s1 in spans:
        if end is None or s0 > end:
            total += s1 - s0
            end = s1
        elif s1 > end:
            total += s1 - end
            end = s1
    return total / 1e3


def copy_gb_per_s(torch, dev, fn, nbytes: int) -> tuple:
    """GB/s of the copy fn() queues on the current stream, from CUDA events
    on that stream (the stream first sleeps past the host's staging, so the
    events bracket the copy alone), and the host's ms in fn() (staging and
    queueing)."""
    cur = torch.cuda.current_stream(dev)
    rates, host_ms = [], []
    for _ in range(COPY_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e8))
        start.record(cur)
        t0 = time.perf_counter()
        out = fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record(cur)
        end.synchronize()
        rates.append(nbytes / (start.elapsed_time(end) * 1e-3) / 1e9)
        del out
    return rates, host_ms


@contextlib.contextmanager
def two_copy_streams(torch, dev):
    """ops/transfer.py's copies moved onto an upload and a download stream
    of their own, beside the compute stream, for the video files phase's
    comparison (the package queues them on the compute stream): the
    compute stream waits on an event after each upload, the download
    stream on one after the result's last op, and record_stream keeps
    each tensor's memory from the allocator until the other stream is done
    with it."""
    from of_dis_tpu_torch.ops import transfer
    from of_dis_tpu_torch.parallel import video

    up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def upload(host, device):
        cur = torch.cuda.current_stream(device)
        with torch.cuda.stream(up):
            t = torch.empty(host.shape, dtype=host.dtype, device=device)
            t.copy_(host, non_blocking=True)
        cur.wait_event(up.record_event())
        t.record_stream(cur)
        transfer.counts["uploads"] += 1
        return t

    def to_host(t):
        down.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(down):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
        t.record_stream(down)
        transfer.counts["downloads"] += 1
        return transfer.HostCopy(host, down.record_event())

    saved = transfer._upload, video.to_host
    transfer._upload, video.to_host = upload, to_host
    try:
        yield
    finally:
        transfer._upload, video.to_host = saved


def video_files_phase(torch, dev, inputs, smi) -> dict:
    """process_video_batched over op2 gray frames on disk: of1.png as 8-bit
    gray, rolled ROLL_PX a frame, 1 + FILE_B x FILE_CHUNKS frames written as
    .pgm; the default loader (the port's native PNM reader) and native .flo
    writes.  A run without warm start must write, byte for byte, what
    io.write_flo writes of batched_flow on the same frames in memory; the
    warm-started runs (the default) must agree with one another and, in
    the first chunk, with it.  Each run waits once per chunk on the host.
    Prints pairs/s (median of FILE_RUNS timed runs after a warm one), the
    host's seconds per chunk by part, the copies' GB/s and the device's
    busy and idle share over one profiled run.  Then it times the package's
    copies (on the compute stream) against two_copy_streams, FILE_RUNS runs
    each in turns (A B B A A B), from the files and from the same frames
    held in memory (loader=lambda a: a); every run writes the same files."""
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from of_dis_tpu_torch import batched_flow, io, native
    from of_dis_tpu_torch.ops import kernels, transfer
    from of_dis_tpu_torch.parallel import video

    require(native.available(), "the native codec is not available")
    img1, _, cfg = inputs["op2 gray"]
    h0, w0 = img1.shape[:2]
    base = img1[..., 0].astype(np.uint8)
    require(np.array_equal(base, img1[..., 0]), "of1.png as gray is not 8-bit")
    root = OUT_DIR / "video_files"
    shutil.rmtree(root, ignore_errors=True)
    (root / "frames").mkdir(parents=True)
    n_frames, n_pairs = 1 + FILE_B * FILE_CHUNKS, FILE_B * FILE_CHUNKS
    paths = []
    for k in range(n_frames):
        paths.append(root / "frames" / f"frame_{k:04d}.pgm")
        with open(paths[-1], "wb") as f:
            f.write(f"P5\n{w0} {h0}\n255\n".encode())
            f.write(np.roll(base, ROLL_PX * k, axis=1).tobytes())

    def run(d, warm_start=True, src=paths, loader=None):
        """One run into a fresh directory: (yielded pairs, seconds, launches,
        transfer counts, host seconds)."""
        shutil.rmtree(root / d, ignore_errors=True)
        kernels.reset_launches()
        transfer.reset_counts()
        video.reset_host_seconds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(video.process_video_batched(src, root / d, cfg, batch_size=FILE_B,
                                               loader=loader, queue_depth=FILE_QUEUE,
                                               warm_start=warm_start, device=dev))
        secs = time.perf_counter() - t0
        return (out, secs, dict(kernels.launches), dict(transfer.counts),
                dict(video.host_seconds))

    def files(d):
        return [(root / d / f"flow_{i:06d}.flo").read_bytes() for i in range(n_pairs)]

    run("warm")  # captures the chunk's executables, fills the pinned pool
    # no warm start: each chunk is a batched_flow call on the same frames
    cold, _, _, cold_counts, _ = run("cold", warm_start=False)
    frames = [io.load_image(p) for p in paths]
    cold_equal = 0
    ref = root / "ref.flo"
    for j in range(FILE_CHUNKS):
        idx = range(j * FILE_B, (j + 1) * FILE_B)
        flows = transfer.to_host(batched_flow(np.stack([frames[i] for i in idx]),
                                              np.stack([frames[i + 1] for i in idx]),
                                              cfg, device=dev)).numpy()
        for k, i in enumerate(idx):
            io.write_flo(ref, flows[k])
            cold_equal += ref.read_bytes() == (root / "cold" / f"flow_{i:06d}.flo").read_bytes()
    cold_files = files("cold")
    shutil.rmtree(root / "cold")

    timed = [run(f"run{r}") for r in range(FILE_RUNS)]
    first = files("run0")
    same_runs = sum(files(f"run{r}") == first for r in range(1, FILE_RUNS))
    same_chunk0 = sum(first[i] == cold_files[i] for i in range(FILE_B))
    for r in range(1, FILE_RUNS):
        shutil.rmtree(root / f"run{r}")
    out, _, launches, counts, _ = timed[0]
    want_launches = {k: FILE_CHUNKS * n
                     for k, n in expected_launches("op2 gray", entry=False).items()}
    rates = [n_pairs / t[1] for t in timed]
    host = {k: float(np.median([t[4][k] for t in timed])) / FILE_CHUNKS
            for k in video.host_seconds}

    # the package's copies against copies on streams of their own, in turns
    layouts = {"one stream (package)": contextlib.nullcontext,
               "two copy streams": lambda: two_copy_streams(torch, dev)}
    one, two = layouts
    turns = (one, two, two, one, one, two)  # FILE_RUNS of each
    streams = {f"{w} / {lay}": [] for w in ("files", "memory") for lay in layouts}
    streams_same = 0
    for w, src, loader in (("files", paths, None), ("memory", frames, lambda a: a)):
        for k, lay in enumerate(turns):
            with layouts[lay]():
                got, secs, _, cmp_counts, _ = run(f"cmp{k}", src=src, loader=loader)
            streams[f"{w} / {lay}"].append(n_pairs / secs)
            streams_same += (len(got) == n_pairs and files(f"cmp{k}") == first
                             and cmp_counts == counts)
            shutil.rmtree(root / f"cmp{k}")

    # the copies of one chunk
    stack = [frames[i] for i in range(FILE_B)]
    h2d_bytes = FILE_B * h0 * w0 * 4
    flows_dev = batched_flow(np.stack(stack), np.stack(frames[1:FILE_B + 1]), cfg, device=dev)
    d2h_bytes = flows_dev.numel() * 4
    torch.cuda.synchronize()
    h2d, stage_ms = copy_gb_per_s(torch, dev,
                                  lambda: transfer.stack_to_device(stack, FILE_B, dev),
                                  h2d_bytes)
    d2h, _ = copy_gb_per_s(torch, dev, lambda: transfer.to_host(flows_dev), d2h_bytes)

    # where a frame's load goes: the file's bytes, the native decode, load_image
    def frame_ms(fn):
        t0 = time.perf_counter()
        for p in paths[:FILE_B]:
            fn(p)
        return (time.perf_counter() - t0) * 1e3 / FILE_B

    per_frame = dict(read_bytes=frame_ms(lambda p: p.read_bytes()),
                     native_read_pnm=frame_ms(native.read_pnm), load_image=frame_ms(io.load_image))

    # one profiled run: device busy (the union of its ops' spans) and idle
    shutil.rmtree(root / "profiled", ignore_errors=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(video.process_video_batched(paths, root / "profiled", cfg, batch_size=FILE_B,
                                         queue_depth=FILE_QUEUE, device=dev))
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = busy_union_ms(dev_events)
    summary = profile_summary(prof, traced_ms / FILE_CHUNKS, FILE_CHUNKS, DeviceType)
    shutil.rmtree(root / "profiled")
    line = dict(
        config=f"op2 gray {w0}x{h0} process_video_batched from .pgm files", frames=n_frames,
        batch_size=FILE_B, queue_depth=FILE_QUEUE, chunks=FILE_CHUNKS,
        native_codec=native.available(), pairs_yielded=len(out),
        launches=launches, expected_launches=want_launches, transfer_counts=counts,
        cold_run_transfer_counts=cold_counts,
        cold_files_equal_to_batched_flow=cold_equal,
        warm_runs_equal_to_first=same_runs, first_chunk_equal_to_cold=same_chunk0,
        pairs_per_s_median=float(np.median(rates)), pairs_per_s_all=rates,
        run_seconds_all=[t[1] for t in timed],
        host_s_per_chunk_median=host,
        streams_pairs_per_s_median={k: float(np.median(v)) for k, v in streams.items()},
        streams_pairs_per_s_all=streams, streams_runs_equal_to_first=streams_same,
        h2d_gb_per_s_median=float(np.median(h2d)), h2d_gb_per_s_all=h2d, h2d_bytes=h2d_bytes,
        d2h_gb_per_s_median=float(np.median(d2h)), d2h_gb_per_s_all=d2h, d2h_bytes=d2h_bytes,
        stage_host_ms_per_stack_median=float(np.median(stage_ms)), frame_ms=per_frame,
        profiled_run_ms=traced_ms, device_busy_ms=busy_ms,
        device_busy_ms_summed=sum(e.time_range.elapsed_us() for e in dev_events) / 1e3,
        device_idle_share=1.0 - busy_ms / traced_ms,
        copy_ms_per_chunk=summary["copy_ms_per_pair"],
        host_dispatch_calls_per_chunk=summary["host_dispatch_calls_per_pair"],
        top_per_chunk=summary["top"], nvidia_smi=smi)
    emit("video files", **line)
    require(len(out) == n_pairs and [i for i, _ in out] == list(range(n_pairs)),
            f"video files: yielded {len(out)} pairs")
    require(launches == want_launches, f"video files: launches {launches}")
    require(counts == {"uploads": 2 * FILE_CHUNKS, "downloads": FILE_CHUNKS,
                       "host_waits": FILE_CHUNKS}
            and cold_counts == counts, f"video files: not one host wait per chunk: {line}")
    require(cold_equal == n_pairs, f"video files: {n_pairs - cold_equal} files differ from "
            "io.write_flo of batched_flow on the same frames")
    require(same_runs == FILE_RUNS - 1 and same_chunk0 == FILE_B,
            f"video files: warm-started runs differ: {same_runs}, chunk 0 {same_chunk0}")
    require(streams_same == 2 * len(turns),
            f"video files: {2 * len(turns) - streams_same} stream-comparison runs differ")
    shutil.rmtree(root, ignore_errors=True)
    return line


# ---- the spatial phase: one 4-rank world on cuda:0 ----
# Each spatial path: the single-device path it is held to, how it runs
# (strips over tx = 4, tiles over (ty, tx) = (2, 2), flow_2d over (data, tx)
# = (2, 2), batched_flow over data = 4), its pairs, and the launches one
# rank makes for it.
SPATIAL = {
    "op2 gray strips": ("op2 gray", "strips", 1,
                        dict(level_search=3)),
    "stereo gray strips": ("stereo gray", "strips", 1, dict(level_search=3)),
    "op4 gray tiles": ("op4 gray", "tiles", 1,
                       dict(level_search=2, gn_search=4, refine_inner=2)),
    "op2 gray fb tiles": ("op2 gray fb", "tiles", 1,
                          dict(level_search=4, gn_search=2, refine_inner=4)),
    "op2 gray flow_2d": ("op2 gray", "flow_2d", 4, dict(level_search=6)),
    "op2 gray batched mesh": ("op2 gray", "batched", 8, dict(level_search=3, refine_inner=3,
                                                             **ENTRY)),
}
SPATIAL_RANKS = 4
SPATIAL_TIMEOUT_S = 600
SPATIAL_TIMED = 2   # timed pairs per path, after the counted one


def _full_res(flow, cfg, h0: int, w0: int):
    """A padded pair's flow at scale sc_l (h_l, w_l, nop) as dis_raw returns
    it: upscaled by 2^sc_l and cropped to (h0, w0) (models/dis.py::_upscale_crop)."""
    from of_dis_tpu_torch.models.dis import _upscale_crop

    scf = 1 << cfg.sc_f
    return _upscale_crop(flow[None], cfg, -(-h0 // scf) * scf, -(-w0 // scf) * scf, h0, w0)[0]


def _calls_vs_plain(torch, kernels, calls) -> dict:
    """Every recorded kernel call (record_calls) run again and against its
    plain version on the same arguments: the calls checked, those that
    differ, the largest difference."""
    plain = plain_versions()
    checked, err, differ = 0, 0.0, []
    for k, kcalls in calls.items():
        for i, (args, kw) in enumerate(kcalls):
            got, want = outputs(getattr(kernels, k)(*args, **kw)), outputs(plain[k](*args, **kw))
            torch.cuda.synchronize()
            checked += 1
            for g, r in zip(got, want):
                if g is None and r is None:
                    continue
                err = max(err, float((g.double() - r.double()).abs().max()))
                if not torch.equal(g, r):
                    differ.append(f"{k} call {i}")
    return dict(kernel_calls_checked=checked, kernel_calls_differ=sorted(set(differ)),
                kernel_max_abs_err=err)


def _level0_tiles(torch, rank: int, call, img1p, img2p) -> dict:
    """op4's level 0 (its last gn_search call, `call`): this rank's tile
    call against the untiled kernel on the full padded level for the same
    patches and starts; rank 0 also times the tile form (the other ranks
    wait idle), the untiled call and the plain version."""
    import torch.distributed as dist

    from of_dis_tpu_torch.models.inverse_search import build_templates, gn_search_reference
    from of_dis_tpu_torch.ops import kernels
    from of_dis_tpu_torch.ops import pyramid as pyr

    args, kw = call
    _, tmpl_t, pt_own, p_init, cfg, lw, lh, pad = args[:8]
    im, dx, dy = pyr.build_pyramid(torch.stack([img1p, img2p]), 1, pad)
    tmpl_u = build_templates(im[0][0], dx[0][0], dy[0][0], pt_own, cfg, pad)

    def untiled():
        return kernels.gn_search(im[0][1], tmpl_u, pt_own, p_init, cfg, lw, lh, pad)

    res_t, res_u = kernels.gn_search(*args, **kw), untiled()
    torch.cuda.synchronize()
    line = dict(
        level0_tile=list(kw["tile"]), level0_patches=int(pt_own.shape[0]),
        level0_templates_equal=all(torch.equal(x, y) for x, y in zip(tmpl_t, tmpl_u)),
        level0_tile_equals_untiled=all(torch.equal(x, y) for x, y in
                                       zip(outputs(res_t), outputs(res_u)) if x is not None))
    dist.barrier()
    if rank == 0:
        ref = outputs(gn_search_reference(*args, **kw))
        bms, bby = bound_ms(*gn_search_work(args, cfg, res_t.iters))
        line["tile_form"] = dict(
            ms=gpu_ms(torch, lambda: kernels.gn_search(*args, **kw), 10),
            untiled_ms=gpu_ms(torch, untiled, 10),
            plain_ms=gpu_ms(torch, lambda: gn_search_reference(*args, **kw), 2),
            bound_ms=bms, bound_by=bby,
            max_abs_err=max(float((x.double() - y.double()).abs().max())
                            for x, y in zip(outputs(res_t), ref) if x is not None))
    dist.barrier()
    return line


def spatial_rank(rank: int, store: str, out: str) -> None:
    """One rank of the spatial phase's world: every SPATIAL path through its
    entry point on cuda:0 (launch counts and the exchange counters reset
    just before, read just after), each recorded kernel call against its
    plain version, op4's level-0 tile calls against the untiled kernel, and
    two timed pairs; results to <out>/rank<r>.json (rank 0 also writes the
    flows to <out>/flows.npz)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from of_dis_tpu_torch import batched_flow
    from of_dis_tpu_torch.ops import build, kernels
    from of_dis_tpu_torch.ops import pyramid as pyr
    from of_dis_tpu_torch.parallel import collectives, spatial
    from of_dis_tpu_torch.parallel.batch import data_mesh
    from of_dis_tpu_torch.parallel.multihost import flow_2d, init_distributed, mesh_2d, mesh_3d

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the CUDA context, before the meshes
    build.build_all()  # the parent built them: loads only
    init_distributed("gloo", f"file://{store}", SPATIAL_RANKS, rank, timeout_s=300)
    tx4 = mesh_2d(1, SPATIAL_RANKS)
    m22 = mesh_3d(1, 2, 2)
    dx2 = mesh_2d(2, 2)
    dm = data_mesh(SPATIAL_RANKS)
    report, flows = {}, {}

    for name, (base, how, nb, _) in SPATIAL.items():
        img1, img2, cfg = path_inputs(base)
        h0, w0 = img1.shape[:2]
        scf = 1 << cfg.sc_f
        if nb > 1:
            a, b = rolled_batch(img1, img2, nb)
        else:
            a, b = (pyr.pad_to_divisible(torch.as_tensor(x, device=dev)[..., None]
                                         if x.ndim == 2 else torch.as_tensor(x, device=dev), scf)
                    for x in (img1, img2))

        def run():
            """The path through its entry point: (flow(s) at full res, clamp counts)."""
            if how == "strips":
                return _full_res(spatial.spatial_flow(a, b, cfg, tx4), cfg, h0, w0), {}
            if how == "tiles":
                f, cc = spatial.spatial_flow_tiled(a, b, cfg, m22, return_diagnostics=True)
                return _full_res(f, cfg, h0, w0), cc
            if how == "flow_2d":
                return flow_2d(a, b, cfg, dx2), {}
            return batched_flow(a, b, cfg, mesh=dm), {}

        dist.barrier()
        kernels.reset_launches()
        collectives.reset_exchanges()
        calls = record_calls(kernels, lambda: flows.__setitem__(name, run()))
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        xch = dict(collectives.exchanges)
        flow, clamps = flows[name]
        flows[name] = flow.cpu().numpy()
        line = dict(launches=launches, exchanges_per_pair=xch["exchanges"] / nb,
                    staged_bytes_per_pair=xch["staged_bytes"] / nb, clamp_counts=clamps,
                    flow_sha256=hashlib.sha256(flows[name].tobytes()).hexdigest(),
                    **_calls_vs_plain(torch, kernels, calls))
        if name == "op4 gray tiles":
            line.update(_level0_tiles(torch, rank, calls["gn_search"][-1], a, b))
        del calls  # the recorded arguments, before the timed runs' peak memory

        times = []
        for i in range(SPATIAL_TIMED):
            dist.barrier()
            torch.cuda.synchronize()
            if i == 0:
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            dist.barrier()
            times.append((time.perf_counter() - t0) * 1e3 / nb)
            if i == 0:
                line["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - held
        line["pair_ms"] = times
        report[name] = line

    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    if rank == 0:
        np.savez(Path(out, "flows.npz"), **flows)
    dist.barrier()
    dist.destroy_process_group()


def run_world(target, args, what: str) -> float:
    """SPATIAL_RANKS spawned processes target(*args(rank)), joined within
    SPATIAL_TIMEOUT_S (then killed); raises unless each exits with 0.
    Returns the seconds they took."""
    import multiprocessing

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args(r)) for r in range(SPATIAL_RANKS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SPATIAL_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    require(not alive, f"{what} ranks {alive} did not finish in {SPATIAL_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    require(codes == [0] * SPATIAL_RANKS, f"{what} ranks exited with {codes}")
    return time.perf_counter() - t0


def spatial_phase(torch, dev, inputs, flows, golden, smi) -> tuple:
    """Spatial sharding on one card: SPATIAL's paths in one 4-rank gloo
    world on cuda:0 (spatial_rank), each held to its golden, to the
    single-device run on the card, and to its plain kernels.  The ranks
    share the card, so no time here says anything about sharding across
    cards.  Peak memory (per rank, and of the single-device run) is what a
    path's run allocates above what the process already held.  Returns the
    tile form's row of the kernels line and the single-device flows."""
    from of_dis_tpu_torch import batched_flow
    from of_dis_tpu_torch.ops import kernels

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    require(mode != "Exclusive_Process",
            f"compute mode {mode}: the {SPATIAL_RANKS} ranks of the spatial phase share cuda:0")
    out = OUT_DIR / "spatial"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    for f in [store, *out.glob("rank*.json"), out / "flows.npz"]:
        f.unlink(missing_ok=True)

    # the single-device references on the card, with their peak memory
    single, single_peak = {}, {}
    for name, (base, how, nb, _) in SPATIAL.items():
        img1, img2, cfg = inputs[base]
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
        if nb == 1:
            single[name] = flows[base]
            run_path(base, img1, img2, cfg, dev)
        else:
            a, b = rolled_batch(img1, img2, nb)
            single[name] = np.stack([run_path(base, a[i], b[i], cfg, dev) for i in range(nb)])
            if how == "batched":
                batched_flow(a, b, cfg, device=dev)
        torch.cuda.synchronize()
        single_peak[name] = torch.cuda.max_memory_allocated(dev) - held

    world_s = run_world(spatial_rank, lambda r: (r, str(store), str(out)), "spatial")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(SPATIAL_RANKS)]
    got = np.load(out / "flows.npz")

    tile_row = None
    for name, (base, how, nb, want) in SPATIAL.items():
        img1, img2, cfg = inputs[base]
        want = {k: want.get(k, 0) for k in KERNELS}
        flow, ref = got[name], single[name]
        clamps = ranks[0][name]["clamp_counts"]
        line = dict(
            config=f"{name} {img1.shape[1]}x{img1.shape[0]}", mesh=how, pairs=nb,
            ranks_share_one_card=True,
            launches_per_rank=[r[name]["launches"] for r in ranks],
            pair_ms_per_rank=[r[name]["pair_ms"] for r in ranks],
            exchanges_per_pair=ranks[0][name]["exchanges_per_pair"],
            staged_bytes_per_pair=ranks[0][name]["staged_bytes_per_pair"],
            peak_bytes_per_rank=[r[name]["peak_bytes"] for r in ranks],
            single_device_peak_bytes=single_peak[name],
            clamp_counts=clamps,
            kernel_calls_checked=[r[name]["kernel_calls_checked"] for r in ranks],
            kernel_calls_differ=[r[name]["kernel_calls_differ"] for r in ranks],
            same_on_every_rank=len({r[name]["flow_sha256"] for r in ranks}) == 1,
            finite_and_shaped=bool(np.isfinite(flow).all() and flow.shape == ref.shape),
            max_abs_diff_vs_single_device=float(np.abs(flow - ref).max()),
            epe_vs_single_device=epe(flow, ref),
            nvidia_smi=smi)
        case = PATHS[base][4]
        if case is not None:
            line["epe_vs_golden"] = epe(flow[0] if nb > 1 else flow, golden(case))
        for key in ("level0_tile", "level0_patches", "level0_templates_equal",
                    "level0_tile_equals_untiled"):
            if key in ranks[0][name]:
                line[key] = [r[name][key] for r in ranks]
        if how == "batched":
            line["pairs_equal_to_own_run"] = int(sum(np.array_equal(flow[i], ref[i])
                                                     for i in range(nb)))
        emit("spatial", **line)
        require(all(r[name]["launches"] == want for r in ranks),
                f"{name}: launches {line['launches_per_rank']}, expected {want} per rank")
        require(line["same_on_every_rank"], f"{name}: ranks returned different flows")
        require(line["finite_and_shaped"], f"{name}: non-finite or misshapen output")
        require(not any(line["kernel_calls_differ"]),
                f"{name}: kernel calls differ from their plain versions: {line}")
        if "epe_vs_golden" in line:
            require(line["epe_vs_golden"] < EPE_GOLDEN, f"{name}: {line}")
        if not any(clamps.values()):
            require(line["epe_vs_single_device"] < EPE_SHARDED, f"{name}: {line}")
        if how == "batched":
            require(line["pairs_equal_to_own_run"] == nb, f"{name}: {line}")
        if "level0_tile_equals_untiled" in line:
            require(all(line["level0_tile_equals_untiled"])
                    and all(line["level0_templates_equal"]),
                    f"{name}: a level-0 tile call differs from the untiled kernel: {line}")
        if "tile_form" in ranks[0][name]:
            tf = ranks[0][name]["tile_form"]
            tile_row = dict(tf, launches=ranks[0][name]["launches"]["gn_search"], per=name)
    emit("spatial world", ranks=SPATIAL_RANKS, backend="gloo", device="cuda:0",
         seconds=world_s, compute_mode=mode)
    return tile_row, single


# NCCL ranks sharing one card: each rank takes itself for a host of its own
# (NCCL refuses two ranks of one host on one device), and NCCL moves the
# exchanges over its socket transport on loopback, from CUDA buffers.
NCCL_SHARED_ENV = dict(NCCL_SOCKET_IFNAME="lo", NCCL_IB_DISABLE="1", LOCAL_RANK="0")


def _no_host_sync(torch, fn):
    """fn() with any operation that syncs the host with the card raising
    (torch.cuda.set_sync_debug_mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def spatial_nccl_rank(rank: int, store: str, out: str, shared: bool) -> None:
    """One rank of the spatial nccl phase's world: every SPATIAL path
    through its entry point, (1) under eager() with every kernel call
    recorded (then each against its plain version), (2) under eager() on
    the pair rolled by ROLL_PX px, profiled and with host syncs raising,
    (3) through its executable: the first call (warm-up, capture, replay),
    a replay, and a replay on the rolled pair, profiled; counters reset
    just before each run and read just after; results to <out>/rank<r>.json
    (rank 0 also writes the eager flows to <out>/flows.npz).  shared: all
    ranks on cuda:0, each named a host of its own (NCCL_SHARED_ENV and
    NCCL_HOSTID); else rank r on cuda:r."""
    import hashlib
    import os

    if shared:
        os.environ.update(NCCL_HOSTID=f"ofdis-rank{rank}", **NCCL_SHARED_ENV)
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from of_dis_tpu_torch import batched_flow
    from of_dis_tpu_torch.ops import build, graphs, kernels
    from of_dis_tpu_torch.ops import pyramid as pyr
    from of_dis_tpu_torch.parallel import collectives, spatial
    from of_dis_tpu_torch.parallel.batch import data_mesh
    from of_dis_tpu_torch.parallel.multihost import (
        destroy_distributed,
        flow_2d,
        init_distributed,
        mesh_2d,
        mesh_3d,
    )

    card = 0 if shared else rank
    torch.cuda.set_device(card)
    dev = torch.device("cuda", card)
    torch.zeros(1, device=dev)  # the CUDA context, before the meshes
    build.build_all()  # the parent built them: loads only
    init_distributed("nccl", f"file://{store}", SPATIAL_RANKS, rank, timeout_s=300)
    meshes = dict(strips=mesh_2d(1, SPATIAL_RANKS), tiles=mesh_3d(1, 2, 2),
                  flow_2d=mesh_2d(2, 2), batched=data_mesh(SPATIAL_RANKS))
    report, flows = {}, {}

    for name, (base, how, nb, _) in SPATIAL.items():
        img1, img2, cfg = path_inputs(base)
        h0, w0 = img1.shape[:2]
        scf = 1 << cfg.sc_f
        mesh = meshes[how]

        def pair_at(roll):
            """The path's inputs, rolled horizontally by roll px."""
            if nb > 1:
                return tuple(np.roll(x, roll, axis=2) for x in rolled_batch(img1, img2, nb))
            return tuple(pyr.pad_to_divisible(torch.as_tensor(
                np.roll(x, roll, axis=1)[..., None] if x.ndim == 2 else np.roll(x, roll, axis=1),
                device=dev), scf) for x in (img1, img2))

        def run(a, b):
            """The path through its entry point: what it returns on the card."""
            if how == "strips":
                return spatial.spatial_flow(a, b, cfg, mesh), {}
            if how == "tiles":
                return spatial.spatial_tiled_fn(cfg, mesh, *a.shape[:2])[0](a, b)
            if how == "flow_2d":
                return flow_2d(a, b, cfg, mesh), {}
            return batched_flow(a, b, cfg, mesh=mesh), {}

        def host(got):
            """(flow at full resolution, clamp counts) on the host."""
            flow, cc = got
            if how in ("strips", "tiles"):
                flow = _full_res(flow, cfg, h0, w0)
            return flow.cpu().numpy(), {k: int(v) for k, v in cc.items()}

        def counted(fn):
            """(fn(), ms per pair barrier to barrier, the counters it moved)."""
            kernels.reset_launches()
            collectives.reset_exchanges()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            dist.barrier()
            ms = (time.perf_counter() - t0) * 1e3 / nb
            return got, ms, dict(launches=dict(kernels.launches), **collectives.exchanges,
                                 modes=dict(collectives.modes))

        a, b = pair_at(0)
        ar, br = pair_at(ROLL_PX)
        box = {}
        calls = record_calls(kernels, lambda: box.__setitem__("eager", counted(
            lambda: run(a, b))))
        res, eager_ms, eager_counts = box.pop("eager")
        eager = host(res)
        line = dict(eager=eager_counts, **_calls_vs_plain(torch, kernels, calls))
        del calls, res  # the recorded arguments
        with graphs.eager(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
            res, eager_rolled_ms, rolled_counts = counted(
                lambda: _no_host_sync(torch, lambda: run(ar, br)))
        eager_rolled = host(res)
        line["eager_profile"] = profile_summary(prof, eager_rolled_ms, nb, DeviceType)

        held = {ex.key for ex in graphs.cache.sharded_entries() + graphs.cache.entries(dev)}
        res, first_ms, line["first_call"] = counted(lambda: run(a, b))
        first = host(res)
        new = [ex for ex in graphs.cache.sharded_entries() + graphs.cache.entries(dev)
               if ex.key not in held]
        res, graph_ms, line["replay"] = counted(lambda: run(a, b))
        replay = host(res)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, graph_rolled_ms, _ = counted(lambda: run(ar, br))
        graph_rolled = host(res)
        line["graph_profile"] = profile_summary(prof, graph_rolled_ms, nb, DeviceType)
        line.update(
            executables=[dict(name=ex.key[0].__qualname__, capture_ms=ex.capture_ms,
                              pool_mib=ex.pool_bytes / 2**20, sharded=ex.exchange_counter
                              is not None, exchanges_per_replay=ex.exchanges) for ex in new],
            pair_ms=dict(eager=eager_ms, eager_rolled=eager_rolled_ms, first_call=first_ms,
                         graph=graph_ms, graph_rolled=graph_rolled_ms),
            clamp_counts=eager[1],
            graph_equals_eager=dict(
                first=bool(np.array_equal(first[0], eager[0])) and first[1] == eager[1],
                replay=bool(np.array_equal(replay[0], eager[0])) and replay[1] == eager[1],
                rolled=bool(np.array_equal(graph_rolled[0], eager_rolled[0]))
                and graph_rolled[1] == eager_rolled[1]),
            rolled_eager_counts_equal=rolled_counts["launches"] == eager_counts["launches"],
            flow_sha256=hashlib.sha256(eager[0].tobytes()).hexdigest())
        flows[name] = eager[0]
        report[name] = line

    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    if rank == 0:
        np.savez(Path(out, "flows.npz"), **flows)
    dist.barrier()
    destroy_distributed()


def spatial_nccl_phase(torch, dev, inputs, single, golden, smi) -> None:
    """The spatial paths in an NCCL world of SPATIAL_RANKS ranks
    (spatial_nccl_rank): on cuda:0, each rank named a host of its own
    (NCCL over its socket transport on loopback), or one rank per card on a
    host with that many.  Each path's CUDA graph replays must equal the
    same world's eager() run bit for bit and count its launches and
    exchanges (none staged through the host); the path is held to its
    golden and the single-device run under the gloo phase's bounds, and
    its max difference from the gloo world's flow is printed.  Ranks that
    share a card take turns on it, so no time here says anything about
    speed across cards."""
    shared = torch.cuda.device_count() < SPATIAL_RANKS
    out = OUT_DIR / "spatial_nccl"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    for f in [store, *out.glob("rank*.json"), out / "flows.npz"]:
        f.unlink(missing_ok=True)
    world_s = run_world(spatial_nccl_rank, lambda r: (r, str(store), str(out), shared),
                        "spatial nccl")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(SPATIAL_RANKS)]
    got = np.load(out / "flows.npz")
    gloo = np.load(OUT_DIR / "spatial" / "flows.npz")
    layout = (f"{SPATIAL_RANKS} ranks on cuda:0, one NCCL_HOSTID each" if shared
              else f"one rank per card, cuda:0-{SPATIAL_RANKS - 1}")
    for name, (base, how, nb, want) in SPATIAL.items():
        img1, img2, cfg = inputs[base]
        want = {k: want.get(k, 0) for k in KERNELS}
        flow, ref = got[name], single[name]
        r0 = ranks[0][name]
        sharded = how not in ("batched",)
        line = dict(
            config=f"{name} {img1.shape[1]}x{img1.shape[0]}", mesh=how, pairs=nb,
            backend="nccl", layout=layout, ranks_share_one_card=shared,
            mode_per_rank=[("graph" if r[name]["replay"]["modes"]["graph"] else
                            "graph (single-device executable, eager all_gather)")
                           for r in ranks],
            eager_mode_per_rank=[r[name]["eager"]["modes"] for r in ranks],
            executables_per_rank=[r[name]["executables"] for r in ranks],
            pair_ms_per_rank=[r[name]["pair_ms"] for r in ranks],
            pair_ms_note="ranks take turns on one card: no statement about speed"
            if shared else "one rank per card",
            host_dispatched_ops_per_pair_per_rank=[
                dict(graph=r[name]["graph_profile"]["host_dispatched_ops_per_pair"],
                     eager=r[name]["eager_profile"]["host_dispatched_ops_per_pair"])
                for r in ranks],
            host_dispatch_calls_per_pair_rank0=dict(
                graph=r0["graph_profile"]["host_dispatch_calls_per_pair"],
                eager=r0["eager_profile"]["host_dispatch_calls_per_pair"]),
            device_ops_per_pair_rank0=dict(graph=r0["graph_profile"]["device_ops_per_pair"],
                                           eager=r0["eager_profile"]["device_ops_per_pair"]),
            launches_per_rank=[r[name]["eager"]["launches"] for r in ranks],
            launches_per_replay_per_rank=[r[name]["replay"]["launches"] for r in ranks],
            exchanges_per_pair=dict(eager=r0["eager"]["exchanges"] / nb,
                                    replay=r0["replay"]["exchanges"] / nb),
            staged_bytes=dict(eager=[r[name]["eager"]["staged_bytes"] for r in ranks],
                              replay=[r[name]["replay"]["staged_bytes"] for r in ranks]),
            graph_equals_eager=[r[name]["graph_equals_eager"] for r in ranks],
            clamp_counts=r0["clamp_counts"],
            kernel_calls_checked=[r[name]["kernel_calls_checked"] for r in ranks],
            kernel_calls_differ=[r[name]["kernel_calls_differ"] for r in ranks],
            same_on_every_rank=len({r[name]["flow_sha256"] for r in ranks}) == 1,
            finite_and_shaped=bool(np.isfinite(flow).all() and flow.shape == ref.shape),
            max_abs_diff_vs_gloo=float(np.abs(flow - gloo[name]).max()),
            max_abs_diff_vs_single_device=float(np.abs(flow - ref).max()),
            epe_vs_single_device=epe(flow, ref),
            nvidia_smi=smi)
        case = PATHS[base][4]
        if case is not None:
            line["epe_vs_golden"] = epe(flow[0] if nb > 1 else flow, golden(case))
        if how == "batched":
            line["pairs_equal_to_own_run"] = int(sum(np.array_equal(flow[i], ref[i])
                                                     for i in range(nb)))
        emit("spatial nccl", **line)
        for r, rk in enumerate(ranks):
            rl = rk[name]
            require(rl["eager"]["launches"] == want and rl["replay"]["launches"] == want,
                    f"{name} rank {r}: launches {rl['eager']['launches']} eager, "
                    f"{rl['replay']['launches']} per replay, expected {want}")
            require(rl["replay"]["exchanges"] == rl["eager"]["exchanges"] > 0,
                    f"{name} rank {r}: exchanges per replay {rl['replay']['exchanges']}, "
                    f"eager {rl['eager']['exchanges']}")
            require(rl["eager"]["staged_bytes"] == rl["replay"]["staged_bytes"] == 0,
                    f"{name} rank {r}: bytes staged through the host under NCCL")
            require(all(rl["graph_equals_eager"].values()) and rl["rolled_eager_counts_equal"],
                    f"{name} rank {r}: graph replays differ from the eager run: {rl}")
            require(not sharded or (rl["replay"]["modes"] == {"graph": 1, "eager": 0}
                                    and rl["eager"]["modes"] == {"graph": 0, "eager": 1}),
                    f"{name} rank {r}: modes eager {rl['eager']['modes']}, "
                    f"replay {rl['replay']['modes']}")
            require(not sharded or any(ex["sharded"] for ex in rl["executables"]),
                    f"{name} rank {r}: no sharded executable captured")
            ops = {m: rl[f"{m}_profile"]["host_dispatched_ops_per_pair"]
                   for m in ("graph", "eager")}
            require(not sharded or (all(isinstance(v, float) for v in ops.values())
                                    and 100 * ops["graph"] < ops["eager"]),
                    f"{name} rank {r}: host-dispatched ops per pair {ops}: the graph "
                    "should cost one launch and copies per call, not a call per exchange")
        require(line["same_on_every_rank"], f"{name}: ranks returned different flows")
        require(line["finite_and_shaped"], f"{name}: non-finite or misshapen output")
        require(not any(line["kernel_calls_differ"]),
                f"{name}: kernel calls differ from their plain versions: {line}")
        if "epe_vs_golden" in line:
            require(line["epe_vs_golden"] < EPE_GOLDEN, f"{name}: {line}")
        if not any(line["clamp_counts"].values()):
            require(line["epe_vs_single_device"] < EPE_SHARDED, f"{name}: {line}")
        if how == "batched":
            require(line["pairs_equal_to_own_run"] == nb, f"{name}: {line}")
    emit("spatial nccl world", ranks=SPATIAL_RANKS, backend="nccl", layout=layout,
         environment=dict(NCCL_HOSTID="ofdis-rank<r>", **NCCL_SHARED_ENV) if shared else {},
         seconds=world_s)


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
    from of_dis_tpu_torch.ops import build, graphs, kernels

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

    # ---- kernels frame_pad and flow_upscale: the entry's full-resolution passes ----
    # frame_pad on op2 gray's pair as uint8 (a camera's frames) at B = 1 and
    # 32; flow_upscale on the flows op2 (nop 2, sc_l 3), stereo gray (nop 1)
    # and op4 (sc_l 0) hand it, at B = 1 and 32 (pair i the flow plus
    # 0.25 i).  Each bit-equal to its plain version; ms, plain_ms, bound_ms
    # from the bytes each moves once, and library_ms: PyTorch's own ops for
    # the same result (F.pad replicate after the conversion; F.interpolate
    # bilinear, the scale and a sliced copy).  The rows' ms is op2 gray's
    # pair (B = 1); case_ms gives every case.
    import torch.nn.functional as F

    from of_dis_tpu_torch.ops import pyramid as pyr

    plain = plain_versions()

    def entry_case(k, case, args, library, nbytes, nops):
        got, want = outputs(getattr(kernels, k)(*args)), outputs(plain[k](*args))
        torch.cuda.synchronize()
        err = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, want))
        b, by = bound_ms(nbytes, nops)
        line = dict(case=case, out_shape=list(got[0].shape), max_abs_err=err,
                    ok=all(torch.equal(g, r) for g, r in zip(got, want, strict=True)),
                    ms=gpu_ms(torch, lambda: getattr(kernels, k)(*args), 50),
                    plain_ms=gpu_ms(torch, lambda: plain[k](*args), 20),
                    library_ms=gpu_ms(torch, library, 20), bound_ms=b, bound_by=by)
        emit(f"kernel {k}", **line)
        require(line["ok"] and err == 0.0, f"{k} differs from its plain version: {line}")
        return line

    img1, img2, cfg = inputs["op2 gray"]
    top, bottom, left, right = pyr.divisibility_padding(h0, w0, 1 << cfg.sc_f)
    hp, wp = h0 + top + bottom, w0 + left + right
    fp = {}
    for b in (1, 32):
        f1, f2 = (torch.as_tensor(x.astype(np.uint8), device=dev)
                  for x in rolled_batch(img1, img2, b))
        c = f1.shape[-1]
        fp[b] = entry_case(
            "frame_pad", f"op2 gray uint8 B = {b}", (f1, f2, 1 << cfg.sc_f),
            lambda f1=f1, f2=f2: [F.pad(x.permute(0, 3, 1, 2).float(), (left, right, top, bottom),
                                        mode="replicate") for x in (f1, f2)],
            2 * b * c * (h0 * w0 + 4 * hp * wp), 0.0)
    rows["frame_pad"] = dict(
        source="frame_io.cu", replaces="of_dis_tpu/models/dis.py:210-211 (XLA ops)",
        per="op2 gray", max_abs_err=max(x["max_abs_err"] for x in fp.values()),
        ms=fp[1]["ms"], plain_ms=fp[1]["plain_ms"], library_ms=fp[1]["library_ms"],
        bound_ms=fp[1]["bound_ms"], bound_by=fp[1]["bound_by"],
        case_ms={x["case"]: x["ms"] for x in fp.values()})

    up = {}
    for name in ("op2 gray", "stereo gray", "op4 gray"):
        (flow, cfg_u, hp_u, wp_u, h_u, w_u), _ = calls[name]["flow_upscale"][0]
        t_u, _, l_u, _ = pyr.divisibility_padding(h_u, w_u, 1 << cfg_u.sc_f)
        sc, nop = cfg_u.sc_l, cfg_u.nop
        for b in (1, 32):
            fb = torch.stack([flow + 0.25 * i for i in range(b)])

            def library(fb=fb, sc=sc, hp_u=hp_u, wp_u=wp_u, t_u=t_u, l_u=l_u, h_u=h_u, w_u=w_u):
                x = fb.permute(0, 3, 1, 2)
                if sc:
                    x = F.interpolate(x * float(1 << sc), size=(hp_u, wp_u), mode="bilinear",
                                      align_corners=False)
                return x[:, :, t_u:t_u + h_u, l_u:l_u + w_u].contiguous()

            up[f"{name} B = {b}"] = entry_case(
                "flow_upscale", f"{name} B = {b}", (fb, cfg_u, hp_u, wp_u, h_u, w_u), library,
                4 * b * nop * (flow.shape[0] * flow.shape[1] + h_u * w_u),
                10.0 * b * nop * h_u * w_u if sc else 0.0)
    op2 = up["op2 gray B = 1"]
    rows["flow_upscale"] = dict(
        source="frame_io.cu", replaces="of_dis_tpu/models/dis.py:222 and its crop (XLA ops)",
        per="op2 gray", max_abs_err=max(x["max_abs_err"] for x in up.values()),
        ms=op2["ms"], plain_ms=op2["plain_ms"], library_ms=op2["library_ms"],
        bound_ms=op2["bound_ms"], bound_by=op2["bound_by"],
        case_ms={x["case"]: x["ms"] for x in up.values()})

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

    # ---- graphs: every path as a CUDA graph against its eager run ----
    pools = graphs_phase(torch, dev, inputs, calls, golden, sor_system, smi)

    flows = {}
    counts = {}
    latency = {}
    eager_latency = {}
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
            def timed():
                for _ in range(3):
                    run_path(name, img1, img2, cfg, dev)
                torch.cuda.synchronize()
                ms = []
                for _ in range(PAIRS_TIMED[name]):
                    t0 = time.perf_counter()
                    run_path(name, img1, img2, cfg, dev)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                return ms

            pair_ms = timed()
            with graphs.eager():
                eager_ms = timed()
            latency[name] = float(np.median(pair_ms))
            eager_latency[name] = float(np.median(eager_ms))
            line.update(pair_ms_median=latency[name], pair_ms_min=float(np.min(pair_ms)),
                        pairs_timed=len(pair_ms), eager_pair_ms_median=eager_latency[name],
                        eager_pair_ms_min=float(np.min(eager_ms)))
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
        for mode in ("graph", "eager"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                run_path(name, img1, img2, cfg, dev)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n_prof):
                        run_path(name, img1, img2, cfg, dev)
                    torch.cuda.synchronize()
                    traced_ms = (time.perf_counter() - t0) * 1e3 / n_prof
            emit("profile", config=name, mode=mode, pairs=n_prof,
                 **profile_summary(prof, traced_ms, n_prof, DeviceType))

    # ---- video files: the batched video driver fed from .pgm files ----
    video_files = video_files_phase(torch, dev, inputs, smi)

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

    # ---- spatial sharding: a 4-rank world on this card ----
    tile_row, single = spatial_phase(torch, dev, inputs, flows, golden, smi)

    # ---- spatial sharding compiled: the same paths in an NCCL world ----
    spatial_nccl_phase(torch, dev, inputs, single, golden, smi)

    # ---- kernels ----
    kernel_rows = [
        dict(name=k, route="cuda", source=f"of_dis_tpu_torch/csrc/{rows[k]['source']}",
             replaces=rows[k]["replaces"],
             launches=counts[rows[k]["per"]][k] if rows[k]["per"] else 0,
             max_abs_err=rows[k]["max_abs_err"], ms=rows[k]["ms"],
             plain_ms=rows[k]["plain_ms"], bound_ms=rows[k]["bound_ms"],
             bound_by=rows[k]["bound_by"], library_ms=rows[k].get("library_ms"),
             **{key: rows[k][key] for key in ("level_ms", "variant_ms", "case_ms",
                                             "ms_per_pair_b32") if key in rows[k]})
        for k in KERNELS
    ]
    # gn_search's tile form (spatial tiling): op4 gray's level-0 tile call
    # on rank 0, its launches that rank's in the op4 gray tiles path
    kernel_rows.append(dict(
        name="gn_search tile form", route="cuda", source="of_dis_tpu_torch/csrc/gn_search.cu",
        replaces="of_dis_tpu/ops/pallas_kernels.py:538 and :560 (optimize_level(tile=))",
        launches=tile_row["launches"], max_abs_err=tile_row["max_abs_err"], ms=tile_row["ms"],
        plain_ms=tile_row["plain_ms"], bound_ms=tile_row["bound_ms"],
        bound_by=tile_row["bound_by"], library_ms=None, untiled_ms=tile_row["untiled_ms"],
        per=tile_row["per"]))
    emit("kernels", note="launches, ms, plain_ms and bound_ms are per pair of the path "
         "named in `per` (the sum over its launches; level_ms splits ms by pyramid level, "
         "variant_ms gives it for each launch variant); ms_per_pair_b32 is the time of the "
         "same calls of the batched path at B = 32 distinct pairs, over 32; "
         "sor_coupled is on no path: its times sum one launch at each op2 level shape, "
         "and its variant_ms gives each variant's ms at each of those levels; the gn_search "
         "tile form's row is rank 0's level-0 call of op4 gray tiles and that rank's launches "
         "there, untiled_ms the untiled kernel on the same patches; frame_pad's ms is op2 "
         "gray's pair as uint8 frames, flow_upscale's op2 gray's flow, case_ms each case "
         "(B = 1 and 32; stereo gray and op4 gray for flow_upscale), library_ms PyTorch's own "
         "ops for the same result (F.pad replicate; F.interpolate bilinear and a slice)",
         per={k: rows[k]["per"] for k in KERNELS}, launches_per_path=counts,
         launches_are="per replay of the path's CUDA graph, equal to an eager run's",
         pair_ms_median=latency, eager_pair_ms_median=eager_latency,
         batched_pairs_per_s=throughput["graph"], eager_batched_pairs_per_s=throughput["eager"],
         video_files_pairs_per_s=video_files["pairs_per_s_median"],
         graph_pool_mib=pools,
         checks={k: "ok" for k in KERNELS},
         total_seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
