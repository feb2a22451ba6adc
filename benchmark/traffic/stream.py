"""Traffic driver `stream`: one camera, one pair at a time, 8-bit frames in
host memory, and the result needed on the host.

A closed loop of `to_host(dis_flow(a, b, cfg)).numpy()` (`dis_stereo` for
a stereo configuration), the pairs drawn in turn from a pool of
`pool_pairs` pairs made on the card from the seed and copied to host
memory once, during set-up.  Each pair's latency is taken on the host clock
from the call until its numpy result is in hand; pair_ms_p50 is over
every pair of the window, and pair_ms_mean is the window's whole time over
its pairs (the closed loop's time per pair, long stalls included).
pair_ms_p95 is read per layer (metrics/pair_tail_ms_p95.py); pair_ms_p99
and pair_ms_max are for the log.

Mix parameters: pool_pairs, warm_calls (set-up), check_answers (pairs whose
results are copied to host memory the harness owns, and checked), trace_calls.
"""

from __future__ import annotations

import time

import numpy as np


def _entry(run):
    return run.port.dis_stereo if run.cfg.mode == "stereo" else run.port.dis_flow


def prepare(run):
    t = run.cell.traffic
    img1, img2 = run.make_pairs(t["pool_pairs"])
    host = [(a.numpy(), b.numpy()) for a, b in zip(img1.cpu(), img2.cpu())]
    del img1, img2
    from of_dis_tpu_torch.ops.transfer import to_host

    entry = _entry(run)
    for k in range(t["warm_calls"]):
        to_host(entry(*host[k % len(host)], run.cfg, device=run.device)).numpy()
    shape = (t["check_answers"], run.height, run.width) + ((2,) if run.cfg.nop == 2 else ())
    keep = np.empty(shape, np.float32)
    keep.fill(0.0)  # touch the pages now, not in the window
    return {"host": host, "to_host": to_host, "keep": keep, "kept": [None] * shape[0]}


def window(run, state, seconds, sample, max_calls):
    host, to_host, entry = state["host"], state["to_host"], _entry(run)
    lat = []
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while clock() - t0 < seconds and (max_calls is None or i < max_calls):
        a, b = host[i % len(host)]
        s = clock()
        with run.span("bench.call"):
            out = to_host(entry(a, b, run.cfg, device=run.device))
        with run.span("bench.wait"):
            arr = out.numpy()
        lat.append(clock() - s)
        j = sample.slot()
        if j is not None:
            state["keep"][j] = arr
            state["kept"][j] = i
        i += 1
    run.sync()
    elapsed = clock() - t0
    ms = np.asarray(lat) * 1e3
    e2e = {}
    if i:
        e2e = {"pair_ms_p50": float(np.percentile(ms, 50)),
               "pair_ms_p95": float(np.percentile(ms, 95)),
               "pair_ms_mean": elapsed * 1e3 / i,
               "pair_ms_p99": float(np.percentile(ms, 99)),
               "pair_ms_max": float(ms.max())}
    return {"pairs": i, "calls": i, "failed": 0, "seconds": elapsed, "e2e": e2e}


def answers(run, state):
    """(pool index, result) of each sampled pair."""
    n = len(state["host"])
    return [([i % n], state["keep"][j:j + 1]) for j, i in enumerate(state["kept"])
            if i is not None]


def pool(run, state):
    import torch

    img1 = torch.from_numpy(np.stack([a for a, _ in state["host"]]))
    img2 = torch.from_numpy(np.stack([b for _, b in state["host"]]))
    return img1, img2
