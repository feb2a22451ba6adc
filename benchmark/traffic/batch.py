"""Traffic driver `batch`: many streams whose frames are already on the
card (as from a GPU decoder) and whose flows the next stage reads on the
card.

A closed loop of `batched_flow(a, b, cfg)` calls, each on `batch` distinct
pairs (uint8, on the card), drawn in turn from a pool of `pool_batches`
batches made from the seed.  The host runs at most `queue_depth` calls
ahead: before it enqueues call i it waits for call i - queue_depth to
complete (as process_video_batched queues).  The window ends with a
synchronize; pairs_per_s is every pair of the window over the time from its
start until the last call completed.

Mix parameters: batch, pool_batches, queue_depth, warm_calls (set-up),
check_answers (calls whose outputs are kept, on the card, and checked), trace_calls.
"""

from __future__ import annotations

import time
from collections import deque

import torch


def prepare(run):
    t = run.cell.traffic
    b, n = t["batch"], t["pool_batches"]
    img1, img2 = run.make_pairs(b * n)
    pool = [(img1[k * b:(k + 1) * b], img2[k * b:(k + 1) * b]) for k in range(n)]
    for k in range(t["warm_calls"]):
        run.port.batched_flow(*pool[k % n], run.cfg, device=run.device)
    keep = torch.empty((t["check_answers"], b, run.height, run.width, run.cfg.nop),
                       dtype=torch.float32, device=run.device)
    run.sync()
    return {"pool": pool, "img1": img1, "img2": img2, "keep": keep,
            "kept": [None] * keep.shape[0]}


def window(run, state, seconds, sample, max_calls):
    t = run.cell.traffic
    pool, depth, b = state["pool"], t["queue_depth"], t["batch"]
    cuda = run.device.type == "cuda"
    done = deque()
    i = 0
    run.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds and (max_calls is None or i < max_calls):
        if len(done) >= depth:
            with run.span("bench.wait"):
                done.popleft().synchronize()
        a, bb = pool[i % len(pool)]
        with run.span("bench.call"):
            out = run.port.batched_flow(a, bb, run.cfg, device=run.device)
        if cuda:
            done.append(torch.cuda.current_stream(run.device).record_event())
        j = sample.slot()
        if j is not None:
            state["keep"][j].copy_(out)
            state["kept"][j] = i
        i += 1
    run.sync()
    elapsed = time.perf_counter() - t0
    return {"pairs": i * b, "calls": i, "failed": 0, "seconds": elapsed,
            "e2e": {"pairs_per_s": i * b / elapsed}}


def answers(run, state):
    """(pool indices, outputs) of each sampled call."""
    b, n = run.cell.traffic["batch"], len(state["pool"])
    return [(list(range((i % n) * b, (i % n + 1) * b)), state["keep"][j])
            for j, i in enumerate(state["kept"]) if i is not None]


def pool(run, state):
    """The whole pool (img1, img2), on the device."""
    return state["img1"], state["img2"]
