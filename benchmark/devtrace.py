"""Reading a torch.profiler trace of the traced window into what the
per-layer readers need.

    with profiler() as prof:
        with torch.profiler.record_function(WINDOW):
            ...                                   # the traced window
    view = TraceView.from_profile(prof, pairs=..., calls=...)

The window is the host span named WINDOW; the device operations are the
kernels, copies and fills (CUPTI records each node of a CUDA graph replay
as its own kernel) that start inside it.  Device busy time is the union of
their intervals, clipped to the window, not a sum of durations.  A host
call "dispatches" when it is a CUDA runtime or driver call that enqueues
device work: a kernel or graph launch, a copy or a fill (a graph launch
counts once, however many nodes it replays).  Idle gaps on the device are
labelled with the innermost host span of the window's thread that was
running at the gap's midpoint.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."      # the harness's host spans: bench.window, bench.call, bench.wait
WINDOW = SPAN_PREFIX + "window"
KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


def profiler():
    """The profiler the traced window runs under: host and device
    activities, no shapes or stacks."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def dispatches(name: str) -> bool:
    """Whether a host call enqueues device work (kernel or graph launch, copy
    or fill): a cuda* / cu* call whose name says Launch, Memcpy or Memset."""
    return name.startswith("cu") and any(w in name for w in ("Launch", "Memcpy", "Memset"))


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy HtoD") or name.startswith("Memcpy DtoH")


def port_kernels() -> Dict[str, str]:
    """{stage: substring of its kernel's name}, one file per kernel of the
    program under benchmark/kernels/."""
    return {p.stem: json.loads(p.read_text())["match"] for p in sorted(KERNELS_DIR.glob("*.json"))}


def _is_annotation(e) -> bool:
    """Whether a kineto event is a record_function range (host or device
    side); older PyTorch builds lack activity_type()."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in ("user_annotation", "gpu_user_annotation")
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def _union(spans: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s0, s1 in sorted(spans):
        if end is None or s0 > end:
            total += s1 - s0
            end = s1
        elif s1 > end:
            total += s1 - end
            end = s1
    return total


class TraceView:
    """The traced window: device operations and host spans as (name, start
    ns, end ns), busy and idle time, with the pairs and calls the window
    completed."""

    def __init__(self, device, host, t0: int, t1: int, pairs: int, calls: int):
        self.device: List[Tuple[str, int, int]] = device
        self.host: List[Tuple[str, int, int]] = host
        self.t0, self.t1 = t0, t1
        self.pairs, self.calls = pairs, calls
        self.window_s = (t1 - t0) / 1e9
        spans = [(max(s, t0), min(e, t1)) for _, s, e in device]
        self.busy_s = _union([sp for sp in spans if sp[1] > sp[0]]) / 1e9

    @classmethod
    def from_profile(cls, prof, pairs: int, calls: int) -> "TraceView":
        """The window WINDOW of a torch.profiler run: device operations that
        start in it, and the host spans of its thread."""
        events = prof.profiler.kineto_results.events()
        cpu = torch.autograd.DeviceType.CPU
        wins = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
        if len(wins) != 1:
            raise RuntimeError(f"expected one {WINDOW!r} span in the trace, found {len(wins)}")
        t0, t1, thread = wins[0].start_ns(), wins[0].end_ns(), wins[0].start_thread_id()
        spans = {e.name() for e in events if _is_annotation(e)}
        device, host = [], []
        for e in events:
            s = e.start_ns()
            if not t0 <= s <= t1:
                continue
            name = e.name()
            if e.device_type() != cpu:
                # kernels, copies and fills; not the device-side copies of
                # host annotations (record_function ranges)
                if not name.startswith(SPAN_PREFIX) and name not in spans and not _is_annotation(e):
                    device.append((name, s, s + e.duration_ns()))
            elif e.start_thread_id() == thread and name != WINDOW:
                host.append((name, s, s + e.duration_ns()))
        return cls(device, host, t0, t1, pairs, calls)

    # -- sums over the window ------------------------------------------------

    def device_seconds(self, pred) -> float:
        return sum(e - s for name, s, e in self.device if pred(name)) / 1e9

    def host_calls(self) -> int:
        return sum(1 for name, _, _ in self.host if dispatches(name))

    def kernel_seconds(self, stage: str) -> Optional[float]:
        """Device seconds of the program's kernel for `stage`, or None when
        it did not run in the window."""
        match = port_kernels().get(stage)
        if match is None:
            return None
        t = [e - s for name, s, e in self.device if match in name]
        return sum(t) / 1e9 if t else None

    def torch_op_seconds(self) -> float:
        """Device seconds of kernels that are neither the program's own
        CUDA kernels nor copies and fills."""
        mine = tuple(port_kernels().values())
        return self.device_seconds(
            lambda n: not n.startswith(("Memcpy", "Memset")) and not any(m in n for m in mine))

    # -- the breakdown --------------------------------------------------------

    def top_device_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            key = name[:160]
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Device idle time in the window, summed by the innermost host span
        running at each gap's midpoint ("(no host span)" where none ran)."""
        spans = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.device)
        gaps, cur = [], self.t0
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid)
            label = "(no host span)"
            for j in range(i - 1, max(-1, i - 2049), -1):  # latest start first
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            by[label[:160]] = by.get(label[:160], 0.0) + (g1 - g0) / 1e9
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def roofline(view: TraceView, run, stage: str) -> Optional[float]:
    """The stage's share of its roofline, in %: the least time the card's
    peaks allow for one pair's work (work.py) over the stage's kernel time
    per pair in the window.  None where the kernel did not run or the card
    is not in the table of peaks."""
    from work import bound_s, pair_work, peak

    t = view.kernel_seconds(stage)
    pk = peak(run.extra.get("device_name", ""))
    w = pair_work(run.params, run.width, run.height).get(stage)
    if t is None or pk is None or w is None or not view.pairs:
        return None
    return 100.0 * bound_s(*w, pk) / (t / view.pairs)


def idle_share(view: TraceView) -> Optional[float]:
    """100 x (1 - device busy union / traced window), in %."""
    if not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def per_pair_ms(view: TraceView, seconds: float) -> Optional[float]:
    return 1e3 * seconds / view.pairs if view.pairs and view.device else None
