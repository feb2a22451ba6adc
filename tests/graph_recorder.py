"""A recording stand-in for CUDA graphs behind ops/graphs.py's cache, for
CPU tests (tests/test_torch_graphs.py; the sharded passes in
tests/torch_spatial_worker.py).  Imports no JAX."""

from of_dis_tpu_torch.ops import graphs, kernels
from of_dis_tpu_torch.parallel import collectives

POOL = 1 << 20  # the stand-in's pool per capture, bytes


class Recorder:
    """CudaGraphs' interface on the CPU.  A capture runs the function once
    and keeps its results as the graph's output buffers; a replay runs it
    again with the launch, route and exchange counters left as they were
    (a graph calls no wrapper and no collective's Python) and writes into
    those same buffers, as a graph rewrites its pool.  Every call is recorded,
    and whether each capture was collective."""

    def __init__(self):
        self.warm_ups = 0
        self.captures = []
        self.replays = 0
        self.released = []

    def warm_up(self, run, device):
        self.warm_ups += 1
        run()

    def pool_bytes(self, handle, device):
        return POOL

    def capture(self, run, device, collective=False):
        handle = dict(run=run, out=run(), collective=collective)
        self.captures.append(handle)
        return handle, handle["out"]

    def replay(self, handle):
        counters = (kernels.launches, kernels.routes, collectives.exchanges)
        counts = [dict(c) for c in counters]
        new = handle["run"]()
        for c, saved in zip(counters, counts):
            c.update(saved)
        bufs, fresh = [], []
        graphs._flatten(handle["out"], bufs)
        graphs._flatten(new, fresh)
        for b, f in zip(bufs, fresh):
            b.copy_(f)
        self.replays += 1

    def release(self, handle):
        self.released.append(handle)
