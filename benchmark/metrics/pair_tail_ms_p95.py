"""The 95th percentile of the host clock's time per pair, over every pair of
the untraced window that a traced run makes first (the stream driver's
p95, read per layer).  It swings from run to run with the share of pairs
that stall: op2's sits where the upload's stalls in
ops/transfer.py::to_device begin, stereo's in the jitter of its graph's
launch."""


def read(view, run):
    return (run.extra.get("clocked") or {}).get("pair_ms_p95")
