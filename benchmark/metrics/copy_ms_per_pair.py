"""Device ms per pair of the host-to-device and device-to-host copies
(ops/transfer.py's pinned uploads and result copies) in the traced window."""

from devtrace import is_copy, per_pair_ms


def read(view, run):
    s = view.device_seconds(is_copy)
    return per_pair_ms(view, s) if s else None
