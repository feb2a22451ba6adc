"""The level_search stage's share of its roofline in the traced window, in %
(devtrace.roofline: work.py's bytes and FP32 operations per pair against
the card's peaks, over the kernel's device time per pair)."""

from devtrace import roofline


def read(view, run):
    return roofline(view, run, "level_search")
