"""The device's idle share of the traced window, in %: 100 x (1 - the
union of device operations' intervals / the window)."""

from devtrace import idle_share


def read(view, run):
    return idle_share(view)
