"""Host calls that enqueue device work (kernel and graph launches, copies,
fills; a graph launch counts once) per pair of the traced window: the
entry path's cost on the host (models/dis.py::dis_raw, _dis_batch)."""


def read(view, run):
    n = view.host_calls()
    return n / view.pairs if n and view.pairs else None
