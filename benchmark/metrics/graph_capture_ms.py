"""The capture ms of the cell's CUDA graphs: Executable.capture_ms summed
over the executables the program's cache holds after the window
(ops/graphs.py), the set-up share that capturing costs."""


def read(view, run):
    ex = run.extra.get("executables") or []
    return sum(ms for ms, _ in ex) if ex else None
