"""Device ms per pair of the kernels that are neither the program's own
CUDA kernels (benchmark/kernels/) nor copies or fills: the PyTorch ops of
the driver, pyramid, densification and refinement steps (models/dis.py,
models/densify.py, models/refine.py, ops/pyramid.py)."""

from devtrace import per_pair_ms


def read(view, run):
    return per_pair_ms(view, view.torch_op_seconds())
