"""The benchmark's plain reference: Dense Inverse Search flow and stereo in
plain PyTorch, independent of the program under test.

A frozen copy of the DIS driver's plain path (pyramid, patch grid, inverse
search with the L2 cost, densification, TV refinement, upscale and crop),
written from the upstream OF_DIS sources' semantics
(run_dense.cpp, oflow.cpp, patchgrid.cpp, patch.cpp,
refine_variational.cpp, FDF1.0.1's opticalflow_aux.c and solver.c).  Every
stage runs on a leading batch axis of pairs, one pair's numbers the same
whatever the batch.  The arithmetic runs in the dtype of the images it is
given: float32 is the configurations' precision, bfloat16 the benchmark's
lower-precision control.

This package imports torch and numpy only: nothing of the program, and
nothing of JAX.
"""
