"""castro_tpu_torch: the PyTorch / CUDA port of castro_tpu for NVIDIA Hopper.

The JAX package `castro_tpu` is the reference. This package imports torch
and numpy only, keeps the JAX package's state layout at every public
function, and runs the single-level CTU hydro step (1D, 2D and 3D;
Cartesian, RZ and spherical) on the card through the hand-written CUDA
kernels of `castro_tpu_torch/csrc` (see `castro_tpu_torch/ops/kernels.py`;
the profiling probes are `ops/probes.py` and `scripts/`). Entry points run on the card unless the
caller passes `device="cpu"`.
"""
