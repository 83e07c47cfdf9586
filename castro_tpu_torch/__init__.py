"""castro_tpu_torch: the PyTorch / CUDA port of castro_tpu for NVIDIA Hopper.

The JAX package `castro_tpu` is the reference. This package imports torch
and numpy only, keeps the JAX package's state layout at every public
function, and runs the 3D CTU hydro step on the card through the
hand-written CUDA kernels of `castro_tpu_torch/csrc` (see
`castro_tpu_torch/ops/kernels.py`). Entry points run on the card unless the
caller passes `device="cpu"`.
"""
