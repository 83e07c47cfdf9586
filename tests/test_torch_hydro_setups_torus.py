"""One step of the rotating torus of the PyTorch port
(`problems/hydro_tests.py:rotating_torus_*`: 3D, PoissonGrav with a point
mass, hybrid momenta with hybrid_hydro; 16 x 16 x 8) from the JAX initial
state against the JAX package's step, within 1e-10 |jax| + 1e-10 max|jax|
per component (float64, interiors only), the JAX step op by op with its
multigrid jitted (`tests/test_torch_gravity.py:make_jit_poisson`). The
helpers are `tests/test_torch_hydro_setups.py`'s.
"""

import pytest
import torch

from castro_tpu.solvers import multigrid as jmg
from test_torch_gravity import make_jit_poisson
from test_torch_hydro_setups import step_matches_jax


def test_rotating_torus_step_matches_jax():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    try:
        step_matches_jax("rotating_torus")
    finally:
        mp.undo()
        torch.set_num_threads(threads)
