"""One step of each 2D hydro test setup of the PyTorch port
(`problems/hydro_tests.py`: KH in both variants, RT under ConstantGrav,
Noh, gresho_vortex, oddeven with hybrid_riemann, lw_acoustics; and
`riemann_2d.py` configuration 3) from the JAX initial state at 16^2 (RT
16 x 32), against the JAX package's step within 1e-10 |jax| + 1e-10
max|jax| per component (float64, interiors only); the JAX step runs op by
op. The helpers and the initial states are `tests/test_torch_hydro_setups.py`'s.
"""

import pytest
import torch

from test_torch_hydro_setups import SETUPS, step_matches_jax

STEPPED_2D = ["kh-1", "kh-2", "rt", "noh-2d", "gresho", "oddeven", "lw_acoustics",
              "riemann_2d-c3"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", STEPPED_2D)
def test_step_matches_jax(name):
    assert name in SETUPS
    step_matches_jax(name)
