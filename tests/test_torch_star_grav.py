"""StarGrav (gravity_tests.star_grav_*: a white dwarf held in HSE under
MonopoleGrav, its 1024-shell model built by the spherical march) in the
port against the JAX package on the CPU, float64: the initial state at
n = 64 within 1e-10 relative (each component's largest magnitude as the
floor); then the check of tests/test_problem_coverage.py on the port's
own steps: the core's flow stays far below its sound speed. The
hydrostatic_adjust setup, the same star with its heating source, is
test_torch_hse_adjust.py.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.problems import gravity_tests as j_gt
from castro_tpu_torch.problems import gravity_tests as gt
from test_torch_science_setups import init_pair, run_port

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_star_grav_holds_hse():
    js, sim = init_pair(j_gt.star_grav_params(n=64), j_gt.star_grav_init,
                        gt.star_grav_params(n=64), gt.star_grav_init)
    L = sim.layout
    assert sim.interior().numpy()[L.URHO].max() > 1e9
    ui = run_port(sim, 6)
    sel = ui[L.URHO] > 1e7
    assert np.abs(ui[L.UMX][sel] / ui[L.URHO][sel]).max() < 5e7
