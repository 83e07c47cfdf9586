"""hydrostatic_adjust (gravity_tests.hse_adjust_*: the StarGrav white dwarf
driven out of HSE by a Gaussian heating shell, `make_hse_adjust_source`)
in the port against the JAX package on the CPU, float64: the initial
state at n = 64 within 1e-10 relative, the source on it against JAX's
(both prob_types); then the check of tests/test_problem_coverage.py on
the port's own steps: the heating deposits energy.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.problems import gravity_tests as j_gt
from castro_tpu_torch.problems import gravity_tests as gt
from test_torch_science_setups import init_pair, run_port, same_state

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_hse_adjust_heating_expands_star():
    jp, tp = j_gt.hse_adjust_params(n=64), gt.hse_adjust_params(n=64)
    js, sim = init_pair(jp, j_gt.hse_adjust_init, tp, gt.hse_adjust_init,
                        ext=gt.make_hse_adjust_source(tp), jext=j_gt.make_hse_adjust_source(jp))
    L = sim.layout
    for prob_type in (1, 3):
        jsrc = j_gt.make_hse_adjust_source(jp.replace(problem=dict(jp.problem,
                                                                   prob_type=prob_type)))
        tsrc = gt.make_hse_adjust_source(tp.replace(problem=dict(tp.problem,
                                                                 prob_type=prob_type)))
        for t in (0.1, 0.6):  # before and after heating_time
            ref = np.asarray(jsrc(js, js.u, None, None, t, 1e-3))
            got = tsrc(sim, sim.u, None, None, t, 1e-3).numpy()
            same_state(got, ref, what=f"source {prob_type} t={t}")
    e0 = sim.interior().numpy()[L.UEINT].sum()
    ui = run_port(sim, 4)
    assert ui[L.UEINT].sum() > e0
