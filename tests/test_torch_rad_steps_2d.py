"""2D radiation steps of the port against the JAX package's from the same
state with the same dt (tests/test_torch_rad_steps.py:steps_against_jax):
the characteristic rad-CTU step (one transverse pass with the radiation
terms) and the operator-split step on the radiation layout (cmpflx for the
1D solves, trans_cmpflx for the final stage on the card; their plain
versions here). Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per
component."""

import pytest

from castro_tpu.config import Params as JParams

from castro_tpu_torch.config import Params

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_steps import box_params, steps_against_jax


@pytest.mark.parametrize("case", ["ctu", "split"])
def test_rad_step_2d(jit_jax_solve, case):
    kw = dict(split=int(case == "split"))
    steps_against_jax(box_params(JParams, (16, 8), **kw), box_params(Params, (16, 8), **kw),
                      eager=case == "ctu")
