"""Radiation steps in 2D RZ of the port against the JAX package's from the
same state with the same dt (tests/test_torch_rad_steps.py:
steps_against_jax): the characteristic rad-CTU step (the area-weighted
transverse pass with its radiation terms, the dloga trace source) and the
operator-split step (cmpflx with coord 1 on the card, the RZ transverse
pass in torch ops), the implicit solves on the RZ metric. Tolerance:
float64 1e-10 |jax| + 1e-10 max|jax| per component."""

import pytest

from castro_tpu.config import Params as JParams

from castro_tpu_torch.config import Params

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_steps import box_params, steps_against_jax


@pytest.mark.parametrize("case", ["ctu", "split"])
def test_rad_step_rz(jit_jax_solve, case):
    kw = dict(split=int(case == "split"), coord=1)
    steps_against_jax(box_params(JParams, (12, 8), **kw), box_params(Params, (12, 8), **kw),
                      eager=case == "ctu", dt=1e-3)
