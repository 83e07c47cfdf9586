"""3D radiation of the port against the JAX package's: the rad-CTU chain
piece by piece (tests/test_torch_rad_hydro.py:check_chain, full corner
coupling with the radiation terms of trans_single and trans_final), and
one characteristic rad-CTU step from the same state with the same dt
(tests/test_torch_rad_steps.py:steps_against_jax). Tolerance: float64
1e-10 |jax| + 1e-10 max|jax| per component."""

from castro_tpu.config import Params as JParams

from castro_tpu_torch.config import Params

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_hydro import check_chain
from test_torch_rad_steps import box_params, steps_against_jax


def test_rad_ctu_chain_3d():
    check_chain(3, 0, 1)


def test_rad_step_3d(jit_jax_solve):
    steps_against_jax(box_params(JParams, (8, 8, 8)), box_params(Params, (8, 8, 8)), steps=1,
                      eager=True)
