"""bwp-rad of the port against the JAX package's (`science_extra.bwp_rad_*`:
a 0.2 Msun solar-like star in 2D RZ, monopole gravity, gray FLD with the
Kramers opacity through the operator-split step), init + 2 steps
(tests/test_torch_rad_setups.py:setup_against_jax) at 16 x 32. Tolerance
float64 1e-10 |jax| + 1e-10 max|jax| per component."""

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_setups import setup_against_jax


def test_bwp_rad(jit_jax_solve):
    from castro_tpu.problems import science_extra as jm
    from castro_tpu_torch.problems import science_extra as tm

    setup_against_jax(jm.bwp_rad_params(n=(16, 32)), tm.bwp_rad_params(n=(16, 32)),
                      jm.bwp_rad_init, tm.bwp_rad_init)
