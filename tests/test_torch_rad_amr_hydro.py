"""Radiation with hydro on two-level Cartesian AMR, the port's hierarchy
against the JAX package's (tests/test_torch_rad_amr.py:
hierarchy_against_jax): each level's step the characteristic rad-CTU step,
the gas and radiation fluxes both into the flux registers; one coarse
step. Tolerance float64 1e-10 |jax| + 1e-10 max|jax| per component."""

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_amr import hierarchy_against_jax


def test_amr_radiation_with_hydro(jit_jax_solve):
    hierarchy_against_jax(do_hydro=1, steps=1)
