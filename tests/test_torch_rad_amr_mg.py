"""Multigroup radiation with Compton scattering on two-level Cartesian AMR,
the port's hierarchy against the JAX package's (tests/test_torch_rad_amr.py:
hierarchy_against_jax): 4 groups with a leading group axis on every level
(`_rad_cax`), per-group window Dirichlet data and deferred sync, the
Compton exchange after each level's implicit update. Tolerance float64
1e-10 |jax| + 1e-10 max|jax| per component."""

import torch

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_amr import hierarchy_against_jax


def test_amr_radiation_multigroup_compton(jit_jax_solve):
    ja, ta = hierarchy_against_jax(ngroups=4)
    assert ta._rad_cax == 1 and all(er.dim() == 3 for er in ta.u_rad)
    assert all(bool(torch.isfinite(er).all()) and float(er.min()) >= 0.0 for er in ta.u_rad)
