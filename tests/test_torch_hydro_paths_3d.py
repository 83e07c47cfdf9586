"""The unfused 3D hydro paths end to end: steps of the port's Simulation on
the CPU against the JAX Simulation on its XLA path, for 3D Sedov (n = 12)
with riemann_solver=1 (riemanncg) and with hybrid_riemann=1 (riemannus with
the HLL flux inside shocks; the run must flag some cells), in float64 and
float32. The port runs flatten, trace, 18 trans_apply and 3 consup through
the kernels' plain versions and the Riemann solves as torch ops.

Same inputs, steps and tolerances as tests/test_torch_hydro_paths.py, whose
helpers this file uses: float64 rtol 1e-10 (floor 1e-10 of the component's
largest magnitude), float32 rtol = atol = 2e-5 (tests/test_pallas.py:41),
interiors only.
"""

import pytest

from test_torch_hydro_paths import _few_threads, _jax_states, _port_matches  # noqa: F401

# name -> (problem, dim, n, castro overrides, steps, dt)
CASES = {
    "sedov3d-cg": ("sedov", 3, 12, dict(riemann_solver=1), 2, 2e-3),
    "sedov3d-hybrid": ("sedov", 3, 12, dict(hybrid_riemann=1), 3, 2e-3),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax_3d(case, dtype):
    states, ng = _jax_states(CASES[case], dtype)
    _port_matches(CASES[case], dtype, states, ng)
