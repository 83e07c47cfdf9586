"""Curvilinear steps: Sedov in 2D RZ (the reference's
inputs.2d.sph_in_cylcoords setup: r in [0, 1], z in [-1, 1], symmetry on the
axis) and in 1D spherical and cylindrical geometry, through the port's
kernel structure (plain versions on the CPU) against the JAX XLA path in
float64, 1D spherical in float32 against the JAX kernel route under the
Pallas interpreter, and one step of the port from a JAX checkpoint of an
RZ run. (Split from tests/test_torch_curvilinear.py, whose helpers it uses,
to keep each file under a minute on one worker.)

Tolerances as the other test_torch_* files: float64 rtol 1e-10 (plus 1e-10
of each component's largest magnitude); float32 rtol = atol = 2e-5
(tests/test_pallas.py:41); interiors only.
"""

import numpy as np
import pytest

import jax

from castro_tpu.driver import io as jio
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.problems import sedov as jsedov

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import sedov

from test_torch_curvilinear import _init, _jax_steps, _params, _port_steps
from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401


# geometry -> (n, steps, dt)
CASES = {"rz": (8, 2, 1e-3), "sph": (32, 3, 1e-3), "cyl1d": (32, 3, 1e-3)}


@pytest.mark.parametrize("geometry", ["rz", "sph", "cyl1d"])
def test_steps_match_jax(geometry):
    """float64 (1D spherical in float32 is held against the JAX kernel
    route below; RZ in float32 on the card against the CPU, chip_smoke.py
    path E)."""
    dtype = "float64"
    n, steps, dt = CASES[geometry]
    _port_steps(geometry, n, dtype, _jax_steps(geometry, n, dtype, steps, dt), dt)
    assert all(v == 0 for v in K.launch_counts().values())


def test_steps_match_jax_kernel_route():
    """1D spherical in float32, the JAX package on its kernel route
    (cmpflx_pallas) under the Pallas interpreter."""
    geometry = "sph"
    n, steps, dt = CASES[geometry]
    pk.INTERPRET = True
    try:
        states = _jax_steps(geometry, n, "float32", steps, dt, use_pallas=True)
    finally:
        pk.INTERPRET = False
    _port_steps(geometry, n, "float32", states, dt)



def test_restart_from_jax_rz_checkpoint(tmp_path):
    """One step of the port from a JAX RZ checkpoint matches the JAX step."""
    n = 8
    with jax.disable_jit():
        js = JSim(_params(jsedov, "rz", n, "float64"), problem_init=_init(jsedov, 2))
        js.init_data()
        js.run(max_step=1, verbose=False)
        path = jio.write_checkpoint(js, str(tmp_path / "chk00001"))
        js.run(max_step=2, verbose=False)
        ref = np.asarray(js.interior())
    sim = Simulation(_params(sedov, "rz", n, "float64"), problem_init=_init(sedov, 2),
                     device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    sim.run(max_step=2, verbose=False)
    _assert_close(sim.interior(), ref, "float64", "one step after the restart")
