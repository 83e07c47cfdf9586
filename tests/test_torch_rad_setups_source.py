"""The radiation setups with castro.do_hydro=0 (source-only evolution: no
fluxes, u_new = u + sources, then the implicit radiation update) against
the JAX package's, init + 2 steps (tests/test_torch_rad_setups.py:
setup_against_jax): RadThermalWave, RadSourceTest, Su & Olson gray and
multigroup (its picket-fence emissivity and volume source); and do_hydro=0
without radiation, the 1D spherical dust collapse under its monopole
gravity alone. Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per
component."""

import numpy as np
import pytest
import torch

import jax

from castro_tpu.driver.sim import Simulation as JSim

from castro_tpu_torch.driver.sim import Simulation

from test_torch_radiation import _few_threads, close, jit_jax_solve  # noqa: F401
from test_torch_rad_setups import setup_against_jax


def test_thermal_wave_and_rad_source(jit_jax_solve):
    from castro_tpu.problems import rad_tests as jm
    from castro_tpu_torch.problems import rad_tests as tm

    setup_against_jax(jm.thermal_wave_params(n=32), tm.thermal_wave_params(n=32),
                      jm.thermal_wave_init, tm.thermal_wave_init)
    setup_against_jax(jm.rad_source_params(n=16), tm.rad_source_params(n=16),
                      jm.rad_source_init, tm.rad_source_init,
                      jpost=lambda s_: setattr(s_, "u_rad", jm.rad_source_Er0(s_)),
                      tpost=lambda s_: setattr(s_, "u_rad", tm.rad_source_Er0(s_)), dt=1e-13)


@pytest.mark.parametrize("mg", [False, True], ids=["gray", "multigroup"])
def test_su_olson(jit_jax_solve, mg):
    from castro_tpu.problems import su_olson as jm
    from castro_tpu_torch.problems import su_olson as tm

    if mg:
        setup_against_jax(jm.mg_params(n=32), tm.mg_params(n=32), jm.mg_init, tm.mg_init,
                          jpost=jm.mg_setup_radiation, tpost=tm.mg_setup_radiation,
                          dt=3.3356409519815201e-12)
    else:
        setup_against_jax(jm.make_params(n=32), tm.make_params(n=32), jm.problem_init,
                          tm.problem_init, dt=1.0e-13)


def test_do_hydro_0_without_radiation():
    """castro.do_hydro=0 (castro_tpu/driver/sim.py:560-570): the sources
    alone, no Courant check; the 1D spherical dust collapse's monopole
    gravity, two steps from the JAX state, the JAX step op by op. The
    energy source is grav_source_type 2 (v . rho g): with the setup's type
    4 the cold dust's total energy is its kinetic energy to 10 digits, and
    e = E - KE cancels to two ulps of E (both packages' states agree to 4e-15
    of E before the clean)."""
    from castro_tpu.problems import dust_collapse as jm
    from castro_tpu_torch.problems import dust_collapse as tm

    jp = jm.make_params(n=32).with_ns("castro", do_hydro=0, grav_source_type=2)
    tp = tm.make_params(n=32).with_ns("castro", do_hydro=0, grav_source_type=2)
    js = JSim(jp, problem_init=jm.problem_init)
    js.init_data()
    ts = Simulation(tp, problem_init=tm.problem_init, device="cpu")
    ts.u = torch.tensor(np.asarray(js.u))
    u = js.u
    for k in range(2):
        with jax.disable_jit():
            u = js._step_impl(u, 1e-3, k * 1e-3)[0]
        ts.u = ts._step_impl(ts.u, 1e-3, k * 1e-3)[0]
        L = ts.layout
        close(ts.interior(), np.asarray(js.interior(u)), what=f"step {k + 1}",
              vectors=[(L.UMX, L.UMY, L.UMZ)])
    # the gravity moved the matter: a source-only step is not the identity
    assert float((ts.interior()[L.UMX]).abs().max()) > 0.0
