"""True SDC on the PyTorch port's AMR hierarchy (`driver/amr.py`: level 0
and every window step with `Simulation._sdc_step`, whose time-averaged face
fluxes feed the flux registers), on the CPU:

- against the JAX AmrSimulation: the acoustic pulse in 1D (n = 32 + one
  level over 0.3 < x < 0.7, regrid_int=0), SDC-4 on Lobatto nodes, two
  coarse steps, every level within 1e-10 of the largest magnitude of each
  component (float64, ghosts included);
- conservation, the port alone: every integrator (SDC-2, SDC-4 Lobatto and
  Radau) on the pulse in 1D and 2D to 1e-12 relative.

(`tests/test_torch_sdc_amr_react.py` holds the reacting configuration.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems import acoustic_pulse as jap
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.ops.interlevel import restrict, restrict_mask
from castro_tpu_torch.problems import acoustic_pulse as ap

jax.config.update("jax_enable_x64", True)

INTEGRATORS = {"sdc2": (2, 0), "sdc4-lobatto": (4, 0), "sdc4-radau": (4, 1)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pulse_params(mod, n, dim, order, quadrature=0):
    p = mod.make_params(n=n, dim=dim).with_ns(
        "castro", time_integration_method=2, sdc_order=order, sdc_quadrature=quadrature,
        use_retry=0)
    return p.with_ns("amr", max_level=1, regrid_int=0)


def _box_tag(dim, xp):
    """Tags the cells within 0.3 < x < 0.7 along every axis."""

    def tag(sim, u_int, level):
        m = xp.ones(tuple(u_int.shape[1:]), dtype=bool if xp is jnp else torch.bool)
        for d in range(dim):
            x = sim.geom.cell_centers(d, 0)
            x = jnp.asarray(x) if xp is jnp else x
            m = m & (x > 0.3) & (x < 0.7)
        return m

    return tag


def test_sdc4_amr_matches_jax():
    dim, n = 1, 32
    ja = JAmr(_pulse_params(jap, n, dim, 4), problem_init=jap.problem_init,
              problem_tagging=_box_tag(dim, jnp))
    ja.init_data()
    ta = AmrSimulation(_pulse_params(ap, n, dim, 4), problem_init=ap.problem_init,
                       problem_tagging=_box_tag(dim, torch), device="cpu")
    ta.init_data()
    for _ in range(2):
        ja.advance(2e-3)
        ta.advance(2e-3)
    for l in range(2):
        assert tuple(ja.window[l][1]) == tuple(ta.window[l][1])
        np.testing.assert_array_equal(np.asarray(ja.masks[l]), ta.masks[l].numpy())
        a, b = np.asarray(ja.u[l]), ta.u[l].numpy()
        scale = np.abs(a).reshape(a.shape[0], -1).max(1).reshape((-1,) + (1,) * dim)
        np.testing.assert_array_less(np.abs(b - a), 1e-10 * (np.abs(a) + scale) + 1e-300,
                                     err_msg=f"level {l}")


def _mass(amr, dx_vol):
    return float(amr.interior(0)[0].double().sum()) * dx_vol


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("name", list(INTEGRATORS))
def test_sdc_amr_conserves_mass(name, dim):
    """The pulse in a periodic box: the reflux of the SDC fluxes keeps the
    composite mass to round-off; the covered coarse cells hold the average
    of their children."""
    order, quad = INTEGRATORS[name]
    n = 32 if dim == 1 else 16
    amr = AmrSimulation(_pulse_params(ap, n, dim, order, quad), problem_init=ap.problem_init,
                        problem_tagging=_box_tag(dim, torch), device="cpu")
    amr.init_data()
    assert int(amr.masks[1].sum()) > 0
    vol = (1.0 / n) ** dim
    amr.advance(2e-3)  # re-baselines the covered cells from the fine data
    m0 = _mass(amr, vol)
    for _ in range(2):
        amr.advance(2e-3)
    assert abs(_mass(amr, vol) - m0) / m0 < 1e-12
    assert all(bool(torch.isfinite(u).all()) for u in amr.u)
    cmask = restrict_mask(amr.masks[1], dim)
    covered = amr.interior(0)[(0,) + amr._parent_rel_slice(1)][cmask]
    children = restrict(amr.interior(1), dim)[0][cmask]
    assert cmask.any() and torch.allclose(covered, children, rtol=1e-14, atol=0.0)
    assert amr.sim0.sdc is not None and type(amr.sims[1].sdc) is type(amr.sim0.sdc)
