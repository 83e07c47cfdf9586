"""True SDC-4 on the PyTorch port's AMR hierarchy with reactions, on the
CPU: the configuration of tests/test_sdc_amr.py:25-75 (reacting_convergence,
Helmholtz + triple-alpha, 1D + one level over 0.25e8 < x < 0.75e8, SDC-4,
the pointwise initial values turned into cell averages), whose first coarse
step re-baselines the covered cells from the fine data and whose next
conserves the composite mass to 1e-11 relative, as the JAX test asks. The
port holds it alone, at n = 16 (the JAX test's n is 32): the JAX package's
own run takes minutes on a CPU, its whole SDC-4 step with the burner
compiling. `tests/test_torch_sdc_amr.py` holds SDC on AMR against the JAX
AmrSimulation without reactions, and `tests/test_torch_sdc_react.py` the
reacting SDC steps against JAX on one level.
"""

import numpy as np
import torch

from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.ops.fourth_order import cell_center_to_avg
from castro_tpu_torch.problems.reacting_tests import (reacting_convergence_init,
                                                      reacting_convergence_params)


def _mass(amr, dx_vol):
    return float(amr.interior(0)[0].double().sum()) * dx_vol


def test_sdc_amr_reacting_conserves_mass():
    torch.set_num_threads(2)
    n = 16
    params = reacting_convergence_params(n=n, dim=1).with_ns(
        "castro", time_integration_method=2, sdc_order=4, use_retry=0)
    params = params.with_ns("amr", max_level=1, regrid_int=0)

    def ptag(sim, u_int, level):
        x = sim.geom.cell_centers_1d(0, 0)
        return (x > 0.25e8) & (x < 0.75e8)

    amr = AmrSimulation(params, problem_init=reacting_convergence_init, problem_tagging=ptag,
                        device="cpu")
    amr.init_data()
    # pointwise initial values -> cell averages (4th-order FV evolves averages)
    amr.u[0] = amr.sim0._clean_fill_impl(cell_center_to_avg(amr.u[0], 1))
    lev = amr._get_level(1, amr.window[1][1])
    amr.u[1] = lev.sim._clean_fill_impl(cell_center_to_avg(amr.u[1], 1))
    assert int(amr.masks[1].sum()) > 0 and amr.sim0.sdc.burner is not None
    vol = 1.0e8 / n
    amr.advance(1.5e-3)
    m0 = _mass(amr, vol)
    amr.advance(1.5e-3)
    m1 = _mass(amr, vol)
    assert abs(m1 - m0) / m0 < 1e-11, (m0, m1)
    assert np.isfinite(amr.interior(0).numpy()).all()
    assert bool(torch.isfinite(amr.u[1]).all())
