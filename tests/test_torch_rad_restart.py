"""Restart the port from the JAX package's checkpoint of a radiation run
(`castro_tpu/driver/io.py:write_checkpoint`, whose state.npz carries
`u_rad`) and take the next step in both: gray and multigroup
(tests/test_torch_rad_steps.py's box, the characteristic rad-CTU step).
Without `u_rad` a restarted run would start from the equilibrium Er.
Tolerance float64 1e-10 |jax| + 1e-10 max|jax| per component."""

import numpy as np
import pytest

from castro_tpu.config import Params as JParams
from castro_tpu.driver import io as jio
from castro_tpu.driver.sim import Simulation as JSim

from castro_tpu_torch import convert
from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation

from test_torch_radiation import _few_threads, close, jit_jax_solve  # noqa: F401
from test_torch_rad_steps import _jinit, box_params


@pytest.mark.parametrize("ngroups", [1, 4], ids=["gray", "4groups"])
def test_restart_radiation_from_jax_checkpoint(jit_jax_solve, tmp_path, ngroups):
    kw = dict(ngroups=ngroups)
    js = JSim(box_params(JParams, (32,), **kw).with_ns("castro", fixed_dt=2e-3),
              problem_init=_jinit)
    js.init_data()
    js.u_rad = js.u_rad * 3.0 + 0.5  # out of equilibrium, so a reset Er would show
    js.run(max_step=1, verbose=False)
    path = jio.write_checkpoint(js, str(tmp_path / "chk00001"))
    js.run(max_step=2, verbose=False)
    sim = Simulation(box_params(Params, (32,), **kw).with_ns("castro", fixed_dt=2e-3),
                     device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    assert sim.u_rad is not None and sim.step_count == 1
    sim.run(max_step=2, verbose=False)
    L = sim.layout
    close(sim.interior(), np.asarray(js.interior()), what="u",
          vectors=[(L.UMX, L.UMY, L.UMZ)])
    er = np.asarray(js.u_rad)
    close(sim.u_rad if ngroups > 1 else sim.u_rad[None], er if ngroups > 1 else er[None],
          what="Er")
    hydro = Simulation(box_params(Params, (32,), **kw).with_ns("castro", do_radiation=0),
                       device="cpu")
    with pytest.raises(ValueError, match="do_radiation"):
        convert.restart_from_jax_checkpoint(hydro, path)
